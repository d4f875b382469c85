# Copyright 2026. Apache License 2.0.
"""Single-line console progress bar for the evaluation loop.

A copy of ``medicalseg_tpu/utils/progbar.py`` (pure Python; the port
imports nothing of the JAX package). Capability parity with the
reference's Keras-derived bar (medicalseg/utils/progbar.py:22-208) —
``Progbar(target).update(step, [(name, value), ...])`` with running-mean
metrics, ETA while in flight and time-per-step at the end — but
implemented as a fresh line renderer: each update rebuilds the whole
status line and redraws it in place.
"""

import shutil
import sys
import time


def _fmt_duration(seconds):
    seconds = int(seconds)
    if seconds >= 3600:
        return "%d:%02d:%02d" % (seconds // 3600, seconds % 3600 // 60,
                                 seconds % 60)
    if seconds >= 60:
        return "%d:%02d" % (seconds // 60, seconds % 60)
    return "%ds" % seconds


def _fmt_rate(sec_per_step, unit):
    if sec_per_step >= 1 or sec_per_step == 0:
        return "%.0fs/%s" % (sec_per_step, unit)
    if sec_per_step >= 1e-3:
        return "%.0fms/%s" % (sec_per_step * 1e3, unit)
    return "%.0fus/%s" % (sec_per_step * 1e6, unit)


class _RunningMean:
    __slots__ = ("total", "weight")

    def __init__(self):
        self.total = 0.0
        self.weight = 0

    def push(self, value, weight):
        self.total += float(value) * weight
        self.weight += weight

    @property
    def value(self):
        return self.total / self.weight if self.weight else 0.0


class Progbar:
    """Draws ``k/N [====>....] - ETA: .. - name: value`` on one line.

    Args:
        target: total step count, or ``None`` when unknown.
        width: character width of the bar segment.
        verbose: 0 = silent, 1 = live bar, 2 = summary line at the end only.
        interval: minimum seconds between redraws (final draw always shown).
        stateful_metrics: names reported verbatim instead of running-mean.
        unit_name: noun used in the rate suffix ("step" → "12ms/step").
    """

    def __init__(self, target, width=30, verbose=1, interval=0.05,
                 stateful_metrics=None, unit_name="step"):
        self.target = target
        self.width = width
        self.verbose = verbose
        self.interval = interval
        self.unit_name = unit_name
        self.stateful_metrics = frozenset(stateful_metrics or ())
        self._metrics = {}          # name -> _RunningMean | raw value
        self._order = []
        self._begun = time.time()
        self._last_draw = 0.0
        self._last_step = 0
        self._prev_len = 0
        self._isatty = bool(getattr(sys.stdout, "isatty", lambda: False)())

    # -- metric bookkeeping -------------------------------------------------
    def _absorb(self, current, values):
        step_weight = max(current - self._last_step, 1)
        for name, value in values or ():
            if name not in self._metrics:
                self._order.append(name)
                if name not in self.stateful_metrics:
                    self._metrics[name] = _RunningMean()
            slot = self._metrics.get(name)
            if isinstance(slot, _RunningMean):
                slot.push(value, step_weight)
            else:
                self._metrics[name] = value
        self._last_step = current

    def _metric_text(self):
        parts = []
        for name in self._order:
            slot = self._metrics[name]
            v = slot.value if isinstance(slot, _RunningMean) else slot
            try:
                v = float(v)
                spec = " %.4f" if abs(v) > 1e-3 else " %.4e"
                parts.append(" - %s:%s" % (name, spec % v))
            except (TypeError, ValueError):
                parts.append(" - %s: %s" % (name, v))
        return "".join(parts)

    # -- rendering ----------------------------------------------------------
    def _bar_text(self, current):
        if self.target is None:
            return "%7d/Unknown" % current
        digits = len(str(self.target))
        frac = min(float(current) / self.target, 1.0)
        filled = int(self.width * frac)
        body = "=" * max(filled - 1, 0)
        if filled:
            body += "=" if current >= self.target else ">"
        body += "." * (self.width - filled)
        return "%*d/%d [%s]" % (digits, current, self.target, body)

    def _timing_text(self, current, done):
        elapsed = time.time() - self._begun
        per_step = elapsed / current if current else 0.0
        if done or self.target is None:
            return " - %.0fs %s" % (elapsed, _fmt_rate(per_step,
                                                       self.unit_name))
        return " - ETA: %s" % _fmt_duration(per_step *
                                            (self.target - current))

    def _draw(self, line, newline):
        pad = max(self._prev_len - len(line), 0)
        if self._isatty:
            sys.stdout.write("\r" + line + " " * pad)
        else:
            sys.stdout.write("\n" + line)
        if newline:
            sys.stdout.write("\n")
        sys.stdout.flush()
        self._prev_len = len(line)

    # -- public API ---------------------------------------------------------
    def update(self, current, values=None, finalize=None):
        if finalize is None:
            finalize = self.target is not None and current >= self.target
        self._absorb(current, values)
        if self.verbose == 0:
            return
        now = time.time()
        if self.verbose == 1:
            if not finalize and now - self._last_draw < self.interval:
                return
            line = (self._bar_text(current) +
                    self._timing_text(current, finalize) +
                    self._metric_text())
            maxw = shutil.get_terminal_size((200, 20)).columns
            self._draw(line[:maxw], newline=finalize)
        elif self.verbose == 2 and finalize:
            line = ("%d/%d" % (current, self.target) +
                    self._timing_text(current, True) + self._metric_text())
            sys.stdout.write(line + "\n")
            sys.stdout.flush()
        self._last_draw = now

    def add(self, n, values=None):
        self.update(self._last_step + n, values)
