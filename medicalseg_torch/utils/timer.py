# Copyright 2026. Apache License 2.0.
"""Wall-clock cost averaging for the train loop.

A copy of ``medicalseg_tpu/utils/timer.py`` without its ``Stopwatch``
(the port imports nothing of the JAX package): windowed batch and reader
cost, samples per second and an ETA string, as the reference's
medicalseg/utils/timer.py:18-53 gives them.
"""


class TimeAverager:
    """Windowed mean of recorded durations and derived throughput.

    The train loop calls :meth:`record` once per step with the step's
    wall-clock duration (and optionally how many samples it processed),
    reads :meth:`get_average` / :meth:`get_ips_average` at each logging
    boundary, then calls :meth:`reset` to start a fresh window.
    """

    __slots__ = ("_events", "_seconds", "_samples")

    def __init__(self):
        self.reset()

    def reset(self):
        self._events = 0
        self._seconds = 0.0
        self._samples = 0

    def record(self, usetime, num_samples=None):
        self._events += 1
        self._seconds += float(usetime)
        if num_samples is not None:
            self._samples += int(num_samples)

    def get_average(self):
        """Mean seconds per recorded event (0 when the window is empty)."""
        return self._seconds / self._events if self._events else 0

    def get_ips_average(self):
        """Samples per second over the window (0 if none were counted)."""
        if self._samples <= 0 or self._seconds <= 0:
            return 0
        return self._samples / self._seconds


def calculate_eta(remaining_step, speed):
    """Format the remaining time as ``HH:MM:SS``.

    Args:
        remaining_step: steps left (clamped at zero).
        speed: seconds per step.
    """
    seconds = int(max(remaining_step, 0) * speed)
    minutes, ss = divmod(seconds, 60)
    hh, mm = divmod(minutes, 60)
    return "{:02d}:{:02d}:{:02d}".format(hh, mm, ss)
