# Copyright 2026. Apache License 2.0.
"""Iteration-windowed profiler hook.

Counterpart of ``medicalseg_tpu/utils/train_profiler.py`` (the reference's
medicalseg/utils/train_profiler.py:26-112): a ``--profiler_options
"batch_range=[50,60];profile_path=...;exit_on_finished=true"`` option
string starts a trace when the training loop's step counter reaches the
window's first value and stops it at the second. The tracer is
``torch.profiler`` with the card's activity where there is a card; the
trace is written as a Chrome trace, ``<profile_path>/trace.json`` (the
JAX package writes an XProf trace into the same directory).
"""

import os
import sys
import tempfile

import torch

_profiler_options = None
_profiler_step_id = 0
_profiler = None


class ProfilerOptions:
    """Parses 'key=value;key=value' option strings, as the JAX class does.

    Supported keys (reference train_profiler.py:26-81):
        batch_range - e.g. [50, 60]
        profile_path - trace output directory
        exit_on_finished - whether to exit after the window
        state / sorted_key / tracer_option - accepted for CLI parity
          (ignored: the trace records every operator and kernel).
    """

    def __init__(self, options_str):
        assert isinstance(options_str, str)
        self._options = {
            "batch_range": [10, 20],
            "state": "All",
            "sorted_key": "total",
            "tracer_option": "Default",
            "profile_path": os.path.join(tempfile.gettempdir(), "profile"),
            "exit_on_finished": True,
        }
        self._parse_from_string(options_str)

    def _parse_from_string(self, options_str):
        for kv in options_str.replace(" ", "").split(";"):
            if not kv:
                continue
            key, value = kv.split("=")
            if key == "batch_range":
                value_list = value.replace("[", "").replace("]", "").split(
                    ",")
                value_list = list(map(int, value_list))
                if len(value_list) >= 2 and 0 <= value_list[0] < \
                        value_list[1]:
                    self._options[key] = value_list
            elif key == "exit_on_finished":
                self._options[key] = value.lower() in ("yes", "true", "t",
                                                       "1")
            elif key in ("state", "sorted_key", "tracer_option",
                         "profile_path"):
                self._options[key] = value

    def __getitem__(self, name):
        if name not in self._options:
            raise ValueError(
                "ProfilerOptions does not have an option named %s." % name)
        return self._options[name]


def trace_path(options):
    """Where the window's trace goes: ``<profile_path>/trace.json``."""
    return os.path.join(options["profile_path"], "trace.json")


def add_profiler_step(options_str=None):
    """Call once per training iteration (reference core/train.py:153).
    The first call parses ``options_str``; the trace starts at call
    ``batch_range[0]`` (counting from 0) and stops at call
    ``batch_range[1]``, after waiting for the card, and then, with
    ``exit_on_finished``, ends the process."""
    if options_str is None:
        return

    global _profiler_options, _profiler_step_id, _profiler
    if _profiler_options is None:
        _profiler_options = ProfilerOptions(options_str)

    lo, hi = _profiler_options["batch_range"]
    if _profiler_step_id == lo and _profiler is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        _profiler = torch.profiler.profile(activities=activities)
        _profiler.start()
    elif _profiler_step_id == hi and _profiler is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        _profiler.stop()
        path = trace_path(_profiler_options)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _profiler.export_chrome_trace(path)
        _profiler = None
        if _profiler_options["exit_on_finished"]:
            sys.exit(0)

    _profiler_step_id += 1


def reset():
    """Forget the parsed options and the step count (a new run in the same
    process starts its window from 0 again); stops a trace in progress
    without writing it."""
    global _profiler_options, _profiler_step_id, _profiler
    if _profiler is not None:
        _profiler.stop()
    _profiler_options, _profiler_step_id, _profiler = None, 0, None
