# Copyright 2026. Apache License 2.0.
"""Where a step's device time goes, from a trace of the port.

    python -m medicalseg_torch.tools.trace_ops TRACE_OR_DIR [steps] [top]

Reads the Chrome trace that ``--profiler_options`` writes
(``utils/train_profiler.py``: ``<profile_path>/trace.json``; a directory is
searched for its newest ``*.json`` or ``*.json.gz``), keeps the device
events only (``cat`` ``kernel``, ``gpu_memcpy`` and ``gpu_memset``) and
prints, per step (the trace's window divided by ``steps``, 1 by default):
the busy ms, the ms and share of each category, and the ``top`` kernels (40
by default) with their ms and launches. NCCL kernels are summed apart and
left out of the busy time: a collective's kernel spins on its own stream
while it waits for the other ranks, so its time is not work. A trace with
no device events (one taken on the CPU) is reported as such and the command
exits with 1. The counterpart of the repo's ``tools/trace_ops.py``, which
reads a ``jax.profiler`` trace.
"""

import glob
import gzip
import json
import os
import re
import sys

# the hand kernels of csrc/, by their names in the trace
CONV5_KERNELS = ("conv5_wg_kernel", "conv5_reduce_kernel", "conv5_kernel",
                 "wgrad_kernel", "wgrad_mma_kernel", "wgrad_reduce_kernel",
                 "wgrad_tma_kernel", "wgrad_tma_reduce_kernel",
                 "wgrad_head_tma_kernel", "stem_tc_kernel",
                 "stem_wgrad_tc_kernel", "stem_wgrad_reduce_kernel",
                 "conv5_tf32_kernel", "conv5_tf32_reduce_kernel",
                 "wgrad_tf32_kernel", "wgrad_tf32_reduce_kernel",
                 "stem_tf32_kernel", "stem_wgrad_tf32_kernel",
                 "stem_wgrad_tf32_reduce_kernel")
PIN_KERNELS = ("pin_vec_kernel", "pin_kernel")
HU_KERNELS = ("hu_resize_kernel",)
# the second kernel of a split sum: it belongs to the launch of the first
REDUCE_KERNELS = ("conv5_reduce_kernel", "wgrad_reduce_kernel",
                  "wgrad_tma_reduce_kernel", "stem_wgrad_reduce_kernel",
                  "conv5_tf32_reduce_kernel", "wgrad_tf32_reduce_kernel",
                  "stem_wgrad_tf32_reduce_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NCCL = "nccl"
_LIBRARY = ("cudnn", "cublas", "cutlass", "xmma", "gemm", "gemv",
            "convolve", "winograd")
_REDUCTION = ("reduce", "softmax", "welford", "norm", "scan")


def _identifier(name, ids):
    """The first of ``ids`` that appears in ``name`` as a whole
    identifier (so ``pin_kernel`` does not match ``pin_vec_kernel``)."""
    for ident in ids:
        if re.search(r"(?<![A-Za-z0-9_])" + ident + r"(?![A-Za-z0-9_])",
                     name):
            return ident
    return None


def hand_kernel(name):
    """The csrc kernel that a device event's name launches, or None."""
    return _identifier(name, CONV5_KERNELS + PIN_KERNELS + HU_KERNELS)


def categorize(name, cat="kernel"):
    """The category of one device event: a hand conv5 kernel by its name,
    ``pin``, ``hu_resize``, ``cuDNN / cuBLAS``, ``copies / memsets``,
    ``elementwise``, ``reductions``, ``NCCL`` or ``other``."""
    if cat != "kernel":
        return "copies / memsets"
    hand = hand_kernel(name)
    if hand in CONV5_KERNELS:
        return hand
    if hand in PIN_KERNELS:
        return "pin"
    if hand in HU_KERNELS:
        return "hu_resize"
    n = name.lower()
    if NCCL in n:
        return "NCCL"
    if any(tag in n for tag in _LIBRARY):
        return "cuDNN / cuBLAS"
    if "copy" in n:
        return "copies / memsets"
    if "elementwise" in n:
        return "elementwise"
    if any(tag in n for tag in _REDUCTION):
        return "reductions"
    return "other"


def find_trace(path):
    """``path`` itself, or the newest trace file under a directory."""
    if os.path.isfile(path):
        return path
    found = [p for pattern in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(path, "**", pattern), recursive=True)]
    if not found:
        raise FileNotFoundError("no trace (*.json, *.json.gz) under " + path)
    return max(found, key=os.path.getmtime)


def load_events(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace.get("traceEvents", []) if isinstance(trace, dict) else trace


def summarize(path, steps=1):
    """The figures :func:`main` prints, per step, as a dict: ``busy_ms``
    (device events without NCCL), ``nccl_ms``, ``categories`` {name: ms},
    ``kernels`` {name: [ms, launches]}, ``hand_launches`` (launches of the
    hand kernels, a split sum's second kernel not counted: one a wrapper
    launch) and ``events`` (the device events read, in the whole
    trace)."""
    by_cat, by_name = {}, {}
    events = hand = 0
    for e in load_events(find_trace(path)):
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        name, dur = e.get("name", "?"), float(e.get("dur", 0.0))
        events += 1
        c = categorize(name, cat)
        by_cat[c] = by_cat.get(c, 0.0) + dur
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur, n + 1)
        kernel = hand_kernel(name) if cat == "kernel" else None
        if kernel is not None and kernel not in REDUCE_KERNELS:
            hand += 1
    scale = 1e-3 / steps  # us over the window -> ms a step
    nccl = by_cat.pop("NCCL", 0.0)
    return {"steps": steps, "events": events,
            "busy_ms": sum(by_cat.values()) * scale, "nccl_ms": nccl * scale,
            "categories": {c: v * scale for c, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "kernels": {k: [v[0] * scale, v[1] / steps] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])},
            "hand_launches": hand / steps}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m medicalseg_torch.tools.trace_ops "
              "TRACE_OR_DIR [steps] [top]")
        return 2
    path = find_trace(argv[0])
    steps = int(argv[1]) if len(argv) > 1 else 1
    top = int(argv[2]) if len(argv) > 2 else 40
    s = summarize(path, steps)
    print("trace: {}".format(path))
    if not s["events"]:
        print("no device events in the trace (taken without a card?)")
        return 1
    busy = s["busy_ms"]
    print("device busy: {:.3f} ms/step over {} step(s); NCCL apart: {:.3f} "
          "ms/step; hand-kernel launches: {:.2f}/step".format(
              busy, steps, s["nccl_ms"], s["hand_launches"]))
    print("\nby category (ms/step, share of busy):")
    for c, ms in s["categories"].items():
        print("  {:>10.3f} ms  {:5.1f}%  {}".format(
            ms, 100 * ms / busy if busy else 0.0, c))
    if s["nccl_ms"]:
        print("  {:>10.3f} ms      -   NCCL (apart)".format(s["nccl_ms"]))
    print("\ntop {} kernels (ms/step, launches/step):".format(top))
    for name, (ms, n) in list(s["kernels"].items())[:top]:
        print("  {:>10.3f} ms  x{:<7.2f} {}".format(ms, n, name[:100]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
