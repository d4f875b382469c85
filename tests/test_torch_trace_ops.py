"""The port's trace reader (``python -m medicalseg_torch.tools.trace_ops``)
on the CPU: a hand-written Chrome trace with the device events a train
step's trace holds (hand conv5 kernels with a split sum's second kernel,
the pin, cuDNN, elementwise, reductions, NCCL, copies and memsets, beside
host events that must not count), read per step by category, kernel and
launches; and a trace written through ``utils/train_profiler.py`` on the
CPU, which has no device events, so the command exits non-zero. Times
are sums of the events' ``dur`` (us) and compared to 1e-9 ms.
"""
import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from medicalseg_torch.tools import trace_ops
from medicalseg_torch.utils import train_profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WG = "void conv5_wg_kernel<2>(CUtensorMap, float const*, float*, int)"
REDUCE = "conv5_reduce_kernel(float const*, int, long, float*)"
WGRAD = "void wgrad_tma_kernel<64>(float*, CUtensorMap, CUtensorMap)"
PIN = "void pin_vec_kernel<unsigned long long>(ulonglong2 const*, int)"
CUDNN = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc"
ELTWISE = ("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::AUnaryFunctor<float, float, float, MulFunctor>>")
REDUCTION = "void at::native::reduce_kernel<512, 1, ReduceOp<float>>"
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, ulong)"
# (name, cat, dur us, times)
EVENTS = [(WG, "kernel", 1000.0, 4), (REDUCE, "kernel", 50.0, 2),
          (WGRAD, "kernel", 800.0, 2), (PIN, "kernel", 30.0, 8),
          (CUDNN, "kernel", 200.0, 2), (ELTWISE, "kernel", 10.0, 40),
          (REDUCTION, "kernel", 25.0, 4), (NCCL, "kernel", 700.0, 2),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 300.0, 2),
          ("Memset (Device)", "gpu_memset", 2.0, 6),
          ("aten::mul", "cpu_op", 5000.0, 3),
          ("cudaLaunchKernel", "cuda_runtime", 4.0, 60)]
STEPS = 2


def _write(path, events):
    trace = {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0,
                              "args": {"name": "python"}}]}
    t = 0.0
    for name, cat, dur, times in events:
        for _ in range(times):
            trace["traceEvents"].append({"ph": "X", "cat": cat, "name": name,
                                         "pid": 0, "tid": 7, "ts": t,
                                         "dur": dur})
            t += dur
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(trace, f)
    return path


def test_reader_groups_a_synthetic_trace_per_step(tmp_path):
    s = trace_ops.summarize(str(_write(tmp_path / "trace.json", EVENTS)),
                            STEPS)
    want = {"conv5_wg_kernel": 4000.0, "conv5_reduce_kernel": 100.0,
            "wgrad_tma_kernel": 1600.0, "pin": 240.0,
            "cuDNN / cuBLAS": 400.0, "elementwise": 400.0,
            "reductions": 100.0, "copies / memsets": 612.0}
    assert s["categories"].keys() == want.keys()
    for cat, us in want.items():
        assert s["categories"][cat] == pytest.approx(us / 1e3 / STEPS,
                                                     abs=1e-9), cat
    assert s["busy_ms"] == pytest.approx(sum(want.values()) / 1e3 / STEPS,
                                         abs=1e-9)
    assert s["nccl_ms"] == pytest.approx(1400.0 / 1e3 / STEPS, abs=1e-9)
    # conv5 4 + wgrad 2 + pin 8 a window; the split sum's reduce is not a
    # launch of its own
    assert s["hand_launches"] == (4 + 2 + 8) / STEPS
    assert s["kernels"][WG] == pytest.approx([2.0, 2.0])
    assert s["kernels"][ELTWISE] == pytest.approx([0.2, 20.0])
    assert list(s["kernels"])[0] == WG  # the largest first
    assert s["events"] == sum(t for _, c, _, t in EVENTS
                              if c not in ("cpu_op", "cuda_runtime"))


@pytest.mark.parametrize("name,cat", [
    (WG, "conv5_wg_kernel"), (REDUCE, "conv5_reduce_kernel"),
    ("void pin_kernel<float>(float const*)", "pin"), (PIN, "pin"),
    ("void hu_resize_kernel<4>(short const*)", "hu_resize"),
    ("void stem_wgrad_tc_kernel<true>(bf16 const*)", "stem_wgrad_tc_kernel"),
    ("void wgrad_head_tma_kernel(float*)", "wgrad_head_tma_kernel"),
    ("void (anonymous namespace)::conv5_tf32_kernel<4>(float const*)",
     "conv5_tf32_kernel"),
    ("void (anonymous namespace)::stem_tf32_kernel<true, true>(float*)",
     "stem_tf32_kernel"),
    ("void (anonymous namespace)::stem_wgrad_tf32_kernel<true>(float*)",
     "stem_wgrad_tf32_kernel"),
    ("void (anonymous namespace)::stem_wgrad_tf32_reduce_kernel(float*)",
     "stem_wgrad_tf32_reduce_kernel"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel", "cuDNN / cuBLAS"),
    ("void at::native::elementwise_kernel<128, 2>(int)", "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<f>",
     "copies / memsets"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>",
     "reductions"),
    (NCCL, "NCCL"), ("void some_kernel(int)", "other")])
def test_categories_by_name(name, cat):
    assert trace_ops.categorize(name) == cat


def test_cli_prints_the_tables_and_finds_a_trace_in_a_directory(tmp_path):
    """A gzipped trace under a directory, through the command."""
    os.makedirs(tmp_path / "run" / "host")
    _write(tmp_path / "run" / "host" / "t.trace.json.gz", EVENTS)
    proc = subprocess.run(
        [sys.executable, "-m", "medicalseg_torch.tools.trace_ops",
         str(tmp_path / "run"), str(STEPS), "3"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "device busy: 3.726 ms/step over 2 step(s)" in out
    assert "NCCL apart: 0.700 ms/step; hand-kernel launches: 7.00/step" in out
    assert "top 3 kernels" in out and out.count(" ms  x") == 3
    assert "53.7%  conv5_wg_kernel" in out


def test_a_cpu_trace_has_no_device_events(tmp_path):
    """``train_profiler`` on the CPU writes a trace of host events only:
    the reader says so and exits with 1."""
    train_profiler.reset()
    options = "batch_range=[1,3];profile_path={};exit_on_finished=false" \
        .format(tmp_path / "prof")
    x = torch.ones(64, 64)
    try:
        for _ in range(4):
            x = (x @ x).tanh()
            train_profiler.add_profiler_step(options)
    finally:
        train_profiler.reset()
    trace = tmp_path / "prof" / "trace.json"
    assert trace.is_file()
    assert trace_ops.summarize(str(trace), 2)["events"] == 0
    proc = subprocess.run(
        [sys.executable, "-m", "medicalseg_torch.tools.trace_ops",
         str(tmp_path / "prof"), "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 1
    assert "no device events" in proc.stdout
