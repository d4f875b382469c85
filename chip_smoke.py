#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``medicalseg_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or ``medicalseg_tpu``. Phases, each printing one
JSON line; any failure raises and the script exits non-zero:

1. device: require CUDA, print ``nvidia-smi``'s name and power limit, turn
   TF32 off for the f32 references.
2. build: compile ``medicalseg_torch/csrc/*.cu`` (one ``nvcc`` each, in
   parallel) and report the seconds.
3. kernels: at every 5^3 conv shape of the 128^3 batch-2 V-Net forward,
   hold each kernel (head, stem, fused epilogue) against its plain PyTorch
   version in bf16 (atol = rtol = 2e-2, one bf16 ulp at the outputs'
   magnitude) and f32 (atol = rtol = 1e-4, TF32 off: summation order
   only), and the pin kernel against ``contiguous()`` on the permuted
   views the forward pins (exact). Times (CUDA events, one warm-up,
   median of 5) of each kernel, its plain version and ``F.conv3d`` /
   ``contiguous()`` as the library yardstick, beside each kernel's bound.
4. serve: four seeded 128^3 volumes through
   ``medicalseg_torch.deploy.infer.Predictor`` (the lung ``_tpu`` config's
   model section, a seeded init with non-trivial BN statistics, bf16,
   batch 2: two requests after one warm-up batch). The launch counters are
   zeroed just before and read just after; every kernel must have run, 16
   convs and 8 pins per forward. The kernel path's logits are then held
   against the plain-version path's on the same batch (argmax agreement
   >= 99.5% of voxels), and the saved predictions against the logits.
5. kernels_bwd: at the same conv shapes, the backward kernels against
   their plain versions: the input gradient (the forward kernel on the
   flipped, io-transposed weight; not for the stem, whose input is the
   image) with the forward's tolerances, and the weight gradient in its
   three forms (stem, narrow head, square / wide). dW sums one product per
   voxel, up to 4.2 M of them, so its tolerance is relative to the
   tensor's magnitude: |d| <= tol * (max |dW| + |dW|), tol = 2e-2 in bf16
   (dW is rounded to bf16, as the JAX package's is) and 1e-4 in f32.
   Times as in phase 3 (the plain weight gradient once), with
   ``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` as the library
   yardstick.
6. train: the lung ``_tpu`` config's model (bf16, per-block remat),
   optimizer, schedule and loss built by ``Config``, seeded init, batch 2
   at 128^3, seeded volumes and labels in {0, 1, 2}, through
   ``core.state.make_train_step``: two warm-up steps and three timed
   steps on the same batch, the dropout generator re-seeded before each
   step so that the losses are comparable. Fatal checks: finite losses;
   after step 1 every parameter has a finite, non-zero gradient; the
   launch counts of the three timed steps are what the model implies (per
   step, with remat recomputing each block once: 2 x 16 forward convs, 15
   dgrads, 16 wgrads as 1 stem + 1 head + 14 mid, 2 x 8 forward pins and
   none in the backward); step 1's loss and per-parameter gradients agree
   with the plain-version path from the same state and masks (loss within
   1e-2 relative, each leaf's gradient within a relative L2 error of
   0.35: bf16 activations rounded at other places by the two paths,
   through 31 layers; the same comparison in f32 at 64^3 holds every leaf
   to 2e-2 and the loss to 1e-5); the loss falls. Prints ms per step (the
   median of the three), patches/s, peak memory with and without remat,
   and the profiler's device time by kernel and idle share of one step.

Then one ``{"kernels": [...]}`` line (times summed over the convs of one
forward or backward; ``launches`` of the forward kernels from the serve
phase, of the backward kernels from the train phase) and, last, the
``{"ok": ...}`` line.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from medicalseg_torch.core.state import (TrainState,  # noqa: E402
                                         make_train_step)
from medicalseg_torch.cvlibs.config import Config, build_model  # noqa: E402
from medicalseg_torch.deploy import infer  # noqa: E402
from medicalseg_torch.ops import _build  # noqa: E402
from medicalseg_torch.ops import conv5 as c5  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LUNG_TPU = os.path.join(ROOT, "configs", "lung_coronavirus",
                        "vnet_lung_coronavirus_128_128_128_15k_tpu.yml")
BATCH = 2
EDGE = 128  # served volume edge
# The 5^3 convs of one V-Net forward at 128^3: (name, kind, Ci, Co, edge,
# convs per forward). 16 convs: the stem, the NConv stacks, the head.
CONVS = [("in_tr", "stem", 1, 16, 128, 1),
         ("down_tr32", "head", 32, 32, 64, 1),
         ("down_tr64", "head", 64, 64, 32, 2),
         ("down_tr128", "head", 128, 128, 16, 3),
         ("down_tr256", "head", 256, 256, 8, 2),
         ("up_tr256", "head", 256, 256, 16, 2),
         ("up_tr128", "head", 128, 128, 32, 2),
         ("up_tr64", "head", 64, 64, 64, 1),
         ("up_tr32", "head", 32, 32, 128, 1),
         ("out_tr", "head", 32, 3, 128, 1)]
# The pins of one forward: each down/up conv output [N, C, D, H, W] seen as
# [N, D, C, H, W]: (C, edge).
PINS = [(32, 64), (64, 32), (128, 16), (256, 8),
        (128, 16), (64, 32), (32, 64), (16, 128)]
FWD_KERNELS = ("conv5_head", "conv5_stem", "conv5_fused_epilogue", "pin")
BWD_KERNELS = ("conv5_dgrad", "conv5_wgrad_stem", "conv5_wgrad_head",
               "conv5_wgrad_mid")
SOURCES = {"conv5_head": "medicalseg_torch/csrc/conv5.cu",
           "conv5_stem": "medicalseg_torch/csrc/conv5.cu",
           "conv5_fused_epilogue": "medicalseg_torch/csrc/conv5.cu",
           "pin": "medicalseg_torch/csrc/pin.cu",
           "conv5_dgrad": "medicalseg_torch/csrc/conv5.cu",
           "conv5_wgrad_stem": "medicalseg_torch/csrc/conv5_wgrad.cu",
           "conv5_wgrad_head": "medicalseg_torch/csrc/conv5_wgrad.cu",
           "conv5_wgrad_mid": "medicalseg_torch/csrc/conv5_wgrad.cu"}
REPLACES = {"conv5_head": "medicalseg_tpu/ops/pallas_conv5.py:382",
            "conv5_stem": "medicalseg_tpu/ops/pallas_conv5.py:423",
            "conv5_fused_epilogue": "medicalseg_tpu/ops/pallas_conv5.py:1288",
            "pin": "medicalseg_tpu/ops/pallas_conv5.py:1412",
            "conv5_dgrad": "medicalseg_tpu/ops/pallas_conv5.py:1383",
            "conv5_wgrad_stem": "medicalseg_tpu/ops/pallas_conv5.py:912",
            "conv5_wgrad_head": "medicalseg_tpu/ops/pallas_conv5.py:912",
            "conv5_wgrad_mid": "medicalseg_tpu/ops/pallas_conv5.py:832"}
TRAIN_SEED = 0
# kernel path vs plain path, relative L2 error per leaf. bf16 at 128^3:
# the two paths round at other places, and the random-init net amplifies
# it (measured worst 0.20, median 0.08, while either bf16 path sits 0.17
# median and 0.49 worst from the f32 gradients). f32 at 64^3: measured
# worst 4e-3.
GRAD_REL_L2 = 0.35
GRAD_REL_L2_F32 = 2e-2
LOSS_REL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, message):
    if not cond:
        raise SmokeFailure(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed_once(fn):
    """(fn(), its CUDA-event time in ms): one run, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def new_stats(keys):
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bound_by": {}} for k in keys}


def add_stats(stats, key, count, ms, plain_ms, bound, by, lib_ms):
    s = stats[key]
    s["ms"] += count * ms
    s["plain_ms"] += count * plain_ms
    s["bound_ms"] += count * bound
    s["bound_by"][by] = s["bound_by"].get(by, 0.0) + count * bound
    s["library_ms"] = (None if lib_ms is None or s["library_ms"] is None
                       else s["library_ms"] + count * lib_ms)


def conv_bound_ms(ci, co, edge, itemsize):
    """The least time of one conv, forward or backward: the same 2 * 125 *
    Ci * Co FLOP per voxel, and both activations (x and y, g and dx, or x
    and g) moved once beside the f32 weights (read, or dW written)."""
    vox = BATCH * edge ** 3
    flops = 2.0 * vox * 125 * ci * co
    nbytes = vox * (ci + co) * itemsize + 4 * (125 * ci * co + co)
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


# ----------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    t0 = time.time()
    paths = _build.build()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": [p.name for p in paths.values()]})


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    stats = new_stats(FWD_KERNELS)

    def add(*args):
        add_stats(stats, *args)

    for name, kind, ci, co, e, count in CONVS:
        x = torch.randn((BATCH, e, ci, e, e), generator=gen, device=dev)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device=dev) / (125 * ci) ** 0.5
        b = torch.randn((co,), generator=gen, device=dev)
        ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
              torch.randn((co,), generator=gen, device=dev),
              torch.rand((co,), generator=gen, device=dev))
        line = {"phase": "kernels", "conv": name, "kind": kind, "ci": ci,
                "co": co, "shape": [BATCH, e, ci, e, e]}
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            for fused in (False, True):
                e_ = ep if fused else None
                got = (c5.conv5_kl_fused(xd, w, b, e_, kind) if fused else
                       c5.conv5_kl(xd, w, b, kind))
                ref = c5.conv5_kl_plain(xd, w, b, e_)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                tag = "{}_{}".format(str(dtype)[6:],
                                     "fused" if fused else "plain_form")
                line["err_" + tag] = err
                check(torch.allclose(got.float(), ref.float(),
                                     atol=TOL[dtype], rtol=TOL[dtype]),
                      "{} {} disagrees with its plain version: max |d| "
                      "{}".format(name, tag, err))
                if dtype == torch.bfloat16:
                    key = "conv5_fused_epilogue" if fused else "conv5_" + kind
                    stats[key]["err"] = max(stats[key]["err"], err)
                    if fused and kind == "stem":
                        stats["conv5_stem"]["err"] = max(
                            stats["conv5_stem"]["err"], err)
                del got, ref
        xb = x.to(torch.bfloat16)
        ms = time_ms(lambda: c5.conv5_kl(xb, w, b, kind))
        ms_f = time_ms(lambda: c5.conv5_kl_fused(xb, w, b, ep, kind))
        plain = time_ms(lambda: c5.conv5_kl_plain(xb, w, b))
        plain_f = time_ms(lambda: c5.conv5_kl_plain(xb, w, b, ep))
        x_ncdhw = xb.transpose(1, 2).contiguous()
        w_oidhw = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        b16 = b.to(torch.bfloat16)
        lib = time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, b16, padding=2))
        bound, by = conv_bound_ms(ci, co, e, 2)
        line.update(ms=ms, ms_fused=ms_f, plain_ms=plain,
                    plain_ms_fused=plain_f, library_ms=lib, bound_ms=bound,
                    bound_by=by, per_forward=count)
        emit(line)
        add("conv5_" + kind, count, ms, plain, bound, by, lib)
        add("conv5_fused_epilogue", count, ms_f, plain_f, bound, by, None)
        del x, xb, x_ncdhw

    for c, e in PINS:
        src = torch.randn((BATCH, c, e, e, e), generator=gen,
                          device=dev).to(torch.bfloat16)
        view = src.transpose(1, 2)
        got = c5.pin_kl(view)
        torch.cuda.synchronize()
        check(got.is_contiguous() and torch.equal(got, view.contiguous()),
              "pin disagrees with contiguous() at C={} edge={}".format(c, e))
        ms = time_ms(lambda: c5.pin_kl(view))
        plain = time_ms(lambda: c5.pin_kl_plain(view))
        nbytes = 2 * src.numel() * src.element_size()
        bound = nbytes / PEAK_BYTES * 1e3
        emit({"phase": "kernels", "pin": [BATCH, e, c, e, e], "ms": ms,
              "plain_ms": plain, "library_ms": plain, "bound_ms": bound,
              "bound_by": "bytes", "err": 0.0})
        add("pin", 1, ms, plain, bound, "bytes", plain)
    return stats


def scaled_err(got, ref):
    """max |got - ref| / (max |ref| + |ref|): the error relative to the
    tensor's magnitude, for sums whose entries grow with the voxel count."""
    ref = ref.float()
    return ((got.float() - ref).abs() /
            (ref.abs().max() + ref.abs())).max().item()


def phase_kernels_bwd():
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    stats = new_stats(BWD_KERNELS)
    for name, kind, ci, co, e, count in CONVS:
        x = torch.randn((BATCH, e, ci, e, e), generator=gen, device=dev)
        g = torch.randn((BATCH, e, co, e, e), generator=gen, device=dev)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device=dev) / (125 * ci) ** 0.5
        form = "conv5_wgrad_" + c5.conv5_wgrad_geometry(
            BATCH, e, e, e, ci, co, kind)["form"]
        line = {"phase": "kernels_bwd", "conv": name, "kind": kind, "ci": ci,
                "co": co, "shape": [BATCH, e, ci, e, e], "wgrad_form": form}
        plain_w = plain_d = None
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype)[6:]
            xd, gd = x.to(dtype), g.to(dtype)
            got = c5.conv5_wgrad_kl(xd, gd, kind)
            torch.cuda.synchronize()
            ref, ms = timed_once(lambda: c5.conv5_wgrad_kl_plain(xd, gd))
            if dtype == torch.bfloat16:  # the plain version is timed once
                plain_w = ms
            check(tuple(got.shape) == (5, 5, 5, ci, co) and
                  got.dtype == torch.float32, name + " dW shape/dtype")
            rel = scaled_err(got, ref)
            line["wgrad_rel_err_" + tag] = rel
            line["wgrad_max_abs_" + tag] = ref.abs().max().item()
            check(bool(torch.isfinite(got).all()) and rel <= TOL[dtype],
                  "{} wgrad {} disagrees with its plain version: scaled "
                  "error {}".format(name, tag, rel))
            if dtype == torch.bfloat16:
                stats[form]["err"] = max(stats[form]["err"],
                                         (got - ref).abs().max().item())
            del got, ref
            if kind != "stem":
                got = c5.conv5_dgrad_kl(gd, w)
                ref, ms = timed_once(lambda: c5.conv5_dgrad_kl_plain(gd, w))
                if dtype == torch.bfloat16:
                    plain_d = ms
                err = (got.float() - ref.float()).abs().max().item()
                line["dgrad_err_" + tag] = err
                check(torch.allclose(got.float(), ref.float(),
                                     atol=TOL[dtype], rtol=TOL[dtype]),
                      "{} dgrad {} disagrees with its plain version: max "
                      "|d| {}".format(name, tag, err))
                if dtype == torch.bfloat16:
                    stats["conv5_dgrad"]["err"] = max(
                        stats["conv5_dgrad"]["err"], err)
                del got, ref
            del xd, gd
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        del x, g
        bound, by = conv_bound_ms(ci, co, e, 2)
        x_ncdhw = xb.transpose(1, 2).contiguous()
        g_ncdhw = gb.transpose(1, 2).contiguous()
        w_oidhw = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        ms_w = time_ms(lambda: c5.conv5_wgrad_kl(xb, gb, kind))
        lib_w = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x_ncdhw, w_oidhw.shape, g_ncdhw, padding=2))
        line.update(wgrad_ms=ms_w, wgrad_plain_ms=plain_w,
                    wgrad_library_ms=lib_w, bound_ms=bound, bound_by=by,
                    per_step=count)
        add_stats(stats, form, count, ms_w, plain_w, bound, by, lib_w)
        if kind != "stem":
            ms_d = time_ms(lambda: c5.conv5_dgrad_kl(gb, w))
            lib_d = time_ms(lambda: torch.nn.grad.conv3d_input(
                x_ncdhw.shape, w_oidhw, g_ncdhw, padding=2))
            line.update(dgrad_ms=ms_d, dgrad_plain_ms=plain_d,
                        dgrad_library_ms=lib_d)
            add_stats(stats, "conv5_dgrad", count, ms_d, plain_d, bound, by,
                      lib_d)
        emit(line)
        del xb, gb, x_ncdhw, g_ncdhw
    return stats


KERNEL_TAGS = ("conv5_mma_kernel", "conv5_kernel", "wgrad_kernel",
               "wgrad_reduce_kernel", "pin_kernel")


def profile_call(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of the host wall time of that call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        for tag in KERNEL_TAGS:
            if tag in name:
                name = tag
        groups[name] = groups.get(name, 0.0) + ev.self_device_time_total / 1e3
    busy_ms = sum(groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "device_ms_by_kernel": [[k[:80], v] for k, v in top]}


@contextlib.contextmanager
def plain_ops():
    """Route every kernel launch of the model, forward and backward, to
    its plain version (the reference path on the card). The autograd
    Functions stay in place: only what they launch changes."""
    names = ("_conv5_forward", "conv5_kl_fused", "conv5_dgrad_kl",
             "conv5_wgrad_kl", "_pin_forward")
    saved = [getattr(c5, n) for n in names]
    c5._conv5_forward = lambda xk, w, b, kind: c5.conv5_kl_plain(xk, w, b)
    c5.conv5_kl_fused = (lambda xk, w, b, ep, kind="head":
                         c5.conv5_kl_plain(xk, w, b, ep))
    c5.conv5_dgrad_kl = c5.conv5_dgrad_kl_plain
    c5.conv5_wgrad_kl = (lambda xk, gk, kind="head":
                         c5.conv5_wgrad_kl_plain(xk, gk))
    c5._pin_forward = c5.pin_kl_plain
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(c5, n, fn)


def phase_serve(workdir):
    model_cfg = Config(LUNG_TPU).dic["model"]
    gen = torch.Generator().manual_seed(0)
    model = build_model(model_cfg, generator=gen)
    state = model.state_dict()
    for key, val in state.items():  # non-trivial BN statistics
        if key.endswith("running_mean"):
            val.copy_(0.1 * torch.randn(val.shape, generator=gen))
        elif key.endswith("running_var"):
            val.copy_(0.5 + torch.rand(val.shape, generator=gen))
    torch.save(state, os.path.join(workdir, "model.pt"))
    import yaml
    with open(os.path.join(workdir, "deploy.yaml"), "w") as f:
        yaml.dump({"Deploy": {"model": "model.stablehlo",
                              "params": "model.pt", "transforms": [],
                              "output_op": "argmax",
                              "input_shape_ndhwc": [1, EDGE, EDGE, EDGE, 1],
                              "model_config": model_cfg}}, f)
    img_dir = os.path.join(workdir, "images")
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    imgs = []
    for i in range(4):
        path = os.path.join(img_dir, "vol{}.npy".format(i))
        np.save(path, (rng.rand(EDGE, EDGE, EDGE) * 1000).astype(np.float32))
        imgs.append(path)
    args = infer.parse_args([
        "--config", os.path.join(workdir, "deploy.yaml"), "--image_path",
        img_dir, "--save_dir", os.path.join(workdir, "pred"),
        "--precision", "bf16", "--batch_size", str(BATCH),
        "--benchmark", "true"])
    predictor = infer.Predictor(args)
    check(predictor.model.dtype == torch.bfloat16, "model is not bf16")

    c5.reset_launches()
    saved = predictor.run(imgs)
    torch.cuda.synchronize()
    launches = dict(c5.LAUNCHES)
    forwards = 1 + len(imgs) // BATCH  # warm-up + two requests
    expect = {"conv5_head": 15 * forwards, "conv5_stem": forwards,
              "conv5_fused_epilogue": 16 * forwards, "pin": 8 * forwards}
    expect.update({k: 0 for k in BWD_KERNELS})
    check(launches == expect, "launch counts {} != expected {}".format(
        launches, expect))

    batch = np.concatenate([predictor._preprocess(p) for p in imgs[:BATCH]])
    with torch.inference_mode():
        x = torch.from_numpy(batch).to(predictor.device)
        logits = predictor.model(x)[0]
        with plain_ops():
            logits_plain = predictor.model(x)[0]
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, EDGE, EDGE, EDGE, 3)
          and logits.dtype == torch.float32, "logits shape/dtype")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    agree = (logits.argmax(-1) == logits_plain.argmax(-1)).float().mean()
    max_d = (logits - logits_plain).abs().max().item()
    check(agree.item() >= 0.995, "argmax agreement {} < 0.995".format(
        agree.item()))
    for j in range(BATCH):
        pred = np.load(saved[j])
        check(pred.shape == (EDGE,) * 3 and pred.dtype == np.int32,
              "saved prediction shape/dtype")
        check(np.array_equal(pred, logits[j].argmax(-1).cpu().numpy()),
              "saved prediction differs from the logits' argmax")
    def forward():
        with torch.inference_mode():
            predictor.model(x)[0].argmax(-1)

    profile = profile_call(forward)
    inf_s = predictor.timer.stages["inference"]
    emit({"phase": "serve", "volumes": len(imgs), "batch": BATCH,
          "requests": len(inf_s), "ms_per_batch": 1e3 * float(np.mean(inf_s)),
          "ms_per_batch_each": [1e3 * t for t in inf_s],
          "vol_per_s": len(imgs) / float(np.sum(inf_s)),
          "preprocess_ms": 1e3 * float(np.mean(
              predictor.timer.stages["preprocess"])),
          "launches": launches, "max_abs_logit_diff_vs_plain": max_d,
          "argmax_agreement_vs_plain": agree.item(),
          "logit_absmax": logits.abs().max().item(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "profile": profile})
    return launches


def grad_rel_l2(grads, ref_grads):
    """{leaf: ||g - ref|| / ||ref||}. The bias of a conv that feeds a
    BatchNorm has a zero gradient up to rounding (the batch mean removes
    it), so its error is held relative to the gradient of its conv's
    weight."""
    rels = {}
    for name, gp in ref_grads.items():
        scale = gp.norm()
        if name.endswith(("conv1.bias", "down_conv.bias", "up_conv.bias")):
            scale = ref_grads[name[:-4] + "weight"].norm()
        rels[name] = ((grads[name] - gp).norm() /
                      scale.clamp_min(1e-30)).item()
    return rels


def phase_train():
    cfg = Config(LUNG_TPU)
    check(cfg.dic["model"]["remat"] is True and
          cfg.dic["model"]["dtype"] == "bfloat16", "lung config changed")
    dev = torch.device("cuda")
    rng = np.random.RandomState(TRAIN_SEED)
    images = torch.from_numpy(
        rng.rand(BATCH, EDGE, EDGE, EDGE, 1).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.randint(0, 3, (BATCH, EDGE, EDGE, EDGE)).astype(np.uint8)).to(dev)
    step = make_train_step(cfg.loss)

    def new_state(weights=None):
        model = build_model(cfg.dic["model"], generator=torch.Generator(
        ).manual_seed(TRAIN_SEED))
        if weights is not None:
            model.load_state_dict(weights)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED)

    def run(state):
        """One step on the batch with the same dropout masks every time;
        returns (loss, ms on the host clock, synchronized)."""
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    state = new_state()
    model = state.model
    check(model.dtype == torch.bfloat16 and model.remat, "model is not the "
          "bf16 remat model of the config")
    start = copy.deepcopy(model.state_dict())

    # step 1 (warm-up): gradients on every parameter
    torch.cuda.reset_peak_memory_stats()
    loss1, warm_ms = run(state)
    peak_remat = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = {}
    for name, p in model.named_parameters():
        check(p.grad is not None, name + " has no gradient")
        check(bool(torch.isfinite(p.grad).all()), name + ": non-finite "
              "gradient")
        check(p.grad.abs().sum().item() > 0, name + ": zero gradient")
        grads[name] = p.grad.float().clone()

    # the same step through the plain versions, from the same state
    ref = new_state(start)
    with plain_ops():
        c5.reset_launches()
        loss1_plain, plain_ms = run(ref)
        check(not any(c5.LAUNCHES.values()), "the plain path launched a "
              "kernel: {}".format(c5.LAUNCHES))
    ref_grads = {n: p.grad.float() for n, p in ref.model.named_parameters()}
    rels = grad_rel_l2(grads, ref_grads)
    worst = max(rels.items(), key=lambda kv: kv[1])
    rel_sorted = sorted(rels.values())
    check(abs(loss1 - loss1_plain) <= LOSS_REL * abs(loss1_plain),
          "step-1 loss {} vs plain path {}".format(loss1, loss1_plain))
    check(worst[1] <= GRAD_REL_L2, "gradient of {} differs from the plain "
          "path's by {} relative L2".format(*worst))
    del ref, grads, ref_grads

    # the same comparison in f32 at 64^3, where rounding leaves it power
    f32 = {}
    for path in ("kernel", "plain"):
        st32 = TrainState.create(
            build_model(cfg.dic["model"], dtype=torch.float32,
                        generator=torch.Generator().manual_seed(TRAIN_SEED)),
            cfg.build_optimizer, cfg.lr_scheduler, seed=TRAIN_SEED)
        with (plain_ops() if path == "plain" else contextlib.nullcontext()):
            _, metrics = step(st32, images[:, :64, :64, :64],
                              labels[:, :64, :64, :64])
        f32[path] = (metrics["loss"].item(), {
            n: p.grad.clone() for n, p in st32.model.named_parameters()})
        del st32
    rels32 = grad_rel_l2(f32["kernel"][1], f32["plain"][1])
    worst32 = max(rels32.items(), key=lambda kv: kv[1])
    check(abs(f32["kernel"][0] - f32["plain"][0]) <= 1e-5 * f32["plain"][0],
          "f32 step-1 loss {} vs plain path {}".format(f32["kernel"][0],
                                                       f32["plain"][0]))
    check(worst32[1] <= GRAD_REL_L2_F32, "f32 gradient of {} differs from "
          "the plain path's by {} relative L2".format(*worst32))
    del f32

    # one more untimed step (the comparisons above emptied the caching
    # allocator's pools), then three timed steps, the counts set to 0 just
    # before them
    loss2, _ = run(state)
    c5.reset_launches()
    timed = [run(state) for _ in range(3)]
    launches = dict(c5.LAUNCHES)
    losses = [loss1, loss2] + [l for l, _ in timed]
    step_ms = [ms for _, ms in timed]
    check(all(np.isfinite(losses)), "non-finite loss: {}".format(losses))
    check(losses[-1] < losses[0], "the loss did not fall: {}".format(losses))
    fwd = 2  # remat: each block's forward runs again in the backward
    expect = {"conv5_head": 3 * fwd * 15, "conv5_stem": 3 * fwd,
              "conv5_fused_epilogue": 0, "conv5_dgrad": 3 * 15,
              "conv5_wgrad_stem": 3, "conv5_wgrad_head": 3,
              "conv5_wgrad_mid": 3 * 14}
    got = {k: launches[k] for k in expect}
    check(got == expect, "launch counts {} != expected {}".format(
        got, expect))
    # pins: the 8 up/down conv outputs of each forward run; no cotangent
    # of the backward arrives non-contiguous
    check(launches["pin"] == 3 * fwd * 8, "pin launches {} != expected "
          "{}".format(launches["pin"], 3 * fwd * 8))

    profile = profile_call(lambda: run(state))

    # the same step without remat: time and peak memory
    model.remat = False
    run(state)
    torch.cuda.reset_peak_memory_stats()
    _, ms_no_remat = run(state)
    peak_no_remat = torch.cuda.max_memory_allocated() / 2 ** 30
    model.remat = True

    mean_ms = float(np.median(step_ms))
    emit({"phase": "train", "batch": BATCH, "edge": EDGE, "dtype": "bfloat16",
          "remat": True, "steps": len(losses), "losses": losses,
          "loss_step1_plain_path": loss1_plain,
          "worst_grad_rel_l2_vs_plain": list(worst),
          "f32_64_worst_grad_rel_l2_vs_plain": list(worst32),
          "median_grad_rel_l2_vs_plain": rel_sorted[len(rel_sorted) // 2],
          "lr": [state.schedule(i) for i in range(len(losses))],
          "ms_per_step": mean_ms, "ms_per_step_each": step_ms,
          "patches_per_s": BATCH / mean_ms * 1e3, "warmup_step_ms": warm_ms,
          "plain_path_step_ms": plain_ms,
          "ms_per_step_no_remat": ms_no_remat,
          "peak_mem_gb_remat": peak_remat,
          "peak_mem_gb_no_remat": peak_no_remat,
          "launches": launches, "profile": profile})
    return launches


def main():
    phase_device()
    phase_build()
    stats = phase_kernels()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        launches = phase_serve(wd)
    stats.update(phase_kernels_bwd())
    train_launches = phase_train()
    launches.update({k: train_launches[k] for k in BWD_KERNELS})
    kernels = []
    for key, s in stats.items():
        check(launches[key] > 0, key + " never launched on the main path")
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "launches": launches[key],
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": max(s["bound_by"], key=s["bound_by"].get),
            "library_ms": s["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
