# Copyright 2026. Apache License 2.0.
"""Times of the bf16 convs of one V-Net forward / backward at 128^3, batch
2, on the card: the quick loop for work on ``csrc/conv5_wg.cu`` and, with
``--wgrad``, on the weight-gradient kernels (``csrc/conv5_wgrad_tma.cu``,
``csrc/conv5_wgrad.cu``).

    python -m medicalseg_torch.tools.conv5_times [--wgrad | --wgrad-stem |
        --ragged | --stem-f32] [--variant SRC.cu]

Builds ``conv5_wg`` (printing what ``-Xptxas -v`` says of each
instantiation: registers, spills, wgmma warnings), then per shape holds
the fused forward and the input gradient against their plain versions
(bf16, atol = rtol = 2e-2), checks that a second launch gives the same
bits, and prints their times with warm packed weights beside
``F.conv3d`` / ``conv3d_input``, the operation bound and the geometry
that ran; last the sums over one forward / backward. Then the bf16 stem
(``in_tr``, 1 -> 16): ``stem_tc_kernel`` (``csrc/conv5_stem.cu``,
printing its registers and spills) without and with the epilogue, held
to the plain version and to a repeat, beside ``conv5_kernel`` forced
(the kernel it replaced), ``F.conv3d`` and the bound by bytes; ``dev``
is the device time of the same call with the host's dispatch taken out
(ten calls replayed from one CUDA graph). ``--variant SRC.cu`` (any
number) builds each candidate of ``conv5_stem.cu`` (same C interface)
and times it beside the built kernel with the same checks. CUDA events,
one warm-up, median of five. Needs one NVIDIA GPU.

``--wgrad``: builds ``conv5_wgrad_tma`` and ``conv5_wgrad`` (printing
registers and spills of each instantiation), then per weight gradient of
one backward (the eight square and wide convs, the 32 -> 3 head and the
stem) the route that runs (``conv5_wgrad_form``) and its time, beside
the kernel each tensor-copy route replaced, forced (``old``:
``wgrad_mma_kernel<4>`` at the square and wide shapes,
``wgrad_mma_kernel<1>`` at the narrow head); whether a second launch
gives the same bits; the error against ``conv5_wgrad_kl_plain`` scaled by
the result's magnitude (fatal above 2e-2); ``conv3d_weight``; the
operation bound; the geometry; last the sums over one backward.
``--variant SRC.cu`` (any number) builds each candidate source of
``conv5_wgrad_tma.cu`` (same C interface: both launchers) with the same
flags and times it beside the built kernel at the shapes the two
tensor-copy routes take, with the same checks.

``--wgrad-stem``: builds ``conv5_stem_wgrad`` (printing registers and
spills), then at the stem's two main-path shapes (the cube's 2 x 128^3
and the flagship's 3 x 12 x 512 x 512, 1 -> 16 channels) holds
``stem_wgrad_tc_kernel`` to ``conv5_wgrad_kl_plain`` (scaled error, fatal
above 2e-2) and to a repeat, and prints its time and device time (graph
replays) beside ``wgrad_kernel`` forced (``old``, the kernel it
replaced), ``conv3d_weight``, the bound by bytes (x and g read once) and
the geometry. ``--variant SRC.cu`` builds each candidate of
``conv5_stem_wgrad.cu`` (same C interface) and times it beside the built
kernel with the same checks.

``--stem-f32``: builds ``conv5_stem_tf32`` and ``conv5_stem_wgrad_tf32``
(printing registers and spills), holds both split-TF32 stem kernels to
their plain versions on small views (rows of 13 and 12, a base 4 bytes
off, a channel slice, a halo'd H block, W over several tiles, Co 5), then
at the f32 stem's two shapes (the cube's 2 x 128^3 and the upstream spine
recipes' 3 x 512 x 512 x 12) prints each kernel's time and device time
(graph replays) beside the kernel it replaced forced (``old``:
``conv5_kernel``, ``wgrad_kernel``), cuDNN in strict f32 and with TF32 on,
the bound and the geometry; ``--variant`` candidates of either source.

``--ragged``: builds ``conv5_wgrad_tma`` and ``conv5_wgrad`` (registers
and spills), then holds the tensor-copy kernels' software producer (the
'ragged' / 'head_ragged' routes) on views a tensor copy cannot describe:
first small views (W = 9, 12, 4, 2 and 3, Co 20 and 3, a base 2 bytes
into an allocation, a channel slice, W over several tiles), then the
spine recipe's ragged weight gradients at batch 3 and the ragged shapes
of a 96^3 V-Net. Each against ``conv5_wgrad_kl_plain`` (scaled error,
fatal above 2e-2), a repeat and the tensor copy's route on the same
values padded to a W that is a multiple of 8 and cut back to W (fatal
unless bit for bit: the boxes are the same bytes); at the full-size
shapes the times of the route as routed (``routed``) and with 1, 2, 4
and 6 producer warps (``pw``),
``wgrad_mma_kernel`` forced (``old``), ``conv3d_weight``, the pad route
(the padded copies and the tensor-copy kernel, ``pad``; the kernel alone,
``pad_kernel``) and the bound.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from medicalseg_torch.ops import _build
from medicalseg_torch.ops import conv5 as c5

# (name, Ci, Co, edge, convs per forward)
CONVS = [("down_tr32", 32, 32, 64, 1), ("down_tr64", 64, 64, 32, 2),
         ("down_tr128", 128, 128, 16, 3), ("down_tr256", 256, 256, 8, 2),
         ("up_tr256", 256, 256, 16, 2), ("up_tr128", 128, 128, 32, 2),
         ("up_tr64", 64, 64, 64, 1), ("up_tr32", 32, 32, 128, 1),
         ("out_tr", 32, 3, 128, 1)]
BATCH = 2
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def time_ms(fn, reps=5):
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


def ptxas_lines(name, tag):
    """Build ``csrc/<name>.cu`` and print what ``-Xptxas -v`` says of each
    kernel whose name holds ``tag``: registers, spills."""
    log = _build.build([name])[name].with_suffix(".log")
    lines = log.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            print(line.split("'")[1][:60], *(
                l.strip() for l in lines[i + 1:i + 4] if "Compiling" not in l))
        elif "warning" in line.lower() or "(C75" in line:
            print(line[:200])


def build_variant(src, ref, names):
    """Compile a candidate source beside the built libraries; print its
    registers and spills; return the loaded library, its functions
    ``names`` typed as those of the built library ``ref``."""
    out = _build.BUILD_DIR / "variant-{}.so".format(Path(src).stem)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(k in line for k in ("registers", "spill", "error", "C75")):
            print(Path(src).name, line.strip()[:160])
    if proc.returncode:
        sys.exit("conv5_times: {} does not build".format(src))
    lib = ctypes.CDLL(str(out))
    for name in names:
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    return lib


def graph_ms(fn, calls=10):
    """Device time of one ``fn()``: ``calls`` calls captured into one CUDA
    graph, the median replay over ``calls``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay) / calls
    del graph
    return ms


def stem_main(variants):
    """The in_tr row: the bf16 stem's kernel, the kernel it replaced, its
    candidates and the library call, with the same checks."""
    ptxas_lines("conv5_stem", "stem")
    built = c5._conv5_stem_lib
    libs = [(Path(v).name, build_variant(v, built(),
                                         ("conv5_stem_tc_launch",)))
            for v in variants]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    e, co = 128, 16
    x = torch.randn((BATCH, e, 1, e, e), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn((5, 5, 5, 1, co), generator=gen, device=dev) / 125 ** 0.5
    b = torch.randn((co,), generator=gen, device=dev)
    ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
          torch.randn((co,), generator=gen, device=dev),
          torch.rand((co,), generator=gen, device=dev))
    xn = x.transpose(1, 2).contiguous()
    wo = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
    lib = time_ms(lambda: F.conv3d(xn, wo, b.to(torch.bfloat16), padding=2))
    bound = BATCH * e ** 3 * (1 + co) * 2 / PEAK_BYTES * 1e3
    for vname, vlib in [("built", None)] + libs:
        if vlib is not None:
            c5._conv5_stem_lib = lambda vlib=vlib: vlib
        try:
            for tag, e_ in (("plain", None), ("fused", ep)):
                def call(form=None):
                    return c5._conv5_cuda(x, w, b, "stem", e_, form=form)
                got, ref = call(), c5.conv5_kl_plain(x, w, b, e_)
                ok = torch.allclose(got.float(), ref.float(), atol=2e-2,
                                    rtol=2e-2)
                same = torch.equal(got, call())
                del got, ref
                ms, dev_ms = time_ms(call), graph_ms(call)
                old = time_ms(lambda: call("stem"))
                old_dev = graph_ms(lambda: call("stem"))
                print("in_tr      {} {} stem_tc {:.3f} dev {:.3f} conv5_kernel "
                      "{:.3f} dev {:.3f} library {:.3f} bound {:.4f} agrees {} "
                      "repeats {} geometry {}".format(
                          vname, tag, ms, dev_ms, old, old_dev, lib, bound,
                          ok, same, c5.conv5_stem_tc_geometry(
                              BATCH, e, e, e)), flush=True)
                if not (ok and same):
                    sys.exit("conv5_times: the stem disagrees with its plain "
                             "version or does not repeat")
        finally:
            c5._conv5_stem_lib = built


def wgrad_main(variants):
    print(torch.cuda.get_device_name(0))
    ptxas_lines("conv5_wgrad_tma", "tma")
    ptxas_lines("conv5_wgrad", "wgrad")
    built = c5._wgrad_tma_lib
    libs = [(Path(v).name, build_variant(
        v, built(), ("conv5_wgrad_tma_launch", "conv5_wgrad_head_tma_launch")))
        for v in variants]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = np.zeros(3)
    totals = {}  # variant: its sum over the square and wide convs
    for name, ci, co, e, count in CONVS + [("in_tr", 1, 16, 128, 1)]:
        kind = "stem" if ci == 1 else "head"
        x = torch.randn((BATCH, e, ci, e, e), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((BATCH, e, co, e, e), generator=gen,
                        device=dev).to(torch.bfloat16)
        form = c5.conv5_wgrad_form(x, g, kind)
        got = c5._conv5_wgrad_cuda(x, g, kind)
        same = torch.equal(got, c5._conv5_wgrad_cuda(x, g, kind))
        ref = c5.conv5_wgrad_kl_plain(x, g)
        err = ((got - ref).abs() / (ref.abs().max() + ref.abs())).max().item()
        del got, ref
        ms = time_ms(lambda: c5._conv5_wgrad_cuda(x, g, kind))
        # the kernel each tensor-copy route replaced, forced beside it
        old_form = {"tma": "mid", "head_tma": "head",
                    "stem_tc": "stem"}.get(form)
        old = (time_ms(lambda: c5._conv5_wgrad_cuda(x, g, kind, form=old_form))
               if old_form else ms)
        xn, gn = x.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.nn.grad.conv3d_weight(
            xn, (co, ci, 5, 5, 5), gn, padding=2))
        del xn, gn
        q = (c5.conv5_wgrad_tma_geometry(BATCH, e, e, e, ci, co)
             if form == "tma" else
             c5.conv5_wgrad_head_tma_geometry(BATCH, e, e, e, ci, co)
             if form == "head_tma" else
             c5.conv5_wgrad_stem_tc_geometry(BATCH, e, e, e)
             if form == "stem_tc" else
             c5.conv5_wgrad_mma_geometry(BATCH, e, e, e, ci, co)
             if kind == "head" else
             c5.conv5_wgrad_geometry(BATCH, e, e, e, ci, co, kind))
        flops = 2.0 * BATCH * e ** 3 * 125 * ci * co
        geo = {k: q[k] for k in ("th", "tw", "stages", "splits", "chan_blocks",
                                 "per", "blocks", "smem") if k in q}
        if form in ("tma", "head_tma"):
            totals["built", form] = totals.get(("built", form), 0.0) + \
                count * ms
        for vname, vlib in (libs if form in ("tma", "head_tma") else []):
            c5._wgrad_tma_lib = lambda vlib=vlib: vlib
            try:
                got = c5._conv5_wgrad_cuda(x, g, kind)
                ref = c5.conv5_wgrad_kl_plain(x, g)
                v_err = ((got - ref).abs() /
                         (ref.abs().max() + ref.abs())).max().item()
                v_same = torch.equal(got, c5._conv5_wgrad_cuda(x, g, kind))
                del got, ref
                v_ms = time_ms(lambda: c5._conv5_wgrad_cuda(x, g, kind))
            finally:
                c5._wgrad_tma_lib = built
            print("{:10s} variant {} wgrad {:.3f} scaled_err {:.2e} repeats "
                  "{}".format(name, vname, v_ms, v_err, v_same), flush=True)
            totals[vname, form] = totals.get((vname, form), 0.0) + \
                count * v_ms
        print("{:10s} route {} wgrad {:.3f} old {:.3f} conv3d_weight {:.3f} "
              "bound {:.4f} TF/s {:.0f} scaled_err {:.2e} repeats {} "
              "geometry {}".format(name, form, ms, old, lib,
                                   flops / PEAK_BF16 * 1e3, flops / ms / 1e9,
                                   err, same, geo), flush=True)
        total += count * np.array([ms, old, lib])
        if not (err <= 2e-2 and same):
            sys.exit("conv5_times: {} wgrad disagrees with its plain version "
                     "or does not repeat".format(name))
        del x, g
    print("per backward: wgrad {:.2f} old {:.2f} conv3d_weight {:.2f}".format(
        *total))
    for (vname, form), ms in totals.items():
        print("per backward, route {}: variant {} {:.2f}".format(
            form, vname, ms))


# The spine recipe's ragged weight gradients at batch 3 (configs/
# mri_spine_seg/vnet_mri_spine_seg_512_512_12_15k_tpu.yml: W runs 12 -> 9 ->
# 8 -> 4 -> 2; the two levels at W = 8 take the tensor copy) and the ragged
# shapes of a 96^3 V-Net: (name, [N, D, H, W], Ci, Co, convs a step)
RAGGED = [("down_tr32", (3, 256, 256, 9), 32, 32, 1),
          ("down_tr128", (3, 64, 64, 4), 128, 128, 3),
          ("down_tr256", (3, 32, 32, 2), 256, 256, 2),
          ("up_tr256", (3, 64, 64, 4), 256, 256, 2),
          ("up_tr64", (3, 256, 256, 9), 64, 64, 1),
          ("up_tr32", (3, 512, 512, 12), 32, 32, 1),
          ("out_tr", (3, 512, 512, 12), 32, 20, 1),
          ("down_tr128_96", (2, 12, 12, 12), 128, 128, 0),
          ("up_tr256_96", (2, 12, 12, 12), 256, 256, 0),
          ("down_tr256_96", (2, 6, 6, 6), 256, 256, 0),
          ("head3_w12", (2, 12, 12, 12), 32, 3, 0),
          ("head16_w12", (2, 12, 12, 12), 32, 16, 0)]


def padded(t):
    """``t`` copied into a buffer whose W is a multiple of 8 and cut back
    to W: a view a tensor copy can describe, the same values."""
    w = t.shape[4]
    buf = t.new_zeros(t.shape[:4] + (-(-w // 8) * 8,))
    buf[..., :w] = t
    return buf[..., :w]


def small_views(gen):
    """(name, x, g) views of the software producer's cases at small
    shapes."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    out = []
    for w, co in ((9, 20), (12, 40), (4, 32), (2, 24), (3, 17), (9, 3),
                  (12, 16), (4, 3), (100, 36), (100, 5)):
        out.append(("w{}_co{}".format(w, co), rnd(2, 5, 40, 7, w),
                    rnd(2, 5, co, 7, w)))
    flat = rnd(2 * 5 * 40 * 7 * 16 + 1)
    out.append(("odd_base", flat[1:].view(2, 5, 40, 7, 16),
                rnd(2, 5, 20, 7, 16)))
    flat3 = rnd(2 * 5 * 3 * 7 * 16 + 1)
    out.append(("odd_base_head", rnd(2, 5, 40, 7, 16),
                flat3[1:].view(2, 5, 3, 7, 16)))
    wide = rnd(2, 5, 48, 7, 12)
    out.append(("channel_slice", wide[:, :, 3:43], rnd(2, 5, 36, 7, 12)))
    out.append(("channel_slice_head", rnd(2, 5, 40, 7, 12),
                wide[:, :, 5:8]))
    return out


def ragged_check(name, x, g):
    """The routed ragged weight gradient against the plain version, a
    repeat and the tensor copy on the padded copies (bit for bit); fatal
    if any fails. Returns (form, scaled error)."""
    form = c5.conv5_wgrad_form(x, g, "head")
    if form not in ("ragged", "head_ragged"):
        sys.exit("conv5_times: {} routes to {}".format(name, form))
    got = c5._conv5_wgrad_cuda(x, g, "head")
    ref = c5.conv5_wgrad_kl_plain(x, g)
    err = ((got - ref).abs() / (ref.abs().max() + ref.abs())).max().item()
    same = torch.equal(got, c5._conv5_wgrad_cuda(x, g, "head"))
    xp, gp = padded(x), padded(g)
    pad_form = c5.conv5_wgrad_form(xp, gp, "head")
    as_tma = torch.equal(got, c5._conv5_wgrad_cuda(xp, gp, "head"))
    print("{:14s} {} {} scaled_err {:.2e} repeats {} = {} {}".format(
        name, tuple(x.shape), tuple(g.shape), err, same, pad_form, as_tma),
        flush=True)
    if not (err <= 2e-2 and same and as_tma and pad_form in (
            "tma", "head_tma")):
        sys.exit("conv5_times: {} ragged wgrad disagrees".format(name))
    return form, err


def ragged_main():
    print(torch.cuda.get_device_name(0))
    ptxas_lines("conv5_wgrad_tma", "tma")
    ptxas_lines("conv5_wgrad", "mma")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, x, g in small_views(gen):
        ragged_check(name, x, g)
    total = {}
    for name, (n, d, h, w), ci, co, count in RAGGED:
        x = torch.randn((n, d, ci, h, w), generator=gen,
                        device="cuda").to(torch.bfloat16)
        g = torch.randn((n, d, co, h, w), generator=gen,
                        device="cuda").to(torch.bfloat16)
        form, err = ragged_check(name, x, g)
        times = {}
        times["routed"] = time_ms(lambda: c5._conv5_wgrad_cuda(x, g, "head"))
        saved = c5._SOFT_WARPS, c5._SOFT_WARPS_REALIGNED
        for pw in (1, 2, 4, 6):
            c5._SOFT_WARPS = c5._SOFT_WARPS_REALIGNED = pw
            c5._wgrad_tma_geometry.cache_clear()
            c5._wgrad_head_tma_geometry.cache_clear()
            try:
                times["pw{}".format(pw)] = time_ms(
                    lambda: c5._conv5_wgrad_cuda(x, g, "head"))
            finally:
                c5._SOFT_WARPS, c5._SOFT_WARPS_REALIGNED = saved
                c5._wgrad_tma_geometry.cache_clear()
                c5._wgrad_head_tma_geometry.cache_clear()
        old = "mid" if co > 16 else "head"
        times["old"] = time_ms(lambda: c5._conv5_wgrad_cuda(
            x, g, "head", form=old))
        xn, gn = x.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        times["conv3d_weight"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
            xn, (co, ci, 5, 5, 5), gn, padding=2))
        del xn, gn
        times["pad"] = time_ms(lambda: c5._conv5_wgrad_cuda(
            padded(x), padded(g), "head"))
        xp, gp = padded(x), padded(g)
        times["pad_kernel"] = time_ms(lambda: c5._conv5_wgrad_cuda(
            xp, gp, "head"))
        del xp, gp
        flops = 2.0 * n * d * h * w * 125 * ci * co
        q = (c5.conv5_wgrad_tma_geometry if form == "ragged" else
             c5.conv5_wgrad_head_tma_geometry)(n, d, h, w, ci, co)
        print("{:14s} route {} {} bound {:.4f} vec {} {} geometry {}".format(
            name, form, " ".join("{} {:.3f}".format(k, v)
                                 for k, v in times.items()),
            flops / PEAK_BF16 * 1e3, c5.soft_vec(x), c5.soft_vec(g),
            {k: q[k] for k in ("th", "tw", "stages", "splits", "chan_blocks",
                               "xspan", "gspan")}), flush=True)
        for k, v in times.items():
            total[k] = total.get(k, 0.0) + count * v
        del x, g
    print("per spine step: " + " ".join("{} {:.2f}".format(k, v)
                                        for k, v in total.items()))


def wgrad_stem_main(variants):
    """The stem's weight gradient at its cube and flagship shapes: the
    built kernel and its candidates beside the kernel it replaced and the
    library call, with the same checks."""
    print(torch.cuda.get_device_name(0))
    ptxas_lines("conv5_stem_wgrad", "stem_wgrad")
    built = c5._stem_wgrad_lib
    libs = [(Path(v).name, build_variant(v, built(),
                                         ("conv5_stem_wgrad_tc_launch",)))
            for v in variants]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, (n, d, h, w) in (("cube", (BATCH, 128, 128, 128)),
                               ("flagship", (3, 12, 512, 512))):
        x = torch.randn((n, d, 1, h, w), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((n, d, 16, h, w), generator=gen,
                        device=dev).to(torch.bfloat16)
        ref = c5.conv5_wgrad_kl_plain(x, g)

        def call(form=None):
            return c5._conv5_wgrad_cuda(x, g, "stem", form=form)

        old, old_dev = time_ms(lambda: call("stem")), graph_ms(
            lambda: call("stem"))
        xn, gn = x.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.nn.grad.conv3d_weight(
            xn, (16, 1, 5, 5, 5), gn, padding=2))
        del xn, gn
        bound = n * d * h * w * 17 * 2 / PEAK_BYTES * 1e3
        for vname, vlib in [("built", None)] + libs:
            if vlib is not None:
                c5._stem_wgrad_lib = lambda vlib=vlib: vlib
            try:
                got = call().to(torch.bfloat16).float()
                err = ((got - ref).abs() /
                       (ref.abs().max() + ref.abs())).max().item()
                same = torch.equal(call(), call())
                ms, dev_ms = time_ms(call), graph_ms(call)
            finally:
                c5._stem_wgrad_lib = built
            print("in_tr {:8s} {} stem_wgrad_tc {:.3f} dev {:.3f} "
                  "wgrad_kernel {:.3f} dev {:.3f} conv3d_weight {:.3f} bound "
                  "{:.4f} scaled_err {:.2e} repeats {} geometry {}".format(
                      name, vname, ms, dev_ms, old, old_dev, lib, bound, err,
                      same, c5.conv5_wgrad_stem_tc_geometry(n, d, h, w)),
                  flush=True)
            if not (err <= 2e-2 and same):
                sys.exit("conv5_times: the stem's weight gradient disagrees "
                         "with its plain version or does not repeat")
        del x, g, ref


# the f32 stem (1 -> 16) at its two main-path shapes: the upstream lung
# recipe's cube and the upstream spine recipes' [N, D, 1, H, W]
STEM_F32 = [("cube", (BATCH, 128, 128, 128)), ("spine", (3, 512, 512, 12))]
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s


def stem_f32_views(gen):
    """(name, x, g) small f32 stem views the kernels must take: rows of 13
    and 12, a base 4 bytes into an allocation (x and g), a channel slice,
    an H block behind a 2-row halo, W over several tiles, Co < 16."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = [("w13", rnd(2, 7, 1, 9, 13), rnd(2, 7, 16, 9, 13)),
           ("w12_rows", rnd(1, 6, 1, 50, 12), rnd(1, 6, 16, 50, 12)),
           ("w200", rnd(1, 5, 1, 11, 200), rnd(1, 5, 16, 11, 200)),
           ("co5", rnd(1, 6, 1, 10, 40), rnd(1, 6, 5, 10, 40))]
    fx, fg = rnd(1 * 6 * 10 * 24 + 1), rnd(6 * 16 * 10 * 24 + 1)
    out.append(("odd_base", fx[1:].view(1, 6, 1, 10, 24),
                fg[1:].view(1, 6, 16, 10, 24)))
    out.append(("channel_slice", rnd(1, 6, 3, 10, 24)[:, :, 1:2],
                rnd(1, 6, 20, 10, 24)[:, :, 2:18]))
    x = rnd(2, 9, 1, 16, 32)
    out.append(("halo_h", F.pad(x, (0, 0, 2, 2)), rnd(2, 9, 16, 20, 32)))
    return out


def stem_f32_main(variants):
    """The f32 stem's forward (unfused and fused) and weight gradient: the
    routed kernels (``stem_tf32_kernel``, ``stem_wgrad_tf32_kernel``) and
    the kernels forced by ``form='stem'`` (``old``: ``conv5_kernel``,
    ``wgrad_kernel``). First the small views of :func:`stem_f32_views`
    against the plain versions; then at :data:`STEM_F32` host-timed and on
    the device (``dev``: ten calls replayed from one CUDA graph), held to
    the plain version (atol = rtol = 1e-4; dW scaled by its magnitude) and
    to a repeat, beside ``F.conv3d`` / ``conv3d_weight`` in strict f32 and
    with TF32 on, and the bound (three TF32 passes at 495 TF/s, or the
    bytes). A ``--variant`` whose file name holds ``wgrad`` is a candidate
    of ``conv5_stem_wgrad_tf32.cu``, any other of ``conv5_stem_tf32.cu``."""
    print(torch.cuda.get_device_name(0))
    ptxas_lines("conv5_stem_tf32", "stem_tf32")
    ptxas_lines("conv5_stem_wgrad_tf32", "stem_wgrad_tf32")
    built = {"fwd": c5._stem_tf32_lib, "wgrad": c5._stem_wgrad_tf32_lib}
    fns = {"fwd": "conv5_stem_tf32_launch",
           "wgrad": "conv5_stem_wgrad_tf32_launch"}
    libs = []
    for v in variants:
        which = "wgrad" if "wgrad" in Path(v).name else "fwd"
        libs.append((Path(v).name, which,
                     build_variant(v, built[which](), (fns[which],))))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, x, g in stem_f32_views(gen):
        co = g.shape[2]
        k = torch.randn((5, 5, 5, 1, co), generator=gen,
                        device=dev) / 125 ** .5
        b = torch.randn((co,), generator=gen, device=dev)
        got, ref = c5.conv5_kl_fused(x, k, b, (b.abs(), b, b.abs()), "stem"), \
            c5.conv5_kl_plain(x, k, b, (b.abs(), b, b.abs()))
        ok = torch.allclose(got, ref, atol=1e-4, rtol=1e-4)
        w_ok = True
        if g.shape[3] == x.shape[3]:
            dw, dref = c5._conv5_wgrad_cuda(x, g, "stem"), \
                c5.conv5_wgrad_kl_plain(x, g)
            w_ok = ((dw - dref).abs() / (dref.abs().max() + dref.abs())
                    ).max().item() <= 1e-4
        print("view {:14s} {} {} forms {} {} agrees {} {}".format(
            name, tuple(x.shape), x.stride(), c5.conv5_form(x, co, "stem"),
            c5.conv5_wgrad_form(x, g, "stem"), ok, w_ok), flush=True)
        if not (ok and w_ok):
            sys.exit("conv5_times: the f32 stem disagrees at " + name)
    for name, (n, d, h, w) in STEM_F32:
        co = 16
        x = torch.randn((n, d, 1, h, w), generator=gen, device=dev)
        g = torch.randn((n, d, co, h, w), generator=gen, device=dev)
        k = torch.randn((5, 5, 5, 1, co), generator=gen,
                        device=dev) / 125 ** .5
        b = torch.randn((co,), generator=gen, device=dev)
        ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
              torch.randn((co,), generator=gen, device=dev),
              torch.rand((co,), generator=gen, device=dev))
        vox = n * d * h * w
        flops = 2.0 * vox * 125 * co
        bound = max(3 * flops / PEAK_TF32,
                    vox * (1 + co) * 4 / PEAK_BYTES) * 1e3
        xn, gn = x.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        ko = k.permute(4, 3, 0, 1, 2).contiguous()

        def lib_tf32(fn):
            torch.backends.cudnn.allow_tf32 = True
            try:
                return time_ms(fn)
            finally:
                torch.backends.cudnn.allow_tf32 = False

        def check_fwd(call, e_, what):
            got, ref = call(), c5.conv5_kl_plain(x, k, b, e_)
            err = (got - ref).abs().max().item()
            ok = torch.allclose(got, ref, atol=1e-4, rtol=1e-4)
            same = torch.equal(got, call())
            if not (ok and same):
                sys.exit("conv5_times: {} disagrees with its plain version "
                         "({:.2e}) or does not repeat".format(what, err))
            return err

        for tag, e_ in (("fwd", None), ("fused", ep)):
            def call(form=None, e_=e_):
                return c5._conv5_cuda(x, k, b, "stem", e_, form=form)

            err = check_fwd(call, e_, "the f32 stem")
            lib = (lambda: F.conv3d(xn, ko, b, padding=2))
            print("{:6s} {:5s} route {} {:.3f} dev {:.3f} old {:.3f} dev "
                  "{:.3f} conv3d {:.3f} tf32 {:.3f} bound {:.4f} max_abs_err "
                  "{:.2e} repeats True geometry {}".format(
                      name, tag, c5.conv5_form(x, co, "stem"), time_ms(call),
                      graph_ms(call), time_ms(lambda: call("stem")),
                      graph_ms(lambda: call("stem")), time_ms(lib),
                      lib_tf32(lib), bound, err,
                      c5.conv5_stem_tf32_geometry(n, d, h, w)), flush=True)
            for vname, which, vlib in libs:
                if which != "fwd":
                    continue
                c5._stem_tf32_lib = lambda vlib=vlib: vlib
                try:
                    err = check_fwd(call, e_, vname)
                    print("{:6s} {:5s} variant {} {:.3f} dev {:.3f} "
                          "max_abs_err {:.2e}".format(
                              name, tag, vname, time_ms(call), graph_ms(call),
                              err), flush=True)
                finally:
                    c5._stem_tf32_lib = built["fwd"]

        def wcall(form=None):
            return c5._conv5_wgrad_cuda(x, g, "stem", form=form)

        ref = c5.conv5_wgrad_kl_plain(x, g)

        def check_w(what):
            got = wcall()
            err = ((got - ref).abs() / (ref.abs().max() + ref.abs())).max(
                ).item()
            if not (err <= 1e-4 and torch.equal(got, wcall())):
                sys.exit("conv5_times: {} disagrees with its plain version "
                         "({:.2e}) or does not repeat".format(what, err))
            return err

        err = check_w("the f32 stem's weight gradient")
        lib = (lambda: torch.nn.grad.conv3d_weight(xn, (co, 1, 5, 5, 5), gn,
                                                   padding=2))
        print("{:6s} wgrad route {} {:.3f} dev {:.3f} old {:.3f} dev {:.3f} "
              "conv3d_weight {:.3f} tf32 {:.3f} bound {:.4f} scaled_err "
              "{:.2e} repeats True geometry {}".format(
                  name, c5.conv5_wgrad_form(x, g, "stem"), time_ms(wcall),
                  graph_ms(wcall), time_ms(lambda: wcall("stem")),
                  graph_ms(lambda: wcall("stem")), time_ms(lib),
                  lib_tf32(lib), bound, err,
                  c5.conv5_wgrad_stem_tf32_geometry(n, d, h, w)), flush=True)
        for vname, which, vlib in libs:
            if which != "wgrad":
                continue
            c5._stem_wgrad_tf32_lib = lambda vlib=vlib: vlib
            try:
                err = check_w(vname)
                print("{:6s} wgrad variant {} {:.3f} dev {:.3f} scaled_err "
                      "{:.2e}".format(name, vname, time_ms(wcall),
                                      graph_ms(wcall), err), flush=True)
            finally:
                c5._stem_wgrad_tf32_lib = built["wgrad"]
        del x, g, xn, gn, ref


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--wgrad", action="store_true",
                        help="time the weight gradients instead")
    parser.add_argument("--wgrad-stem", action="store_true",
                        help="time the stem's weight gradient instead")
    parser.add_argument("--ragged", action="store_true",
                        help="time the software producer of the tensor-copy "
                        "weight gradients on ragged views instead")
    parser.add_argument("--stem-f32", action="store_true",
                        help="time the f32 stem, forward and weight "
                        "gradient, instead")
    parser.add_argument("--variant", action="append", default=[],
                        help="a candidate conv5_stem.cu (with --wgrad: "
                        "conv5_wgrad_tma.cu, with --wgrad-stem: "
                        "conv5_stem_wgrad.cu, with --stem-f32: "
                        "conv5_stem_tf32.cu, or conv5_stem_wgrad_tf32.cu "
                        "where its name holds 'wgrad') to time beside the "
                        "built one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("conv5_times: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.wgrad:
        return wgrad_main(args.variant)
    if args.wgrad_stem:
        return wgrad_stem_main(args.variant)
    if args.ragged:
        return ragged_main()
    if args.stem_f32:
        return stem_f32_main(args.variant)
    print(torch.cuda.get_device_name(0))
    log = _build.build(["conv5_wg"])["conv5_wg"].with_suffix(".log")
    lines = log.read_text().splitlines()
    for i, line in enumerate(lines):
        if "(C7" in line:
            print(line[:200])
        if "Compiling entry function" in line and "conv5_wg_kernelILi" in line:
            print("NT=" + line.split("conv5_wg_kernelILi")[1].split("E")[0],
                  lines[i + 2].strip(), lines[i + 3].strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = np.zeros(4)
    for name, ci, co, e, count in CONVS:
        x = torch.randn((BATCH, e, ci, e, e), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((BATCH, e, co, e, e), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device=dev) / (125 * ci) ** 0.5
        b = torch.randn((co,), generator=gen, device=dev)
        ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
              torch.randn((co,), generator=gen, device=dev),
              torch.rand((co,), generator=gen, device=dev))
        got, dx = c5.conv5_kl_fused(x, w, b, ep), c5.conv5_dgrad_kl(g, w)
        ok = (torch.allclose(got.float(), c5.conv5_kl_plain(
                  x, w, b, ep).float(), atol=2e-2, rtol=2e-2) and
              torch.allclose(dx.float(), c5.conv5_dgrad_kl_plain(
                  g, w).float(), atol=2e-2, rtol=2e-2))
        same = (torch.equal(got, c5.conv5_kl_fused(x, w, b, ep)) and
                torch.equal(dx, c5.conv5_dgrad_kl(g, w)))
        del got, dx
        ms = time_ms(lambda: c5.conv5_kl_fused(x, w, b, ep))
        ms_d = time_ms(lambda: c5.conv5_dgrad_kl(g, w))
        xn, gn = x.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        wo = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        b16 = b.to(torch.bfloat16)
        lib = time_ms(lambda: F.conv3d(xn, wo, b16, padding=2))
        lib_d = time_ms(lambda: torch.nn.grad.conv3d_input(
            xn.shape, wo, gn, padding=2))
        q = c5.conv5_wg_geometry(BATCH, e, e, e, ci, co)
        flops = 2.0 * BATCH * e ** 3 * 125 * ci * co
        print("{:10s} fwd {:.3f} dgrad {:.3f} library {:.3f} {:.3f} bound "
              "{:.3f} TF/s {:.0f} tile {} nt {} splits {} agrees {} "
              "repeats {}".format(
                  name, ms, ms_d, lib, lib_d, flops / PEAK_BF16 * 1e3,
                  flops / ms / 1e9, (q["td"], q["th"], q["tw"]), q["nt"],
                  q["splits"], ok, same), flush=True)
        total += count * np.array([ms, ms_d, lib, lib_d])
        if not (ok and same):
            sys.exit("conv5_times: {} disagrees with its plain version or "
                     "does not repeat".format(name))
    print("per forward / backward: fwd {:.2f} dgrad {:.2f} library {:.2f} "
          "{:.2f}".format(*total))
    stem_main(args.variant)


if __name__ == "__main__":
    main()
