# Copyright 2026. Apache License 2.0.
"""5^3 SAME convolutions (stride 1) and the layout pin, through the
hand-written CUDA kernels of ``csrc/conv5.cu`` and ``csrc/pin.cu``.

Counterpart of ``medicalseg_tpu/ops/pallas_conv5.py``, forward and
backward. The public functions keep the JAX package's layouts at their
boundary:

* :func:`conv5`: x NDHWC [N, D, H, W, Ci], w [5, 5, 5, Ci, Co], b [Co].
* :func:`conv5_kl`, :func:`conv5_kl_fused`: x in the kernel layout
  [N, D, Ci, H, W] (the port's internal layout), same w and b.
* :func:`conv5_dgrad_kl`, :func:`conv5_wgrad_kl`: the two halves of
  :func:`conv5_kl`'s backward, in the same layout.
* :func:`ep_apply_kl`, :func:`to_kl`, :func:`from_kl`, :func:`pin_kl`.

:func:`conv5_kl` and :func:`pin_kl` are ``torch.autograd.Function``s on
the CPU and on the card alike (the JAX ``_conv5_kl_bwd`` / ``_pin_bwd``):
dx is the same conv of the cotangent with the flipped, io-transposed
weight through the forward kernel, dw comes from the weight-gradient
kernels of ``csrc/conv5_wgrad.cu``, db is a plain f32 sum.
:func:`conv5_kl_fused` is inference-only.

One wrapper covers every 5^3 conv of V-Net: Ci from 1 to 256, Co from 1
to 256, in bfloat16 or float32, with f32 accumulation and a single cast of
the result. bf16 head convs run on the tensor cores
(``conv5_mma_kernel``); f32 convs and the ``kind="stem"`` (Ci = 1) form
run on the CUDA cores (``conv5_kernel``). No shape gate: the TPU's lane and
VMEM eligibility rules do not apply here.

Every wrapper has a plain PyTorch version beside it (``*_plain``). A
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it
launches its kernel or raises. :data:`LAUNCHES` counts the launches of
each kernel.
"""

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build

K = 5  # kernel edge
P = K // 2  # halo

# Launches of each kernel since the last reset_launches(). A forward conv
# launch counts under "conv5_head" or "conv5_stem" by its form, and also
# under "conv5_fused_epilogue" when it applies the BN + PReLU epilogue; the
# same kernel launched for a backward counts under "conv5_dgrad" only. A
# weight gradient counts under its form: "stem" (Ci = 1), "head" (Co <= 16)
# or "mid" (every wider conv, square or not).
LAUNCHES = {"conv5_head": 0, "conv5_stem": 0, "conv5_fused_epilogue": 0,
            "pin": 0, "conv5_dgrad": 0, "conv5_wgrad_stem": 0,
            "conv5_wgrad_head": 0, "conv5_wgrad_mid": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MIN_BLOCKS = 1056  # 8 blocks per SM of an H100 before tiles shrink
_WGRAD_BLOCKS = 528  # wgrad: voxel splits until the grid has 4 blocks per SM
_WGRAD_SMEM = 100 * 1024  # wgrad: shared memory of a block (2 blocks per SM)
_WGRAD_THREADS = 384  # wgrad: the kernel's __launch_bounds__


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ----------------------------------------------------------------------
# layouts
# ----------------------------------------------------------------------
def to_kl(x):
    """NDHWC -> kernel layout [N, D, C, H, W] (a view)."""
    return x.permute(0, 1, 4, 2, 3)


def from_kl(xk):
    """Kernel layout [N, D, C, H, W] -> NDHWC (a view)."""
    return xk.permute(0, 1, 3, 4, 2)


# ----------------------------------------------------------------------
# plain versions (the CPU path, and the reference on the card)
# ----------------------------------------------------------------------
def ep_apply_kl(yk, ep):
    """Reference epilogue on a kernel-layout tensor: PReLU_alpha(y * inv +
    shift) in f32, cast back to y's dtype. ``ep`` = (inv, shift, alpha),
    each [C]."""
    inv, shift, alpha = (torch.as_tensor(v, dtype=torch.float32,
                                         device=yk.device).reshape(
                                             1, 1, -1, 1, 1) for v in ep)
    f = yk.float() * inv + shift
    return torch.where(f >= 0, f, f * alpha).to(yk.dtype)


def conv5_kl_plain(xk, w, b, ep=None):
    """Plain PyTorch 5^3 SAME conv in kernel layout, with the kernel's
    numerics: operands rounded to x's dtype, products summed in f32 (one
    matmul per tap), bias and the optional epilogue applied in f32, one
    cast of the result."""
    n, d, ci, h, ww = xk.shape
    co = w.shape[-1]
    xf = F.pad(xk.float(), (P, P, P, P, 0, 0, P, P))  # W, H, C, D
    wf = w.to(xk.dtype).float()
    out = xk.new_zeros((n, d, h, ww, co), dtype=torch.float32)
    for kd in range(K):
        for kh in range(K):
            for kw in range(K):
                tap = xf[:, kd:kd + d, :, kh:kh + h, kw:kw + ww]
                out += torch.matmul(tap.permute(0, 1, 3, 4, 2), wf[kd, kh, kw])
    out = out.permute(0, 1, 4, 2, 3) + b.float().reshape(1, 1, -1, 1, 1)
    if ep is not None:
        inv, shift, alpha = (v.float().reshape(1, 1, -1, 1, 1) for v in ep)
        out = out * inv + shift
        out = torch.where(out >= 0, out, out * alpha)
    return out.to(xk.dtype).contiguous()


def conv5_dgrad_kl_plain(gk, w):
    """Plain PyTorch input gradient of the 5^3 SAME conv in kernel layout:
    dx[v] = sum over taps of g[v - tap] . w[tap]^T, i.e. the conv of ``gk``
    [N, D, Co, H, W] with the spatially flipped, io-transposed weight and
    no bias. Numerics of the kernel: operands rounded to g's dtype, f32
    sums, one cast to g's dtype."""
    n, d, co, h, ww = gk.shape
    ci = w.shape[3]
    gf = F.pad(gk.float(), (P, P, P, P, 0, 0, P, P))  # W, H, C, D
    wf = w.to(gk.dtype).float()
    out = gk.new_zeros((n, d, h, ww, ci), dtype=torch.float32)
    for kd in range(K):
        for kh in range(K):
            for kw in range(K):
                tap = gf[:, K - 1 - kd:K - 1 - kd + d, :,
                         K - 1 - kh:K - 1 - kh + h,
                         K - 1 - kw:K - 1 - kw + ww]
                out += torch.matmul(tap.permute(0, 1, 3, 4, 2),
                                    wf[kd, kh, kw].t())
    return out.permute(0, 1, 4, 2, 3).to(gk.dtype).contiguous()


def conv5_wgrad_kl_plain(xk, gk):
    """Plain PyTorch weight gradient of the 5^3 SAME conv in kernel layout:
    dW[kd, kh, kw, ci, co] = sum over voxels of x[v + tap] * g[v], one
    contraction per tap. Numerics of the kernel: operands in x's dtype,
    f32 products and sums, and the f32 result rounded to x's dtype and
    back (see :func:`conv5_wgrad_kl`). Returns f32 [5, 5, 5, Ci, Co]."""
    n, d, ci, h, ww = xk.shape
    co = gk.shape[2]
    xf = F.pad(xk.float(), (P, P, P, P, 0, 0, P, P))  # W, H, C, D
    gf = gk.to(xk.dtype).float().permute(2, 0, 1, 3, 4).reshape(co, -1)
    dw = xk.new_zeros((K, K, K, ci, co), dtype=torch.float32)
    for kd in range(K):
        for kh in range(K):
            for kw in range(K):
                tap = xf[:, kd:kd + d, :, kh:kh + h, kw:kw + ww]
                dw[kd, kh, kw] = torch.matmul(
                    tap.permute(2, 0, 1, 3, 4).reshape(ci, -1), gf.t())
    return dw.to(xk.dtype).float()


def pin_kl_plain(xk):
    return xk.contiguous()


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _conv5_lib():
    lib = _build.library("conv5")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_launch.argtypes = [vp] * 5 + [i] * 11 + [ll] * 8 + [vp]
    lib.conv5_mma_launch.argtypes = [vp] * 5 + [i] * 10 + [ll] * 8 + [vp]
    lib.conv5_launch.restype = lib.conv5_mma_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_lib():
    lib = _build.library("conv5_wgrad")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_wgrad_launch.argtypes = [vp] * 4 + [i] * 17 + [ll] * 8 + [vp]
    lib.conv5_wgrad_mma_launch.argtypes = ([vp] * 4 + [i] * 12 + [ll] * 8 +
                                           [vp])
    lib.conv5_wgrad_launch.restype = ctypes.c_int
    lib.conv5_wgrad_mma_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _pin_lib():
    lib = _build.library("pin")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pin_launch.argtypes = [vp, vp] + [i] * 6 + [ll] * 5 + [vp]
    lib.pin_launch.restype = ctypes.c_int
    return lib


def _pow2ceil(v):
    return 1 << max(0, (int(v) - 1).bit_length())


def conv5_geometry(n, d, h, w, co):
    """Launch geometry of the conv kernel: (th, tw, cot) = output rows and
    columns per block (2 rows per thread, at most 128 threads) and the
    output-channel tile. The channel tile shrinks from 32 toward 4 until
    the grid has enough blocks to fill the card."""
    tw = min(32, _pow2ceil(w))
    th = min(256 // tw, max(2, _pow2ceil(h)))
    cot = min(32, max(4, _pow2ceil(co)))
    tiles = -(-h // th) * -(-w // tw)
    while cot > 4 and tiles * d * n * -(-co // cot) < _MIN_BLOCKS:
        cot //= 2
    return th, tw, cot


def conv5_mma_geometry(n, d, h, w, co):
    """Launch geometry of the bf16 tensor-core head kernel: (mf, nf, th,
    tw) = m16 and n8 fragments per warp (4 warps) and the th x tw output
    tile of 64 * mf voxels. Fragments shrink for small planes and grids."""
    tw = min(32, _pow2ceil(w))
    mf = 4
    while mf > 1 and 64 * mf // tw > _pow2ceil(h):
        mf //= 2
    th = 64 * mf // tw
    nf = 4 if co > 16 else 2
    tiles = -(-h // th) * -(-w // tw)
    if nf == 4 and tiles * d * n * -(-co // 32) < _MIN_BLOCKS:
        nf = 2
    return mf, nf, th, tw


def _pack_weights_mma(w, nf):
    """[5, 5, 5, Ci, Co] -> bf16 [Co/tn, Ci/16, 5, 25, tn, 16] (tn = 8 *
    nf), zero-padded in Ci and Co: per (channel tile, 16-channel chunk,
    depth tap) the kernel copies one contiguous block."""
    ci, co = w.shape[3], w.shape[4]
    tn = 8 * nf
    tiles, chunks = -(-co // tn), -(-ci // 16)
    wb = F.pad(w.to(torch.bfloat16), (0, tiles * tn - co, 0, chunks * 16 - ci))
    return wb.reshape(K, K * K, chunks, 16, tiles, tn).permute(
        4, 2, 0, 1, 5, 3).contiguous()


def _pack_weights(w, dtype, cot):
    """[5, 5, 5, Ci, Co] -> f32 [Co/cot, 125, Ci, cot], rounded to the
    activation dtype first (the JAX layer casts its kernel the same way);
    padded output channels are zero."""
    ci, co = w.shape[3], w.shape[4]
    tiles = -(-co // cot)
    wf = F.pad(w.to(dtype).float(), (0, tiles * cot - co))
    return wf.reshape(K * K * K, ci, tiles, cot).permute(
        2, 0, 1, 3).contiguous()


def _check_conv(xk, w, b, kind, ep):
    if xk.dim() != 5:
        raise ValueError("expected [N, D, C, H, W], got {}".format(
            tuple(xk.shape)))
    ci = xk.shape[2]
    if tuple(w.shape[:4]) != (K, K, K, ci) or w.dim() != 5:
        raise ValueError("weight {} does not match [5, 5, 5, {}, Co]".format(
            tuple(w.shape), ci))
    co = w.shape[4]
    if tuple(b.shape) != (co,):
        raise ValueError("bias {} does not match Co={}".format(
            tuple(b.shape), co))
    if ep is not None and (len(ep) != 3 or any(
            tuple(v.shape) != (co,) for v in ep)):
        raise ValueError("epilogue must be (inv, shift, alpha), each [Co]")
    if kind not in ("head", "stem"):
        raise ValueError("kind must be 'head' or 'stem', got " + repr(kind))
    if kind == "stem" and ci != 1:
        raise ValueError("the stem form takes Ci=1, got Ci={}".format(ci))
    if xk.dtype not in _DTYPES:
        raise TypeError("conv5 takes float32 or bfloat16, got {}".format(
            xk.dtype))


def _conv5_cuda(xk, w, b, kind, ep, count=None):
    """Launch the forward kernel. ``count`` names the :data:`LAUNCHES`
    entry of a launch made for something else than a forward conv (the
    dgrad); by default the launch counts under its form."""
    if xk.device.type != "cuda":
        raise RuntimeError("conv5 kernel needs a CUDA tensor, got device "
                           + str(xk.device))
    for t in (w, b) + tuple(ep or ()):
        if t.device != xk.device:
            raise RuntimeError("conv5 operands on {} and {}".format(
                xk.device, t.device))
    if xk.stride(4) != 1:
        raise ValueError("conv5 kernel needs W as the contiguous axis; "
                         "pin_kl the input first")
    n, d, ci, h, ww = xk.shape
    co = w.shape[4]
    # bf16 head convs run on the tensor cores; f32 (exact f32 sums) and
    # the Ci = 1 stem on the CUDA cores
    if xk.dtype == torch.bfloat16 and kind == "head":
        mf, nf, th, tw = conv5_mma_geometry(n, d, h, ww, co)
        tiles = -(-co // (8 * nf))
        wpk = _pack_weights_mma(w, nf)
        fn, cfg = _conv5_lib().conv5_mma_launch, (mf, nf, th, tw)
    else:
        th, tw, cot = conv5_geometry(n, d, h, ww, co)
        tiles = -(-co // cot)
        wpk = _pack_weights(w, xk.dtype, cot)
        fn = _conv5_lib().conv5_launch
        cfg = (_DTYPES[xk.dtype], int(kind == "stem"), cot, th, tw)
    if d > 65535 or n * tiles > 65535:
        raise ValueError("conv5 grid too large for {}".format(
            tuple(xk.shape)))
    bias = b.float().contiguous()
    epk = (None if ep is None else
           torch.cat([v.float().reshape(-1) for v in ep]).contiguous())
    y = torch.empty((n, d, co, h, ww), dtype=xk.dtype, device=xk.device)
    xs, ys = xk.stride(), y.stride()
    with torch.cuda.device(xk.device):
        rc = fn(xk.data_ptr(), wpk.data_ptr(), bias.data_ptr(),
                None if epk is None else epk.data_ptr(), y.data_ptr(),
                *cfg, n, d, ci, h, ww, co,
                xs[0], xs[2], xs[1], xs[3], ys[0], ys[2], ys[1], ys[3],
                torch.cuda.current_stream(xk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv5 kernel launch failed: CUDA error {}".format(
            rc))
    LAUNCHES[count or "conv5_" + kind] += 1
    if ep is not None:
        LAUNCHES["conv5_fused_epilogue"] += 1
    return y


def _conv5_forward(xk, w, b, kind):
    if xk.device.type == "cpu":
        return conv5_kl_plain(xk, w, b)
    return _conv5_cuda(xk, w, b, kind, None)


def conv5_dgrad_kl(gk, w):
    """Input gradient of :func:`conv5_kl`: ``gk`` [N, D, Co, H, W] (W
    contiguous) and the forward weight ``w`` [5, 5, 5, Ci, Co] ->
    [N, D, Ci, H, W] in g's dtype. On the card it is the forward kernel
    (head form) on the spatially flipped, io-transposed weight with zero
    bias, counted under ``conv5_dgrad``."""
    if gk.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (K, K, K) \
            or w.shape[4] != gk.shape[2]:
        raise ValueError("dgrad of g {} with weight {}".format(
            tuple(gk.shape), tuple(w.shape)))
    if gk.dtype not in _DTYPES:
        raise TypeError("conv5 takes float32 or bfloat16, got {}".format(
            gk.dtype))
    if gk.device.type == "cpu":
        return conv5_dgrad_kl_plain(gk, w)
    wflip = w.flip(0, 1, 2).transpose(3, 4)
    zero = torch.zeros((w.shape[3],), dtype=torch.float32, device=gk.device)
    return _conv5_cuda(gk, wflip, zero, "head", None, count="conv5_dgrad")


def conv5_wgrad_geometry(n, d, h, w, ci, co, kind):
    """Launch geometry of the weight-gradient kernel, a dict:

    * ``form``: 'stem' (``kind='stem'``, Ci = 1), 'head' (Co <= 16) or
      'mid' (everything wider), the :data:`LAUNCHES` entry;
    * ``ci_t``: input channels per thread (1 for the stem, else 4), and
      ``cig`` / ``cog``: thread groups over Ci (``ci_t`` each) and Co (4
      each), so a block owns a [ci_t * cig, 4 * cog] tile of every tap;
    * ``kdn``: depth taps per block, 5 for the stem (g is its wide
      operand and is staged once for all five) and 1 otherwise (the grid
      carries kd);
    * ``vs``: voxel groups inside a block (a power of two), which fill the
      block's threads where the channel tile is small; each writes its
      own partial dW;
    * ``th``, ``tw``: the voxel tile of one staging step, shrunk until the
      block's shared memory fits twice on an SM;
    * ``cis``, ``cos``: shared-memory channel strides, padded to an odd
      number of 16-byte vectors (conflict-free vector stores);
    * ``splits``: blocks along the voxel axis, enough to put about four
      blocks on every SM, each with at least one voxel tile."""
    if kind == "stem":
        form, ci_t, cig, kdn = "stem", 1, 1, K
    else:
        form = "head" if co <= 16 else "mid"
        ci_t, cig, kdn = 4, min(8, -(-ci // 4)), 1
    cog = min(8, -(-co // 4))
    tw = max(4, min(32, _pow2ceil(w)))
    th = min(8, _pow2ceil(h))
    cis = 1 if ci_t == 1 else 4 * (cig + 1 - cig % 2)
    cos = 4 * (cog + 1 - cog % 2)

    def smem(th, tw):
        return 4 * ((kdn * (th + 2 * P) * (tw + 2 * P) * cis + 3) // 4 * 4
                    + th * tw * cos)

    while smem(th, tw) > _WGRAD_SMEM and (tw > 4 or th > 1):
        if tw > 8 or th == 1:
            tw //= 2
        else:
            th //= 2
    vs = 1
    while 2 * vs <= th and 2 * vs * kdn * K * cig * cog <= _WGRAD_THREADS:
        vs *= 2
    tiles = n * d * -(-h // th) * -(-w // tw)
    chan_blocks = (-(-ci // (ci_t * cig)) * -(-co // (4 * cog)) *
                   (K if kdn == 1 else 1))
    splits = _wgrad_splits(tiles, chan_blocks)
    return dict(form=form, ci_t=ci_t, cig=cig, cog=cog, kdn=kdn, vs=vs,
                th=th, tw=tw, cis=cis, cos=cos, splits=splits,
                threads=vs * kdn * K * cig * cog, smem=smem(th, tw),
                chan_blocks=chan_blocks)


def _wgrad_splits(tiles, chan_blocks):
    """Blocks along the voxel axis: enough to put about four blocks on
    every SM, each with at least one voxel tile."""
    splits = max(1, min(tiles, -(-_WGRAD_BLOCKS // chan_blocks)))
    return -(-tiles // -(-tiles // splits))


def conv5_wgrad_mma_geometry(n, d, h, w, ci, co):
    """Launch geometry of the bf16 tensor-core weight-gradient kernel, a
    dict: ``form`` ('head' for Co <= 16, else 'mid'); ``nf`` n8 fragments
    per warp (a block owns 32 input x 8 * nf output channels of one depth
    tap); the ``th`` x ``tw`` voxel tile, staged for two depth slices at a
    time; ``xcs`` / ``gcs``, the shared-memory channel strides in words,
    padded to 4 mod 8 (conflict-free fragment loads); ``splits`` blocks
    along the list of (n, depth pair, tile)."""
    nf = 4 if co > 16 else (2 if co > 8 else 1)
    tw = max(8, min(32, _pow2ceil(w)))
    th = min(8, _pow2ceil(h))

    def stride(words):
        return words + (4 - words % 8) % 8

    xcs, gcs = stride((th + 2 * P) * (tw + 2 * P)), stride(th * tw)
    tiles = n * -(-d // 2) * -(-h // th) * -(-w // tw)
    chan_blocks = -(-ci // 32) * -(-co // (8 * nf)) * K
    return dict(form="head" if co <= 16 else "mid", nf=nf, th=th, tw=tw,
                xcs=xcs, gcs=gcs, splits=_wgrad_splits(tiles, chan_blocks),
                smem=4 * (32 * xcs + 8 * nf * gcs), chan_blocks=chan_blocks)


def _check_wgrad(xk, gk, kind):
    if xk.dim() != 5 or gk.dim() != 5 or (
            tuple(xk.shape[:2]) + tuple(xk.shape[3:]) !=
            tuple(gk.shape[:2]) + tuple(gk.shape[3:])):
        raise ValueError("wgrad of x {} and g {}: expected [N, D, Ci, H, W] "
                         "and [N, D, Co, H, W]".format(tuple(xk.shape),
                                                       tuple(gk.shape)))
    if kind not in ("head", "stem"):
        raise ValueError("kind must be 'head' or 'stem', got " + repr(kind))
    if kind == "stem" and xk.shape[2] != 1:
        raise ValueError("the stem form takes Ci=1, got Ci={}".format(
            xk.shape[2]))
    if xk.dtype not in _DTYPES or gk.dtype != xk.dtype:
        raise TypeError("wgrad takes x and g both float32 or both bfloat16, "
                        "got {} and {}".format(xk.dtype, gk.dtype))


def _conv5_wgrad_cuda(xk, gk, kind):
    if xk.device.type != "cuda" or gk.device != xk.device:
        raise RuntimeError("wgrad kernel needs CUDA tensors on one device, "
                           "got {} and {}".format(xk.device, gk.device))
    if xk.stride(4) != 1 or gk.stride(4) != 1:
        raise ValueError("wgrad kernel needs W as the contiguous axis; "
                         "pin_kl the operands first")
    n, d, ci, h, ww = xk.shape
    co = gk.shape[2]
    # bf16 on the tensor cores, except the Ci = 1 stem (one row of an m16
    # fragment); f32 keeps exact f32 products and sums on the CUDA cores
    mma = xk.dtype == torch.bfloat16 and kind != "stem"
    q = (conv5_wgrad_mma_geometry(n, d, h, ww, ci, co) if mma else
         conv5_wgrad_geometry(n, d, h, ww, ci, co, kind))
    if q.get("threads", 0) > _WGRAD_THREADS:
        raise ValueError("wgrad block of {} threads exceeds {}".format(
            q["threads"], _WGRAD_THREADS))
    if q["chan_blocks"] > 65535 or q["splits"] >= 2 ** 31:
        raise ValueError("wgrad grid too large: {} splits x {} channel "
                         "tiles for x {}".format(q["splits"],
                                                 q["chan_blocks"],
                                                 tuple(xk.shape)))
    if q["smem"] > 227 * 1024:
        raise ValueError("wgrad tile needs {} bytes of shared memory".format(
            q["smem"]))
    parts = q["splits"] * q.get("vs", 1)
    size = K * K * K * ci * co
    out = torch.empty((K, K, K, ci, co), dtype=torch.float32,
                      device=xk.device)
    part = (torch.empty((parts, size), dtype=torch.float32,
                        device=xk.device) if parts > 1 else None)
    xs, gs = xk.stride(), gk.stride()
    ptrs = (xk.data_ptr(), gk.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr())
    if mma:
        fn = _wgrad_lib().conv5_wgrad_mma_launch
        cfg = (q["nf"], q["th"], q["tw"], q["xcs"], q["gcs"], q["splits"])
    else:
        fn = _wgrad_lib().conv5_wgrad_launch
        cfg = (_DTYPES[xk.dtype], q["ci_t"], q["cig"], q["cog"], q["kdn"],
               q["vs"], q["th"], q["tw"], q["cis"], q["cos"], q["splits"])
    with torch.cuda.device(xk.device):
        rc = fn(*ptrs, *cfg, n, d, ci, h, ww, co, xs[0], xs[2], xs[1], xs[3],
                gs[0], gs[2], gs[1], gs[3],
                torch.cuda.current_stream(xk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("wgrad kernel launch failed: CUDA error {}".format(
            rc))
    LAUNCHES["conv5_wgrad_" + q["form"]] += 1
    return out


def conv5_wgrad_kl(xk, gk, kind="head"):
    """Weight gradient of :func:`conv5_kl`: ``xk`` [N, D, Ci, H, W] and the
    cotangent ``gk`` [N, D, Co, H, W] (same dtype, W contiguous) -> f32
    [5, 5, 5, Ci, Co]. One wrapper for every conv of V-Net (stem, narrow
    head, square and wide stacks), no shape gate: bf16 runs on the tensor
    cores (``wgrad_mma_kernel``) except the Ci = 1 stem, which like f32
    runs on the CUDA cores (``wgrad_kernel``); the voxel axis is reduced
    deterministically (partials and a second pass, no atomics).

    Rounding: the f32 sums are rounded to x's dtype and widened again.
    The JAX layer casts its f32 kernel to the activation dtype before the
    conv, so its custom VJP returns dW in that dtype and the cast's VJP
    widens it; the port's layer passes the f32 parameter in, and this
    rounding makes both compute the same gradient (a no-op in f32)."""
    _check_wgrad(xk, gk, kind)
    if xk.device.type == "cpu":
        return conv5_wgrad_kl_plain(xk, gk)
    return _conv5_wgrad_cuda(xk, gk, kind).to(xk.dtype).float()


class _Conv5KL(torch.autograd.Function):
    """conv5_kl with the backward of the JAX ``_conv5_kl_bwd``."""

    @staticmethod
    def forward(ctx, xk, w, b, kind):
        ctx.kind = kind
        ctx.save_for_backward(xk, w)
        return _conv5_forward(xk, w, b, kind)

    @staticmethod
    def backward(ctx, gk):
        xk, w = ctx.saved_tensors
        gk = pin_kl(gk)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv5_dgrad_kl(gk, w)
        if ctx.needs_input_grad[1]:
            dw = conv5_wgrad_kl(xk, gk, ctx.kind).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = gk.float().sum(dim=(0, 1, 3, 4))
        return dx, dw, db, None


def conv5_kl(xk, w, b, kind="head"):
    """5^3 SAME conv in kernel layout: [N, D, Ci, H, W] -> [N, D, Co, H, W]
    in x's dtype. ``kind``: 'head' (any Ci) or 'stem' (Ci = 1).
    Differentiable in x, w and b; dx is skipped when x needs no gradient
    (the stem's input is the image)."""
    _check_conv(xk, w, b, kind, None)
    return _Conv5KL.apply(xk, w, b, kind)


def conv5_kl_fused(xk, w, b, ep: Sequence[torch.Tensor], kind="head"):
    """:func:`conv5_kl` with the BN affine + PReLU fused into the kernel's
    output path. Inference only, like the JAX function (no VJP): it raises
    when gradients are being recorded for any operand. ``ep`` = (inv,
    shift, alpha), each [Co] f32; the stem passes alpha = 1."""
    _check_conv(xk, w, b, kind, ep)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xk, w, b) + tuple(ep)):
        raise RuntimeError(
            "conv5_kl_fused has no backward: call it under torch.no_grad() "
            "or use conv5_kl with a separate BatchNorm and activation")
    if xk.device.type == "cpu":
        return conv5_kl_plain(xk, w, b, ep)
    return _conv5_cuda(xk, w, b, kind, tuple(ep))


def conv5(x, w, b, kind="head"):
    """5^3 SAME conv on NDHWC [N, D, H, W, Ci] -> NDHWC [N, D, H, W, Co]
    (a view of the kernel-layout result)."""
    return from_kl(conv5_kl(pin_kl(to_kl(x)), w, b, kind))


def _pin_forward(xk):
    if xk.device.type == "cpu":
        return pin_kl_plain(xk)
    return _pin_cuda(xk)


class _PinKL(torch.autograd.Function):
    """The pin with the JAX ``_pin_bwd``: the cotangent is handed on, pinned
    when it is not contiguous (it feeds the backward kernels)."""

    @staticmethod
    def forward(ctx, xk):
        return _pin_forward(xk)

    @staticmethod
    def backward(ctx, g):
        return g if g.is_contiguous() else _pin_forward(g)


def pin_kl(xk: torch.Tensor):
    """Identity that materializes a kernel-layout view in contiguous
    row-major order (the JAX ``pin_kl``). Returns ``xk`` itself when it is
    already contiguous; else copies it with the pin kernel (CUDA) or
    ``contiguous()`` (CPU). Differentiable."""
    if xk.is_contiguous():
        return xk
    return _PinKL.apply(xk)


def _pin_cuda(xk):
    if xk.device.type != "cuda":
        raise RuntimeError("pin kernel needs a CUDA tensor, got device "
                           + str(xk.device))
    if xk.dim() != 5 or xk.element_size() not in (2, 4):
        raise ValueError("pin takes a 5-D tensor of 2- or 4-byte elements, "
                         "got {} {}".format(tuple(xk.shape), xk.dtype))
    y = torch.empty(xk.shape, dtype=xk.dtype, device=xk.device)
    with torch.cuda.device(xk.device):
        rc = _pin_lib().pin_launch(
            xk.data_ptr(), y.data_ptr(), xk.element_size(), *xk.shape,
            *xk.stride(), torch.cuda.current_stream(xk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("pin kernel launch failed: CUDA error {}".format(
            rc))
    LAUNCHES["pin"] += 1
    return y
