# Copyright 2026. Apache License 2.0.
"""5^3 SAME convolutions (stride 1) and the layout pin, through the
hand-written CUDA kernels of ``csrc/conv5_wg.cu``, ``csrc/conv5_stem.cu``,
``csrc/conv5_stem_tf32.cu``, ``csrc/conv5_tf32.cu``, ``csrc/conv5.cu``,
``csrc/conv5_stem_wgrad.cu``, ``csrc/conv5_stem_wgrad_tf32.cu``,
``csrc/conv5_wgrad.cu``, ``csrc/conv5_wgrad_tma.cu``,
``csrc/conv5_wgrad_tf32.cu`` and ``csrc/pin.cu``.

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
kernels of ``csrc/conv5_wgrad_tma.cu`` (bf16 square, wide and narrow-head
convs, fed by tensor copies or by a software producer on views a tensor
copy cannot describe: :func:`conv5_wgrad_form`),
``csrc/conv5_stem_wgrad.cu`` (bf16 stems with Co <= 16),
``csrc/conv5_stem_wgrad_tf32.cu`` (f32 stems with Co <= 16),
``csrc/conv5_wgrad_tf32.cu`` (f32 convs but the stem) and
``csrc/conv5_wgrad.cu`` (wider stems), db is a plain f32
sum.
:func:`conv5_kl_fused` is inference-only. It and the no-grad pin of
:func:`pin_kl` call the ``torch.library`` ops ``medicalseg::conv5_fused``
and ``medicalseg::pin`` (the eval forward's kernels), so that
``torch.export`` keeps them as nodes of an exported program.

One wrapper covers every 5^3 conv of V-Net: Ci from 1 to 256, Co from 1
to 256, in bfloat16 or float32, with f32 accumulation and a single cast of
the result. Every bf16 head conv, forward and input gradient, runs on the
tensor cores through the warpgroup kernel (``conv5_wg_kernel`` of
``csrc/conv5_wg.cu``: wgmma, mbarrier rings, a deterministic split of K
where the grid is short of blocks; :func:`conv5_wg_geometry`); the bf16
``kind="stem"`` (Ci = 1) form with Co <= 16 runs on the tensor cores
through ``stem_tc_kernel`` of ``csrc/conv5_stem.cu``
(:func:`conv5_stem_tc_geometry`); every f32 head conv, forward and input
gradient, runs on the tensor cores in split TF32 at f32 accuracy
(``conv5_tf32_kernel`` of ``csrc/conv5_tf32.cu``: three TF32 products a
term, :func:`split_tf32`, :func:`conv5_tf32_geometry`), and so does the f32
stem with Co <= 16 (``stem_tf32_kernel`` of ``csrc/conv5_stem_tf32.cu``,
:func:`conv5_stem_tf32_geometry`); stems wider than 16 channels run on the
CUDA cores (``conv5_kernel`` of ``csrc/conv5.cu``).
The choice is by dtype, kind and Co alone (:func:`conv5_form`): the TPU's
lane and VMEM eligibility rules do not apply here. The packed weights of
the warpgroup, stem and split-TF32 kernels are kept while their parameter
is unchanged (:func:`_packed_weight`).

Every wrapper has a plain PyTorch version beside it (``*_plain``). A
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it
launches its kernel or raises. :data:`LAUNCHES` counts the launches of
each kernel.

Under a mesh with a space axis (``parallel.use_mesh``), :func:`conv5_kl`
and :func:`conv5_kl_fused` take the rank's H block [N, D, C, H/S, W] and
run as the JAX ``_cp_batchmap_kl`` / ``_cp_batchmap_kl_fused`` /
``_cp_wgrad_kl`` partitions do: P = 2 halo rows from each H neighbour
(zeros at the volume's edges, ``parallel.halo_h``), the same kernel on
the extended shard [N, D, C, H/S + 4, W], and its rows ``[P:-P]``. The
backward's dx is rows ``[P:-P]`` of the dgrad kernel on the halo'd
cotangent; dW is the weight-gradient kernel on the saved halo'd input and
the cotangent zero-padded by P rows, a partial sum that
``parallel.sum_grads`` completes over the world (as it does the batch
shards' partials); db is local. Nothing gives way to another route on a
CUDA tensor. A mesh without a space axis, or in an H-replicated region
(``Mesh.whole``, where the JAX partition asks for H replication because
H does not divide), changes nothing here: the whole H axis, no halo and
no extra copy.
"""

import ctypes
import functools
import weakref
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build
from ..parallel.collectives import halo_h
from ..parallel.mesh import active_mesh

K = 5  # kernel edge
P = K // 2  # halo

# Launches of each kernel since the last reset_launches(). A forward conv
# launch counts under its form (:func:`conv5_form`): "conv5_head" (bf16),
# "conv5_head_tf32" (f32), "conv5_stem_tc" (bf16 stems, Co <= 16),
# "conv5_stem_tf32" (f32 stems, Co <= 16) or "conv5_stem" (wider stems),
# and also under "conv5_fused_epilogue" when it applies the BN + PReLU
# epilogue; the same kernel launched for a backward counts under
# "conv5_dgrad" (f32: "conv5_dgrad_tf32") only. A weight gradient counts
# under its form (:func:`conv5_wgrad_form`): "stem_tc" (bf16 stems, Co <=
# 16), "stem_tf32" (f32 stems, Co <= 16), "stem" (wider stems), "tf32"
# (every other f32 conv), "head_tma"
# (bf16 narrow heads, Co <= 16, on views a tensor copy can describe),
# "head_ragged" (every other bf16 narrow head), "tma" (bf16 wider convs on
# such views) or "ragged" (every other bf16 wider conv); "head" and "mid"
# (``wgrad_mma_kernel``) only where ``form=`` forces them.
LAUNCHES = {"conv5_head": 0, "conv5_head_tf32": 0, "conv5_stem": 0,
            "conv5_stem_tc": 0, "conv5_stem_tf32": 0,
            "conv5_fused_epilogue": 0,
            "pin": 0, "conv5_dgrad": 0, "conv5_dgrad_tf32": 0,
            "conv5_wgrad_stem": 0, "conv5_wgrad_stem_tc": 0,
            "conv5_wgrad_stem_tf32": 0,
            "conv5_wgrad_head": 0, "conv5_wgrad_head_tma": 0,
            "conv5_wgrad_head_ragged": 0, "conv5_wgrad_mid": 0,
            "conv5_wgrad_tma": 0, "conv5_wgrad_ragged": 0,
            "conv5_wgrad_tf32": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MIN_BLOCKS = 1056  # 8 blocks per SM of an H100 before tiles shrink
_SMS = 132  # SMs of an H100: the warpgroup kernel sizes its K split by them
_WG_XS, _WG_RS = 2, 2  # warpgroup kernel: halo-tile and raw-tile stages
_SMEM_MAX = 227 * 1024  # shared memory a block can use on an H100
_WGRAD_BLOCKS = 528  # wgrad: voxel splits until the grid has 4 blocks per SM
_WGRAD_SMEM = 100 * 1024  # wgrad: shared memory of a block (2 blocks per SM)
_WGRAD_THREADS = 384  # wgrad: the kernel's __launch_bounds__
_TMA_MAX_STAGES = 8  # wgrad_tma_kernel: most stages of its ring
_TMA_BAR_BYTES = 128  # wgrad_tma_kernel: its mbarriers, ahead of the ring
# the tensor-copy kernels' software producer: its warps where it copies by
# cp.async, and where it realigns 32-bit loads (latency-bound: more warps
# keep more loads in flight; measured in PERF.md)
_SOFT_WARPS, _SOFT_WARPS_REALIGNED = 2, 6
_STEM_BLOCKS = 1056  # stem_tc_kernel: depth chunks until 8 blocks per SM
_STEM_CO = 16  # stem_tc_kernel: most output channels (N of its GEMM)
_STEM_WG_RESIDENT = 2 * _SMS  # stem_wgrad_tc_kernel: 2 blocks an SM
_TF32_VOX = 256  # conv5_tf32_kernel: output voxels of a block (8 warps x 32)
_TF32_CK = 8  # conv5_tf32_kernel: input channels a stage (one k8 step)
_TF32_CIB = 16  # wgrad_tf32_kernel: input channels of a block (m16)
_STF_VOX = 512  # stem_tf32_kernel: voxels of a block tile (8 warps x 64)
_STF_WARP = 64  # stem_tf32_kernel: voxels of a warp (four m16 tiles)
_STF_YP = 68  # stem_tf32_kernel: staged output pitch (floats)
_SWF_VOX = 256  # stem_wgrad_tf32_kernel: voxels of a tile (8 warps x 32)
_SWF_GP = 260  # stem_wgrad_tf32_kernel: staged g channel pitch (floats)


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
    """A contiguous copy of ``xk`` (a new tensor even where ``xk`` is
    contiguous: an op's output never aliases its input)."""
    return xk.clone(memory_format=torch.contiguous_format)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _conv5_lib():
    lib = _build.library("conv5")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_launch.argtypes = [vp] * 5 + [i] * 11 + [ll] * 8 + [vp]
    lib.conv5_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _conv5_stem_lib():
    lib = _build.library("conv5_stem")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_stem_tc_launch.argtypes = [vp] * 5 + [i] * 6 + [ll] * 7 + [vp]
    lib.conv5_stem_tc_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _stem_wgrad_lib():
    lib = _build.library("conv5_stem_wgrad")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_stem_wgrad_tc_launch.argtypes = ([vp] * 4 + [i] * 8 + [ll] * 7
                                               + [vp])
    lib.conv5_stem_wgrad_tc_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _stem_tf32_lib():
    lib = _build.library("conv5_stem_tf32")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_stem_tf32_launch.argtypes = ([vp] * 5 + [i] * 13 + [ll] * 7 +
                                           [vp])
    lib.conv5_stem_tf32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _stem_wgrad_tf32_lib():
    lib = _build.library("conv5_stem_wgrad_tf32")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_stem_wgrad_tf32_launch.argtypes = ([vp] * 4 + [i] * 16 +
                                                 [ll] * 7 + [vp])
    lib.conv5_stem_wgrad_tf32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _conv5_wg_lib():
    lib = _build.library("conv5_wg")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_wg_launch.argtypes = [vp] * 6 + [i] * 13 + [ll] * 8 + [vp]
    lib.conv5_wg_launch.restype = ctypes.c_int
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
def _wgrad_tma_lib():
    lib = _build.library("conv5_wgrad_tma")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.conv5_wgrad_tma_launch, lib.conv5_wgrad_head_tma_launch):
        fn.argtypes = [vp] * 4 + [i] * 14 + [ll] * 8 + [vp]
        fn.restype = ctypes.c_int
    for fn in (lib.conv5_wgrad_ragged_launch,
               lib.conv5_wgrad_head_ragged_launch):
        fn.argtypes = [vp] * 4 + [i] * 21 + [ll] * 8 + [vp]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _conv5_tf32_lib():
    lib = _build.library("conv5_tf32")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_tf32_launch.argtypes = [vp] * 6 + [i] * 14 + [ll] * 4 + [vp]
    lib.conv5_tf32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_tf32_lib():
    lib = _build.library("conv5_wgrad_tf32")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv5_wgrad_tf32_launch.argtypes = ([vp] * 4 + [i] * 13 + [ll] * 8 +
                                            [vp])
    lib.conv5_wgrad_tf32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _pin_lib():
    lib = _build.library("pin")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pin_launch.argtypes = [vp, vp] + [i] * 6 + [ll] * 5 + [vp]
    lib.pin_vec_launch.argtypes = [vp, vp, ll, ll] + [i] * 3 + [ll] * 4 + [vp]
    lib.pin_launch.restype = lib.pin_vec_launch.restype = ctypes.c_int
    return lib


class _on_device:
    """Make ``device`` current for a launch, and hand out the raw handle of
    its current stream. Costs nothing where the device is current already
    (the usual case: one card)."""

    def __init__(self, device):
        self.index = (torch.cuda.current_device() if device.index is None
                      else device.index)
        self.ctx = (None if self.index == torch.cuda.current_device()
                    else torch.cuda.device(self.index))

    def __enter__(self):
        if self.ctx is not None:
            self.ctx.__enter__()
        return torch.cuda.current_stream(self.index).cuda_stream

    def __exit__(self, *exc):
        if self.ctx is not None:
            self.ctx.__exit__(*exc)


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


def conv5_wg_geometry(n, d, h, w, ci, co):
    """Launch geometry of the bf16 warpgroup head kernel, a dict (a fresh
    copy of a cached one):

    * ``nt``: output channels per block (8, 32, 64 or 128: one wgmma's N),
      ``co_tiles`` of them; ``mt``: m64 tiles per consumer warpgroup (two
      warpgroups, at most 128 accumulators a thread), so a block owns
      ``128 * mt`` output voxels; ``blocks_per_sm``: 2 up to 32 channels
      (a small block, so that one block's prologue and stores overlap the
      other's wgmmas), else 1; ``ws``: stages of the weight ring;
    * ``td``, ``th``, ``tw``: the block's output tile over depth, rows and
      columns, made of 8 x 8 patches (one m64 tile each; small planes
      stack depth slices), shrunk until the block fits the card's shared
      memory; ``sw``: the halo row pitch in voxels, ``tw + 4`` raised to 6
      mod 8 (conflict-free 16-byte stores of the transposing producers);
    * ``chunks`` of 16 input channels, ``stages`` = 5 * chunks (depth tap,
      chunk) steps of the reduction, and ``splits``: blocks along that
      reduction, more than 1 where the grid alone would leave SMs idle
      (:func:`_wg_splits`: about one full wave of blocks, each split at
      least one stage); split ``z`` owns stages ``[z * stages // splits,
      (z + 1) * stages // splits)`` (:func:`conv5_wg_split_ranges`);
    * ``x_stage``, ``r_stage``, ``smem``: bytes of one halo-tile stage
      (two planes of 8 channels), of one raw input tile as the tensor copy
      brings it ([td][16][th + 4][8-voxel groups]) and of the block
      (barriers, ``ws`` weight stages of one kh row, ``_WG_XS`` halo and
      ``_WG_RS`` raw stages); ``grid``: (voxel tiles, n * co_tiles,
      splits)."""
    return dict(_wg_geometry(n, d, h, w, ci, co))


@functools.lru_cache(maxsize=None)
def _wg_geometry(n, d, h, w, ci, co):
    nt = 8 if co <= 8 else 32 if co <= 32 else 64 if co <= 64 else 128
    mt = 4 if nt == 64 else 2
    ws = 6 if nt == 128 else 8  # stages of the weight ring
    blocks_per_sm = 2 if nt <= 32 else 1
    m = 128 * mt
    tw = max(8, min(32, _pow2ceil(w)))
    th = max(8, min(m // tw, _pow2ceil(h)))
    td = min(m // (tw * th), _pow2ceil(d))
    sw = tw + 2 * P + (6 - (tw + 2 * P)) % 8
    groups = (tw + 1) // 8 + 2  # aligned 8-voxel groups that cover a halo row

    def stages_bytes(td, th):
        rows = td * (th + 2 * P)
        plane = rows * sw * 16
        plane += (16 - plane) % 128  # the stride between the two planes
        return -(-2 * plane // 128) * 128, rows * 16 * groups * 16

    def smem(td, th):
        x_stage, r_stage = stages_bytes(td, th)
        return 256 + ws * K * nt * 32 + _WG_XS * x_stage + _WG_RS * r_stage

    while smem(td, th) > _SMEM_MAX // blocks_per_sm and td * th > 8:
        if td > 1:
            td //= 2
        else:
            th //= 2
    co_tiles, chunks = -(-co // nt), -(-ci // 16)
    stages = K * chunks
    tiles = -(-d // td) * -(-h // th) * -(-w // tw)
    base = tiles * n * co_tiles
    splits = _wg_splits(base, stages, blocks_per_sm * _SMS)
    x_stage, r_stage = stages_bytes(td, th)
    return dict(nt=nt, mt=mt, ws=ws, blocks_per_sm=blocks_per_sm, td=td,
                th=th, tw=tw, sw=sw, co_tiles=co_tiles, chunks=chunks, stages=stages, splits=splits, x_stage=x_stage,
                r_stage=r_stage, smem=smem(td, th),
                grid=(tiles, n * co_tiles, splits))


def _wg_splits(base, stages, resident):
    """Splits of the (depth tap, chunk) reduction for ``base`` blocks of
    ``stages`` stages on a card that holds ``resident`` blocks at once: the
    count that makes the launch shortest, where a launch costs its waves
    of blocks times a block's stages (plus two for its prologue and
    stores), and a split launch the second pass over its partials (one
    stage and a quarter per split). The smallest count wins a tie."""
    def cost(s):
        waves = -(-base * s // resident)
        return waves * (-(-stages // s) + 2) + (s > 1) * (1 + 0.25 * s)

    return min(range(1, stages + 1), key=lambda s: (cost(s), s))


def conv5_wg_split_ranges(stages, splits):
    """The (depth tap, chunk) stages of each split of the warpgroup
    kernel, as the kernel computes them: [(first, past-the-last), ...]."""
    return [(z * stages // splits, (z + 1) * stages // splits)
            for z in range(splits)]


def _pack_weights_wg(w, nt, dgrad=False):
    """[5, 5, 5, Ci, Co] f32 -> the warpgroup kernel's bf16 weights
    [Co/nt, kd, Ci/16, kh, kw, nt/8, 2, 8, 8], zero-padded in Ci and Co:
    per tap an [nt][16] K-major operand stored as 8 x 8 core matrices of
    128 contiguous bytes (the no-swizzle shared-memory form of wgmma), per
    (channel tile, depth tap, chunk, kh) one contiguous block for one bulk
    copy. One pass (cast, permute) where Ci and Co fill their tiles.
    ``dgrad``: the weight of the input gradient's conv, io-transposed by
    index; its spatial flip is the kernel's (it walks the taps
    backwards)."""
    src = w.transpose(3, 4) if dgrad else w
    ci, co = src.shape[3], src.shape[4]
    tiles, chunks = -(-co // nt), -(-ci // 16)
    if ci != chunks * 16 or co != tiles * nt:
        src = F.pad(src.to(torch.bfloat16),
                    (0, tiles * nt - co, 0, chunks * 16 - ci))
    out = torch.empty((tiles, K, chunks, K, K, nt // 8, 2, 8, 8),
                      dtype=torch.bfloat16, device=w.device)
    # the packed tensor seen as [kd, kh, kw, chunk, half, k8, tile, ng, n8]
    out.permute(1, 3, 4, 2, 6, 8, 0, 5, 7).copy_(
        src.reshape(K, K, K, chunks, 2, 8, tiles, nt // 8, 8))
    return out


# id(parameter) -> (weak reference, _version, data_ptr, {form: packed})
_PACKED = {}


def _packed_weight(w, nt, dgrad=False):
    """:func:`_pack_weights_wg` of ``w`` (``nt='stem'``:
    :func:`_pack_weights_stem`; ``nt='stem_tf32'``:
    :func:`_pack_weights_stem_tf32`; ``nt=('tf32', nf)``:
    :func:`_pack_weights_tf32`), kept while the tensor ``w`` views
    (a layer passes a permuted view of its parameter) is alive and
    unchanged: an in-place update (an optimizer step, ``load_state_dict``)
    moves its ``_version`` and the weights are packed again. Entries belong
    to one tensor object and leave with it. Inference tensors carry no
    version and are packed per call, and so are weights while a CUDA graph
    is being captured: the packing is then part of the graph, and each
    replay packs the weights the parameters hold at that time (a cached
    packing would replay the weights of the capture)."""
    def pack(w):
        if nt == "stem":
            return _pack_weights_stem(w)
        if nt == "stem_tf32":
            return _pack_weights_stem_tf32(w)
        if isinstance(nt, tuple):  # ("tf32", nf)
            return _pack_weights_tf32(w, nt[1], dgrad)
        return _pack_weights_wg(w, nt, dgrad)

    if w.is_inference() or (w.is_cuda and
                            torch.cuda.is_current_stream_capturing()):
        return pack(w)
    base = w if w._base is None else w._base
    entry = _PACKED.get(id(base))
    if (entry is None or entry[0]() is not base
            or entry[1] != base._version or entry[2] != base.data_ptr()):
        def drop(ref, key=id(base)):
            if _PACKED.get(key, (None,))[0] is ref:
                del _PACKED[key]

        entry = (weakref.ref(base, drop), base._version, base.data_ptr(), {})
        _PACKED[id(base)] = entry
    form = (tuple(w.shape), w.stride(), w.storage_offset(), nt, dgrad)
    if form not in entry[3]:
        entry[3][form] = pack(w.detach())
    return entry[3][form]


def _pack_weights(w, dtype, cot):
    """[5, 5, 5, Ci, Co] -> f32 [Co/cot, 125, Ci, cot], rounded to the
    activation dtype first (the JAX layer casts its kernel the same way);
    padded output channels are zero."""
    ci, co = w.shape[3], w.shape[4]
    tiles = -(-co // cot)
    wf = F.pad(w.to(dtype).float(), (0, tiles * cot - co))
    return wf.reshape(K * K * K, ci, tiles, cot).permute(
        2, 0, 1, 3).contiguous()


def conv5_form(xk, co, kind):
    """The forward kernel that takes a conv of ``xk`` into ``co`` output
    channels, named by its :data:`LAUNCHES` entry (``'conv5_' + form``):
    for ``kind='stem'`` with Co <= 16 'stem_tc' (bf16: ``stem_tc_kernel``)
    or 'stem_tf32' (f32: ``stem_tf32_kernel``, any W-contiguous view), for
    wider stems 'stem' (``conv5_kernel``); 'head' (bf16:
    ``conv5_wg_kernel``) or 'head_tf32' (f32: ``conv5_tf32_kernel``, any
    W-contiguous view). Its input gradient counts under 'dgrad' or, in
    f32, 'dgrad_tf32'."""
    if kind != "stem":
        return "head_tf32" if xk.dtype == torch.float32 else "head"
    if co > _STEM_CO:
        return "stem"
    return "stem_tf32" if xk.dtype == torch.float32 else "stem_tc"


def split_tf32(a):
    """(hi, lo) of the float32 tensor ``a``: ``hi`` rounds ``a`` to TF32
    (10 mantissa bits; to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``; the 13 low bits zero) and ``lo`` rounds ``a - hi``
    (exact in f32) the same way. hi*hi + hi*lo + lo*hi is the product of
    two such pairs to about 2^-22 relative: the split-TF32 kernels' terms.
    The integer form ``(bits + 0x1000) & ~0x1fff`` is the kernels' own."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def conv5_tf32_geometry(n, d, h, w, ci, co):
    """Launch geometry of ``conv5_tf32_kernel`` (``csrc/conv5_tf32.cu``), a
    dict (a fresh copy of a cached one):

    * ``nf``: n8 tiles of a block (1..4), ``nt`` = 8 * nf output channels
      (Co 3 pads to 8, Co 20 to 24), ``co_tiles`` of them;
    * ``td`` x ``th`` x ``tw`` = 256: the block's output tile (tw 8, 16 or
      32 by W; th up to 256 / tw by H, at least 256 / (4 tw), so that at
      most 4 depths stack);
    * ``pitch`` = tw + 8 and ``plane``: the raw input box's row pitch (from
      4 columns left of the tile: 16-byte copies) and channel plane in
      floats, the plane padded to 4 mod 8 (the split pass's reads of 4
      channels hit distinct banks); ``voxels``: the halo box's voxels,
      split into (hi, lo) planes of 48 bytes a voxel (8 channels and a
      pad: the 8 rows of an ldmatrix hit distinct banks);
    * ``chunks`` of 8 input channels, ``stages`` = 5 * chunks (depth tap,
      chunk) steps of K, ``splits``: blocks along them where the grid alone
      leaves SMs idle (:func:`_wg_splits`), each a range as
      :func:`conv5_wg_split_ranges` gives;
    * ``x_stage``, ``w_stage``: bytes of a stage's input box (raw and
      split) and packed weights (25 taps x nf x 32 lanes x 16 bytes);
      ``smem``: their sum; ``blocks_per_sm``: 2 where two blocks fit (the
      kernel's ``__launch_bounds__``), else 1; ``grid``: (tiles, n *
      co_tiles, splits); ``threads``: 256."""
    return dict(_tf32_geometry(n, d, h, w, ci, co))


@functools.lru_cache(maxsize=None)
def _tf32_geometry(n, d, h, w, ci, co):
    nf = min(4, -(-co // 8))
    tw = 8 if w <= 8 else 16 if w <= 16 else 32
    th = min(_TF32_VOX // tw, max(_pow2ceil(h), _TF32_VOX // (4 * tw)))
    td = _TF32_VOX // (tw * th)
    pitch = tw + 8
    plane = (th + 2 * P) * pitch
    plane += (4 - plane) % 8
    voxels = td * (th + 2 * P) * (tw + 2 * P)
    x_stage = 4 * td * _TF32_CK * plane + 2 * 48 * voxels
    w_stage = 16 * K * K * nf * 32
    smem = x_stage + w_stage
    blocks_per_sm = 2 if smem <= _SMEM_MAX // 2 else 1
    co_tiles, chunks = -(-co // (8 * nf)), -(-ci // _TF32_CK)
    stages = K * chunks
    tiles = -(-d // td) * -(-h // th) * -(-w // tw)
    splits = _wg_splits(tiles * n * co_tiles, stages, blocks_per_sm * _SMS)
    return dict(nf=nf, nt=8 * nf, co_tiles=co_tiles, td=td, th=th, tw=tw,
                pitch=pitch, plane=plane, voxels=voxels, chunks=chunks,
                stages=stages, splits=splits, x_stage=x_stage,
                w_stage=w_stage, smem=smem, blocks_per_sm=blocks_per_sm,
                grid=(tiles, n * co_tiles, splits), threads=256)


def _pack_weights_tf32(w, nf, dgrad=False):
    """[5, 5, 5, Ci, Co] f32 -> ``conv5_tf32_kernel``'s pre-split weights
    [Co / (8 nf), kd, Ci / 8, kh * 5 + kw, nf, 32 lanes, 4] f32, zero-padded
    in Ci and Co: lane (g, t) = (lane // 4, lane % 4) of n8 tile f holds
    the B fragment b0 = W[tap, t, 8 f + g], b1 = W[tap, t + 4, 8 f + g] of
    its 8-channel chunk as (hi(b0), hi(b1), lo(b0), lo(b1))
    (:func:`split_tf32`), one 16-byte load; per (channel tile, depth tap,
    chunk) one contiguous block, the weights of one stage of the kernel.
    ``dgrad``: the weight of the input gradient's conv, spatially flipped
    and io-transposed."""
    src = w.flip(0, 1, 2).transpose(3, 4) if dgrad else w
    ci, co = src.shape[3], src.shape[4]
    tiles, chunks = -(-co // (8 * nf)), -(-ci // _TF32_CK)
    src = F.pad(src.float(), (0, tiles * 8 * nf - co,
                              0, chunks * _TF32_CK - ci))
    # [kd, tap, chunk, k half, t, tile, f, g]
    hi, lo = split_tf32(src.reshape(K, K * K, chunks, 2, 4, tiles, nf, 8))
    # [hl, kd, tap, chunk, khalf, t, tile, f, g] ->
    # [tile, kd, chunk, tap, f, g, t, hl, khalf]
    return torch.stack((hi, lo)).permute(6, 1, 3, 2, 7, 8, 5, 0,
                                         4).contiguous()


def conv5_wgrad_tf32_geometry(n, d, h, w, ci, co):
    """Launch geometry of ``wgrad_tf32_kernel``
    (``csrc/conv5_wgrad_tf32.cu``), a dict (a fresh copy of a cached one):

    * ``nf``: n8 tiles of a block (1, 2 or 4: 8 * nf output channels, Co 3
      padded to 8), beside 16 input channels (one m16 tile);
    * ``th`` x ``tw``: the voxel tile (tw 8, 16 or 32 by W, th up to 8
      rows, halved until two blocks fit an SM);
    * ``xplane`` ((th + 4) rows of tw + 8, from 4 columns left of the
      tile: 16-byte copies) and ``gplane`` (th x tw): the channel planes of
      x and g in floats, padded to 4 mod 8 (the 8 channels x 4 voxels of a
      fragment load hit 32 banks); ``smem``: the raw tile and its hi and lo
      halves in the same layout; ``blocks_per_sm``: 2 where two fit (the
      kernel's ``__launch_bounds__``), else 1;
    * ``chan_blocks``: 5 depth taps x (Ci / 16) x (Co / 8 nf) blocks;
      ``tiles``: (n, d, h, w) voxel tiles; ``splits``: blocks along them
      (:func:`_wgrad_tf32_splits`), each a contiguous range, the partials
      summed in split order by a second pass; ``grid``: (chan_blocks,
      splits);
    * ``threads``: a warp a (kh, half of the n8 tiles), 5 warps where nf
      is 1."""
    return dict(_wgrad_tf32_geometry(n, d, h, w, ci, co))


@functools.lru_cache(maxsize=None)
def _wgrad_tf32_geometry(n, d, h, w, ci, co):
    nf = 1 if co <= 8 else 2 if co <= 16 else 4
    tw = 8 if w <= 8 else 16 if w <= 16 else 32
    th = min(8, _pow2ceil(h))

    def planes(th):
        xplane, gplane = (th + 2 * P) * (tw + 8), th * tw
        return xplane + (4 - xplane) % 8, gplane + (4 - gplane) % 8

    def smem(th):  # the raw tile and its hi and lo halves
        xplane, gplane = planes(th)
        return 3 * 4 * (_TF32_CIB * xplane + 8 * nf * gplane)

    while smem(th) > _SMEM_MAX // 2 and th > 1:  # two blocks an SM
        th //= 2
    xplane, gplane = planes(th)
    tiles = n * d * -(-h // th) * -(-w // tw)
    chan_blocks = K * -(-ci // _TF32_CIB) * -(-co // (8 * nf))
    blocks_per_sm = 2 if smem(th) <= _SMEM_MAX // 2 else 1
    splits = _wgrad_tf32_splits(tiles, th * tw, chan_blocks, ci, co, nf,
                                blocks_per_sm)
    return dict(nf=nf, th=th, tw=tw, xplane=xplane, gplane=gplane,
                smem=smem(th), blocks_per_sm=blocks_per_sm, tiles=tiles,
                chan_blocks=chan_blocks, splits=splits,
                grid=(chan_blocks, splits),
                threads=32 * K * (2 if nf > 1 else 1))


def _wgrad_tf32_splits(tiles, tile_vox, chan_blocks, ci, co, nf,
                       blocks_per_sm):
    """Blocks along the voxel tiles for ``chan_blocks`` channel blocks,
    ``blocks_per_sm`` at once on an SM: the count that makes the launch
    shortest by a model in microseconds. A block takes its tiles' three
    TF32 passes at 1.5 TF/s an SM shared by the SM's blocks (about 40% of an
    SM's share of 495 TF/s, what ``mma.sync`` reaches) plus 3 us of set-up
    and stores; a split launch adds the second pass, which reads the
    partials and writes dW (2.5 TB/s). Every split gets a tile at least;
    the smallest count wins a tie."""
    flop_tile = 3 * 2.0 * K * K * _TF32_CIB * 8 * nf * tile_vox

    def cost(s):
        waves = -(-chan_blocks * s // (blocks_per_sm * _SMS))
        block = -(-tiles // s) * flop_tile * blocks_per_sm / 1.5e6 + 3.0
        return waves * block + (s > 1) * (s + 1) * 500.0 * ci * co / 2.5e6

    splits = min(range(1, min(tiles, 65535) + 1), key=lambda s: (cost(s), s))
    return -(-tiles // -(-tiles // splits))


def conv5_stem_tc_geometry(n, d, h, w):
    """Launch geometry of ``stem_tc_kernel`` (``csrc/conv5_stem.cu``), a
    dict: ``th`` x ``tw`` = 8 x 32, the (h, w) tile of a block (warp i
    computes row i as two m16 tiles); ``dc``: output depths a block walks
    (``chunks`` of them cover D), as many chunks as bring the grid to
    about 8 blocks per SM but at most D / 8 of them, rounded up (a chunk
    reads 4 input slices more than it writes); ``grid``: (tiles, n *
    chunks);
    ``threads``; ``smem``: the ring of ten input slots (12 rows x 40
    columns of bf16), the per-warp output staging (16 channels x 40) and
    the channels' bias and epilogue (4 x 16 f32);
    ``blocks_per_sm``: 2 (its ``__launch_bounds__``: at most 128 registers
    a thread, 40 of them the held weight fragments)."""
    tiles = -(-h // 8) * -(-w // 32)
    chunks = max(1, min(-(-d // 8), -(-_STEM_BLOCKS // (tiles * n))))
    dc = -(-d // chunks)
    chunks = -(-d // dc)
    return dict(th=8, tw=32, dc=dc, chunks=chunks,
                grid=(tiles, n * chunks), threads=256,
                smem=10 * 12 * 40 * 2 + 8 * 16 * 40 * 2 + 4 * 16 * 4,
                blocks_per_sm=2)


def _pack_weights_stem(w):
    """[5, 5, 5, 1, Co] -> ``stem_tc_kernel``'s 32-bit words [80, 16]: K
    pair j < 75 is (kd, kh, kp) in row-major order and holds the bf16 pair
    (w[kd, kh, 2 kp, co], w[kd, kh, 2 kp + 1, co]) in its (low, high)
    halves; the sixth kw, the pairs 75..79 and the channels past Co are
    zero."""
    co = w.shape[4]
    wb = w.to(torch.bfloat16).reshape(K * K, K, co)
    wb = F.pad(wb, (0, _STEM_CO - co, 0, 1)).reshape(75, 2, _STEM_CO)
    wb = F.pad(wb, (0, 0, 0, 0, 0, 5))
    return wb.permute(0, 2, 1).contiguous().view(torch.int32).reshape(
        80, _STEM_CO)


def _round4(v):
    return -(-int(v) // 4) * 4


def _stem_tile(w, h, tw_max, vox):
    """The (h, w) tile of a split-TF32 stem kernel: (tiles_w, twd, th).
    Where W fits ``tw_max`` a tile is whole rows (twd = W: its voxels pack
    onto the GEMM's rows without a padded column), else ``tiles_w`` tiles
    of equal width rounded up to 4 columns (16-byte copies); th rows make
    at most ``vox`` voxels, spread evenly over the tiles along H."""
    tiles_w = 1 if w <= tw_max else -(-w // tw_max)
    twd = w if tiles_w == 1 else _round4(-(-w // tiles_w))
    th = max(1, min(h, vox // twd))
    th = -(-h // -(-h // th))
    return tiles_w, twd, th


def stem_tf32_columns():
    """The K columns of ``stem_tf32_kernel``: column 4 hg + t (half k8 step
    hg, lane quad position t) -> (kd, kh, kw), or None for the three
    zero-weight columns. hg 0..24: (kd, kh) = divmod(hg, 5), kw = t; 25..29:
    kd = hg - 25, kh = t, kw = 4; 30: kd = t, (kh, kw) = (4, 4); 31: the
    tap (4, 4, 4) at t = 0."""
    cols = []
    for hg in range(32):
        for t in range(4):
            if hg < 25:
                cols.append(divmod(hg, K) + (t,))
            elif hg < 30:
                cols.append((hg - 25, t, 4))
            elif hg == 30:
                cols.append((t, 4, 4))
            else:
                cols.append((4, 4, 4) if t == 0 else None)
    return cols


def _lift(res, lo, mod=32):
    """The least value >= ``lo`` that is ``res`` mod ``mod``: a shared-memory
    pitch whose word lands on a chosen bank."""
    return lo + (res - lo) % mod


def _stem_fit(h, th, layout):
    """Halve a tall narrow tile of ``th`` rows (rounded to even blocks of
    the H rows) until ``layout(th)``'s ``smem`` fits two blocks an SM, or
    th is 1. Returns (th, layout(th), blocks_per_sm)."""
    while True:
        q = layout(th)
        if q["smem"] <= _SMEM_MAX // 2 or th == 1:
            return th, q, 2 if q["smem"] <= _SMEM_MAX // 2 else 1
        th = -(-h // -(-h // (th // 2)))


def _stem_chunks(d, units, resident):
    """Depth chunks for ``units`` (tile, sample) pairs of ``d`` depths, each
    chunk one work item, on a card that holds ``resident`` blocks at once:
    the fewest items a block (``per``) times (depths a chunk + 0.5, its
    set-up); the fewest chunks win a tie. Returns (dc, chunks, per)."""
    best = None
    for c in range(1, d + 1):
        dc = -(-d // c)
        chunks = -(-d // dc)
        per = -(-units * chunks // resident)
        key = (per * (dc + 0.5), chunks, dc, per)
        best = key if best is None or key < best else best
    return best[2], best[1], best[3]


def _stem_tf32_smem(th, rawp, slot):
    """Bytes of ``stem_tf32_kernel``'s block: the weight fragments, the
    warps' output staging, the raw box, the channel constants and the
    ring's hi and lo planes."""
    return 16 * 16 * 2 * 32 + 4 * (8 * 16 * _STF_YP + (th + 4) * rawp +
                                   4 * 16 + 2 * K * slot)


def conv5_stem_tf32_geometry(n, d, h, w):
    """Launch geometry of ``stem_tf32_kernel`` (``csrc/conv5_stem_tf32.cu``),
    a dict (a fresh copy of a cached one):

    * ``th`` x ``twd``: the block's (h, w) tile, at most 512 voxels packed
      row-major onto M (:func:`_stem_tile`; whole rows where W <= 64),
      ``tiles_w`` of them along W; warp i owns voxels 64 i .. 64 i + 63;
    * ``rawp``: the raw box's row pitch (from 4 columns left of the tile,
      twd + 6 rounded up to 4); ``rowp``, ``slot``: the ring's pitches, the
      least that hold a row of twd + 4 and th + 4 rows with rowp = 8 mod
      16 (the kh quad's four rows 8 banks apart, and a kw quad's two rows
      apart while rowp < twd + 22) and slot = 8 mod 32 (the kd quad's
      slots 8 banks apart but for the first and fifth); ``smem``;
      ``blocks_per_sm``: 2 where two blocks fit, else 1 (a tall tile
      halves first, :func:`_stem_fit`);
    * ``dc``: output depths a block walks, ``chunks`` of them cover D: the
      count that makes the launch shortest, a wave of blocks costing its
      depths plus half a depth of set-up (:func:`_stem_chunks`); ``grid``:
      (tiles, n * chunks); ``threads``: 256."""
    return dict(_stem_tf32_geometry(n, d, h, w))


@functools.lru_cache(maxsize=None)
def _stem_tf32_geometry(n, d, h, w):
    tiles_w, twd, th = _stem_tile(w, h, 64, _STF_VOX)
    rawp = _round4(twd + 6)

    def layout(th):
        rowp = _lift(8, twd + 4, 16)
        slot = _lift(8, (th + 4) * rowp)
        return dict(rowp=rowp, slot=slot,
                    smem=_stem_tf32_smem(th, rawp, slot))

    th, q, blocks_per_sm = _stem_fit(h, th, layout)
    tiles = -(-h // th) * tiles_w
    dc, chunks, _ = _stem_chunks(d, tiles * n, blocks_per_sm * _SMS)
    return dict(th=th, twd=twd, tiles_w=tiles_w, rawp=rawp, **q,
                blocks_per_sm=blocks_per_sm, dc=dc, chunks=chunks,
                grid=(tiles, n * chunks), threads=256)


def _pack_weights_stem_tf32(w):
    """[5, 5, 5, 1, Co] f32 -> ``stem_tf32_kernel``'s pre-split weights [16
    k8 steps, 2 n8 tiles, 32 lanes, 4] f32: lane (g, t) of n8 tile f at k
    step s holds (hi(b0), hi(b1), lo(b0), lo(b1)) (:func:`split_tf32`) of b0
    = W[column 8 s + t][8 f + g], b1 = W[column 8 s + 4 + t][8 f + g], the
    columns of :func:`stem_tf32_columns`; zero-weight columns and channels
    past Co are zero."""
    co = w.shape[4]
    wf = F.pad(w.float().reshape(K, K, K, co), (0, _STEM_CO - co))
    # the columns in order, from slices (no host index: a CUDA graph
    # captures the packing): kw 0..3 of the 25 (kd, kh) rows, kh 0..3 at kw
    # 4 of the 5 kd, kd 0..3 at (4, 4), the tap (4, 4, 4) and three zeros
    cols = torch.cat((wf[:, :, :4].reshape(-1, _STEM_CO),
                      wf[:, :4, 4].reshape(-1, _STEM_CO), wf[:4, 4, 4],
                      wf[4, 4, 4:], wf.new_zeros((3, _STEM_CO))))
    hi, lo = split_tf32(cols)
    # [hl, s, half, t, f, g] -> [s, f, g, t, hl, half]
    return torch.stack((hi, lo)).reshape(2, 16, 2, 4, 2, 8).permute(
        1, 4, 5, 3, 0, 2).contiguous().reshape(16, 2, 32, 4)


def conv5_wgrad_stem_tf32_geometry(n, d, h, w):
    """Launch geometry of ``stem_wgrad_tf32_kernel``
    (``csrc/conv5_stem_wgrad_tf32.cu``), a dict (a fresh copy of a cached
    one):

    * ``th`` x ``twd``: the (h, w) tile of a work item, at most 256 voxels
      packed row-major onto K (:func:`_stem_tile`; whole rows where W <=
      32), ``tiles_w`` along W, ``tiles`` in all; warp i takes voxels 32 i
      .. 32 i + 31 of every depth;
    * ``rawp``: the raw x box's row pitch; ``order``, ``rowp``, ``slot``:
      the tap order on N and the ring's pitches, rowp = 4 and slot = 20 mod
      32 (order 0) or 20 and 4 (order 1), whichever ring is smaller, so
      that a B load's eight 4-word windows lie on distinct banks (the
      kernel's tap order: ``col_tap`` of its source); ``smem``: three copy
      stages
      (raw g [16][260], raw x box), the ring of ten slots, hi and lo, and
      the lanes' voxel offsets (8 x 256 words);
      ``blocks_per_sm``;
    * ``dc``: the depths of an item, ``chunks`` of them cover D; ``items``
      = n * chunks * tiles, ``per`` of them a block, ``blocks`` (the grid)
      at most one wave: the fewest ``per`` times (dc + 0.5) (the fewest
      chunks win a tie); each block writes one partial dW and a second
      pass adds them in block order; ``threads``: 256."""
    return dict(_stem_wgrad_tf32_geometry(n, d, h, w))


@functools.lru_cache(maxsize=None)
def _stem_wgrad_tf32_geometry(n, d, h, w):
    tiles_w, twd, th = _stem_tile(w, h, 32, _SWF_VOX)
    rawp = _round4(twd + 6)

    def layout(th):
        rings = []
        for order, (rr, ss) in enumerate(((4, 20), (20, 4))):
            rowp = _lift(rr, twd + 4)
            rings.append((_lift(ss, (th + 4) * rowp), order, rowp))
        slot, order, rowp = min(rings)
        return dict(order=order, rowp=rowp, slot=slot, smem=4 * (
            3 * 16 * _SWF_GP + 3 * (th + 4) * rawp + 4 * K * slot + 8 * 256))

    th, q, blocks_per_sm = _stem_fit(h, th, layout)
    tiles = -(-h // th) * tiles_w
    dc, chunks, per = _stem_chunks(d, tiles * n, blocks_per_sm * _SMS)
    items = n * chunks * tiles
    blocks = -(-items // per)
    return dict(th=th, twd=twd, tiles_w=tiles_w, tiles=tiles, rawp=rawp,
                **q, blocks_per_sm=blocks_per_sm, dc=dc, chunks=chunks,
                items=items, per=per, blocks=blocks, grid=(blocks,),
                threads=256)


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


def _stem_tc_launch(xk, w, b, epk, y):
    """``stem_tc_kernel`` of ``xk`` [N, D, 1, H, W] into ``y``, with the
    packed epilogue ``epk`` or None."""
    n, d, _, h, ww = xk.shape
    q = conv5_stem_tc_geometry(n, d, h, ww)
    if q["grid"][1] > 65535:
        raise ValueError("conv5 stem launch too large for {}".format(
            tuple(xk.shape)))
    wpk = _packed_weight(w, "stem")
    bias = b.float().contiguous()
    xs, ys = xk.stride(), y.stride()
    with _on_device(xk.device) as stream:
        rc = _conv5_stem_lib().conv5_stem_tc_launch(
            xk.data_ptr(), wpk.data_ptr(), bias.data_ptr(),
            None if epk is None else epk.data_ptr(), y.data_ptr(), q["dc"],
            n, d, h, ww, y.shape[2], xs[0], xs[1], xs[3], ys[0], ys[2],
            ys[1], ys[3], stream)
    if rc != 0:
        raise RuntimeError("conv5 stem kernel launch failed: CUDA error "
                           "{}".format(rc))


def _stem_tf32_launch(xk, w, b, epk, y):
    """``stem_tf32_kernel`` of the f32 ``xk`` [N, D, 1, H, W] into ``y``,
    with the packed epilogue ``epk`` or None."""
    if xk.dtype != torch.float32:
        raise TypeError("the f32 stem kernel takes float32, got {}".format(
            xk.dtype))
    n, d, _, h, ww = xk.shape
    q = _stem_tf32_geometry(n, d, h, ww)
    if (q["grid"][1] > 65535 or q["grid"][0] >= 2 ** 31
            or q["smem"] > _SMEM_MAX):
        raise ValueError("conv5 f32 stem launch too large for {}: {}".format(
            tuple(xk.shape), q))
    wpk = _packed_weight(w, "stem_tf32")
    bias = b.float().contiguous()
    xs, ys = xk.stride(), y.stride()
    vec = int(xk.data_ptr() % 16 == 0 and
              all(v % 4 == 0 for v in (xs[0], xs[1], xs[3])) and
              (q["twd"] % 4 == 0 or q["tiles_w"] == 1))
    with _on_device(xk.device) as stream:
        rc = _stem_tf32_lib().conv5_stem_tf32_launch(
            xk.data_ptr(), wpk.data_ptr(), bias.data_ptr(),
            None if epk is None else epk.data_ptr(), y.data_ptr(), q["th"],
            q["twd"], q["tiles_w"], q["dc"], q["rowp"], q["slot"], q["rawp"],
            vec, n, d, h, ww, y.shape[2], xs[0], xs[1], xs[3], ys[0], ys[2],
            ys[1], ys[3], stream)
    if rc != 0:
        raise RuntimeError("conv5 f32 stem kernel launch failed: CUDA error "
                           "{}".format(rc))


def _tf32_launch(xk, w, b, epk, y, dgrad):
    """``conv5_tf32_kernel`` of the f32 ``xk`` [N, D, Ci, H, W] into the
    contiguous f32 ``y`` [N, D, Co, H, W]: the conv with ``w``, bias ``b``
    (or None) and the packed epilogue ``epk`` (or None), or with ``dgrad``
    the input gradient's conv of the cotangent ``xk``."""
    n, d, ci, h, ww = xk.shape
    co = y.shape[2]
    q = _tf32_geometry(n, d, h, ww, ci, co)
    if (q["smem"] > _SMEM_MAX or max(q["grid"][1:]) > 65535
            or q["grid"][0] >= 2 ** 31):
        raise ValueError("conv5 tf32 launch too large for {}: {}".format(
            tuple(xk.shape), q))
    wpk = _packed_weight(w, ("tf32", q["nf"]), dgrad)
    bias = None if b is None else b.float().contiguous()
    part = (torch.empty((q["splits"], y.numel()), dtype=torch.float32,
                        device=xk.device) if q["splits"] > 1 else None)
    xs = xk.stride()
    vec = int(xk.data_ptr() % 16 == 0 and all(v % 4 == 0 for v in xs[:4]))
    with _on_device(xk.device) as stream:
        rc = _conv5_tf32_lib().conv5_tf32_launch(
            xk.data_ptr(), wpk.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if epk is None else epk.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), q["nf"], q["td"],
            q["th"], q["tw"], q["pitch"], q["plane"], q["splits"], vec, n, d,
            ci, h, ww, co, xs[0], xs[2], xs[1], xs[3], stream)
    if rc != 0:
        raise RuntimeError("conv5 tf32 kernel launch failed: CUDA error "
                           "{}".format(rc))


def _conv5_cuda(xk, w, b, kind, ep, dgrad=False, form=None):
    """Launch the forward kernel on ``xk``: the conv with ``w`` and bias
    ``b``, or with ``dgrad`` the input gradient of that conv (``xk`` is
    the cotangent, ``b`` is None), which counts under ``conv5_dgrad`` (f32:
    ``conv5_dgrad_tf32``) in :data:`LAUNCHES` where a forward counts under
    its form (:func:`conv5_form`); ``form='stem'`` takes ``conv5_kernel``
    where ``stem_tc_kernel`` or ``stem_tf32_kernel`` would run, and
    ``form='head'`` takes it where
    ``conv5_tf32_kernel`` would (an f32 head conv, forward or input
    gradient), to time the two side by side."""
    if xk.device.type != "cuda":
        raise RuntimeError("conv5 kernel needs a CUDA tensor, got device "
                           + str(xk.device))
    for t in (w,) + (() if b is None else (b,)) + tuple(ep or ()):
        if t.device != xk.device:
            raise RuntimeError("conv5 operands on {} and {}".format(
                xk.device, t.device))
    if xk.stride(4) != 1:
        raise ValueError("conv5 kernel needs W as the contiguous axis; "
                         "pin_kl the input first")
    n, d, ci, h, ww = xk.shape
    co = w.shape[3] if dgrad else w.shape[4]
    epk = (None if ep is None else
           torch.cat([v.float().reshape(-1) for v in ep]).contiguous())
    y = torch.empty((n, d, co, h, ww), dtype=xk.dtype, device=xk.device)
    form = form or conv5_form(xk, co, kind)
    key = form
    if dgrad:
        key = "dgrad_tf32" if form == "head_tf32" else "dgrad"
    if form in ("stem_tc", "stem_tf32", "head_tf32"):
        if form == "stem_tc":
            _stem_tc_launch(xk, w, b, epk, y)
        elif form == "stem_tf32":
            _stem_tf32_launch(xk, w, b, epk, y)
        else:
            _tf32_launch(xk, w, b, epk, y, dgrad)
        LAUNCHES["conv5_" + key] += 1
        if ep is not None:
            LAUNCHES["conv5_fused_epilogue"] += 1
        return y
    part = None
    # bf16 head convs run on the tensor cores; stems wider than the stem
    # kernels' 16 channels (and any conv forced to form 'head' / 'stem')
    # on the CUDA cores
    if xk.dtype == torch.bfloat16 and kind == "head":
        q = _wg_geometry(n, d, h, ww, ci, co)
        if (q["smem"] > _SMEM_MAX // q["blocks_per_sm"]
                or max(q["grid"][1:]) > 65535):
            raise ValueError("conv5 launch too large for {}: {}".format(
                tuple(xk.shape), q))
        wpk = _packed_weight(w, q["nt"], dgrad)
        bias = None if b is None else b.float().contiguous()
        if q["splits"] > 1:
            part = torch.empty((q["splits"], y.numel()), dtype=torch.float32,
                               device=xk.device)
        fn = _conv5_wg_lib().conv5_wg_launch
        ptrs = (None if part is None else part.data_ptr(),)
        cfg = (q["nt"], q["td"], q["th"], q["tw"], q["sw"], q["splits"],
               int(dgrad))
    else:
        if dgrad:  # the same conv on the flipped, io-transposed weight
            w = w.flip(0, 1, 2).transpose(3, 4)
        th, tw, cot = conv5_geometry(n, d, h, ww, co)
        if d > 65535 or n * -(-co // cot) > 65535:
            raise ValueError("conv5 grid too large for {}".format(
                tuple(xk.shape)))
        wpk = _pack_weights(w, xk.dtype, cot)
        bias = (torch.zeros((co,), dtype=torch.float32, device=xk.device)
                if b is None else b.float().contiguous())
        fn, ptrs = _conv5_lib().conv5_launch, ()
        cfg = (_DTYPES[xk.dtype], int(kind == "stem"), cot, th, tw)
    xs, ys = xk.stride(), y.stride()
    with _on_device(xk.device) as stream:
        rc = fn(xk.data_ptr(), wpk.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if epk is None else epk.data_ptr(), y.data_ptr(),
                *ptrs, *cfg, n, d, ci, h, ww, co,
                xs[0], xs[2], xs[1], xs[3], ys[0], ys[2], ys[1], ys[3],
                stream)
    if rc != 0:
        raise RuntimeError("conv5 kernel launch failed: CUDA error {}".format(
            rc))
    LAUNCHES["conv5_" + key] += 1
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
    (head form) on the spatially flipped, io-transposed weight with no
    bias, counted under ``conv5_dgrad`` (f32: ``conv5_dgrad_tf32``): in
    bf16 the packed weight is io-transposed by index and the kernel walks
    the taps backwards; in f32 the packing flips and transposes it."""
    if gk.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (K, K, K) \
            or w.shape[4] != gk.shape[2]:
        raise ValueError("dgrad of g {} with weight {}".format(
            tuple(gk.shape), tuple(w.shape)))
    if gk.dtype not in _DTYPES:
        raise TypeError("conv5 takes float32 or bfloat16, got {}".format(
            gk.dtype))
    if gk.device.type == "cpu":
        return conv5_dgrad_kl_plain(gk, w)
    return _conv5_cuda(gk, w, None, "head", None, dgrad=True)


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


def _tma_view(t):
    """A view the tensor copy can describe: base on 16 bytes, W contiguous,
    every other stride a positive multiple of 8 elements (16 bytes)."""
    return (t.data_ptr() % 16 == 0 and t.stride(4) == 1 and
            all(s > 0 and s % 8 == 0 for s in t.stride()[:4]))


def conv5_wgrad_form(xk, gk, kind):
    """The weight-gradient kernel that takes these operands, named by its
    :data:`LAUNCHES` entry (``'conv5_wgrad_' + form``): for stems (``kind
    = 'stem'``, Ci = 1) with Co <= 16 'stem_tc' (bf16:
    ``stem_wgrad_tc_kernel``) or 'stem_tf32' (f32:
    ``stem_wgrad_tf32_kernel``), both at any W-contiguous view, and for
    wider stems 'stem' (``wgrad_kernel``); for every other f32 conv 'tf32'
    (``wgrad_tf32_kernel``, any W-contiguous views); for bf16 narrow heads
    (Co <= 16) ``wgrad_head_tma_kernel``, 'head_tma' where a tensor copy
    can describe both views, else 'head_ragged' (its software producer);
    for wider bf16 convs ``wgrad_tma_kernel``, 'tma' or 'ragged' alike.
    'head' and 'mid' (``wgrad_mma_kernel<1|2>`` / ``<4>``; ``wgrad_kernel``
    in f32) run only where ``form=`` forces them. Every view of the main
    path is contiguous after :func:`pin_kl`: the cube's and the flagship's
    (W a multiple of 8) take 'stem_tc', 'head_tma' and 'tma'; the spine
    recipe's rows of W = 12, 9, 4 and 2 elements take 'ragged'; in f32 the
    stem is 'stem_tf32' and every other conv 'tf32'."""
    if kind == "stem":
        if gk.shape[2] > _STEM_CO:
            return "stem"
        return "stem_tf32" if xk.dtype == torch.float32 else "stem_tc"
    if xk.dtype == torch.float32:
        return "tf32"
    copyable = _tma_view(xk) and _tma_view(gk)
    if gk.shape[2] <= 16:
        return "head_tma" if copyable else "head_ragged"
    return "tma" if copyable else "ragged"


def soft_vec(t):
    """How the software producer copies a W-contiguous bf16 view: 8 or 4
    (cp.async of that many bytes) where the base and every stride keep each
    row on that many bytes, else 0 (aligned 32-bit loads realigned with
    ``__byte_perm``)."""
    ptr, strides = t.data_ptr(), t.stride()[:4]
    for vec in (8, 4):
        if ptr % vec == 0 and all(2 * v % vec == 0 for v in strides):
            return vec
    return 0


def _soft_warps():
    return dict(producer_warps=_SOFT_WARPS,
                producer_warps_realigned=_SOFT_WARPS_REALIGNED,
                soft_threads=32 * (2 * K + max(_SOFT_WARPS,
                                               _SOFT_WARPS_REALIGNED)))


def _soft_span(cols, left, tw, w):
    """The box columns [c0, c1) the software producer writes, multiples of
    4, of a box ``cols`` wide that starts ``left`` columns left of its
    tile: where W fits one tile, the columns that hold the row (the rest
    are padding in every tile and stay zero), else all of them."""
    if w > tw:
        return (0, cols)
    return (left, min(cols, -(-(left + w) // 4) * 4))


def conv5_wgrad_stem_tc_geometry(n, d, h, w):
    """Launch geometry of ``stem_wgrad_tc_kernel``
    (``csrc/conv5_stem_wgrad.cu``), a dict: ``th`` x ``tw`` = 8 x 32, the
    (h, w) tile of a work item (warp i takes row i, two K steps of 16 w);
    ``dc``: the depths of an item, ``chunks`` of them cover D (more than one
    only where the volumes' tiles alone leave the card short of blocks, and
    at least 8 depths each: an item stages 4 input slices more than it
    has depths); ``tiles`` per depth chunk and volume; ``items`` = n *
    chunks * tiles, ``per`` of them a block, so that ``blocks`` (the grid)
    is one wave of two blocks an SM; each block writes one partial dW (125
    x Co f32) and a second pass adds them in block order; ``threads``;
    ``smem``: the ring of ten input slots (12 rows of 44 words, 540 words a
    slot: two copies of each row, the second one element to the right) and
    three g slices (16 channels x 132 words; the copy-engine ring of the
    main path, one slice on the register path), static; ``blocks_per_sm``:
    2 (its ``__launch_bounds__``: at most 128 registers a thread, 64 of
    them accumulators)."""
    tiles = -(-h // 8) * -(-w // 32)
    chunks = max(1, min(d // 8, _STEM_WG_RESIDENT // (n * tiles)))
    dc = -(-d // chunks)
    chunks = -(-d // dc)
    items = n * chunks * tiles
    per = -(-items // _STEM_WG_RESIDENT)
    blocks = -(-items // per)
    return dict(th=8, tw=32, dc=dc, chunks=chunks, tiles=tiles, items=items,
                per=per, blocks=blocks, grid=(blocks,), threads=256,
                smem=4 * (10 * 540 + 3 * 16 * 132), blocks_per_sm=2)


def conv5_wgrad_tma_geometry(n, d, h, w, ci, co):
    """Launch geometry of ``wgrad_tma_kernel`` (``csrc/conv5_wgrad_tma.cu``),
    a dict (a fresh copy of a cached one):

    * ``th`` x ``tw``: the voxel tile of one ring stage (tw 8, 16 or 32 by
      W; th up to 8 rows, even: at tw = 8 a K step spans two rows);
    * ``xrows`` x ``xw``: the x box of a stage per channel, the tile with
      its 2-voxel halo, starting 8 columns left of the tile (a box starts
      on 16 bytes); ``grows`` x ``gw``: the g box. Both are padded by one
      row and, where needed, 8 columns, so that each channel of a box is an
      odd number of 16-byte units (conflict-free fragment loads);
    * ``x_bytes``, ``g_bytes``, ``stage``: bytes of the boxes (32 channels
      each) and of a stage; ``stages``: as many as fit the block's shared
      memory, 3 to 8; ``smem``: barriers and ring;
    * ``chan_blocks``: 5 depth taps x (Ci / 32) x (Co / 32) blocks, each
      holding 25 taps x 32 x 32 f32 accumulators (100 KB of registers, 80
      a thread over 10 warps, one block per SM); ``splits``: blocks along
      the voxel tiles (:func:`_wgrad_tma_splits`); ``grid``;
    * ``threads``: 10 consumer warps and the loader warp;
    * the software producer's ('ragged': views a tensor copy cannot
      describe): ``producer_warps`` in place of the loader warp where
      both views are copied by cp.async, ``producer_warps_realigned``
      where one is read by realigned loads (:func:`soft_vec` 0),
      ``soft_threads`` (the block at the larger count), and ``xspan`` /
      ``gspan``, the box columns [c0, c1) it writes (:func:`_soft_span`;
      the ring starts zeroed)."""
    return dict(_wgrad_tma_geometry(n, d, h, w, ci, co))


@functools.lru_cache(maxsize=None)
def _wgrad_tma_geometry(n, d, h, w, ci, co):
    tw = 8 if w <= 8 else 16 if w <= 16 else 32
    th = max(2, min(8, _pow2ceil(h)))
    xw = tw + 16 if (tw + 16) // 8 % 2 else tw + 24
    gw = tw if tw // 8 % 2 else tw + 8
    xrows, grows = th + 2 * P + 1, th + 1
    x_bytes, g_bytes = 64 * xrows * xw, 64 * grows * gw
    stage = x_bytes + g_bytes
    stages = min(_TMA_MAX_STAGES, (_SMEM_MAX - _TMA_BAR_BYTES) // stage)
    tiles = n * d * -(-h // th) * -(-w // tw)
    chan_blocks = K * -(-ci // 32) * -(-co // 32)
    splits = _wgrad_tma_splits(tiles, th * tw, chan_blocks, ci, co)
    return dict(th=th, tw=tw, xrows=xrows, xw=xw, grows=grows,
                gw=gw, x_bytes=x_bytes, g_bytes=g_bytes, stage=stage,
                stages=stages, smem=_TMA_BAR_BYTES + stages * stage,
                chan_blocks=chan_blocks, splits=splits,
                grid=(chan_blocks, splits), threads=32 * (2 * K + 1),
                **_soft_warps(), xspan=_soft_span(xw, 8, tw, w),
                gspan=_soft_span(gw, 0, tw, w))


def conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co):
    """Launch geometry of ``wgrad_head_tma_kernel``
    (``csrc/conv5_wgrad_tma.cu``), the narrow head's weight gradient with
    the taps on g, a dict (a fresh copy of a cached one):

    * ``th`` x ``tw``: the voxel tile of one ring stage (tw 16 or 32 by W,
      the tensor copy filling columns past W with zeros; th up to 8 rows);
      a K step is 16 consecutive w of one row;
    * ``xrows`` x ``xw``: the x box per channel, the tile itself (no halo:
      x is not shifted), padded by 8 columns and to an odd row count so
      that each channel is an odd number of 16-byte units (conflict-free A
      loads); ``grows`` x ``gw``: the g box per (depth, channel), the tile
      with its 2-voxel halo in h and from 8 columns left of it (a box starts
      on 16 bytes), padded until the three channels one B load touches
      (each 6 words wide, a pitch apart) lie at least 6 banks apart;
    * ``x_bytes`` (32 channels), ``g_bytes`` (5 depths x 3 channels),
      ``stage`` (their sum rounded to 128 bytes); ``stages``: as many as
      fit the block's shared memory, at most 8; ``smem``;
    * ``chan_blocks``: (Ci / 32) x (Co / 3) blocks, each holding 25 (kd,
      kh) x 32 ci x 16 (co, kw) f32 accumulators twice, once per tile-row
      parity (100 KB of registers, 80 a thread over 10 warps, one block per
      SM); ``splits``: blocks along the voxel tiles, about one wave of
      blocks, each with a tile at least (the partials summed in split
      order by a second pass); ``grid``;
    * ``threads``: 10 consumer warps (depth tap x tile-row parity) and the
      loader warp;
    * the software producer's ('head_ragged'), as
      :func:`conv5_wgrad_tma_geometry`'s: ``producer_warps``,
      ``producer_warps_realigned``, ``soft_threads``, ``xspan`` (the x box
      starts at its tile) and ``gspan`` (8 columns left of it)."""
    return dict(_wgrad_head_tma_geometry(n, d, h, w, ci, co))


@functools.lru_cache(maxsize=None)
def _wgrad_head_tma_geometry(n, d, h, w, ci, co):
    tw = 16 if w <= 16 else 32
    th = max(1, min(8, _pow2ceil(h)))
    xw, xrows = tw + 8, th + 1 - th % 2
    gw0 = -(-(tw + 10) // 8) * 8

    def fits(rows, cols):
        pitch = rows * cols // 2
        return all(6 <= k * pitch % 32 <= 26 for k in (1, 2))

    grows, gw = min(((r, c) for r in range(th + 4, th + 12)
                     for c in (gw0, gw0 + 8, gw0 + 16) if fits(r, c)),
                    key=lambda rc: (rc[0] * rc[1], rc))
    x_bytes, g_bytes = 64 * xrows * xw, 2 * 15 * grows * gw
    stage = -(-(x_bytes + g_bytes) // 128) * 128
    stages = min(_TMA_MAX_STAGES, (_SMEM_MAX - _TMA_BAR_BYTES) // stage)
    tiles = n * d * -(-h // th) * -(-w // tw)
    chan_blocks = -(-ci // 32) * -(-co // 3)
    splits = max(1, min(tiles, 65535, -(-_SMS // chan_blocks)))
    splits = -(-tiles // -(-tiles // splits))
    return dict(th=th, tw=tw, xrows=xrows, xw=xw, grows=grows, gw=gw,
                x_bytes=x_bytes, g_bytes=g_bytes, stage=stage, stages=stages,
                smem=_TMA_BAR_BYTES + stages * stage, chan_blocks=chan_blocks,
                splits=splits, grid=(chan_blocks, splits),
                threads=32 * (2 * K + 1), **_soft_warps(),
                xspan=_soft_span(xw, 0, tw, w), gspan=_soft_span(gw, 8, tw, w))


def _wgrad_tma_splits(tiles, tile_vox, chan_blocks, ci, co):
    """Blocks along the voxel tiles for ``chan_blocks`` channel blocks, one
    block per SM: the count that makes the launch shortest by a model in
    microseconds. A wave of blocks takes its tiles' mma work at 4.5 TF/s
    an SM (60% of an SM's share of 989 TF/s, what ``mma.sync`` can reach)
    plus 3 us of set-up and stores; a split launch adds the second pass,
    which reads the partials and writes dW (2.5 TB/s). The smallest count
    wins a tie."""
    flop_tile = 2.0 * K * K * 32 * 32 * tile_vox

    def cost(s):
        waves = -(-chan_blocks * s // _SMS)
        block = -(-tiles // s) * flop_tile / 4.5e6 + 3.0
        return waves * block + (s > 1) * (s + 1) * 500.0 * ci * co / 2.5e6

    return min(range(1, min(tiles, 65535) + 1), key=lambda s: (cost(s), s))


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


def _stem_wgrad_tc_launch(xk, gk):
    """``stem_wgrad_tc_kernel`` of ``xk`` [N, D, 1, H, W] and ``gk`` [N, D,
    Co, H, W] -> f32 [5, 5, 5, 1, Co]."""
    n, d, _, h, ww = xk.shape
    co = gk.shape[2]
    q = conv5_wgrad_stem_tc_geometry(n, d, h, ww)
    out = torch.empty((K, K, K, 1, co), dtype=torch.float32,
                      device=xk.device)
    part = (torch.empty((q["blocks"], K * K * K * co), dtype=torch.float32,
                        device=xk.device) if q["blocks"] > 1 else None)
    xs, gs = xk.stride(), gk.stride()
    with _on_device(xk.device) as stream:
        rc = _stem_wgrad_lib().conv5_stem_wgrad_tc_launch(
            xk.data_ptr(), gk.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            q["dc"], q["per"], q["blocks"], n, d, h, ww, co, xs[0], xs[1],
            xs[3], gs[0], gs[2], gs[1], gs[3], stream)
    if rc != 0:
        raise RuntimeError("stem wgrad kernel launch failed: CUDA error "
                           "{}".format(rc))
    return out


def _stem_wgrad_tf32_launch(xk, gk):
    """``stem_wgrad_tf32_kernel`` of the f32 ``xk`` [N, D, 1, H, W] and
    ``gk`` [N, D, Co, H, W] -> f32 [5, 5, 5, 1, Co]."""
    if xk.dtype != torch.float32 or gk.dtype != torch.float32:
        raise TypeError("the f32 stem weight gradient takes float32, got {} "
                        "and {}".format(xk.dtype, gk.dtype))
    n, d, _, h, ww = xk.shape
    co = gk.shape[2]
    q = _stem_wgrad_tf32_geometry(n, d, h, ww)
    if q["smem"] > _SMEM_MAX:
        raise ValueError("f32 stem wgrad launch too large for {}: {}".format(
            tuple(xk.shape), q))
    out = torch.empty((K, K, K, 1, co), dtype=torch.float32,
                      device=xk.device)
    part = (torch.empty((q["blocks"], K * K * K * co), dtype=torch.float32,
                        device=xk.device) if q["blocks"] > 1 else None)
    xs, gs = xk.stride(), gk.stride()
    # 16-byte g copies take 4 voxels of a row whole: W a multiple of 4 (a
    # W slice of a wider row would read the row beyond it)
    vec = int(ww % 4 == 0 and q["twd"] % 4 == 0 and
              xk.data_ptr() % 16 == 0 and gk.data_ptr() % 16 == 0 and
              all(v % 4 == 0 for v in (xs[0], xs[1], xs[3]) + gs[:4]))
    with _on_device(xk.device) as stream:
        rc = _stem_wgrad_tf32_lib().conv5_stem_wgrad_tf32_launch(
            xk.data_ptr(), gk.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            q["th"], q["twd"], q["tiles_w"], q["dc"], q["per"], q["blocks"],
            q["rowp"], q["slot"], q["rawp"], q["order"], vec, n, d, h, ww, co,
            xs[0], xs[1], xs[3], gs[0], gs[2], gs[1], gs[3], stream)
    if rc != 0:
        raise RuntimeError("f32 stem wgrad kernel launch failed: CUDA error "
                           "{}".format(rc))
    return out


def _wgrad_tf32_launch(xk, gk):
    """``wgrad_tf32_kernel`` of the f32 ``xk`` [N, D, Ci, H, W] and ``gk``
    [N, D, Co, H, W] -> f32 [5, 5, 5, Ci, Co]."""
    n, d, ci, h, ww = xk.shape
    co = gk.shape[2]
    q = _wgrad_tf32_geometry(n, d, h, ww, ci, co)
    if q["smem"] > _SMEM_MAX or q["splits"] > 65535:
        raise ValueError("wgrad tf32 launch too large for {}: {}".format(
            tuple(xk.shape), q))
    out = torch.empty((K, K, K, ci, co), dtype=torch.float32,
                      device=xk.device)
    part = (torch.empty((q["splits"], out.numel()), dtype=torch.float32,
                        device=xk.device) if q["splits"] > 1 else None)
    xs, gs = xk.stride(), gk.stride()
    vec = int(all(t.data_ptr() % 16 == 0 and all(v % 4 == 0 for v in
                                                   t.stride()[:4])
                  for t in (xk, gk)))
    with _on_device(xk.device) as stream:
        rc = _wgrad_tf32_lib().conv5_wgrad_tf32_launch(
            xk.data_ptr(), gk.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            q["nf"], q["th"], q["tw"], q["xplane"], q["gplane"], vec,
            q["splits"], n, d, ci, h, ww, co, xs[0], xs[2], xs[1], xs[3],
            gs[0], gs[2], gs[1], gs[3], stream)
    if rc != 0:
        raise RuntimeError("wgrad tf32 kernel launch failed: CUDA error "
                           "{}".format(rc))
    return out


def _conv5_wgrad_cuda(xk, gk, kind, form=None):
    """Launch the weight-gradient kernel that :func:`conv5_wgrad_form`
    names; ``form='mid'`` / ``'head'`` takes ``wgrad_mma_kernel`` (bf16)
    where a tensor-copy kernel would run and ``wgrad_kernel`` (f32) where
    ``wgrad_tf32_kernel`` would, and ``form='stem'`` takes ``wgrad_kernel``
    where ``stem_wgrad_tc_kernel`` or ``stem_wgrad_tf32_kernel`` would, to
    time the two side by side;
    ``form='ragged'`` / ``'head_ragged'`` takes the software producer on a
    view a tensor copy could describe too (bf16 only)."""
    if xk.device.type != "cuda" or gk.device != xk.device:
        raise RuntimeError("wgrad kernel needs CUDA tensors on one device, "
                           "got {} and {}".format(xk.device, gk.device))
    if xk.stride(4) != 1 or gk.stride(4) != 1:
        raise ValueError("wgrad kernel needs W as the contiguous axis; "
                         "pin_kl the operands first")
    n, d, ci, h, ww = xk.shape
    co = gk.shape[2]
    form = form or conv5_wgrad_form(xk, gk, kind)
    if form in ("stem_tc", "stem_tf32", "tf32"):
        launch = {"stem_tc": _stem_wgrad_tc_launch,
                  "stem_tf32": _stem_wgrad_tf32_launch,
                  "tf32": _wgrad_tf32_launch}[form]
        out = launch(xk, gk)
        LAUNCHES["conv5_wgrad_" + form] += 1
        return out
    # bf16 on the tensor cores; f32, and the stem where forced, on the CUDA
    # cores (f32 keeps exact f32 products and sums)
    mma = xk.dtype == torch.bfloat16 and form in ("head", "mid")
    if form in ("tma", "ragged", "head_tma", "head_ragged") and (
            xk.dtype != torch.bfloat16 or gk.dtype != torch.bfloat16):
        raise TypeError("the {} weight gradient takes bf16 operands, got "
                        "{}".format(form, xk.dtype))
    if form in ("tma", "ragged"):
        q = conv5_wgrad_tma_geometry(n, d, h, ww, ci, co)
    elif form in ("head_tma", "head_ragged"):
        q = conv5_wgrad_head_tma_geometry(n, d, h, ww, ci, co)
    elif mma:
        q = conv5_wgrad_mma_geometry(n, d, h, ww, ci, co)
    else:
        q = conv5_wgrad_geometry(n, d, h, ww, ci, co, kind)
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
    if form in ("tma", "head_tma"):
        lib = _wgrad_tma_lib()
        fn = (lib.conv5_wgrad_tma_launch if form == "tma" else
              lib.conv5_wgrad_head_tma_launch)
        cfg = (q["th"], q["tw"], q["xrows"], q["xw"], q["grows"], q["gw"],
               q["stages"], q["splits"])
    elif form in ("ragged", "head_ragged"):
        lib = _wgrad_tma_lib()
        fn = (lib.conv5_wgrad_ragged_launch if form == "ragged" else
              lib.conv5_wgrad_head_ragged_launch)
        xvec, gvec = soft_vec(xk), soft_vec(gk)
        pw = q["producer_warps_realigned" if min(xvec, gvec) == 0 else
               "producer_warps"]
        cfg = (q["th"], q["tw"], q["xrows"], q["xw"], q["grows"], q["gw"],
               q["stages"], q["splits"], pw, xvec, gvec, *q["xspan"],
               *q["gspan"])
    elif mma:
        fn = _wgrad_lib().conv5_wgrad_mma_launch
        cfg = (q["nf"], q["th"], q["tw"], q["xcs"], q["gcs"], q["splits"])
    else:
        fn = _wgrad_lib().conv5_wgrad_launch
        cfg = (_DTYPES[xk.dtype], q["ci_t"], q["cig"], q["cog"], q["kdn"],
               q["vs"], q["th"], q["tw"], q["cis"], q["cos"], q["splits"])
    with _on_device(xk.device) as stream:
        rc = fn(*ptrs, *cfg, n, d, ci, h, ww, co, xs[0], xs[2], xs[1], xs[3],
                gs[0], gs[2], gs[1], gs[3], stream)
    if rc != 0:
        raise RuntimeError("wgrad kernel launch failed: CUDA error {}".format(
            rc))
    LAUNCHES["conv5_wgrad_" + form] += 1
    return out


def conv5_wgrad_kl(xk, gk, kind="head"):
    """Weight gradient of :func:`conv5_kl`: ``xk`` [N, D, Ci, H, W] and the
    cotangent ``gk`` [N, D, Co, H, W] (same dtype, W contiguous) -> f32
    [5, 5, 5, Ci, Co]. One wrapper for every conv of V-Net (stem, narrow
    head, square and wide stacks): bf16 runs on the tensor cores, the
    square and wide convs through ``wgrad_tma_kernel`` and the narrow heads
    through ``wgrad_head_tma_kernel`` (rings fed by tensor copies, or by
    their software producer on views a tensor copy cannot describe:
    :func:`conv5_wgrad_form`), and the stem (Ci = 1, Co <= 16) through
    ``stem_wgrad_tc_kernel``; f32 convs run on the tensor cores in split
    TF32 (``wgrad_tf32_kernel``; the stem ``stem_wgrad_tf32_kernel``); wider
    stems
    run on the CUDA cores (``wgrad_kernel``); the voxel axis is reduced
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
    """conv5_kl with the backward of the JAX ``_conv5_kl_bwd``. Under a
    space mesh (``mesh`` not None) ``xk`` is the rank's H block: the JAX
    ``_cp_batchmap_kl`` forward and ``_conv5_kl_bwd`` through
    ``_cp_batchmap_kl`` / ``_cp_wgrad_kl`` (module docstring)."""

    @staticmethod
    def forward(ctx, xk, w, b, kind, mesh):
        ctx.kind, ctx.mesh = kind, mesh
        if mesh is not None:
            xk = halo_h(xk, mesh, P)
        ctx.save_for_backward(xk, w)
        return _unhalo(_conv5_forward(xk, w, b, kind), mesh)

    @staticmethod
    def backward(ctx, gk):
        xk, w = ctx.saved_tensors
        mesh = ctx.mesh
        gk = pin_kl(gk)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            ge = gk if mesh is None else halo_h(gk, mesh, P)
            dx = _unhalo(conv5_dgrad_kl(ge, w), mesh)
        if ctx.needs_input_grad[1]:
            ge = gk if mesh is None else F.pad(gk, (0, 0, P, P))
            dw = conv5_wgrad_kl(xk, ge, ctx.kind).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = gk.float().sum(dim=(0, 1, 3, 4))
        return dx, dw, db, None, None


def _space_mesh():
    """The active mesh where it splits the H axis, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.splits_h else None


def _unhalo(yk, mesh):
    """``yk`` without the P halo rows on each side of its H axis, where
    there is a space mesh."""
    return yk if mesh is None else yk[:, :, :, P:-P]


def conv5_kl(xk, w, b, kind="head"):
    """5^3 SAME conv in kernel layout: [N, D, Ci, H, W] -> [N, D, Co, H, W]
    in x's dtype. ``kind``: 'head' (any Ci) or 'stem' (Ci = 1).
    Differentiable in x, w and b; dx is skipped when x needs no gradient
    (the stem's input is the image). Under a space mesh ``xk`` is the
    rank's H block (module docstring)."""
    _check_conv(xk, w, b, kind, None)
    return _Conv5KL.apply(xk, w, b, kind, _space_mesh())


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
    mesh = _space_mesh()
    if mesh is not None:
        xk = halo_h(xk, mesh, P)
    return _unhalo(torch.ops.medicalseg.conv5_fused(xk, w, b, *ep, kind),
                   mesh)


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
    if not (torch.is_grad_enabled() and xk.requires_grad):
        return torch.ops.medicalseg.pin(xk)  # nothing to record
    return _PinKL.apply(xk)


@functools.lru_cache(maxsize=None)
def _pin_plan(shape, stride, itemsize, misaligned):
    return pin_plan(shape, stride, itemsize, misaligned)


def pin_plan(shape, stride, itemsize, ptr=0):
    """How the pin kernel copies a view of ``shape`` and element ``stride``
    whose first element lies at address ``ptr``, a dict. The innermost
    axes that are jointly contiguous form runs of ``run`` elements, the
    axes outside them (``outer_shape``, ``outer_stride``, size-1 axes
    dropped) index the runs. ``path`` is ``'vec16'`` (16-byte words over a
    flat grid) when runs, outer strides and the address are multiples of
    16 bytes, else ``'element'`` (a strided last axis, a misaligned base,
    odd runs)."""
    run, k = 1, len(shape)
    while k > 0 and (shape[k - 1] == 1 or stride[k - 1] == run):
        run *= shape[k - 1]
        k -= 1
    outer = [(s, t) for s, t in zip(shape[:k], stride[:k]) if s != 1]
    vec = (run * itemsize % 16 == 0 and ptr % 16 == 0 and len(outer) <= 4
           and all(t * itemsize % 16 == 0 for _, t in outer))
    return dict(path="vec16" if vec else "element", run=run,
                outer_shape=[s for s, _ in outer],
                outer_stride=[t for _, t in outer])


def _pin_cuda(xk):
    if xk.device.type != "cuda":
        raise RuntimeError("pin kernel needs a CUDA tensor, got device "
                           + str(xk.device))
    if xk.dim() != 5 or xk.element_size() not in (2, 4):
        raise ValueError("pin takes a 5-D tensor of 2- or 4-byte elements, "
                         "got {} {}".format(tuple(xk.shape), xk.dtype))
    y = torch.empty(xk.shape, dtype=xk.dtype, device=xk.device)
    if y.numel() == 0:
        return y
    size = xk.element_size()
    plan = _pin_plan(tuple(xk.shape), xk.stride(), size, xk.data_ptr() % 16)
    with _on_device(xk.device) as stream:
        if plan["path"] == "vec16":
            pad = 4 - len(plan["outer_shape"])
            sizes = [1] * pad + plan["outer_shape"]
            words = [0] * pad + [t * size // 16 for t in plan["outer_stride"]]
            rc = _pin_lib().pin_vec_launch(
                xk.data_ptr(), y.data_ptr(), y.numel() * size // 16,
                plan["run"] * size // 16, *sizes[1:], *words, stream)
        else:
            rc = _pin_lib().pin_launch(
                xk.data_ptr(), y.data_ptr(), size, *xk.shape, *xk.stride(),
                stream)
    if rc != 0:
        raise RuntimeError("pin kernel launch failed: CUDA error {}".format(
            rc))
    LAUNCHES["pin"] += 1
    return y


# ----------------------------------------------------------------------
# the eval forward's kernels as torch.library ops
# ----------------------------------------------------------------------
# ``torch.export`` traces a model with fake tensors, which have no
# ``data_ptr()`` for a ctypes launch. As ops of their own, the fused conv
# and the pin enter an exported program as single nodes: a fake
# implementation gives the tracer the output's shape, dtype and layout, and
# the program calls the CUDA implementation (the kernel) on the card and
# the CPU implementation (the plain version) on the CPU. No other device
# has an implementation, and neither op has a backward: the training path
# keeps its autograd Functions. Registered through ``torch.library.Library``
# rather than ``custom_op``, whose Python layers cost the host several
# times more a call.
_LIB = torch.library.Library("medicalseg", "DEF")
_LIB.define("conv5_fused(Tensor xk, Tensor w, Tensor b, Tensor inv, "
            "Tensor shift, Tensor alpha, str kind) -> Tensor")
_LIB.define("pin(Tensor xk) -> Tensor")


def _conv5_fused_op_cpu(xk, w, b, inv, shift, alpha, kind):
    """``medicalseg::conv5_fused`` (:func:`conv5_kl_fused` as an op): x [N,
    D, Ci, H, W] (W contiguous), w [5, 5, 5, Ci, Co], b and the epilogue
    (inv, shift, alpha) [Co] -> contiguous [N, D, Co, H, W] in x's dtype.
    The CPU implementation."""
    return conv5_kl_plain(xk, w, b, (inv, shift, alpha))


def _conv5_fused_op_cuda(xk, w, b, inv, shift, alpha, kind):
    return _conv5_cuda(xk, w, b, kind, (inv, shift, alpha))


def _conv5_fused_op_fake(xk, w, b, inv, shift, alpha, kind):
    n, d, _, h, ww = xk.shape
    return xk.new_empty((n, d, w.shape[4], h, ww))


def _pin_op_cpu(xk):
    """``medicalseg::pin``: a contiguous copy of ``xk`` (5-D, 2- or 4-byte
    elements on the card). The CPU implementation."""
    return pin_kl_plain(xk)


def _pin_op_cuda(xk):
    return _pin_cuda(xk)


def _pin_op_fake(xk):
    return torch.empty_like(xk, memory_format=torch.contiguous_format)


_LIB.impl("conv5_fused", _conv5_fused_op_cpu, "CPU")
_LIB.impl("conv5_fused", _conv5_fused_op_cuda, "CUDA")
torch.library.register_fake("medicalseg::conv5_fused", _conv5_fused_op_fake,
                            lib=_LIB)
_LIB.impl("pin", _pin_op_cpu, "CPU")
_LIB.impl("pin", _pin_op_cuda, "CUDA")
torch.library.register_fake("medicalseg::pin", _pin_op_fake, lib=_LIB)
