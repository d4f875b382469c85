# Copyright 2026. Apache License 2.0.
"""Fused HU window + resize of a raw CT volume, the ingest hot path.

Counterpart of ``medicalseg_tpu/ops/pallas_kernels.py``. A raw scan (e.g.
200 x 512 x 512 f32) is HU-windowed and resampled to the model's input
shape. :func:`hu_resize_d` fuses the window with the resize of the leading
(D) axis in the hand-written CUDA kernel of ``csrc/hu_resize.cu``, so the
windowed full-size volume never reaches device memory; the H and W
contractions then run as two small matrix products on the already reduced
volume (:func:`..resize.resize3d`).

:func:`hu_resize_d_plain` is the plain PyTorch version, ``W @ window(x)``
with the dense interpolation matrix. The wrapper takes it only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
:data:`LAUNCHES` counts the kernel's launches. The window's ``hu_min``,
``hu_max`` and ``hu_nan`` are passed through to the kernel (the JAX
package's kernel takes the defaults whatever its wrapper was given).
"""

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .intensity import hu_norm, hu_window
from .resize import _linear_matrix, _linear_taps, resize3d

LAUNCHES = {"hu_resize": 0}

_T_PER_BLOCK = 8  # output slices one block walks (csrc/hu_resize.cu)


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def linear_taps_d(in_size, out_size):
    """The kernel's view of ``_linear_matrix(in_size, out_size)``: (idx
    int32 [2, out] = lo, hi; wt float32 [2, out] = w0, w1), numpy arrays.
    Row t of the matrix is w0[t] at lo[t] plus w1[t] at hi[t]; the two are
    added where lo == hi (``in_size == 1``)."""
    lo, frac = _linear_taps(in_size, out_size)
    hi = np.minimum(lo + 1, in_size - 1)
    return (np.stack([lo, hi]).astype(np.int32),
            np.stack([1.0 - frac, frac]).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _taps_on(in_size, out_size, device):
    idx, wt = linear_taps_d(in_size, out_size)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt).to(device))


def hu_resize_d_plain(x, wmat, hu_min=-1200.0, hu_max=600.0,
                      hu_nan=-2000.0):
    """Plain PyTorch version of the kernel: ``wmat @ window(x)`` for x
    [D, H, W] float32 and the dense (out_d, D) matrix, in float32."""
    d, h, w = x.shape
    win = hu_window(x.reshape(d, h * w), hu_min, hu_max, hu_nan)
    return torch.matmul(wmat, win).reshape(wmat.shape[0], h, w)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("hu_resize")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hu_resize_launch.argtypes = [vp] * 4 + [i, i, ctypes.c_longlong, i,
                                                f, f, f, vp]
    lib.hu_resize_launch.restype = ctypes.c_int
    return lib


def _hu_resize_d_cuda(x, out_d, hu_min, hu_max, hu_nan):
    if x.device.type != "cuda":
        raise RuntimeError("hu_resize kernel needs a CUDA tensor, got "
                           "device " + str(x.device))
    d, h, w = x.shape
    idx, wt = _taps_on(d, out_d, x.device)
    out = torch.empty((out_d, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().hu_resize_launch(
            x.data_ptr(), idx.data_ptr(), wt.data_ptr(), out.data_ptr(),
            d, out_d, h * w, _T_PER_BLOCK, hu_min,
            float(np.float32(hu_max) - np.float32(hu_min)), hu_nan,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("hu_resize kernel launch failed: CUDA error "
                           "{}".format(rc))
    LAUNCHES["hu_resize"] += 1
    return out


def hu_resize_d(vol, out_d, hu_min=-1200.0, hu_max=600.0, hu_nan=-2000.0):
    """HU window + order-1 resize of the leading axis: ``vol`` [D, H, W]
    (any real dtype, any strides; cast to contiguous float32 as the JAX
    wrapper casts) -> float32 [out_d, H, W] on ``vol``'s device."""
    if vol.ndim != 3 or 0 in vol.shape:
        raise ValueError("hu_resize_d expects a non-empty [D, H, W] volume, "
                         "got {}".format(tuple(vol.shape)))
    out_d = int(out_d)
    if out_d < 1:
        raise ValueError("out_d must be positive, got {}".format(out_d))
    hu_min, hu_max, hu_nan = float(hu_min), float(hu_max), float(hu_nan)
    x = vol.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return hu_resize_d_plain(x, _linear_matrix(x.shape[0], out_d),
                                 hu_min, hu_max, hu_nan)
    return _hu_resize_d_cuda(x, out_d, hu_min, hu_max, hu_nan)


def hu_norm_resize(vol, size, hu_min=-1200.0, hu_max=600.0, hu_nan=-2000.0):
    """Fused HU windowing + trilinear resize to ``size`` (d, h, w).

    Equal to ``resize3d(hu_norm(vol), size)`` (same endpoint-aligned
    interpolation) up to summation order. A 3-D volume takes the fused D
    pass (the kernel on the card), then the H and W passes on the reduced
    volume; any other rank takes the composition."""
    vol = torch.as_tensor(vol)
    size = tuple(int(s) for s in size)
    if vol.ndim == 3:
        reduced = hu_resize_d(vol, size[0], hu_min, hu_max, hu_nan)
        return resize3d(reduced, size, order=1)
    return resize3d(hu_norm(vol, hu_min, hu_max, hu_nan), size, order=1)
