# Copyright 2026. Apache License 2.0.
"""3-D resize (zoom): separable per-axis interpolation.

Counterpart of ``medicalseg_tpu/ops/resize.py``. The coordinate convention
of :func:`resize3d` and :func:`crop_resize3d` is scipy's ``zoom`` with
``grid_mode=False``: ``src = i * (in - 1) / (out - 1)`` (endpoints
aligned). Order 1 is three small matrix products, one per axis, in float32
(on the card with TF32 off: values reach 255 and a 10-bit mantissa would
cost 0.1); order 0 is three gathers. :func:`upsample_trilinear_batch`, the
deep-supervision heads' upsample, takes the half-pixel convention instead
(``src = (i + 0.5) * in / out - 0.5``, edges clamped) and runs in the
tensor's own dtype. The static interpolation matrices and index vectors
are built on the host in float64 and moved to the volume's device; those of
:func:`crop_resize3d`, whose window may be drawn on the card, are built on
the volume's device in float32, in the JAX package's order of operations.
"""

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import halo_h


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matrix products in full float32 on the card, whatever the
    caller set (TF32 keeps a 10-bit mantissa)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _scale(in_size, out_size):
    """scipy grid_mode=False zoom coordinate scale (endpoint-aligned)."""
    if out_size == 1:
        return 0.0
    return (in_size - 1) / (out_size - 1)


def _linear_taps(in_size, out_size):
    """The two taps of every output index of an order-1 resize: (lo int64
    [out], frac float64 [out]). Output i is ``(1 - frac) * x[lo] + frac *
    x[min(lo + 1, in - 1)]``; with ``in_size == 1`` both taps are x[0] and
    their weights add to 1."""
    coords = np.arange(out_size) * _scale(in_size, out_size)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, max(in_size - 2, 0))
    return lo, coords - lo


def _linear_matrix(in_size, out_size, dtype=torch.float32, device=None):
    """Static (out, in) order-1 interpolation matrix (host-built, tiny)."""
    lo, frac = _linear_taps(in_size, out_size)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    w[np.arange(out_size), lo] = 1.0 - frac
    w[np.arange(out_size), np.minimum(lo + 1, in_size - 1)] += frac
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def _linear_matrix_halfpixel(in_size, out_size, dtype=torch.float32,
                             device=None):
    """Static (out, in) order-1 matrix with half-pixel coordinates (``src
    = (i + 0.5) * in / out - 0.5``, clamped to the edges): the
    ``F.interpolate(align_corners=False)`` convention, as opposed to
    :func:`_linear_matrix`'s endpoint-aligned one."""
    coords = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, max(in_size - 2, 0))
    frac = coords - lo
    w = np.zeros((out_size, in_size), dtype=np.float32)
    w[np.arange(out_size), lo] = 1.0 - frac
    w[np.arange(out_size), np.minimum(lo + 1, in_size - 1)] += frac
    return torch.from_numpy(w).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=64)
def _halfpixel_on(in_size, out_size, dtype, device):
    """:func:`_linear_matrix_halfpixel` kept on ``device``: uploaded by
    the first call of a shape through pinned memory (no host sync), so
    that later calls copy nothing from the host (a CUDA graph of the train
    step cannot capture that copy). Built outside inference mode, so that
    a first call under ``torch.inference_mode()`` (an eval forward) leaves
    a matrix that a later train step can save for its backward."""
    with torch.inference_mode(False):
        mat = _linear_matrix_halfpixel(in_size, out_size, dtype)
        if torch.device(device).type == "cpu":
            return mat
        return mat.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=64)
def _halfpixel_shard_on(in_size, out_size, space, s, dtype, device):
    """Shard ``s`` of ``space`` of :func:`_linear_matrix_halfpixel` for a
    global (``out_size``, ``in_size``) resize: its output rows, and its
    input rows with one halo row on each side (zero columns beyond the
    volume's edges), [out / space, in / space + 2], kept on ``device``
    (built outside inference mode, as :func:`_halfpixel_on`'s)."""
    with torch.inference_mode(False):
        mat = F.pad(_linear_matrix_halfpixel(in_size, out_size, dtype),
                    (1, 1))
        ho, hi = out_size // space, in_size // space
        mat = mat[s * ho:(s + 1) * ho, s * hi:s * hi + hi + 2].contiguous()
        if torch.device(device).type == "cpu":
            return mat
        return mat.pin_memory().to(device, non_blocking=True)


def upsample_trilinear_batch(x, size, mesh=None):
    """Half-pixel trilinear resize of an NDHWC batch [N, D, H, W, C] to
    ``size`` (d, h, w), as three per-axis matrix products in ``x``'s dtype
    (an integer batch in float32), one for each axis that changes. For the
    deep-supervision heads, which upsample their logits to the input size
    every step. Upsampling (or the identity) only: a downscale raises, as
    a fixed two-tap matrix does not anti-alias.

    With a ``mesh`` that splits the H axis, ``x`` and ``size`` are the
    rank's H blocks of the global tensors: the H product takes one edge
    row from each H neighbour (``parallel.halo_h``, differentiable) and
    the rank's rows of the global matrix, so that the result is the
    rank's block of the global resize (clamped at the volume's edges
    only)."""
    size = tuple(int(s) for s in size)
    n, d, h, w, c = x.shape
    if (d, h, w) == size:
        return x
    if any(o < i for o, i in zip(size, (d, h, w))):
        raise ValueError(
            "upsample_trilinear_batch only upsamples; got {} -> {}".format(
                (d, h, w), size))
    sharded = mesh is not None and mesh.splits_h
    dt = x.dtype if x.dtype.is_floating_point else torch.float32
    out = x.to(dt)
    for axis, spec in ((1, "ad,ndhwc->nahwc"), (2, "bh,ndhwc->ndbwc"),
                       (3, "xw,ndhwc->ndhxc")):
        if out.shape[axis] == size[axis - 1]:
            continue
        if axis == 2 and sharded:
            mat = _halfpixel_shard_on(out.shape[2] * mesh.space,
                                      size[1] * mesh.space, mesh.space,
                                      mesh.s, dt, x.device)
            out = torch.einsum(spec, mat, halo_h(out, mesh, 1, axis=2))
            continue
        mat = _halfpixel_on(out.shape[axis], size[axis - 1], dt, x.device)
        out = torch.einsum(spec, mat, out)
    return out.to(x.dtype)


def _nearest_indices(in_size, out_size, device=None):
    """Static nearest-neighbour source indices (scipy order=0 parity:
    spline order 0 rounds half-up)."""
    coords = np.arange(out_size) * _scale(in_size, out_size)
    idx = np.floor(coords + 0.5).astype(np.int64)
    return torch.from_numpy(np.clip(idx, 0, in_size - 1)).to(device)


def _is_integer(dtype):
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def resize3d(vol, size, order=1):
    """Resize a volume to ``size`` (d, h, w) with endpoint-aligned zoom.

    Args:
        vol: [D, H, W] or [D, H, W, C] tensor or array (any float or int
            dtype); the result lies on the same device.
        size: target (d, h, w).
        order: 1 (trilinear, three matrix products) or 0 (nearest, three
            axis gathers: label volumes).

    Returns:
        the resized tensor in ``vol``'s dtype; integer volumes are rounded
        to nearest after the order-1 interpolation.
    """
    vol = torch.as_tensor(vol)
    size = tuple(int(s) for s in size)
    if vol.ndim not in (3, 4):
        raise ValueError("resize3d expects 3-D or 4-D input, got shape {}".
                         format(tuple(vol.shape)))
    in_dhw = tuple(vol.shape[:3])
    if in_dhw == size:
        return vol
    if order == 0:
        out = vol
        for axis in range(3):
            idx = _nearest_indices(in_dhw[axis], size[axis], vol.device)
            out = out.index_select(axis, idx)
        return out
    out = vol.to(torch.float32)
    # one contraction per axis that changes (an unchanged axis's matrix is
    # the identity)
    with _full_f32_matmul():
        for axis in range(3):
            if in_dhw[axis] == size[axis]:
                continue
            mat = _linear_matrix(in_dhw[axis], size[axis], device=vol.device)
            out = torch.tensordot(mat, out, dims=([1], [axis])).movedim(
                0, axis)
    if _is_integer(vol.dtype):
        out = torch.round(out)
    return out.to(vol.dtype).contiguous()


def resize3d_batch(vol, size, order=1):
    """Batched resize for [N, D, H, W, C] tensors, one volume at a time."""
    vol = torch.as_tensor(vol)
    return torch.stack([resize3d(v, size, order) for v in vol])


def _crop_axis(in_size, start, crop, out_size, device):
    """The float32 source coordinates ``start + i * (crop - 1) / (out - 1)``
    of the ``out_size`` outputs of one axis of a crop window, and the
    window's last index clamped to the volume, ``min(start + crop - 1,
    in_size - 1)``. ``start`` and ``crop`` are host integers or 0-d
    integer tensors on ``device`` (the geometry then stays there)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    denom = float(max(out_size - 1, 1))
    if torch.is_tensor(start):
        scale = (crop.to(torch.float32) - 1.0) / denom
        coords = start.to(torch.float32) + i * scale
        hi = torch.clamp(start + crop - 1, max=in_size - 1).to(torch.float32)
    else:
        scale = float(np.float32(crop - 1.0) / np.float32(denom))
        coords = float(start) + i * scale
        hi = float(min(start + crop - 1, in_size - 1))
    return coords, hi


def _dynamic_linear_matrix(in_size, start, crop, out_size, device=None):
    """(out, in) float32 order-1 interpolation matrix of a crop window: row
    i interpolates the source coordinate ``start + i * (crop - 1) / (out -
    1)``, clamped to [0, min(start + crop - 1, in - 1)], from its two
    neighbours."""
    coords, hi = _crop_axis(in_size, start, crop, out_size, device)
    coords = torch.clamp(coords, min=0.0)
    coords = (torch.minimum(coords, hi) if torch.is_tensor(hi)
              else coords.clamp(max=hi))
    lo = torch.floor(coords)
    frac = coords - lo
    lo_i = lo.long().clamp(0, in_size - 1)
    hi_i = (lo_i + 1).clamp(0, in_size - 1)
    cols = torch.arange(in_size, device=device)
    return ((cols[None, :] == lo_i[:, None]) * (1.0 - frac)[:, None] +
            (cols[None, :] == hi_i[:, None]) * frac[:, None])


def _dynamic_nearest_indices(in_size, start, crop, out_size, device=None):
    """Order-0 source indices of a crop window: ``floor(coord + 0.5)``,
    clamped to the volume."""
    coords, _ = _crop_axis(in_size, start, crop, out_size, device)
    return torch.floor(coords + 0.5).long().clamp(0, in_size - 1)


def crop_resize3d(vol, start, crop, size, order=1):
    """Fused crop + resize: ``resize3d(vol[start:start + crop], size,
    order)`` with the window's geometry as data.

    ``start`` and ``crop`` (three each) are host integers, or int tensors
    [3] on ``vol``'s device: a crop drawn inside a label's bounding box on
    the card needs no host sync. Order 1 contracts each axis of the whole
    volume with a (size, in) interpolation matrix built from the geometry
    (float32, TF32 off); order 0 gathers along each axis. Integer volumes
    are rounded to nearest after the order-1 interpolation.

    Args:
        vol: [D, H, W] or [D, H, W, C] tensor.
        start: crop offsets (d, h, w).
        crop: crop lengths (d, h, w).
        size: output (d, h, w).
        order: 1 trilinear or 0 nearest.
    """
    if vol.ndim not in (3, 4):
        raise ValueError("crop_resize3d expects 3-D or 4-D input, got {}".
                         format(tuple(vol.shape)))
    size = tuple(int(s) for s in size)

    def geometry(g):
        if torch.is_tensor(g) and g.device.type != "cpu":
            return g.long()
        return [int(v) for v in g]  # host values (a CPU tensor: no sync)

    start, crop = geometry(start), geometry(crop)
    in_dhw = tuple(vol.shape[:3])
    if order == 0:
        out = vol
        for axis in range(3):
            idx = _dynamic_nearest_indices(in_dhw[axis], start[axis],
                                           crop[axis], size[axis],
                                           vol.device)
            out = out.index_select(axis, idx)
        return out
    out = vol.to(torch.float32)
    with _full_f32_matmul():
        for axis in range(3):
            mat = _dynamic_linear_matrix(in_dhw[axis], start[axis],
                                         crop[axis], size[axis], vol.device)
            out = torch.tensordot(mat, out, dims=([1], [axis])).movedim(
                0, axis)
    if _is_integer(vol.dtype):
        out = torch.round(out)
    return out.to(vol.dtype).contiguous()


def resize_to_spacing(vol, spacing, new_spacing=None, new_shape=None,
                      order=1):
    """Spacing-aware resample (spacing / new_spacing / new_shape all in the
    volume's own axis order). Either ``new_spacing`` (target mm per voxel)
    or ``new_shape`` must be given. Returns (resampled, real_new_spacing).
    """
    in_dhw = np.asarray(tuple(vol.shape[:3]), dtype=np.float64)
    spacing = None if spacing is None else np.asarray(
        spacing, dtype=np.float64)
    if spacing is not None and spacing.size == 4:
        spacing = spacing[1:]
    if new_shape is None:
        if new_spacing is None:
            raise ValueError("Give either new_spacing or new_shape")
        new_spacing = np.asarray(new_spacing, dtype=np.float64)[:3]
        new_shape = np.round(in_dhw * spacing[:3] / new_spacing)
    else:
        new_shape = np.asarray(new_shape, dtype=np.float64)
        if spacing is not None:
            new_spacing = tuple((in_dhw / new_shape) * spacing[:3])
        else:
            new_spacing = None
    out = resize3d(vol, tuple(int(s) for s in new_shape), order=order)
    return out, new_spacing
