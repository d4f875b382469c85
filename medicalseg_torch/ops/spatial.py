# Copyright 2026. Apache License 2.0.
"""Spatial ops: flip, crop and planar rotation of a volume.

Counterpart of ``medicalseg_tpu/ops/spatial.py``, ported as its math and
not its TPU form. The rotations follow ``scipy.ndimage.rotate(reshape=
False)``: an output voxel samples the input at ``matrix @ (x - c) + c``
with ``matrix = [[cos, sin], [-sin, cos]]`` in the plane ``(a, b)``, and
gets ``cval`` outright where that point leaves the volume (scipy's strict
``mode='constant'``, with a small ``eps`` band).

* :func:`rotate3d` is the exact rotation: four gathered taps (order 1) or
  one (order 0) per output voxel.
* :func:`rotate3d_shear` factors the rotation into three shears, each a
  two-tap resample along one axis at ``src = x + coef * (b - cb)``
  (``coef`` = tan(t / 2), -sin t, tan(t / 2)), on a padded canvas. The
  JAX package writes each shear as a banded-matrix product to keep the
  TPU's matrix unit busy; here each is an index-and-lerp of two gathered
  taps. Augmentation takes it for ranges up to 45 degrees.

The angle, the plane and the flip mask are host values: each picks a code
path or a constant, so a call makes no host sync. Every coordinate is
computed in float32 in the JAX package's order of operations, so the two
agree to float32 rounding. Integer volumes are rotated as float32 and
rounded to nearest (half to even) after the warp.
"""

import torch

from .resize import _is_integer

_F32 = torch.float32


def flip3d(vol, axis):
    """Static-axis flip."""
    return torch.flip(vol, (axis,))


def random_flip3d(vol, flip_mask):
    """Flip along each of the three leading axes where ``flip_mask`` (three
    host booleans) is true."""
    dims = tuple(axis for axis in range(3) if bool(flip_mask[axis]))
    return torch.flip(vol, dims) if dims else vol


def crop3d(vol, i, j, k, d, h, w):
    """Static crop."""
    return vol[i:i + d, j:j + h, k:k + w]


def _trig(angle_deg):
    """(cos, sin, tan(t / 2)) of ``angle_deg`` degrees as float32 values,
    computed on the host's CPU as the JAX package computes them on its
    device (``deg2rad`` in float32, then each function in float32)."""
    rad = torch.tensor(float(angle_deg), dtype=_F32).deg2rad()
    return (rad.cos().item(), rad.sin().item(), (rad / 2.0).tan().item())


def _plane_view(t, ndim, a, b):
    """``t`` of shape [sa, sb] viewed to broadcast against an ``ndim``-D
    volume whose axes ``a`` < ``b`` are the plane."""
    shape = [1] * ndim
    shape[a], shape[b] = t.shape
    return t.reshape(shape)


def _rotation_coords(shape, r_plane, angle_deg, device=None):
    """Input-space sample coordinates of the plane's two axes, each
    [shape[a], shape[b]] float32 (the other axes sample themselves):
    ``matrix @ (x - c) + c`` with scipy's ``matrix = [[cos, sin], [-sin,
    cos]]`` and ``c`` the plane's centre. Returns (coords_a, coords_b)."""
    a, b = sorted(r_plane)
    c, s, _ = _trig(angle_deg)
    ca = (shape[a] - 1) / 2.0
    cb = (shape[b] - 1) / 2.0
    xa = (torch.arange(shape[a], dtype=_F32, device=device) - ca)[:, None]
    xb = (torch.arange(shape[b], dtype=_F32, device=device) - cb)[None, :]
    new_a = c * xa + s * xb + ca
    new_b = -s * xa + c * xb + cb
    return new_a, new_b


def _valid(coords_a, coords_b, sa, sb):
    """scipy's strict constant mode: the unrounded coordinate inside
    [0, size - 1], with an ``eps`` band for float32 noise at right
    angles."""
    eps = max(1e-4, 1e-6 * max(sa, sb))
    return ((coords_a >= -eps) & (coords_a <= sa - 1 + eps) &
            (coords_b >= -eps) & (coords_b <= sb - 1 + eps))


def _finish(out, vol, valid, a, b, cval):
    out = torch.where(_plane_view(valid, out.ndim, a, b), out,
                      torch.full((), cval, dtype=_F32, device=out.device))
    if _is_integer(vol.dtype):
        out = torch.round(out)
    return out.to(vol.dtype)


def rotate3d(vol, angle, r_plane=(0, 1), order=1, cval=0.0):
    """Rotate ``vol`` by ``angle`` degrees (a number) in plane ``r_plane``,
    as ``scipy.ndimage.rotate(vol, angle, axes=r_plane, order=order,
    reshape=False, cval=cval)``.

    Supports 3-D volumes and 4-D (trailing channel) tensors. Order 1 sums
    the four in-plane taps with weights ``(1 - f) * (1 - g)`` and so on
    (the coordinate clamped to the volume first); order 0 takes the tap at
    the coordinate rounded half away from zero."""
    a, b = sorted(int(x) for x in r_plane)
    sa, sb = vol.shape[a], vol.shape[b]
    coords_a, coords_b = _rotation_coords(vol.shape, (a, b), angle,
                                          vol.device)
    valid = _valid(coords_a, coords_b, sa, sb)
    ka = coords_a.clamp(0.0, sa - 1)
    kb = coords_b.clamp(0.0, sb - 1)
    v = vol.to(_F32).movedim((a, b), (0, 1))  # [sa, sb, rest...]
    rest = (1,) * (v.ndim - 2)

    if order == 0:
        def nearest(k):  # half away from zero; k >= 0 here
            lo = torch.floor(k)
            return (lo + (k - lo >= 0.5)).long()
        out = v[nearest(ka), nearest(kb)]
    elif order == 1:
        a0f, b0f = torch.floor(ka), torch.floor(kb)
        wa1, wb1 = ka - a0f, kb - b0f
        wa0, wb0 = 1 - wa1, 1 - wb1
        a0, b0 = a0f.long(), b0f.long()
        a1, b1 = (a0 + 1).clamp(max=sa - 1), (b0 + 1).clamp(max=sb - 1)
        out = None
        for ia, wa in ((a0, wa0), (a1, wa1)):
            for ib, wb in ((b0, wb0), (b1, wb1)):
                term = (wa * wb).reshape(wa.shape + rest) * v[ia, ib]
                out = term if out is None else out + term
    else:
        raise ValueError("rotate3d supports order 0 and 1, got {}".format(
            order))
    return _finish(out.movedim((0, 1), (a, b)), vol, valid, a, b, cval)


def _shear_pass(arr, coef, ax, bx, order, cb):
    """1-D resample of ``arr`` along ``ax`` at ``src = x + coef * (b -
    cb)``, ``b`` the index along ``bx``: order 1 weighs the taps ``x'``
    in range by ``max(0, 1 - |src - x'|)`` (zero outside), order 0 takes
    the tap ``x' = ceil(src - 0.5)`` where it is in range."""
    v = arr.movedim((bx, ax), (-2, -1))
    lead = v.shape[:-2]
    B, A = v.shape[-2], v.shape[-1]
    v2 = v.reshape(-1, B, A)
    xo = torch.arange(A, dtype=_F32, device=arr.device)
    bs = torch.arange(B, dtype=_F32, device=arr.device)
    src = xo[None, :] + coef * (bs[:, None] - cb)  # [B, A]
    x0f = torch.floor(src)
    x0 = x0f.long()

    def tap(idx, weight):
        inside = (idx >= 0) & (idx < A)
        weight = torch.where(inside, weight, torch.zeros((), dtype=_F32,
                                                         device=arr.device))
        got = torch.gather(v2, 2, idx.clamp(0, A - 1).expand(v2.shape))
        return weight * got

    if order == 0:
        idx = torch.where(src - x0f <= 0.5, x0, x0 + 1)
        out = tap(idx, torch.ones((), dtype=_F32, device=arr.device))
    elif order == 1:
        out = (tap(x0, 1 - (src - x0f)) +
               tap(x0 + 1, 1 - ((x0f + 1) - src)))
    else:
        raise ValueError("rotate3d_shear supports order 0 and 1, got "
                         "{}".format(order))
    return out.reshape(lead + (B, A)).movedim((-2, -1), (bx, ax))


def rotate3d_shear(vol, angle, r_plane=(0, 1), order=1, cval=0.0):
    """Planar rotation by three shears (``Sx(tan(t/2)) . Sy(-sin t) .
    Sx(tan(t/2))``, valid for |angle| < 90; augmentation uses it up to
    45 degrees), each a two-tap resample along one axis.

    The passes run on a canvas padded by ``int(0.21 * (sa + sb) / 2) + 2``
    on both sides of both plane axes (content that leaves during the first
    pass comes back by the third) and are cropped back; boundaries follow
    scipy's strict constant mode exactly (the valid mask of
    :func:`rotate3d`). Interior values differ from the direct bilinear
    rotation by the extra smoothing of the 1-D passes. Supports 3-D volumes
    and 4-D (trailing channel) tensors."""
    a, b = sorted(int(x) for x in r_plane)
    sa, sb = vol.shape[a], vol.shape[b]
    _, s, t_half = _trig(angle)
    al, be = t_half, -s
    pad = int(0.21 * (sa + sb) / 2) + 2
    ca = (sa - 1) / 2.0 + pad
    cb = (sb - 1) / 2.0 + pad
    widths = [0] * (2 * vol.ndim)  # F.pad order: last axis first
    for axis in (a, b):
        widths[2 * (vol.ndim - 1 - axis)] = pad
        widths[2 * (vol.ndim - 1 - axis) + 1] = pad
    out = torch.nn.functional.pad(vol.to(_F32), widths)
    out = _shear_pass(out, al, a, b, order, cb)
    out = _shear_pass(out, be, b, a, order, ca)
    out = _shear_pass(out, al, a, b, order, cb)
    sl = [slice(None)] * vol.ndim
    sl[a] = slice(pad, pad + sa)
    sl[b] = slice(pad, pad + sb)
    out = out[tuple(sl)]
    coords_a, coords_b = _rotation_coords(vol.shape, (a, b), angle,
                                          vol.device)
    return _finish(out, vol, _valid(coords_a, coords_b, sa, sb), a, b, cval)
