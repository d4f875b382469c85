# Copyright 2026. Apache License 2.0.
"""Elementwise intensity ops (HU windowing, normalization, label remap).

Counterpart of ``medicalseg_tpu/ops/intensity.py``: plain functions on
tensors that run where their input lies. Arrays and lists are taken as
well and become CPU tensors.
"""

import torch


def _f32(image):
    return torch.as_tensor(image).to(torch.float32)


def hu_window(x, hu_min=-1200.0, hu_max=600.0, hu_nan=-2000.0):
    """The HU window on an f32 tensor: NaN -> ``hu_nan``, then
    ``clip((x - hu_min) / (hu_max - hu_min), 0, 1) * 255``. +inf ends at
    255 and -inf at 0."""
    x = torch.where(torch.isnan(x), torch.full_like(x, hu_nan), x)
    return torch.clamp((x - hu_min) / (hu_max - hu_min), 0.0, 1.0) * 255.0


def hu_norm(image, hu_min=-1200.0, hu_max=600.0, hu_nan=-2000.0):
    """CT Hounsfield-unit windowing to [0, 255] in f32: NaNs are replaced
    with ``hu_nan``, intensities clipped to [hu_min, hu_max], scaled to
    [0, 1] then multiplied by 255."""
    return hu_window(_f32(image), float(hu_min), float(hu_max),
                     float(hu_nan))


def min_max_norm(image):
    """Min-max normalize to [0, 1] over the whole volume."""
    image = _f32(image)
    lo, hi = image.min(), image.max()
    return torch.clamp((image - lo) / torch.clamp(hi - lo, min=1e-12),
                       0.0, 1.0)


def fixed_norm(image, min_val, max_val):
    """Normalize with fixed bounds, clip to [0, 1]."""
    image = _f32(image)
    return torch.clamp((image - min_val) / max(max_val - min_val, 1e-12),
                       0.0, 1.0)


def normalize(image, min_val=None, max_val=None):
    """Dispatch between fixed-bounds and min-max normalization."""
    if min_val is None or max_val is None:
        return min_max_norm(image)
    return fixed_norm(image, float(min_val), float(max_val))


def label_remap(label, map_dict):
    """Dict-driven label id rewrite through a dense lookup table and one
    gather; ids outside the table's keys stay, negative ids count as 0."""
    label = torch.as_tensor(label)
    max_id = int(label.max())
    if map_dict:
        max_id = int(max(max(map_dict.keys()), max_id))
    lut = torch.arange(max_id + 1, dtype=label.dtype, device=label.device)
    for src, dst in map_dict.items():
        lut[int(src)] = dst
    return lut[torch.clamp(label, 0, max_id).long()]


def scale_by_max(image):
    """Per-volume divide-by-max at the end of a transform chain; a volume
    with no positive value is left as it is."""
    image = _f32(image)
    mx = image.max()
    return torch.where(mx > 0, image / mx, image)
