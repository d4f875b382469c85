# Copyright 2026. Apache License 2.0.
"""Visualization helpers: the middle slice of each volume to TensorBoard,
the bit-trick color map and a pseudo-color overlay.

Counterpart of ``medicalseg_tpu/utils/visualize.py`` (reference
medicalseg/utils/visualize.py:22-127), numpy only: the caller imports
tensorboardX and passes its writer.
"""

import numpy as np


def add_image_tb(writer, volume_list, names, step, tag_prefix="eval"):
    """Log the middle slice of each 3-D volume (after squeezing) to
    ``writer`` (anything with tensorboardX's ``add_image(tag, img, step)``)
    as a [1, H, W] uint8 image min-max scaled to [0, 255]; other volumes
    are skipped (replaces the reference's VisualDL image logging)."""
    for vol, name in zip(volume_list, names):
        vol = np.asarray(vol)
        vol = np.squeeze(vol)
        if vol.ndim != 3:
            continue
        mid = vol[vol.shape[0] // 2]
        lo, hi = float(mid.min()), float(mid.max())
        img = (mid - lo) / (hi - lo + 1e-8)
        writer.add_image("{}/{}".format(tag_prefix, name),
                         (img * 255).astype(np.uint8)[None], step)


def get_color_map_list(num_classes):
    """Bit-trick PASCAL-style palette (reference visualize.py:106-127)."""
    num_classes += 1
    color_map = num_classes * [0, 0, 0]
    for i in range(0, num_classes):
        j = 0
        lab = i
        while lab:
            color_map[i * 3] |= (((lab >> 0) & 1) << (7 - j))
            color_map[i * 3 + 1] |= (((lab >> 1) & 1) << (7 - j))
            color_map[i * 3 + 2] |= (((lab >> 2) & 1) << (7 - j))
            j += 1
            lab >>= 3
    return color_map[3:]


def get_pseudo_color_map(pred, color_map=None):
    """Map a 2-D label slice to an RGB image via the palette
    (reference visualize.py:80-103, without the PIL dependency)."""
    pred = np.asarray(pred, np.int32)
    if color_map is None:
        color_map = get_color_map_list(256)
    palette = np.asarray(color_map, np.uint8).reshape(-1, 3)
    return palette[np.clip(pred, 0, len(palette) - 1)]


def visualize(image_slice, pred_slice, weight=0.6, color_map=None):
    """Alpha-blend a pseudo-colored prediction over a grayscale slice
    (reference visualize.py:44-77)."""
    image_slice = np.asarray(image_slice, np.float32)
    lo, hi = image_slice.min(), image_slice.max()
    gray = ((image_slice - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
    rgb = np.stack([gray] * 3, axis=-1).astype(np.float32)
    overlay = get_pseudo_color_map(pred_slice, color_map).astype(
        np.float32)
    out = weight * rgb + (1 - weight) * overlay
    return np.clip(out, 0, 255).astype(np.uint8)
