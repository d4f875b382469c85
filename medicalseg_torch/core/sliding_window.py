# Copyright 2026. Apache License 2.0.
"""Sliding-window whole-volume inference with overlap blending.

Counterpart of ``medicalseg_tpu/core/sliding_window.py``, which runs the
window loop as one compiled scan whose last batch is padded with masked
duplicate windows. Here it is a Python loop over window batches, the last
one short. The windows of one batch overlap, so each window's contribution
is added into ``acc`` and ``weight`` on its own (slice ``+=``), one after
another: never one scatter with duplicate indices. The accumulators are
float32 on the volume's device and are updated in place.

``forward`` is called on windows [B, d, h, w, C] and must return logits
[B, d, h, w, num_classes] (an eval-mode model's ``main_output``; the
caller puts the model in eval mode). The loop runs under
``torch.inference_mode()``.
"""

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def compute_window_starts(in_size: int, roi: int, overlap: float):
    """Window start offsets covering [0, in_size) with >= overlap
    fraction of roi between neighbours; final window clamped flush."""
    if roi >= in_size:
        return [0]
    stride = max(1, int(roi * (1.0 - overlap)))
    starts = list(range(0, in_size - roi + 1, stride))
    if starts[-1] != in_size - roi:
        starts.append(in_size - roi)
    return starts


def gaussian_importance(roi_dhw, sigma_scale=0.125, dtype=torch.float32,
                        device=None):
    """nnU-Net-style Gaussian blend map peaking at the window center,
    built in float64 on the host."""
    grids = []
    for s in roi_dhw:
        x = np.arange(s, dtype=np.float64)
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-3)
        grids.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    m = grids[0][:, None, None] * grids[1][None, :, None] * \
        grids[2][None, None, :]
    m = m / m.max()
    m = np.maximum(m, m[m > 0].min())  # avoid zero weights at corners
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def sliding_window_inference_batched(forward: Callable, volumes,
                                     roi_size: Sequence[int],
                                     num_classes: int, overlap=0.25,
                                     window_batch=4, blend="gaussian"):
    """Sliding-window inference over a batch of same-shape volumes: the
    windows of all volumes stream through ``forward`` ``window_batch`` at
    a time, so a forward mixes windows across volumes.

    Args:
        volumes: [N, D, H, W, C] tensor.
        roi_size: (d, h, w) window size; smaller volumes are zero-padded
            at the far end and the result cropped back.
        blend: 'gaussian' | 'constant'.

    Returns:
        [N, D, H, W, num_classes] float32 blended logits.
    """
    n, d, h, w = volumes.shape[:4]
    roi = tuple(int(r) for r in roi_size)
    pad = [max(roi[i] - volumes.shape[1 + i], 0) for i in range(3)]
    if any(pad):
        volumes = F.pad(volumes, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    pd, ph, pw = volumes.shape[1:4]
    dev = volumes.device

    grid = [(v, d0, h0, w0) for v in range(n)
            for d0 in compute_window_starts(pd, roi[0], overlap)
            for h0 in compute_window_starts(ph, roi[1], overlap)
            for w0 in compute_window_starts(pw, roi[2], overlap)]

    if blend == "gaussian":
        importance = gaussian_importance(roi, device=dev)
    else:
        importance = torch.ones(roi, dtype=torch.float32, device=dev)
    importance = importance[..., None]  # [d, h, w, 1]

    acc = torch.zeros((n, pd, ph, pw, num_classes), dtype=torch.float32,
                      device=dev)
    weight = torch.zeros((n, pd, ph, pw, 1), dtype=torch.float32, device=dev)

    def box(v, d0, h0, w0):
        return (v, slice(d0, d0 + roi[0]), slice(h0, h0 + roi[1]),
                slice(w0, w0 + roi[2]))

    with torch.inference_mode():
        for b in range(0, len(grid), window_batch):
            batch = grid[b:b + window_batch]
            windows = torch.stack([volumes[box(*s)] for s in batch])
            logits = forward(windows).to(torch.float32) * importance
            for i, s in enumerate(batch):
                acc[box(*s)] += logits[i]
                weight[box(*s)] += importance
        out = acc / torch.clamp(weight, min=1e-8)
    return out[:, :d, :h, :w]


def sliding_window_inference(forward: Callable, volume, roi_size,
                             num_classes, overlap=0.25, window_batch=4,
                             blend="gaussian"):
    """Whole-volume logits by tiled window inference: ``volume``
    [D, H, W, C] -> [D, H, W, num_classes] float32."""
    return sliding_window_inference_batched(
        forward, volume[None], roi_size, num_classes, overlap, window_batch,
        blend)[0]
