# Copyright 2026. Apache License 2.0.
"""Loss helpers. Counterpart of
``medicalseg_tpu/models/losses/loss_utils.py``; logits are channels-last
(N, ..., C), as the model returns them."""

import os

import torch


def fused_masks():
    """True (the default) -> CrossEntropyLoss and DiceLoss build their
    per-class masks for all classes at once (the JAX package's default
    form, read from the same variable); ``MEDSEG_LOSS_FUSED=0`` selects
    the per-class loop. Both compute the same sums. Read at every call."""
    return os.environ.get("MEDSEG_LOSS_FUSED", "1") == "1"


def flatten(tensor):
    """(N, ..., C) -> (C, N * ...): channel-major flatten."""
    return tensor.reshape(-1, tensor.shape[-1]).t()


def class_weights(logits):
    """Inverse-frequency class weights from the softmax statistics, with no
    gradient (the JAX ``stop_gradient``). logits: (N, ..., C) -> [C]:
    (V - sum(p_c)) / sum(p_c) over the V voxels."""
    probs = torch.softmax(logits.detach().float(), dim=-1)
    total = float(probs.numel() // probs.shape[-1])
    sums = probs.sum(dim=tuple(range(probs.dim() - 1)))
    return (total - sums) / sums
