# Copyright 2026. Apache License 2.0.
"""V-Net squared-denominator Dice loss.

Counterpart of ``medicalseg_tpu/models/losses/dice_loss.py``: sigmoid
(default) or softmax normalization, per-channel dice ``2 * (p . t) /
(p^2 + t^2)`` over all voxels, returning ``(1 - mean_dice,
per_channel_dice)``. The per-channel dice doubles as the train/eval mDice
metric. The sums run over every axis but the class axis (the loop form of
the JAX class; its fused form is wrong for unbatched logits).
"""

import torch

from ...cvlibs import manager
from .loss_utils import flatten


@manager.LOSSES.add_component
class DiceLoss:
    """Dice loss over NDHWC logits and integer NDHW labels.

    Args:
        sigmoid_norm: True -> sigmoid normalization; False -> softmax over
            the class axis.
        weight: optional per-class weights multiplied into the intersects.
        ignore_index: voxels with this label are masked out of all three
            dice sums (intersect, sum(p^2), label count).
    """

    def __init__(self, sigmoid_norm=True, weight=None, ignore_index=255):
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)
        self.eps = 1e-5
        self.sigmoid_norm = bool(sigmoid_norm)
        self.ignore_index = ignore_index

    def compute_per_channel_dice(self, probs, target, epsilon=1e-6,
                                 weight=None):
        """probs/target: (N, D, H, W, C) float -> per-channel dice [C], the
        one-hot formulation of the same sums (API parity)."""
        if probs.shape != target.shape:
            raise ValueError(
                "'input' and 'target' must have the same shape but input "
                "is {} and target is {}".format(tuple(probs.shape),
                                                tuple(target.shape)))
        probs = flatten(probs)  # (C, N*D*H*W)
        target = flatten(target).float()
        intersect = (probs * target).sum(-1)
        if weight is not None:
            intersect = weight * intersect
        denominator = (probs * probs).sum(-1) + (target * target).sum(-1)
        return 2 * (intersect / torch.clamp(denominator, min=epsilon))

    def __call__(self, logits, labels):
        """logits: [N, D, H, W, C] float; labels: [N, D, H, W] int.
        Returns (loss, per_channel_dice[C]). No one-hot tensor: with
        one-hot targets t^2 = t, so per class
          intersect_c = sum(p_c * [label == c])
          denom_c     = sum(p_c^2) + count(label == c)."""
        if labels.is_floating_point() or labels.dtype == torch.bool:
            raise TypeError(
                "The label should be int but got {}".format(labels.dtype))
        if logits.dim() == 4:
            logits = logits[None]
        num_classes = logits.shape[-1]
        logits = logits.float()
        probs = (torch.sigmoid(logits) if self.sigmoid_norm else
                 torch.softmax(logits, dim=-1))
        labels = labels.long()
        valid = (labels != self.ignore_index).float()
        intersects, denoms = [], []
        for c in range(num_classes):
            p_c = probs[..., c] * valid
            mask_c = (labels == c).float() * valid
            intersects.append((p_c * mask_c).sum())
            denoms.append((p_c * p_c).sum() + mask_c.sum())
        intersect = torch.stack(intersects)
        denominator = torch.stack(denoms)
        if self.weight is not None:
            intersect = self.weight.to(intersect.device) * intersect
        per_channel_dice = 2 * (intersect /
                                torch.clamp(denominator, min=1e-6))
        return 1.0 - per_channel_dice.mean(), per_channel_dice
