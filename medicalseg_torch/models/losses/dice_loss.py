# Copyright 2026. Apache License 2.0.
"""V-Net squared-denominator Dice loss.

Counterpart of ``medicalseg_tpu/models/losses/dice_loss.py``: sigmoid
(default) or softmax normalization, per-channel dice ``2 * (p . t) /
(p^2 + t^2)`` over all voxels, returning ``(1 - mean_dice,
per_channel_dice)``. The per-channel dice doubles as the train/eval mDice
metric. The sums run over every axis but the class axis.

The default (fused) form takes all classes at once
(``loss_utils.fused_masks``); ``MEDSEG_LOSS_FUSED=0`` loops over the
classes. Both give the JAX package's numbers on batched logits. On
unbatched (4-D) logits the port's fused form still equals its loop form,
while the JAX fused form does not: it promotes the logits to 5-D but sums
over the label's axes only, so it is left with a spatial axis. This is the
one place the port departs from the JAX fused form. Under a mesh
(``parallel.use_mesh``) the intersect and denominator sums are the global
batch's.
"""

import torch

from ...cvlibs import manager
from .loss_utils import flatten, fused_masks, global_sums


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
        Returns (loss, per_channel_dice[C]). No float one-hot tensor:
        with one-hot targets t^2 = t, so per class (voxels labelled
        ignore_index left out)
          intersect_c = sum(p_c * [label == c])
          denom_c     = sum(p_c^2) + count(label == c)."""
        if labels.is_floating_point() or labels.dtype == torch.bool:
            raise TypeError(
                "The label should be int but got {}".format(labels.dtype))
        if logits.dim() == 4:  # unbatched
            logits = logits[None]
            labels = labels.reshape(logits.shape[:-1])
        num_classes = logits.shape[-1]
        logits = logits.float()
        probs = (torch.sigmoid(logits) if self.sigmoid_norm else
                 torch.softmax(logits, dim=-1))
        labels = labels.long()
        valid = labels != self.ignore_index
        if fused_masks():
            # the sums for all classes at once, over every axis but the
            # class axis, with the class masks as one boolean compare (a
            # label equal to ignore_index or outside [0, C) matches none)
            classes = torch.arange(num_classes, device=labels.device)
            masks = torch.where(valid, labels, -1)[..., None] == classes
            pv = (probs * valid[..., None]).reshape(-1, num_classes)
            masks = masks.reshape(-1, num_classes)
            intersect = torch.where(masks, pv, 0.0).sum(0)
            denominator = (pv * pv).sum(0) + masks.sum(0)
        else:
            valid = valid.float()
            intersects, denoms = [], []
            for c in range(num_classes):
                p_c = probs[..., c] * valid
                mask_c = (labels == c).float() * valid
                intersects.append((p_c * mask_c).sum())
                denoms.append((p_c * p_c).sum() + mask_c.sum())
            intersect = torch.stack(intersects)
            denominator = torch.stack(denoms)
        # over the global batch under a mesh
        intersect, denominator = global_sums(torch.stack([intersect,
                                                          denominator]))
        if self.weight is not None:
            if self.weight.device != intersect.device:
                # moved once: a CUDA graph of the step cannot capture the
                # copy
                self.weight = self.weight.to(intersect.device)
            intersect = self.weight * intersect
        per_channel_dice = 2 * (intersect /
                                torch.clamp(denominator, min=1e-6))
        return 1.0 - per_channel_dice.mean(), per_channel_dice
