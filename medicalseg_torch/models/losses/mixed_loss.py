# Copyright 2026. Apache License 2.0.
"""Weighted combination of losses in one config entry. Counterpart of
``medicalseg_tpu/models/losses/mixed_loss.py``; the shipped configs all
use ``MixedLoss([CrossEntropyLoss, DiceLoss], coef=[1, 1])``."""

from ...cvlibs import manager
from .dice_loss import DiceLoss


@manager.LOSSES.add_component
class MixedLoss:
    """Args:
        losses: list of loss callables.
        coef: list of float coefficients, same length.

    ``__call__`` returns (loss_list, per_channel_dice); DiceLoss's tuple
    return is unpacked for its per-channel dice.
    """

    def __init__(self, losses, coef):
        if not isinstance(losses, list):
            raise TypeError("`losses` must be a list!")
        if not isinstance(coef, list):
            raise TypeError("`coef` must be a list!")
        if len(losses) != len(coef):
            raise ValueError(
                "The length of `losses` should equal to `coef`, but they "
                "are {} and {}.".format(len(losses), len(coef)))
        self.losses = losses
        self.coef = coef

    def __call__(self, logits, labels):
        loss_list = []
        per_channel_dice = None
        for i, loss in enumerate(self.losses):
            output = loss(logits, labels)
            if isinstance(loss, DiceLoss):
                output, per_channel_dice = output
            loss_list.append(output * self.coef[i])
        return loss_list, per_channel_dice
