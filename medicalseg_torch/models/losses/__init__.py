# Copyright 2026. Apache License 2.0.
from .loss_utils import class_weights, flatten
from .dice_loss import DiceLoss
from .cross_entropy_loss import CrossEntropyLoss
from .binary_cross_entropy_loss import BCELoss
from .mixed_loss import MixedLoss

__all__ = ["flatten", "class_weights", "DiceLoss", "CrossEntropyLoss",
           "BCELoss", "MixedLoss"]
