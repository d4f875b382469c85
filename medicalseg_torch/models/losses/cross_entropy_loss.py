# Copyright 2026. Apache License 2.0.
"""Cross-entropy loss with dynamic class weights.

Counterpart of ``medicalseg_tpu/models/losses/cross_entropy_loss.py``:
when ``weight`` is None, inverse-frequency weights are derived from the
softmax statistics at every call (``loss_utils.class_weights``); the loss
is the weight-normalized mean of the per-voxel NLL, with ``ignore_index``
voxels masked out.
"""

import torch

from ...cvlibs import manager
from .loss_utils import class_weights


@manager.LOSSES.add_component
class CrossEntropyLoss:
    """CE over NDHWC logits and integer NDHW labels.

    Args:
        weight: per-class weights (list/array) or None for dynamic
            inverse-frequency weights recomputed at every call.
        ignore_index: voxels with this label do not contribute.
    """

    def __init__(self, weight=None, ignore_index=255, data_format="NDHWC"):
        self.ignore_index = ignore_index
        self.EPS = 1e-8
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)

    def __call__(self, logits, labels):
        labels = labels.long()
        if logits.dim() == 4:
            logits = logits[None]
        num_classes = logits.shape[-1]
        weight = self.weight
        if weight is None:
            weight = class_weights(logits)
        if weight.shape[0] != num_classes:
            raise ValueError(
                "The number of weights = {} must be the same as the number "
                "of classes = {}.".format(weight.shape[0], num_classes))
        weight = weight.to(logits.device, torch.float32)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        # per-class masked sums: no one-hot tensor, no gather. A label
        # equal to ignore_index matches no class, so nll and w stay zero.
        valid = (labels != self.ignore_index).float()
        nll = torch.zeros(labels.shape, dtype=torch.float32,
                          device=logits.device)
        w = torch.zeros_like(nll)
        for c in range(num_classes):
            m = (labels == c).float()
            nll = nll - log_probs[..., c] * m
            w = w + weight[c] * m
        w = w * valid
        # weighted-mean semantics: sum(w * nll) / sum(w)
        return (nll * w).sum() / torch.clamp(w.sum(), min=self.EPS)
