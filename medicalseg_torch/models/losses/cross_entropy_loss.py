# Copyright 2026. Apache License 2.0.
"""Cross-entropy loss with dynamic class weights.

Counterpart of ``medicalseg_tpu/models/losses/cross_entropy_loss.py``:
when ``weight`` is None, inverse-frequency weights are derived from the
softmax statistics at every call (``loss_utils.class_weights``); the loss
is the weight-normalized mean of the per-voxel NLL, with ``ignore_index``
voxels masked out.

The default (fused) form gathers each voxel's log-probability at its
label; ``MEDSEG_LOSS_FUSED=0`` sums per-class masks in a loop over the
classes (``loss_utils.fused_masks``). Both give the JAX package's numbers. Under a
mesh the weights and both sums are the global batch's.
"""

import torch

from ...cvlibs import manager
from .loss_utils import class_weights, fused_masks, global_sums


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
        if logits.dim() == 4:  # unbatched
            logits = logits[None]
            labels = labels.reshape(logits.shape[:-1])
        num_classes = logits.shape[-1]
        if self.weight is not None and self.weight.device != logits.device:
            # moved once: a CUDA graph of the step cannot capture the copy
            self.weight = self.weight.to(logits.device)
        weight = self.weight
        if weight is None:
            weight = class_weights(logits)
        if weight.shape[0] != num_classes:
            raise ValueError(
                "The number of weights = {} must be the same as the number "
                "of classes = {}.".format(weight.shape[0], num_classes))
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        valid = labels != self.ignore_index
        if fused_masks():
            # the label's log-probability by one gather; a label equal to
            # ignore_index or outside [0, C) matches no class, so its
            # weight is zero
            hit = valid & (labels >= 0) & (labels < num_classes)
            idx = labels.clamp(0, num_classes - 1)
            nll = -log_probs.gather(-1, idx[..., None])[..., 0]
            w = weight[idx] * hit
        else:
            # per-class masked sums. A label equal to ignore_index matches
            # no class, so nll and w stay zero.
            nll = torch.zeros(labels.shape, dtype=torch.float32,
                              device=logits.device)
            w = torch.zeros_like(nll)
            for c in range(num_classes):
                m = (labels == c).float()
                nll = nll - log_probs[..., c] * m
                w = w + weight[c] * m
            w = w * valid
        # weighted-mean semantics: sum(w * nll) / sum(w), over the global
        # batch under a mesh
        num, den = global_sums(torch.stack([(nll * w).sum(), w.sum()]))
        return num / torch.clamp(den, min=self.EPS)
