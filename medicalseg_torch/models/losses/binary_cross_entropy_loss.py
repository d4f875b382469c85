# Copyright 2026. Apache License 2.0.
"""BCE-with-logits loss with dynamic pos/neg rebalancing.

Counterpart of
``medicalseg_tpu/models/losses/binary_cross_entropy_loss.py``:
``weight='dynamic'`` computes per-voxel pos/neg weights from the batch
label balance, ``pos_weight='dynamic'`` a scalar positive-class weight,
with ``ignore_index`` masking and one-hot expansion of sparse labels.
Registered but unused by the shipped configs. Under a mesh
(``parallel.use_mesh``) the means, the masked fraction and the dynamic
weights' positive and negative counts are the global batch's: sums over
the world (``loss_utils.global_sums``), as in the other losses.
"""

import torch
import torch.nn.functional as F

from ...cvlibs import manager
from ...parallel.mesh import active_mesh
from .loss_utils import global_sums


@manager.LOSSES.add_component
class BCELoss:
    """Binary cross-entropy with logits over NDHWC tensors.

    Args:
        weight: None | 'dynamic' | array broadcastable to the loss.
        pos_weight: None | 'dynamic' | float.
        ignore_index: label value excluded from the loss.
        edge_label: flag consumed by loss_computation (edge supervision).
    """

    def __init__(self, weight=None, pos_weight=None, ignore_index=255,
                 edge_label=False):
        self.weight = weight
        self.pos_weight = pos_weight
        self.ignore_index = ignore_index
        self.edge_label = edge_label
        self.EPS = 1e-10
        if isinstance(weight, str) and weight != "dynamic":
            raise ValueError(
                "if type of `weight` is str, it should equal to 'dynamic', "
                "but it is {}".format(weight))
        if isinstance(pos_weight, str) and pos_weight != "dynamic":
            raise ValueError(
                "if type of `pos_weight` is str, it should equal to "
                "'dynamic', but it is {}".format(pos_weight))

    def _balance(self, labels_f):
        pos_num, neg_num = global_sums(torch.stack(
            [(labels_f == 1).float().sum(), (labels_f == 0).float().sum()]))
        return pos_num, neg_num, pos_num + neg_num

    def __call__(self, logits, labels):
        """logits: [N, D, H, W, C]; labels: [N, D, H, W] int (one-hot
        expanded) or [N, D, H, W, C] float in [0, 1]; under a mesh the
        rank's shard of the global batch's (module docstring)."""
        num_classes = logits.shape[-1]
        mask = labels != self.ignore_index
        if labels.dim() == logits.dim() - 1:
            labels_f = F.one_hot(labels.long().clamp(0, num_classes - 1),
                                 num_classes).float()
            mask = mask[..., None].expand(labels_f.shape)
        else:
            labels_f = labels.float()
        mask = mask.float()

        if isinstance(self.weight, str):  # 'dynamic'
            pos_num, neg_num, sum_num = self._balance(labels_f)
            weight_pos = 2 * neg_num / (sum_num + self.EPS)
            weight_neg = 2 * pos_num / (sum_num + self.EPS)
            weight = weight_pos * labels_f + weight_neg * (1 - labels_f)
        elif self.weight is not None:
            weight = torch.as_tensor(self.weight, dtype=torch.float32,
                                     device=logits.device)
        else:
            weight = None

        if isinstance(self.pos_weight, str):  # 'dynamic'
            _, neg_num, sum_num = self._balance(labels_f)
            pos_weight = 2 * neg_num / (sum_num + self.EPS)
        elif self.pos_weight is not None:
            pos_weight = float(self.pos_weight)
        else:
            pos_weight = None

        # stable BCE with logits, with the optional pos_weight on the
        # positive term
        x, t = logits.float(), labels_f.detach()
        log_sig, log_one_minus = F.logsigmoid(x), F.logsigmoid(-x)
        if pos_weight is not None:
            loss = -(pos_weight * t * log_sig + (1 - t) * log_one_minus)
        else:
            loss = -(t * log_sig + (1 - t) * log_one_minus)
        if weight is not None:
            loss = loss * weight
        loss = loss * mask
        mesh = active_mesh()
        if mesh is None:
            return loss.mean() / (mask.mean() + self.EPS)
        count = float(loss.numel() * mesh.world)
        total, masked = global_sums(torch.stack([loss.sum(), mask.sum()]))
        return (total / count) / (masked / count + self.EPS)
