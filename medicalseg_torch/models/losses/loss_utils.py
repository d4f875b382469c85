# Copyright 2026. Apache License 2.0.
"""Loss helpers. Counterpart of
``medicalseg_tpu/models/losses/loss_utils.py``; logits are channels-last
(N, ..., C), as the model returns them. Under a mesh
(``parallel.use_mesh``) the losses' sums are the global batch's."""

import os

import torch

from ...parallel.collectives import all_reduce_sum
from ...parallel.mesh import active_mesh


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
    (V - sum(p_c)) / sum(p_c) over the V voxels (of the global batch under
    a mesh: the sums over the world)."""
    probs = torch.softmax(logits.detach().float(), dim=-1)
    total = float(probs.numel() // probs.shape[-1])
    sums = probs.sum(dim=tuple(range(probs.dim() - 1)))
    mesh = active_mesh()
    if mesh is not None:
        total *= mesh.world
        sums = all_reduce_sum(sums)
    return (total - sums) / sums


def global_sums(t):
    """``t`` (a tensor of per-rank partial sums) summed over the world
    under a mesh, with the differentiable backward of
    ``parallel.all_reduce_sum``; ``t`` itself without one."""
    return t if active_mesh() is None else all_reduce_sum(t)
