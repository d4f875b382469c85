# Copyright 2026. Apache License 2.0.
"""V-Net with deep supervision.

Counterpart of ``medicalseg_tpu/models/vnet_deepsup.py``: the VNet trunk
(:class:`~medicalseg_torch.models.vnet.VNet`, with its per-block remat)
plus three auxiliary 3^3 SAME conv heads, ``Conv_0``, ``Conv_1`` and
``Conv_2``, on the outputs of ``up_tr256``, ``up_tr128`` and ``up_tr64``
(the JAX ``UpTransition_0/1/2``), each with ``num_classes`` outputs and
trilinearly upsampled (half-pixel convention,
:func:`~medicalseg_torch.ops.resize.upsample_trilinear_batch`) to the input
size. ``forward`` takes NDHWC [N, D, H, W, C_in] and returns ``[out, d1,
d2, d3]``, each NDHWC [N, D, H, W, num_classes] in float32, the order the
4-way loss ``coef`` of the flagship config
(``configs/synthetic/vnetdeepsup_synspine_15k.yml``) expects, in training
and at eval alike, as the JAX model does. ``main_output`` (VNet's) returns
``out`` alone and runs neither a head nor an upsample: evaluation, serving
and export take it, where the JAX package leaves XLA to drop the three
unused outputs of its traced call.

The heads run in the compute dtype through cuDNN's ``conv3d``, as the JAX
package runs them through XLA's convolution: no Pallas kernel covers a 3^3
conv there either. Under a space mesh (``parallel.use_mesh``) each head
takes one halo row from each H neighbour and convolves without H padding,
and the upsample works on the rank's H block with its neighbours' edge
rows (``ops.resize.upsample_trilinear_batch``), as XLA's partitioner does
for the JAX model. A head at an H-replicated level (``parallel.h_levels``)
convolves and upsamples the whole H axis and keeps the rank's block.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..cvlibs import manager
from ..ops import conv5 as c5
from ..ops.resize import upsample_trilinear_batch
from ..parallel.collectives import halo_h
from ..parallel.mesh import active_mesh, use_mesh
from .layers import he_normal_
from .vnet import _TRIPLE, VNet


class ConvHead(nn.Module):
    """3^3 SAME conv (flax ``nn.Conv(features, (3, 3, 3), padding='SAME',
    dtype=dtype)``) from a kernel-layout tensor [N, D, C, H, W] to NDHWC:
    ``weight`` [Co, Ci, 3, 3, 3] and ``bias`` [Co] in f32, both cast to the
    compute dtype at use."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        he_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, xk):
        mesh, pad = active_mesh(), 1
        if mesh is not None and mesh.splits_h:
            xk, pad = halo_h(xk, mesh, 1), (1, 0, 1)
        y = F.conv3d(xk.transpose(1, 2).to(self.dtype),
                     self.weight.to(self.dtype), self.bias.to(self.dtype),
                     padding=pad)
        return y.permute(0, 2, 3, 4, 1)


@manager.MODELS.add_component
class VNetDeepSup(VNet):
    """Deep-supervision V-Net. Arguments as :class:`VNet`'s; ``generator``
    seeds the trunk's weights and then the three heads' (he_normal, zero
    bias)."""

    def __init__(self, elu: bool = False, in_channels: int = 1,
                 num_classes: int = 4,
                 kernel_size: Sequence[_TRIPLE] = ((2, 2, 2),) * 4,
                 stride_size: Sequence[_TRIPLE] = ((2, 2, 2),) * 4,
                 dtype=torch.float32, dropout: bool = True,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        super().__init__(elu, in_channels, num_classes, kernel_size,
                         stride_size, dtype, dropout, remat, generator)
        self.Conv_0 = ConvHead(256, num_classes, dtype)
        self.Conv_1 = ConvHead(128, num_classes, dtype)
        self.Conv_2 = ConvHead(64, num_classes, dtype)
        for head in (self.Conv_0, self.Conv_1, self.Conv_2):
            head.reset_parameters(generator)

    def forward(self, x):
        run = self.block_runner()
        size = tuple(x.shape[1:4])
        xk = c5.pin_kl(c5.to_kl(x.to(self.dtype)))
        out, ups = self.trunk(xk)
        deep = [_upsampled(head, up, level, size) for head, (up, level)
                in zip((self.Conv_0, self.Conv_1, self.Conv_2), ups)]
        out = c5.from_kl(run(self.out_tr, out))
        return [out.float()] + [d.float() for d in deep]


def _upsampled(head, xk, level, size):
    """A head's logits upsampled to the input block's ``size``, under its
    level's mesh: in an H-replicated level the whole H axis is upsampled
    and the rank keeps its block (its loss then counts each voxel once)."""
    with use_mesh(level):
        y = head(xk)
    if level is None or not level.whole_h:
        return upsample_trilinear_batch(y, size, level)
    whole = (size[0], size[1] * level.space, size[2])
    return level.keep_h(upsample_trilinear_batch(y, whole), axis=2)
