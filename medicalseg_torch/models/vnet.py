# Copyright 2026. Apache License 2.0.
"""V-Net: 3-D encoder-decoder for volumetric segmentation.

Counterpart of ``medicalseg_tpu/models/vnet.py``: the same topology
(InputTransition 1 -> 16 with the tiled-input residual, four
channel-doubling DownTransitions with residual NConv stacks, four
UpTransitions with transposed-conv upsample and skip concat, and the
OutputTransition head), the same per-stage anisotropic
``kernel_size``/``stride_size`` with VALID shape math, and the same
contract: ``forward`` takes NDHWC [N, D, H, W, C_in] and returns
``[logits]``, logits NDHWC [N, D, H, W, num_classes] in float32;
``main_output`` returns the logits alone.

Inside, every tensor is in the kernel layout [N, D, C, H, W]. Every 5^3
conv goes through the conv5 kernel; at eval each conv's BatchNorm and
PReLU run in the kernel's epilogue. The JAX package's per-stage layout
policy (``boundary_layouts``, ``_kl_block``) is TPU lane policy and has
no counterpart here. Submodule names follow the reference PyTorch V-Net
(``in_tr``, ``down_tr32``, ..., ``out_tr``).
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..cvlibs import manager
from ..ops import conv5 as c5
from ..parallel.mesh import active_mesh, h_levels, use_mesh
from .layers import (BatchNorm3D, ChannelDropout, Conv1x1KL, Conv5KL,
                     ConvBNAct, DownConvKL, NConvs, UpConvKL, activation,
                     remat)

_TRIPLE = Tuple[int, int, int]


def _dropout(on: bool, generator: torch.Generator) -> nn.Module:
    return ChannelDropout(generator) if on else nn.Identity()


class InputTransition(nn.Module):
    """in -> 16 channels: 5^3 conv + BN, plus the input tiled 16 / in times
    as a residual, then the activation. At eval the BN affine runs in the
    conv kernel's epilogue with alpha = 1 (the PReLU follows the
    residual)."""

    def __init__(self, in_channels: int, elu: bool, dtype):
        super().__init__()
        self.dtype = dtype
        self.repeat = 16 // in_channels
        kind = "stem" if in_channels == 1 else "head"
        self.conv1 = Conv5KL(in_channels, 16, kind, dtype)
        self.bn1 = BatchNorm3D(16, dtype)
        self.relu1 = activation(elu, 16, dtype)

    def forward(self, xk):
        if not self.conv1.fuses(xk):
            out = self.bn1(self.conv1(xk))
        else:
            inv, shift = self.bn1.affine_only()
            out = self.conv1(xk, epilogue=(inv, shift, torch.ones_like(inv)))
        x_tile = xk.repeat(1, 1, self.repeat, 1, 1).to(self.dtype)
        return self.relu1(out + x_tile)


class DownTransition(nn.Module):
    """Strided VALID conv doubling the channels + residual NConv stack."""

    def __init__(self, in_channels: int, n_convs: int, elu: bool,
                 dropout: bool, down_stride: _TRIPLE, down_kernel: _TRIPLE,
                 dtype, generator: torch.Generator):
        super().__init__()
        out_channels = 2 * in_channels
        self.down_conv = DownConvKL(in_channels, out_channels, down_kernel,
                                    down_stride, dtype)
        self.bn1 = BatchNorm3D(out_channels, dtype)
        self.relu1 = activation(elu, out_channels, dtype)
        self.do1 = _dropout(dropout, generator)
        self.ops = NConvs(out_channels, n_convs, elu, dtype)
        self.relu2 = activation(elu, out_channels, dtype)

    def forward(self, xk, levels=None):
        """``levels``: the meshes of the input's and the output's level
        (``parallel.h_levels``); the active mesh for both when None."""
        at, into = levels or (active_mesh(),) * 2
        with use_mesh(at):
            down = self.down_conv(xk, into)
        with use_mesh(into):
            down = self.relu1(self.bn1(down))
            out = self.ops(self.do1(down))
            return self.relu2(out + down)


class UpTransition(nn.Module):
    """VALID transposed-conv upsample + skip concat + residual NConv
    stack."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int,
                 elu: bool, dropout: bool, dropout2: bool,
                 up_stride: _TRIPLE, up_kernel: _TRIPLE, dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.do1 = _dropout(dropout, generator)
        self.do2 = _dropout(dropout2, generator)
        self.up_conv = UpConvKL(in_channels, out_channels // 2, up_kernel,
                                up_stride, dtype)
        self.bn1 = BatchNorm3D(out_channels // 2, dtype)
        self.relu1 = activation(elu, out_channels // 2, dtype)
        self.ops = NConvs(out_channels, n_convs, elu, dtype)
        self.relu2 = activation(elu, out_channels, dtype)

    def forward(self, xk, skipk, levels=None):
        """``levels`` as :meth:`DownTransition.forward`'s: the meshes of
        ``xk``'s level and of the output's (and ``skipk``'s)."""
        at, into = levels or (active_mesh(),) * 2
        with use_mesh(at):
            up = self.up_conv(self.do1(xk), into)
        with use_mesh(into):
            out = self.relu1(self.bn1(up))
            xcat = torch.cat([out, self.do2(skipk).to(self.dtype)], dim=2)
            return self.relu2(self.ops(xcat) + xcat)


class OutputTransition(ConvBNAct):
    """5^3 conv -> BN -> activation (fused at eval) -> 1^3 conv to
    num_classes."""

    def __init__(self, in_channels: int, num_classes: int, elu: bool,
                 dtype):
        super().__init__(in_channels, num_classes, elu, dtype)
        self.conv2 = Conv1x1KL(num_classes, num_classes, dtype)

    def forward(self, xk):
        return self.conv2(super().forward(xk))


@manager.MODELS.add_component
class VNet(nn.Module):
    """V-Net. Arguments follow the JAX ``VNet`` (and the YAML surface):
    ``elu``, ``in_channels``, ``num_classes``, per-stage
    ``kernel_size``/``stride_size``, ``dtype`` (the activation dtype),
    ``dropout`` (the mid-stage ChannelDropouts) and ``remat`` (in
    training, checkpoint each transition: the backward recomputes one
    block at a time, so the live activations are bounded by the largest
    stage instead of the whole net). Parameters are initialised as flax
    initialises them, from ``generator`` (seed 0 when none is given),
    which also draws the dropout masks in training until
    :meth:`seed_dropout` replaces it."""

    def __init__(self, elu: bool = False, in_channels: int = 1,
                 num_classes: int = 4,
                 kernel_size: Sequence[_TRIPLE] = ((2, 2, 2),) * 4,
                 stride_size: Sequence[_TRIPLE] = ((2, 2, 2),) * 4,
                 dtype=torch.float32, dropout: bool = True,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        ks = [tuple(k) for k in kernel_size]
        ss = [tuple(s) for s in stride_size]
        self.dtype = dtype
        self.remat = bool(remat)
        # the H window and stride of each down conv (and its up conv)
        self.h_windows = [(k[1], st[1]) for k, st in zip(ks, ss)]
        g = generator
        self.in_tr = InputTransition(in_channels, elu, dtype)
        self.down_tr32 = DownTransition(16, 1, elu, False, ss[0], ks[0],
                                        dtype, g)
        self.down_tr64 = DownTransition(32, 2, elu, False, ss[1], ks[1],
                                        dtype, g)
        self.down_tr128 = DownTransition(64, 3, elu, dropout, ss[2], ks[2],
                                         dtype, g)
        self.down_tr256 = DownTransition(128, 2, elu, dropout, ss[3],
                                         ks[3], dtype, g)
        self.up_tr256 = UpTransition(256, 256, 2, elu, dropout, dropout,
                                     ss[3], ks[3], dtype, g)
        self.up_tr128 = UpTransition(256, 128, 2, elu, dropout, dropout,
                                     ss[2], ks[2], dtype, g)
        self.up_tr64 = UpTransition(128, 64, 1, elu, False, False, ss[1],
                                    ks[1], dtype, g)
        self.up_tr32 = UpTransition(64, 32, 1, elu, False, False, ss[0],
                                    ks[0], dtype, g)
        self.out_tr = OutputTransition(32, num_classes, elu, dtype)
        self.reset_parameters(g)

    def reset_parameters(self, generator: torch.Generator):
        """he_normal conv kernels, zero biases (BN and PReLU keep their
        constant initial values)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def seed_dropout(self, generator: torch.Generator):
        """Draw the dropout masks from ``generator`` from now on; one on
        the model's device keeps the masks off the host."""
        for m in self.modules():
            if isinstance(m, ChannelDropout):
                m.generator = generator

    def block_runner(self):
        """run(block, *args): a transition's forward, under ``remat`` when
        the model rematerializes and gradients are being recorded."""
        if self.remat and self.training and torch.is_grad_enabled():
            def run(block, *args):
                return remat(block, *args)
        else:
            def run(block, *args):
                return block(*args)
        return run

    def h_levels(self, xk):
        """The mesh of each of the five levels for a kernel-layout input
        (``parallel.h_levels``: H sharded, or replicated from the first
        level whose block the strides do not divide)."""
        return h_levels(active_mesh(), xk.shape[3], self.h_windows)

    def trunk(self, xk):
        """The encoder and the decoder: up_tr32's output, and [(output,
        its level's mesh)] of up_tr256, up_tr128 and up_tr64 (the deep
        supervision's inputs)."""
        run = self.block_runner()
        lv = self.h_levels(xk)
        out16 = run(self.in_tr, xk)
        out32 = run(self.down_tr32, out16, lv[0:2])
        out64 = run(self.down_tr64, out32, lv[1:3])
        out128 = run(self.down_tr128, out64, lv[2:4])
        out256 = run(self.down_tr256, out128, lv[3:5])
        up3 = run(self.up_tr256, out256, out128, lv[4:2:-1])
        up2 = run(self.up_tr128, up3, out64, lv[3:1:-1])
        up1 = run(self.up_tr64, up2, out32, lv[2:0:-1])
        out = run(self.up_tr32, up1, out16, lv[1::-1])
        return out, [(up3, lv[3]), (up2, lv[2]), (up1, lv[1])]

    def main_output(self, x):
        """The logits alone, ``forward(x)[0]`` bit for bit: the trunk and
        out_tr, and no other head (a subclass's deep-supervision heads are
        not run). The eval, serving and export paths call this."""
        xk = c5.pin_kl(c5.to_kl(x.to(self.dtype)))
        out, _ = self.trunk(xk)
        return c5.from_kl(self.block_runner()(self.out_tr, out)).float()

    def forward(self, x):
        return [self.main_output(x)]
