# Copyright 2026. Apache License 2.0.
"""Shared building blocks of the 3-D segmentation models.

Counterpart of ``medicalseg_tpu/models/layers.py``. Every module here works
in the kernel layout [N, D, C, H, W] (channel axis 2), the port's one
internal layout: the conv5 kernel reads and writes it, and the stacks of
conv, BatchNorm and PReLU chain in it without layout copies.

Mixed precision as in the JAX package: ``dtype`` is the activation dtype
(bfloat16 when serving), while parameters and BatchNorm statistics stay
float32 and are cast where they are used.
"""

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv5 as c5
from ..ops.updown import conv_down_kl, conv_up_kl


def _bshape(c):
    return (1, 1, c, 1, 1)


# True while a checkpointed block runs a second time for its backward. A
# recomputed forward must change no state: BatchNorm3D leaves its running
# statistics alone and ChannelDropout reuses the mask of the first run.
_RECOMPUTING = False


@contextlib.contextmanager
def _recomputing():
    global _RECOMPUTING
    saved, _RECOMPUTING = _RECOMPUTING, True
    try:
        yield
    finally:
        _RECOMPUTING = saved


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (the JAX
    ``nn.remat`` / ``jax.checkpoint``). The second run is marked, so that
    BatchNorm statistics are updated once and dropout masks are reused
    (``checkpoint`` itself saves only the global generators' state, not an
    explicit ``torch.Generator``'s)."""
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*a)
        with _recomputing():
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def he_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax ``he_normal``: a normal truncated at two standard deviations,
    with variance 2 / fan_in after truncation."""
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class PReLU(nn.Module):
    """Per-channel PReLU, learnable ``alpha`` [C] starting at 0.25."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        alpha = self.alpha.to(self.dtype).reshape(_bshape(-1))
        return torch.where(x >= 0, x, alpha * x)


def activation(elu: bool, features: int, dtype=torch.float32) -> nn.Module:
    """The ELU-or-PReLU switch of V-Net (JAX ``Activation``)."""
    return nn.ELU() if elu else PReLU(features, dtype)


class BatchNorm3D(nn.Module):
    """BatchNorm with f32 statistics and a normalize in the compute dtype.

    Unlike ``torch.nn.BatchNorm3d`` it keeps the *biased* batch variance in
    ``running_var`` (the JAX package's, and the train-dynamics oracle's,
    semantics). ``MOMENTUM`` is flax's: running = m * running + (1 - m) *
    batch, so flax's 0.9 is torch's ``momentum=0.1``.
    """
    MOMENTUM = 0.9
    EPSILON = 1e-5

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def affine_only(self):
        """The eval normalize folded to f32 (inv, shift), each [C], for a
        conv epilogue."""
        inv = self.weight * torch.rsqrt(self.running_var + self.EPSILON)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = (0, 1, 3, 4)
            mean = xf.mean(dim=axes)
            var = torch.clamp(xf.square().mean(dim=axes) - mean.square(),
                              min=0.0)
            if not _RECOMPUTING:
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
            inv = self.weight * torch.rsqrt(var + self.EPSILON)
            shift = self.bias - mean * inv
        else:
            inv, shift = self.affine_only()
        return (x.to(self.dtype) * inv.to(self.dtype).reshape(_bshape(-1)) +
                shift.to(self.dtype).reshape(_bshape(-1)))


class Conv5KL(nn.Module):
    """5^3 SAME conv through the conv5 kernel (JAX ``PallasConv5KL`` and
    ``PallasConv5``). Owns ``weight`` [Co, Ci, 5, 5, 5] and ``bias`` [Co]
    in f32; the weight is cast to the activation dtype at use, the bias is
    added in f32 inside the kernel. In training the conv is differentiable
    through the backward kernels (``ops.conv5.conv5_kl``'s Function)."""

    def __init__(self, in_features: int, features: int, kind: str = "head",
                 dtype=torch.float32):
        super().__init__()
        self.kind = kind
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 5, 5, 5))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        he_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def fuses(self, xk) -> bool:
        """True where the fused epilogue may run: at eval, and with no
        gradient being recorded through the conv (the fused kernel has no
        backward; an eval-mode forward under autograd takes the unfused
        ops instead)."""
        return not self.training and not (torch.is_grad_enabled() and (
            xk.requires_grad or self.weight.requires_grad))

    def forward(self, xk, epilogue=None):
        """``epilogue=(inv, shift, alpha)`` (each f32 [Co]) fuses the BN
        affine and PReLU into the kernel's output path (inference only)."""
        xk = xk.to(self.dtype)
        w = self.weight.permute(2, 3, 4, 1, 0)  # -> [5, 5, 5, Ci, Co]
        if epilogue is None:
            return c5.conv5_kl(xk, w, self.bias, self.kind)
        return c5.conv5_kl_fused(xk, w, self.bias, epilogue, self.kind)


class Conv1x1KL(nn.Module):
    """1^3 conv as a plain contraction over the channel axis of a
    kernel-layout tensor, f32 accumulation, cast to ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        he_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, xk):
        w = self.weight[:, :, 0, 0, 0].to(self.dtype).float()  # [Co, Ci]
        out = torch.einsum("ndchw,oc->ndohw", xk.to(self.dtype).float(), w)
        return (out + self.bias.reshape(_bshape(-1))).to(self.dtype)


class ConvBNAct(nn.Module):
    """5^3 conv + BatchNorm + activation (reference LUConv). At eval with
    PReLU the BN affine and PReLU run in the conv kernel's epilogue."""

    def __init__(self, in_features: int, features: int, elu: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv5KL(in_features, features, "head", dtype)
        self.bn1 = BatchNorm3D(features, dtype)
        self.relu1 = activation(elu, features, dtype)

    def forward(self, xk):
        if self.conv1.fuses(xk) and isinstance(self.relu1, PReLU):
            inv, shift = self.bn1.affine_only()
            return self.conv1(xk, epilogue=(inv, shift, self.relu1.alpha))
        return self.relu1(self.bn1(self.conv1(xk)))


class NConvs(nn.Sequential):
    """``depth`` stacked 5^3 ConvBNAct blocks at constant width."""

    def __init__(self, features: int, depth: int, elu: bool = False,
                 dtype=torch.float32):
        super().__init__(*[ConvBNAct(features, features, elu, dtype)
                           for _ in range(depth)])


class ChannelDropout(nn.Module):
    """Dropout3D: zeroes whole channels (mask broadcast over D, H, W) with
    probability ``RATE``, survivors scaled by 1 / (1 - RATE); identity at
    eval. The mask is drawn from ``generator``, on the generator's device:
    give the module a generator on the model's device
    (``VNet.seed_dropout``) and no mask crosses from the host. A
    recomputed (checkpointed) forward reuses the mask of the first run."""
    RATE = 0.5

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.generator = generator
        self._keep = None

    def forward(self, xk):
        if not self.training:
            return xk
        n, _, c = xk.shape[:3]
        if not _RECOMPUTING or self._keep is None:
            self._keep = torch.rand(
                (n, 1, c, 1, 1), generator=self.generator,
                device=self.generator.device) >= self.RATE
        return xk * (self._keep.to(xk.device, xk.dtype) / (1.0 - self.RATE))


class DownConvKL(nn.Module):
    """Strided VALID conv (JAX ``S2DConv`` / ``nn.Conv``); owns ``weight``
    [Co, Ci, *kernel] and ``bias`` [Co] in f32."""

    def __init__(self, in_features, features, kernel, stride,
                 dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        he_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, xk):
        return conv_down_kl(xk.to(self.dtype), self.weight, self.bias,
                            self.stride)


class UpConvKL(nn.Module):
    """VALID transposed conv (JAX ``D2SConvTranspose`` /
    ``nn.ConvTranspose``); owns ``weight`` [Ci, Co, *kernel] and ``bias``
    [Co] in f32."""

    def __init__(self, in_features, features, kernel, stride,
                 dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        # flax's fan_in of a ConvTranspose kernel [*k, Ci, Co] is k^3 * Ci
        he_normal_(self.weight, self.weight[:, 0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, xk):
        return conv_up_kl(xk.to(self.dtype), self.weight, self.bias,
                          self.stride)
