# Copyright 2026. Apache License 2.0.
"""Weight-only int8 quantization of a ``state_dict`` for serving.

Counterpart of ``medicalseg_tpu/utils/quant.py``. Conv and transposed-conv
kernels are stored as int8 with per-output-channel float32 scales
(symmetric absmax), moved to the device in that form and dequantized
inside each forward; the weights live in device memory as int8 for as
long as the runner serves.

Only "heavy" tensors are quantized (floating point, ``ndim >= 2`` and
``numel >= min_size``). Biases, PReLU alphas and BatchNorm scale, shift and
running statistics are 1-D and stay float32.

A quantized entry ``name`` of the ``state_dict`` becomes two entries,
``name + ".__quant__"`` (int8, the weight's shape) and ``name + ".scale"``
(float32 [Co]). The output-channel axis of a weight is 0 ([Co, Ci, kd, kh,
kw]) except for a transposed conv's ([Ci, Co, ...]), whose names the caller
passes as ``transposed`` (:func:`transposed_conv_weights` finds them in a
model). The JAX package quantizes flax kernels [kd, kh, kw, Ci, Co] over
all axes but the last; per channel both see the same numbers, so the two
give the same ``q`` and ``scale`` bit for bit.
"""

from collections import OrderedDict

import torch

QUANT_SUFFIX = ".__quant__"
SCALE_SUFFIX = ".scale"


def transposed_conv_weights(model):
    """Names of the weights in ``model.state_dict()`` whose output-channel
    axis is 1: those of the transposed convs."""
    from ..models.layers import UpConvKL
    return frozenset(name + ".weight" for name, m in model.named_modules()
                     if isinstance(m, UpConvKL))


def _per_channel(scale, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return scale.reshape(shape)


def quantize_tensor(w, axis=0):
    """Symmetric absmax int8 quantization per output channel (``axis``).
    Returns (q int8 of w's shape, scale float32 [Co])."""
    w = w.detach().to(torch.float32)
    red = [a for a in range(w.ndim) if a != axis]
    absmax = torch.clamp(w.abs().amax(dim=red), min=1e-12)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(w / _per_channel(scale, w.ndim, axis)),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q, scale, axis=0, dtype=None):
    w = q.to(scale.dtype) * _per_channel(scale, q.ndim, axis)
    return w if dtype is None else w.to(dtype)


def quantize_state_dict(state_dict, transposed=(), min_size=1024):
    """Quantize every float tensor with ``ndim >= 2`` and ``numel >=
    min_size``; every other entry is kept as it is."""
    out = OrderedDict()
    for name, t in state_dict.items():
        if (t.ndim >= 2 and t.numel() >= min_size
                and t.dtype.is_floating_point):
            q, scale = quantize_tensor(t, 1 if name in transposed else 0)
            out[name + QUANT_SUFFIX] = q
            out[name + SCALE_SUFFIX] = scale
        else:
            out[name] = t
    return out


def dequantize_state_dict(qstate, transposed=(), dtype=None):
    """Inverse of :func:`quantize_state_dict`: a ``state_dict`` with float
    weights (float32, or ``dtype``) on the device the int8 tensors lie
    on."""
    out = OrderedDict()
    for name, t in qstate.items():
        if name.endswith(QUANT_SUFFIX):
            base = name[:-len(QUANT_SUFFIX)]
            out[base] = dequantize_tensor(
                t, qstate[base + SCALE_SUFFIX],
                1 if base in transposed else 0, dtype)
        elif not (name.endswith(SCALE_SUFFIX) and
                  name[:-len(SCALE_SUFFIX)] + QUANT_SUFFIX in qstate):
            out[name] = t
    return out


def round_trip_parameters(model, precision):
    """Round ``model``'s parameters (not its BatchNorm statistics) through
    a serving precision, in place, to measure what it costs on a val set:
    ``int8`` quantizes the heavy tensors and dequantizes them again
    (:func:`quantize_state_dict`, :func:`dequantize_state_dict`), ``bf16``
    rounds every floating-point parameter through bfloat16, ``fp32``
    leaves them. The JAX package's val CLI does the same to its params
    tree. Returns ``model``."""
    if precision not in ("fp32", "bf16", "int8"):
        raise ValueError("precision must be fp32, bf16 or int8, got "
                         "{!r}".format(precision))
    params = dict(model.named_parameters())
    with torch.no_grad():
        if precision == "int8":
            transposed = transposed_conv_weights(model)
            back = dequantize_state_dict(quantize_state_dict(
                {n: p.detach() for n, p in params.items()}, transposed),
                transposed)
            for name, p in params.items():
                p.copy_(back[name])
        elif precision == "bf16":
            for p in params.values():
                if p.is_floating_point():
                    p.copy_(p.to(torch.bfloat16))
    return model
