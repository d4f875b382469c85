# Copyright 2026. Apache License 2.0.
"""The forward's FLOPs of a V-Net, counted from its layer shapes.

The count is twice the multiply-adds of every convolution of the forward:
the 5^3 SAME convs (``Conv5KL``), the strided VALID down convs
(``DownConvKL``), the VALID transposed up convs (``UpConvKL``), the 1^3
output conv (``Conv1x1KL``) and VNetDeepSup's 3^3 SAME heads
(``ConvHead``). A kernel tap counts only where it reads an element of the
input, not where it falls into the padding or between the elements of a
transposed conv's dilated input, as XLA's cost analysis counts a
convolution: the JAX package's end-of-training report takes its figure
from there, and it is within 0.2% of this count for the same model and
input (the rest is elementwise work, which is not counted here). Counting
every tap would overstate a small input by up to 1.8x.

The shapes come from a walk over the model's levels with the VALID shape
rules of ``models/vnet.py``; nothing runs on the device.
"""

from math import prod

__all__ = ["window_taps", "forward_flops"]


def window_taps(n_in, n_out, k, stride=1, pad=0, dilation=1):
    """The (output, tap) pairs of one axis of a convolution that read an
    input element: output ``o`` and tap ``t`` read index ``o * stride -
    pad + t`` of the input dilated by ``dilation`` (``dilation - 1`` holes
    between its ``n_in`` elements)."""
    count = 0
    for o in range(n_out):
        for t in range(k):
            u = o * stride - pad + t
            if u % dilation == 0 and 0 <= u // dilation < n_in:
                count += 1
    return count


def _same(conv, size):
    """Multiply-adds of a stride-1 SAME conv (``weight`` [Co, Ci, k, k,
    k]) on a volume of ``size``."""
    co, ci, k = conv.weight.shape[:3]
    return ci * co * prod(window_taps(n, n, k, 1, k // 2) for n in size)


def _down(conv, size):
    """Multiply-adds and output size of a strided VALID conv."""
    co, ci = conv.weight.shape[:2]
    out = tuple((n - k) // s + 1 for n, k, s in
                zip(size, conv.weight.shape[2:], conv.stride))
    taps = prod(window_taps(n, o, k, s) for n, o, k, s in
                zip(size, out, conv.weight.shape[2:], conv.stride))
    return ci * co * taps, out


def _up(conv, size):
    """Multiply-adds and output size of a VALID transposed conv (``weight``
    [Ci, Co, *k]): a stride-1 conv over the input dilated by the stride,
    padded by k - 1 on each side."""
    ci, co = conv.weight.shape[:2]
    out = tuple((n - 1) * s + k for n, k, s in
                zip(size, conv.weight.shape[2:], conv.stride))
    taps = prod(window_taps(n, o, k, 1, k - 1, s) for n, o, k, s in
                zip(size, out, conv.weight.shape[2:], conv.stride))
    return ci * co * taps, out


def forward_flops(model, dhw, batch=1):
    """FLOPs of ``model``'s forward (a ``VNet`` or ``VNetDeepSup``) on
    ``batch`` volumes of ``dhw`` = (D, H, W): twice the in-bounds
    multiply-adds of its convolutions (module docstring)."""
    size = tuple(int(n) for n in dhw)
    macs = _same(model.in_tr.conv1, size)
    for tr in (model.down_tr32, model.down_tr64, model.down_tr128,
               model.down_tr256):
        m, size = _down(tr.down_conv, size)
        macs += m + sum(_same(op.conv1, size) for op in tr.ops)
    ups = []
    for tr in (model.up_tr256, model.up_tr128, model.up_tr64, model.up_tr32):
        m, size = _up(tr.up_conv, size)
        macs += m + sum(_same(op.conv1, size) for op in tr.ops)
        ups.append(size)
    conv2 = model.out_tr.conv2.weight
    macs += (_same(model.out_tr.conv1, size) +
             conv2.shape[0] * conv2.shape[1] * prod(size))
    for name, level in zip(("Conv_0", "Conv_1", "Conv_2"), ups):
        head = getattr(model, name, None)
        if head is not None:  # VNetDeepSup's heads on up_tr256/128/64
            macs += _same(head, level)
    return 2 * macs * int(batch)
