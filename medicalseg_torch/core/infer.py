# Copyright 2026. Apache License 2.0.
"""Whole-volume inference with reverse transforms.

Counterpart of ``medicalseg_tpu/core/infer.py``: scan the transform list
for ``Resize3D`` records, run the model, resize the logits back to the
original (d, h, w) and argmax. Sliding-window inference lives in
:mod:`medicalseg_torch.core.sliding_window`.
"""

import torch

from ..ops.resize import resize3d_batch


def get_reverse_list(ori_shape, transforms):
    """List of ('resize', (d, h, w)) records, one per ``Resize3D`` of
    ``transforms`` (matched by class name; ``op.size`` an int or a
    triple)."""
    reverse_list = []
    d, h, w = ori_shape[0], ori_shape[1], ori_shape[2]
    for op in transforms:
        if op.__class__.__name__ in ["Resize3D"]:
            reverse_list.append(("resize", (d, h, w)))
            size = op.size if isinstance(op.size, tuple) else (op.size,) * 3
            d, h, w = size[0], size[1], size[2]
    return reverse_list


def reverse_transform(logit, ori_shape, transforms, order=1):
    """Recover logits [N, D, H, W, C] to the origin shape: the recorded
    resizes applied in reverse."""
    reverse_list = get_reverse_list(ori_shape, transforms)
    for item in reverse_list[::-1]:
        if item[0] == "resize":
            logit = resize3d_batch(logit, tuple(int(v) for v in item[1]),
                                   order=order)
        else:
            raise Exception(
                "Unexpected info '{}' in im_info".format(item[0]))
    return logit


def inference(forward, im, ori_shape=None, transforms=None):
    """Run the model and reverse-resize to the original shape.

    Args:
        forward: the logits of a batch, ``forward(im)`` [N, D, H, W, C]:
            an eval-mode model's ``main_output`` (a deep-supervision model
            then runs none of its auxiliary heads).
        im: [N, D, H, W, C] input batch.
        ori_shape: original (d, h, w) or None.
        transforms: transform list used at load time.

    Returns:
        (pred [N, D, H, W] int32, logit [N, D, H, W, C]).
    """
    with torch.inference_mode():
        logit = forward(im)
        if ori_shape is not None and \
                tuple(ori_shape) != tuple(logit.shape[1:4]):
            logit = reverse_transform(logit, ori_shape, transforms or [],
                                      order=1)
        pred = torch.argmax(logit, dim=-1).to(torch.int32)
    return pred, logit
