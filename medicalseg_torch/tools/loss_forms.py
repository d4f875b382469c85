# Copyright 2026. Apache License 2.0.
"""Times the forms of the flagship's losses on the card: the four
MixedLoss(CrossEntropyLoss + DiceLoss) heads of
``configs/synthetic/vnetdeepsup_synspine_15k.yml``, forward and backward,
on seeded float32 logits of the step's shape (3 x 12 x 512 x 512, 20
classes) and labels in [0, 20) with some set to the ignore index.

    python -m medicalseg_torch.tools.loss_forms [--classes 20]
        [--shape 3 12 512 512]

Forms:

* ``loop``: the per-class loop (``MEDSEG_LOSS_FUSED=0``);
* ``fused``: the port's default form: CrossEntropyLoss gathers the
  label's log-probability, DiceLoss sums under boolean class masks made
  by one compare of the labels against ``arange(C)``;
* ``compare``: the JAX package's fused form, a float one-hot made by one
  compare, written here in PyTorch;
* ``gather``: a candidate not kept: CrossEntropyLoss as ``fused``, and
  DiceLoss's intersections and label counts gathered and added into their
  class by ``index_add`` (atomic adds into C addresses).

For each: ms of one forward and backward of the four heads (CUDA events,
one warm-up, median of three), the device time of one (``torch.profiler``)
and its three largest operators, the peak memory above the inputs, and the
largest difference of the loss and of the logits' gradients from the loop
form's (relative to the largest gradient entry). One JSON line per form,
with the card's name. Needs one NVIDIA GPU.
"""
import argparse
import json
import os

import numpy as np
import torch

from ..models.losses import (CrossEntropyLoss, DiceLoss, MixedLoss,
                             class_weights)
from ..utils.loss_utils import loss_computation


def compare_ce(logits, labels, ignore_index=255):
    """The JAX fused form of CrossEntropyLoss (dynamic weights)."""
    num_classes = logits.shape[-1]
    weight = class_weights(logits)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    oh = (labels[..., None] == torch.arange(num_classes,
                                            device=labels.device)).float()
    nll = -(log_probs * oh).sum(-1)
    w = (weight * oh).sum(-1) * (labels != ignore_index)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


def compare_dice(logits, labels, ignore_index=255):
    """The JAX fused form of DiceLoss (sigmoid): (loss, per-class dice)."""
    num_classes = logits.shape[-1]
    probs = torch.sigmoid(logits.float())
    valid = (labels != ignore_index)[..., None]
    ohv = (labels[..., None] == torch.arange(
        num_classes, device=labels.device)).float() * valid
    pv = probs * valid
    axes = tuple(range(labels.dim()))
    intersect = (pv * ohv).sum(axes)
    denominator = (pv * pv).sum(axes) + ohv.sum(axes)
    dice = 2 * (intersect / torch.clamp(denominator, min=1e-6))
    return 1.0 - dice.mean(), dice


def gather_dice(logits, labels, ignore_index=255):
    """DiceLoss (sigmoid) with the per-class sums by ``index_add``:
    (loss, per-class dice)."""
    num_classes = logits.shape[-1]
    probs = torch.sigmoid(logits.float())
    valid = labels != ignore_index
    hit = (valid & (labels >= 0) & (labels < num_classes)).float()
    idx = labels.clamp(0, num_classes - 1)
    pv = probs * valid[..., None]
    p_label = pv.gather(-1, idx[..., None])[..., 0] * hit
    idx = idx.reshape(-1)
    zeros = torch.zeros(num_classes, device=logits.device)
    intersect = zeros.index_add(0, idx, p_label.reshape(-1))
    denominator = ((pv * pv).reshape(-1, num_classes).sum(0) +
                   zeros.index_add(0, idx, hit.reshape(-1)))
    dice = 2 * (intersect / torch.clamp(denominator, min=1e-6))
    return 1.0 - dice.mean(), dice


def run_form(form, logits, labels, losses):
    for t in logits:
        t.grad = None
    if form == "compare":
        total = sum(0.25 * (compare_ce(t, labels) + compare_dice(t, labels)[0])
                    for t in logits)
    elif form == "gather":
        os.environ["MEDSEG_LOSS_FUSED"] = "1"
        ce = CrossEntropyLoss()
        total = sum(0.25 * (ce(t, labels) + gather_dice(t, labels)[0])
                    for t in logits)
    else:
        os.environ["MEDSEG_LOSS_FUSED"] = "0" if form == "loop" else "1"
        total = sum(loss_computation(logits, labels, losses)[0])
    total.backward()
    return total.detach()


def time_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    ops = sorted(((ev.key, ev.self_device_time_total / 1e3)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CPU and
                  ev.self_device_time_total), key=lambda kv: -kv[1])[:3]
    return kernels / 1e3, ops


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--classes", type=int, default=20)
    parser.add_argument("--shape", type=int, nargs=4,
                        default=[3, 12, 512, 512])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loss_forms needs an NVIDIA GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = tuple(args.shape)
    logits = [torch.randn(shape + (args.classes,), generator=gen,
                          device=dev).requires_grad_(True) for _ in range(4)]
    labels = torch.randint(0, args.classes, shape, generator=gen,
                           device=dev)
    labels[torch.rand(shape, generator=gen, device=dev) < 0.01] = 255
    losses = {"types": [MixedLoss([CrossEntropyLoss(), DiceLoss()], [1, 1])
                        for _ in range(4)], "coef": [0.25] * 4}
    name = torch.cuda.get_device_name(0)

    ref_loss = run_form("loop", logits, labels, losses)
    ref_grads = [t.grad.clone() for t in logits]
    scale = max(g.abs().max().item() for g in ref_grads)
    for form in ("loop", "fused", "compare", "gather"):
        loss = run_form(form, logits, labels, losses)
        grad_err = max((t.grad - g).abs().max().item()
                       for t, g in zip(logits, ref_grads)) / scale
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: run_form(form, logits, labels, losses))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        dev_ms, ops = device_ms(lambda: run_form(form, logits, labels,
                                                 losses))
        print(json.dumps({
            "form": form, "device": name, "shape": list(shape),
            "classes": args.classes, "heads": 4, "ms": ms,
            "device_ms": dev_ms, "top_ops": ops, "peak_gb_above": peak,
            "loss_rel_err": abs(loss.item() - ref_loss.item()) /
            abs(ref_loss.item()), "grad_err_rel_max": grad_err}),
            flush=True)
    os.environ.pop("MEDSEG_LOSS_FUSED")


if __name__ == "__main__":
    main()
