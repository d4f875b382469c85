# Copyright 2026. Apache License 2.0.
"""Train state and the train / eval step.

Counterpart of ``medicalseg_tpu/core/state.py``. One call of the step is
one training iteration: (augmentation ->) forward -> losses -> backward ->
optimizer and BatchNorm-statistics update. PyTorch runs it eagerly, kernel
by kernel, on the model's device; nothing in it waits for the device, and
the metrics stay there (fetch them at log points only).

Unlike the JAX step, which returns a new immutable state, the port's step
updates the state in place (parameters, optimizer slots, BatchNorm
buffers, step counter) and returns the same object.

Quick start::

    cfg = Config("configs/lung_coronavirus/"
                 "vnet_lung_coronavirus_128_128_128_15k_tpu.yml")
    state = TrainState.create(cfg.model, cfg.build_optimizer,
                              cfg.lr_scheduler, seed=0)   # on the card
    step = make_train_step(cfg.loss)
    state, metrics = step(state, images, labels)  # NDHWC f32, NDHW int
"""

import dataclasses
from typing import Callable, Optional

import torch

from ..models.layers import remat
from ..utils.loss_utils import loss_computation
from ..utils.utils import resolve_device


@dataclasses.dataclass
class TrainState:
    """Carries the model (parameters and BatchNorm statistics), the
    optimizer (its slots), the LR schedule, the number of updates done and
    the generator that draws the dropout masks and the augmentations."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model, make_optimizer, schedule, seed: int = 0,
               device: str = "cuda"):
        """Move ``model`` to ``device`` ('cuda' unless the caller asks for
        'cpu'), build the optimizer over its parameters
        (``make_optimizer(params)``, e.g. ``Config.build_optimizer``) and
        seed a generator on the same device for the dropout masks."""
        device = resolve_device(device)
        model = model.to(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        if hasattr(model, "seed_dropout"):
            model.seed_dropout(generator)
        return cls(model=model, optimizer=make_optimizer(model.parameters()),
                   schedule=schedule, generator=generator)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.step)


def make_train_step(losses: dict, augment_fn: Optional[Callable] = None,
                    checkpoint_policy: Optional[str] = None):
    """Build the train step.

    Args:
        losses: {'types': [...], 'coef': [...]} loss config.
        augment_fn: optional (images, labels, generator) -> (images NDHWC,
            labels) device augmentation run at the head of the step.
        checkpoint_policy: 'full' to rematerialize the whole forward pass
            (``torch.utils.checkpoint``), trading FLOPs for memory on
            large volumes; per-block rematerialization is the model's
            ``remat`` key.

    Returns step(state, images, labels) -> (state, metrics) where metrics
    = {'loss', 'loss_list', 'per_channel_dice'} are detached tensors on
    the device. Images [N, D, H, W, C] (any float dtype) widen to f32 and
    labels [N, D, H, W] (any integer dtype) to int64 on the device.
    """
    if checkpoint_policy not in (None, "full"):
        raise ValueError("checkpoint_policy must be None or 'full', got "
                         + repr(checkpoint_policy))

    def step(state: TrainState, images, labels):
        device = state.device
        images = torch.as_tensor(images).to(device, non_blocking=True).float()
        labels = torch.as_tensor(labels).to(device, non_blocking=True).long()
        if augment_fn is not None:
            images, labels = augment_fn(images, labels, state.generator)
        model, optimizer = state.model, state.optimizer
        model.train()
        lr = state.schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        if checkpoint_policy == "full":
            logits_list = remat(model, images)
        else:
            logits_list = model(images)
        loss_list, per_channel_dice = loss_computation(logits_list, labels,
                                                       losses)
        total = sum(loss_list)
        total.backward()
        optimizer.step()
        state.step += 1
        metrics = {
            "loss": total.detach(),
            "loss_list": torch.stack([torch.as_tensor(
                l, device=device).detach() for l in loss_list]),
            "per_channel_dice": (per_channel_dice.detach()
                                 if per_channel_dice is not None
                                 else torch.zeros((1,), device=device)),
        }
        return state, metrics

    return step


def make_eval_step(losses: dict):
    """Eval forward: step(state, images, labels) -> (logits_list,
    loss_list, per_channel_dice), with the first loss of the config (the
    main head's), no gradients and the running BatchNorm statistics."""
    main = {"types": [losses["types"][0]], "coef": [losses["coef"][0]]}

    def step(state: TrainState, images, labels):
        device = state.device
        images = torch.as_tensor(images).to(device).float()
        labels = torch.as_tensor(labels).to(device).long()
        state.model.eval()
        with torch.no_grad():
            logits_list = state.model(images)
            loss_list, per_channel_dice = loss_computation(
                logits_list, labels, main)
        return logits_list, loss_list, per_channel_dice

    return step
