# Copyright 2026. Apache License 2.0.
"""The training loop.

Counterpart of ``medicalseg_tpu/core/train.py`` (the reference's
medicalseg/core/train.py:30-274) on one device: an iteration-based loop
with resume, windowed loss / mDice / ips logging every ``log_iters``,
checkpoints every ``save_interval`` (and at the end) with
``keep_checkpoint_max`` eviction, and with a ``val_dataset`` an evaluation
at each of those points that keeps the best model (``best_model/``, its
``best.json`` restored on resume so that a worse later eval cannot
overwrite it). ``use_vdl`` writes ``Train/*`` at log points and
``Evaluate/*`` after each eval through tensorboardX.

Each iteration takes a batch that :class:`~.prefetch.DevicePrefetcher`
has already copied to the card, and runs the train step of
:mod:`.state`: device augmentation (in ``device`` loader mode), forward,
losses, backward, optimizer. The metrics stay on the card between log
points, so the loop reads the device back only there and at checkpoints;
the batch cost of the iteration that logs includes that wait, so a window's
mean is its wall time per iteration.
Before each step the state's generator is seeded from (``seed``, step):
it draws the dropout masks, and its seed keys the augmentation's draws, so
a resumed run repeats the unbroken run's masks and draws.

Not ported yet, and raising ``NotImplementedError``: ``profiler_options``,
``steps_per_dispatch > 1`` and the ``device_cache`` loader mode (ROADMAP,
modules to port, item 4). Checkpoints are written synchronously, and there
is no end-of-training FLOPs report (the JAX package's comes from XLA's
cost analysis).
"""

import json
import os
import shutil
import time
from collections import deque

import torch

from ..transforms import DeviceAugmentor
from ..transforms.device import step_seed
from ..utils import (TimeAverager, calculate_eta, logger, resume,
                     save_checkpoint)
from ..utils.checkpoint import _atomic_write
from ..utils.utils import resolve_device
from .loader import TrainLoader
from .prefetch import DevicePrefetcher
from .state import TrainState, make_train_step
from .val import evaluate

BEST_DIR = "best_model"
BEST_JSON = "best.json"


def _unported(profiler_options, steps_per_dispatch):
    if profiler_options:
        raise NotImplementedError(
            "profiler_options comes with the cached train step (ROADMAP, "
            "modules to port, item 4)")
    if steps_per_dispatch != 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 comes with the cached train step "
            "(ROADMAP, modules to port, item 4)")


def train(model,
          train_dataset,
          val_dataset=None,
          optimizer=None,
          lr_scheduler=None,
          save_dir="output",
          iters=10000,
          batch_size=2,
          resume_model=None,
          save_interval=1000,
          log_iters=10,
          num_workers=0,
          use_vdl=False,
          losses=None,
          keep_checkpoint_max=5,
          profiler_options=None,
          to_static_training=False,
          seed=0,
          data_loader_mode="auto",
          steps_per_dispatch=1,
          wire_dtype="bfloat16",
          device="cuda"):
    """Train ``model`` on ``train_dataset``; returns the final
    :class:`~.state.TrainState`.

    The surface is the JAX function's without the mesh (``mesh``,
    ``space``) and ``async_checkpoint``: ``optimizer`` builds the
    optimizer over the parameters (``Config.build_optimizer``),
    ``lr_scheduler`` is the schedule (``Config.lr_scheduler``), ``losses``
    the loss config (``Config.loss``), and ``device`` is 'cuda' unless the
    caller asks for 'cpu'. ``to_static_training`` is accepted and unused,
    as in the JAX package."""
    _unported(profiler_options, steps_per_dispatch)
    device = resolve_device(device)
    loader = TrainLoader(train_dataset, batch_size=batch_size,
                         num_workers=num_workers, seed=seed,
                         mode=data_loader_mode, wire_dtype=wire_dtype)
    augment = (DeviceAugmentor(train_dataset.raw_transforms, seed=seed + 1)
               if loader.mode == "device" else None)
    state = TrainState.create(model, optimizer, lr_scheduler, seed=seed,
                              device=device)
    state.step = resume(state.model, state.optimizer, resume_model)
    if not os.path.isdir(save_dir):
        if os.path.exists(save_dir):
            os.remove(save_dir)
        os.makedirs(save_dir, exist_ok=True)

    log_writer = None
    if use_vdl:
        from tensorboardX import SummaryWriter
        log_writer = SummaryWriter(save_dir)
    best_mean_dice, best_model_iter = -1.0, -1
    best_json = os.path.join(save_dir, BEST_DIR, BEST_JSON)
    if state.step > 0 and os.path.isfile(best_json):
        # a resumed run keeps the best model of the run it resumes: a
        # worse later eval must not overwrite it
        best_mean_dice, best_model_iter = _read_best(best_json)
        logger.info("Restored best-model tracker: mDice {:.4f} at iter "
                    "{}".format(best_mean_dice, best_model_iter))

    step_fn = make_train_step(losses, augment_fn=augment)
    prefetcher = DevicePrefetcher(loader, device)
    reader_cost = TimeAverager()
    batch_cost = TimeAverager()
    save_models = deque()
    pending = []  # the device metrics of the iterations since the last log
    iters_per_epoch = loader.iters_per_epoch
    it = state.step
    batch_start = time.time()
    try:
        while it < iters:
            images, labels = next(prefetcher)
            reader_cost.record(time.time() - batch_start)
            state.generator.manual_seed(step_seed(seed, it))
            state, metrics = step_fn(state, images, labels)
            it = state.step
            pending.append(metrics)
            log = it % log_iters == 0
            if log:  # waits for the device: the window's costs include it
                loss = torch.stack([m["loss"] for m in pending]).mean()
                dice = torch.stack([m["per_channel_dice"]
                                    for m in pending]).mean()
                loss_list = torch.stack([m["loss_list"]
                                         for m in pending]).mean(0)
                avg_loss, mdice, *avg_loss_list = torch.cat(
                    [torch.stack([loss, dice]), loss_list]).tolist()
                pending = []
            batch_cost.record(time.time() - batch_start,
                              num_samples=batch_size)

            if log:
                lr = float(lr_scheduler(it)) if lr_scheduler else 0.0
                logger.info(
                    "[TRAIN] epoch: {}, iter: {}/{}, loss: {:.4f}, DSC: "
                    "{:.4f}, lr: {:.6f}, batch_cost: {:.4f}, reader_cost: "
                    "{:.5f}, ips: {:.4f} samples/sec | ETA {}".format(
                        it // iters_per_epoch, it, iters, avg_loss,
                        mdice * 100, lr, batch_cost.get_average(),
                        reader_cost.get_average(),
                        batch_cost.get_ips_average(),
                        calculate_eta(iters - it, batch_cost.get_average())))
                if log_writer is not None:
                    _write_train(log_writer, it, avg_loss, avg_loss_list,
                                 mdice * 100, lr, batch_cost.get_average(),
                                 reader_cost.get_average())
                reader_cost.reset()
                batch_cost.reset()

            if it % save_interval == 0 or it == iters:
                result = None
                if val_dataset is not None:
                    result = evaluate(state, val_dataset, losses,
                                      num_workers=num_workers,
                                      writer=log_writer, save_dir=save_dir)
                current = os.path.join(save_dir, "iter_{}".format(it))
                save_checkpoint(current, state.model, state.optimizer, it)
                save_models.append(current)
                if len(save_models) > keep_checkpoint_max > 0:
                    shutil.rmtree(save_models.popleft(), ignore_errors=True)
                if result is not None:
                    if result["mdice"] > best_mean_dice:
                        best_mean_dice, best_model_iter = result["mdice"], it
                        _save_best(save_dir, state.model, best_mean_dice,
                                   best_model_iter)
                    logger.info(
                        "[EVAL] The model with the best validation mDice "
                        "({:.4f}) was saved at iter {}.".format(
                            best_mean_dice, best_model_iter))
                    if log_writer is not None:
                        log_writer.add_scalar("Evaluate/Dice",
                                              result["mdice"], it)
                        if "auc_roc" in result:
                            log_writer.add_scalar("Evaluate/auc_roc",
                                                  result["auc_roc"], it)
            # eval and checkpoint time stays out of the next batch cost
            batch_start = time.time()
    finally:
        loader.stop()
        prefetcher.close()
        if log_writer is not None:
            log_writer.close()
    return state


def _read_best(path):
    """(mdice, iter) of a ``best.json``; (-1.0, -1) if it cannot be read."""
    try:
        with open(path) as f:
            best = json.load(f)
        return float(best.get("mdice", -1.0)), int(best.get("iter", -1))
    except (OSError, ValueError):
        return -1.0, -1


def _save_best(save_dir, model, mdice, it):
    """``best_model/model.msgpack``, then ``best.json`` {"mdice", "iter"}
    written atomically after the weights: a tracker never names weights
    that are not on disk."""
    best_dir = os.path.join(save_dir, BEST_DIR)
    save_checkpoint(best_dir, model)
    _atomic_write(os.path.join(best_dir, BEST_JSON),
                  json.dumps({"mdice": mdice, "iter": it}).encode())


def _write_train(writer, it, loss, loss_list, mdice, lr, batch_cost,
                 reader_cost):
    """The ``Train/*`` scalars of one log point, as the JAX loop writes
    them (``mdice`` in percent)."""
    writer.add_scalar("Train/loss", loss, it)
    if len(loss_list) > 1:
        for i, value in enumerate(loss_list):
            writer.add_scalar("Train/loss_{}".format(i), value, it)
    writer.add_scalar("Train/mdice", mdice, it)
    writer.add_scalar("Train/lr", lr, it)
    writer.add_scalar("Train/batch_cost", batch_cost, it)
    writer.add_scalar("Train/reader_cost", reader_cost, it)
