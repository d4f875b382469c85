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

The step runs in one of two forms. With ``steps_per_dispatch`` 1 in the
``device`` and ``host`` loader modes, each iteration takes a batch that
:class:`~.prefetch.DevicePrefetcher` has already copied to the card and
runs the eager train step of :mod:`.state` (device augmentation in
``device`` mode, forward, losses, backward, optimizer). In the
``device_cache`` mode, and with ``steps_per_dispatch`` n > 1, a dispatch
takes up to n iterations (never across a log or save point, which also
heals a resume that starts between them) through
``make_cached_train_step`` (the dataset staged on the card once, an index
vector uploaded a step, no prefetcher) or ``make_multi_step`` (n batches
stacked into one super-batch and uploaded together); on the card each of
their iterations replays one CUDA graph of the step. ``steps_per_dispatch``
must divide ``log_iters`` and ``save_interval``.

The metrics stay on the card between log points, so the loop reads the
device back only there and at checkpoints; the batch cost of the
iteration that logs includes that wait, so a window's mean is its wall
time per iteration. Before each step the state's generator is seeded from
(``seed``, step): it draws the dropout masks, and its seed keys the
augmentation's draws, so a resumed run repeats the unbroken run's masks
and draws. ``profiler_options`` traces a window of iterations
(:mod:`..utils.train_profiler`, called once an iteration).

With ``async_checkpoint`` (the default, as in the JAX loop) a save point
takes only the checkpoint's snapshot on the loop's thread: the encode and
the writes, the ``keep_checkpoint_max`` eviction and the best model (a
copy of the save point's model file) with its ``best.json`` run on one
writer thread in that order (:mod:`..utils.checkpoint`), and ``train``
waits for them before it returns or raises, raising a write that failed;
the jobs queued behind a failed write do not run, so a failed save evicts
nothing. Without it each save is written in place. Both leave the same
files, byte for byte. After the last iteration the loop logs the
forward's cost, ``Model forward cost: X GFLOPs (batch B)`` for the global
batch at the augmented sample shape, as the JAX loop does; the count
comes from the model's layer shapes (:mod:`..utils.flops`), where the JAX
package asks XLA's cost analysis.

Over a process mesh (``mesh``, or ``space`` with the process group that
``torchrun`` starts: ``parallel.init_from_env``) ``batch_size`` is per
data index, as in the JAX loop: the global batch is ``batch_size x
data``, each rank's loader makes its rows of the global, seeded batch
order and nothing else (whole samples, in every loader mode; a space
rank keeps its H block after the augmentation, or on the card in
``host`` mode), and the step gives the update and metrics of the global
batch (``core.state``): eagerly, or as replays of one CUDA graph a rank
in the cached and multi-step forms over NCCL. Every rank resumes from
the same file; rank 0 alone logs, writes checkpoints and ``best.json``
(and waits for its writer) and runs VisualDL, while the others wait at a
barrier at each save point. The evaluation runs over
the same mesh (``core.val.evaluate``).
"""

import functools
import json
import os
import shutil
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from ..models import VNet
from ..transforms import DeviceAugmentor
from ..transforms.device import step_seed
from ..utils import (TimeAverager, calculate_eta, logger, resume,
                     save_checkpoint, save_checkpoint_async, train_profiler,
                     wait_pending_checkpoints)
from ..parallel import mesh as mesh_lib
from ..utils import checkpoint as ckpt
from ..utils.flops import forward_flops
from ..utils.utils import resolve_device
from .loader import TrainLoader
from .prefetch import DevicePrefetcher
from .state import (TrainState, make_cached_train_step, make_multi_step,
                    make_train_step)
from .val import evaluate

BEST_DIR = "best_model"
BEST_JSON = "best.json"


def _make_save_dir(save_dir):
    """``save_dir`` as a directory, a file of that name removed first.
    Every rank of a mesh calls this at once: a directory another rank
    makes between this rank's look and its ``makedirs`` is kept."""
    if os.path.isfile(save_dir):
        os.remove(save_dir)
    os.makedirs(save_dir, exist_ok=True)


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
          mesh=None,
          space=1,
          data_loader_mode="auto",
          async_checkpoint=True,
          steps_per_dispatch=1,
          wire_dtype="bfloat16",
          device="cuda"):
    """Train ``model`` on ``train_dataset``; returns the final
    :class:`~.state.TrainState`.

    The surface is the JAX function's: ``async_checkpoint`` writes the
    checkpoints on a writer thread (module docstring), ``optimizer``
    builds the optimizer over the parameters
    (``Config.build_optimizer``), ``lr_scheduler`` is the schedule
    (``Config.lr_scheduler``), ``losses`` the loss config
    (``Config.loss``), ``mesh`` a ``parallel.Mesh`` (else one is built
    over the process group with ``space``: module docstring; every loader
    mode runs over it), and
    ``device`` is 'cuda' unless the caller asks for 'cpu' (a rank's card,
    ``cuda:LOCAL_RANK``, under ``torchrun``). ``to_static_training`` is
    accepted and unused, as in the JAX package."""
    device = resolve_device(device)
    if mesh is None:
        mesh = mesh_lib.build_mesh(space=space)
    n_dispatch = max(int(steps_per_dispatch), 1)
    if n_dispatch > 1 and (log_iters % n_dispatch or
                           save_interval % n_dispatch):
        raise ValueError(
            "steps_per_dispatch ({}) must divide log_iters ({}) and "
            "save_interval ({})".format(n_dispatch, log_iters,
                                        save_interval))
    sharded = mesh.world > 1
    if sharded:
        logger.info("Training over {} ranks: data {} x space {} ({}), "
                    "global batch {}".format(
                        mesh.world, mesh.data, mesh.space, mesh.backend,
                        batch_size * mesh.data))
    loader = TrainLoader(train_dataset, batch_size=batch_size * mesh.data,
                         num_workers=num_workers, seed=seed,
                         mode=data_loader_mode, wire_dtype=wire_dtype,
                         pin_memory=device.type == "cuda",
                         rows=mesh.rows(batch_size))
    augment = (DeviceAugmentor(train_dataset.raw_transforms, seed=seed + 1)
               if loader.mode in ("device", "device_cache") else None)
    # the cached and multi-step forms replay a CUDA graph of the step
    dispatched = loader.mode == "device_cache" or n_dispatch > 1
    state = TrainState.create(model, optimizer, lr_scheduler, seed=seed,
                              device=device, capturable_optimizer=dispatched)
    state.step = resume(state.model, state.optimizer, resume_model)
    _make_save_dir(save_dir)

    log_writer = None
    if use_vdl and mesh.primary:
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

    prefetcher = cache = None
    if loader.mode == "device_cache":
        cache = loader.build_device_cache(device)
        step_fn = make_cached_train_step(losses, n_dispatch,
                                         augment_fn=augment, mesh=mesh)
    elif n_dispatch > 1:
        step_fn = make_multi_step(losses, n_dispatch, augment_fn=augment,
                                  mesh=mesh)
    else:
        step_fn = make_train_step(losses, augment_fn=augment, mesh=mesh)
        prefetcher = DevicePrefetcher(loader, device)
    # the writes and evictions: on the writer thread, or in place
    save = save_checkpoint_async if async_checkpoint else save_checkpoint
    run = ckpt.submit if async_checkpoint else _call
    reader_cost = TimeAverager()
    batch_cost = TimeAverager()
    save_models = deque()
    pending = []  # the device metrics of the iterations since the last log
    iters_per_epoch = loader.iters_per_epoch
    it = state.step
    batch_start = time.time()
    finished = False
    try:
        while it < iters:
            # the iterations this dispatch may take without crossing a log
            # or save point (a resume may start between them)
            boundary = min((it // log_iters + 1) * log_iters,
                           (it // save_interval + 1) * save_interval, iters)
            take = min(n_dispatch, boundary - it)
            if cache is not None:
                idx = np.stack([next(loader) for _ in range(take)])
                _record(reader_cost, time.time() - batch_start, take)
                state, metrics = step_fn(state, *cache,
                                         idx if n_dispatch > 1 else idx[0],
                                         seed=seed)
            elif prefetcher is None:
                batches = [next(loader) for _ in range(take)]
                _record(reader_cost, time.time() - batch_start, take)
                images, labels = (_upload(torch.stack([b[i] for b in
                                                       batches]), device)
                                  for i in (0, 1))
                state, metrics = step_fn(state, images, labels, seed=seed)
            else:
                images, labels = next(prefetcher)
                reader_cost.record(time.time() - batch_start)
                state.generator.manual_seed(step_seed(seed, it))
                state, metrics = step_fn(state, images, labels)
            for _ in range(take):
                train_profiler.add_profiler_step(profiler_options)
            it = state.step
            pending.append(metrics)
            log = it % log_iters == 0
            if log:  # waits for the device: the window's costs include it
                # one-step metrics are a scalar, [L] and [C]; a dispatch
                # of n steps stacks them along a leading [n]
                loss = torch.cat([m["loss"].reshape(-1) for m in pending])
                loss_list = torch.cat([m["loss_list"].reshape(
                    -1, m["loss_list"].shape[-1]) for m in pending])
                dice = torch.cat([m["per_channel_dice"].reshape(-1)
                                  for m in pending])
                avg_loss, mdice, *avg_loss_list = torch.cat(
                    [torch.stack([loss.mean(), dice.mean()]),
                     loss_list.mean(0)]).tolist()
                pending = []
            _record(batch_cost, time.time() - batch_start, take,
                    batch_size * mesh.data)

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
                                      writer=log_writer, save_dir=save_dir,
                                      mesh=mesh)
                current = os.path.join(save_dir, "iter_{}".format(it))
                if mesh.primary:
                    save(current, state.model, state.optimizer, it)
                save_models.append(current)
                if len(save_models) > keep_checkpoint_max > 0:
                    old = save_models.popleft()
                    if mesh.primary:  # behind the pending writes
                        run(shutil.rmtree, old, ignore_errors=True)
                if result is not None:
                    if result["mdice"] > best_mean_dice:
                        best_mean_dice, best_model_iter = result["mdice"], it
                        if mesh.primary:  # behind the write of current
                            run(_write_best, save_dir, current,
                                best_mean_dice, best_model_iter)
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
                if sharded:  # the ranks meet at each save point (rank 0's
                    dist.barrier()  # files are complete after its wait)
            # eval and checkpoint time stays out of the next batch cost
            batch_start = time.time()
        finished = True
    finally:
        loader.stop()
        if prefetcher is not None:
            prefetcher.close()
        if log_writer is not None:
            log_writer.close()
        if async_checkpoint and mesh.primary:
            _wait_writer(raise_failure=finished)
    if mesh.primary:
        _flops_report(state.model, train_dataset, loader.mode,
                      batch_size * mesh.data)
    return state


def _call(fn, *args, **kwargs):
    return fn(*args, **kwargs)


def _wait_writer(raise_failure):
    """Wait for the checkpoint writer. A failed write is raised only after
    a loop that finished: while the loop's own error unwinds, it is logged
    and that error goes on."""
    if raise_failure:
        wait_pending_checkpoints()
        return
    try:
        wait_pending_checkpoints()
    except Exception as e:
        logger.error("A checkpoint write failed as well: {!r}".format(e))


def _augmented_dhw(dataset):
    """(D, H, W) after the dataset's transforms, from the last transform
    that has a ``size``; None if none has."""
    size = None
    for t in (getattr(dataset, "raw_transforms", None) or []):
        if hasattr(t, "size"):
            s = t.size
            size = tuple(s) if isinstance(s, (tuple, list)) else (s,) * 3
    return size


def _flops_report(model, dataset, mode, batch):
    """Log the forward's FLOPs (:func:`..utils.flops.forward_flops`) for
    ``batch`` samples of the shape the step trains on, found as the JAX
    loop finds it: the augmented (D, H, W) where the card augments (else
    the raw volume's), the transformed item's in ``host`` mode."""
    if not isinstance(model, VNet):
        logger.info("Model forward cost: not counted for {} (the count "
                    "knows VNet and VNetDeepSup)".format(type(model).__name__))
        return
    if mode in ("device", "device_cache"):
        dhw = _augmented_dhw(dataset) or dataset.raw_item(0)[0].shape[:3]
    else:
        dhw = np.moveaxis(np.asarray(dataset[0][0]), 0, -1).shape[:3]
    flops = forward_flops(model, dhw, batch)
    logger.info("Model forward cost: {:.3f} GFLOPs (batch {})".format(
        flops / 1e9, batch))


def _record(averager, seconds, iterations, batch_size=0):
    """A dispatch's ``seconds`` as ``iterations`` equal records: the
    averages stay per iteration whatever the dispatch size."""
    for _ in range(iterations):
        averager.record(seconds / iterations, num_samples=batch_size)


def _upload(batch, device):
    """A stacked CPU batch onto ``device`` by a pinned, asynchronous copy."""
    if torch.device(device).type == "cpu":
        return batch
    return batch.pin_memory().to(device, non_blocking=True)


def _read_best(path):
    """(mdice, iter) of a ``best.json``; (-1.0, -1) if it cannot be read."""
    try:
        with open(path) as f:
            best = json.load(f)
        return float(best.get("mdice", -1.0)), int(best.get("iter", -1))
    except (OSError, ValueError):
        return -1.0, -1


def _write_best(save_dir, current, mdice, it):
    """``best_model/model.msgpack`` as a copy of the save point's
    ``current/model.msgpack`` (the same state, so the same bytes; no second
    snapshot), then ``best.json`` {"mdice", "iter"} written atomically
    after the weights: a tracker never names weights that are not on
    disk."""
    best_dir = os.path.join(save_dir, BEST_DIR)
    os.makedirs(best_dir, exist_ok=True)
    with open(os.path.join(current, ckpt.MODEL_FILE), "rb") as f:
        ckpt._atomic_write(os.path.join(best_dir, ckpt.MODEL_FILE),
                           iter(functools.partial(f.read, 1 << 24), b""))
    ckpt._atomic_write(os.path.join(best_dir, BEST_JSON),
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
