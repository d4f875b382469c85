# Copyright 2026. Apache License 2.0.
"""Train state and the train / eval step.

Counterpart of ``medicalseg_tpu/core/state.py``. One call of the step is
one training iteration: (augmentation ->) forward -> losses -> backward ->
optimizer and BatchNorm-statistics update. :func:`make_train_step` runs it
eagerly, kernel by kernel, on the model's device; nothing in it waits for
the device, and the metrics stay there (fetch them at log points only).

:func:`make_multi_step` (a super-batch of n steps a call) and
:func:`make_cached_train_step` (batches gathered from a dataset held on
the device, from an index vector a step) are the JAX package's
one-program dispatch. On the card each update of theirs is the replay of
one CUDA graph of the step (:class:`GraphedStep`): forward, losses,
backward and optimizer captured once, so that the host launches one graph
where the eager step launches several hundred kernels. The augmentation,
whose parameters are host values that choose code paths, runs eagerly
ahead of it and writes into the graph's static input. On the CPU, which
has no graphs, the same functions run the eager step.

Unlike the JAX step, which returns a new immutable state, the port's step
updates the state in place (parameters, optimizer slots, BatchNorm
buffers, step counter) and returns the same object.

With a ``mesh`` (``parallel.build_mesh``) of more than one process each
rank's step takes its rows of the global batch (whole samples), runs
under the mesh (``parallel.use_mesh``: the augmentation, the forward with
its halos and global BatchNorm statistics, the global losses), back-
propagates the global loss over the world size and sums the gradients
over the world (``parallel.sum_grads``) before the optimizer, so that
every rank takes the update of one process at the global batch and the
metrics are the global batch's. The cached and multi-step forms replay
one CUDA graph of that step on each rank where the process group runs on
NCCL (a card a rank): the capture holds the halo exchanges, the
BatchNorm and loss all-reduces and :func:`~..parallel.sum_grads`, and
every rank captures on the same step, at the same shapes and with its
collectives in one order. Over gloo, which moves host memory that a graph
cannot hold (several ranks sharing one card, or the CPU), the step runs
eagerly and says so once.

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

from ..cvlibs.config import capturable, is_capturable, set_lr
from ..models.layers import remat
from ..ops import conv5 as c5
from ..parallel.collectives import sum_grads
from ..parallel.mesh import use_mesh
from ..transforms.device import step_seed
from ..utils import logger
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
               device: str = "cuda", capturable_optimizer: bool = False):
        """Move ``model`` to ``device`` ('cuda' unless the caller asks for
        'cpu'), build the optimizer over its parameters
        (``make_optimizer(params)``, e.g. ``Config.build_optimizer``) and
        seed a generator on the same device for the dropout masks.
        ``capturable_optimizer``: the optimizer in the form a CUDA graph of
        the step can replay (``cvlibs.config.capturable``), which
        :func:`make_multi_step` and :func:`make_cached_train_step` need on
        the card."""
        device = resolve_device(device)
        model = model.to(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        if hasattr(model, "seed_dropout"):
            model.seed_dropout(generator)
        optimizer = make_optimizer(model.parameters())
        if capturable_optimizer:
            optimizer = capturable(optimizer)
        return cls(model=model, optimizer=optimizer, schedule=schedule,
                   generator=generator)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.step)


def _check_policy(checkpoint_policy):
    if checkpoint_policy not in (None, "full"):
        raise ValueError("checkpoint_policy must be None or 'full', got "
                         + repr(checkpoint_policy))


def _prepare(state, images, labels, augment_fn, mesh=None):
    """The batch on the state's device, widened (images f32, labels
    int64), through ``augment_fn`` where there is one; under a space mesh
    the rank's H block of it (the augmentation keeps it itself)."""
    device = state.device
    images = torch.as_tensor(images).to(device, non_blocking=True).float()
    labels = torch.as_tensor(labels).to(device, non_blocking=True).long()
    if augment_fn is not None:
        images, labels = augment_fn(images, labels, state.generator)
    elif mesh is not None:
        images, labels = mesh.keep_h(images), mesh.keep_h(labels)
    return images, labels


def _update(state, images, labels, losses, checkpoint_policy, mesh=None):
    """One update at the learning rate the optimizer holds: forward,
    losses, backward, optimizer (BatchNorm statistics on the way). Returns
    the detached metrics; ``state.step`` is left to the caller. Under a
    ``mesh`` the losses are global, each rank back-propagates their sum
    over the world size and the gradients are summed over the world."""
    model, optimizer = state.model, state.optimizer
    model.train()
    optimizer.zero_grad(set_to_none=True)
    if checkpoint_policy == "full":
        logits_list = remat(model, images)
    else:
        logits_list = model(images)
    loss_list, per_channel_dice = loss_computation(logits_list, labels,
                                                   losses)
    total = sum(loss_list)
    if mesh is None:
        total.backward()
    else:
        (total / mesh.world).backward()
        sum_grads(model, mesh)
    optimizer.step()
    return {
        "loss": total.detach(),
        "loss_list": torch.stack([torch.as_tensor(
            l, device=images.device).detach() for l in loss_list]),
        "per_channel_dice": (per_channel_dice.detach()
                             if per_channel_dice is not None
                             else torch.zeros((1,), device=images.device)),
    }


def _world_mesh(mesh):
    """``mesh`` where it spans more than one process, else None."""
    return mesh if mesh is not None and mesh.world > 1 else None


def make_train_step(losses: dict, augment_fn: Optional[Callable] = None,
                    checkpoint_policy: Optional[str] = None, mesh=None):
    """Build the train step.

    Args:
        losses: {'types': [...], 'coef': [...]} loss config.
        augment_fn: optional (images, labels, generator) -> (images NDHWC,
            labels) device augmentation run at the head of the step.
        checkpoint_policy: 'full' to rematerialize the whole forward pass
            (``torch.utils.checkpoint``), trading FLOPs for memory on
            large volumes; per-block rematerialization is the model's
            ``remat`` key.
        mesh: a ``parallel.Mesh``; the step then takes the rank's rows of
            the global batch and gives the global batch's update and
            metrics (module docstring).

    Returns step(state, images, labels) -> (state, metrics) where metrics
    = {'loss', 'loss_list', 'per_channel_dice'} are detached tensors on
    the device. Images [N, D, H, W, C] (any float dtype) widen to f32 and
    labels [N, D, H, W] (any integer dtype) to int64 on the device.
    """
    _check_policy(checkpoint_policy)
    mesh = _world_mesh(mesh)

    def step(state: TrainState, images, labels):
        with use_mesh(mesh):
            images, labels = _prepare(state, images, labels, augment_fn,
                                      mesh)
            set_lr(state.optimizer, state.schedule(state.step))
            metrics = _update(state, images, labels, losses,
                              checkpoint_policy, mesh)
        state.step += 1
        return state, metrics

    return step


class GraphedStep:
    """One update of the train step (forward, losses, backward, optimizer,
    BatchNorm statistics) as a CUDA graph, replayed once a call.

    ``step(state, images, labels)`` with an augmented batch on the card
    (images [N, D, H, W, C] f32, labels int64) returns the update's
    metrics. The first call for a state (or new batch shapes) is the
    capture: it runs the update eagerly on a side stream (this call's
    update, which also creates the optimizer's lazy slots), then records
    the update into a graph with static image and label inputs; every
    later call copies its batch into those inputs and replays the graph.

    What a replay reads that is not a captured kernel argument is kept on
    the device: the learning rate is a 0-d tensor that :func:`set_lr`
    fills before each update (the optimizer must be capturable:
    ``cvlibs.config.capturable``); the conv kernels' packed weights are
    packed inside the graph (``ops.conv5._packed_weight``); the state's
    generator, which draws the dropout masks, is registered with the
    graph, so each replay advances it and a ``manual_seed`` between
    replays takes effect as in the eager step. The gradients are set to
    None inside the capture, so backward writes them afresh in the graph's
    memory. A replay changes the parameters, BatchNorm statistics and
    optimizer slots in place without autograd seeing it, so each replay
    moves their version counters (no kernel): whatever is keyed on them,
    such as the packed weights of an eval forward between steps, sees the
    new values. Nothing falls back to the eager step: a capture that fails
    raises.

    With a ``mesh`` of more than one process (NCCL) the update is the
    sharded one (``_update(..., mesh)`` under ``use_mesh``), and the graph
    holds its collectives. The warm-up runs every collective the capture
    records, in the same order, so that every communicator (the space and
    data groups', the world's for the halo exchanges) exists before the
    capture. Every rank re-captures on the same call: the condition is the
    model, the optimizer and the batch shapes, which the ranks share.

    The capture is thread-local (``capture_error_mode``): only this
    thread's CUDA calls are held to the capture's rules, so that the
    loader's producer thread and, under a mesh, the process group's
    watchdog thread, which polls the eager collectives' events, do not
    invalidate it.

    ``launches`` counts the hand kernels one replay launches (the
    :data:`ops.conv5.LAUNCHES` of the capture), and ``replays`` the
    replays: a replay does not tick :data:`ops.conv5.LAUNCHES`, so the
    kernels a run launched are the counters plus ``replays`` times
    ``launches``, less the capture's own count."""

    def __init__(self, losses: dict, checkpoint_policy: Optional[str] = None,
                 mesh=None):
        _check_policy(checkpoint_policy)
        self.losses = losses
        self.checkpoint_policy = checkpoint_policy
        self.mesh = _world_mesh(mesh)
        self.graph = None
        self.launches = {}
        self.replays = 0
        self._owner = self._shapes = None
        self._images = self._labels = self._metrics = None
        self._written = []

    def __call__(self, state: TrainState, images, labels):
        shapes = (tuple(images.shape), images.dtype, tuple(labels.shape),
                  labels.dtype)
        set_lr(state.optimizer, state.schedule(state.step))
        if (self._owner is None or self._owner[0] is not state.model or
                self._owner[1] is not state.optimizer or
                self._shapes != shapes):
            return self._capture(state, images, labels, shapes)
        self._images.copy_(images)
        self._labels.copy_(labels)
        self.graph.replay()
        torch.autograd.graph.increment_version(self._written)
        self.replays += 1
        return {k: v.clone() for k, v in self._metrics.items()}

    def _capture(self, state, images, labels, shapes):
        if not is_capturable(state.optimizer):
            raise ValueError(
                "a CUDA graph of the step needs an optimizer that reads its "
                "learning rate from the device: build it with "
                "TrainState.create(..., capturable_optimizer=True)")
        self.graph = self._metrics = None
        # this call's update, eagerly, on a side stream (the warm-up the
        # capture needs: lazy slots, cuDNN plans, the upsample matrices)
        mesh = self.mesh
        current = torch.cuda.current_stream(images.device)
        side = torch.cuda.Stream(images.device)
        side.wait_stream(current)
        with torch.cuda.stream(side), use_mesh(mesh):
            metrics = _update(state, images, labels, self.losses,
                              self.checkpoint_policy, mesh)
        current.wait_stream(side)
        self._images, self._labels = images.clone(), labels.clone()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before = dict(c5.LAUNCHES)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                use_mesh(mesh):
            self._metrics = _update(state, self._images, self._labels,
                                    self.losses, self.checkpoint_policy,
                                    mesh)
        self.launches = {k: c5.LAUNCHES[k] - before[k] for k in before}
        self.graph, self.replays = graph, 0
        self._owner, self._shapes = (state.model, state.optimizer), shapes
        # what a replay writes in place
        self._written = [*state.model.parameters(), *state.model.buffers(),
                         *(v for slots in state.optimizer.state.values()
                           for v in slots.values() if torch.is_tensor(v))]
        logger.info("Captured the train step into a CUDA graph: {} hand "
                    "kernel launches a replay{}".format(
                        sum(self.launches.values()),
                        "" if mesh is None else ", rank {} of {} ({})".format(
                            mesh.rank, mesh.world, mesh.backend)))
        return metrics


class _Updates:
    """The updates of :func:`make_multi_step` and
    :func:`make_cached_train_step`: the generator re-seeded from (``seed``,
    step) when a seed is given (the train loop's rule), the batch
    prepared and augmented, then one update: the graph's replay where
    :meth:`replays` says so, else the eager update."""

    def __init__(self, losses, augment_fn, checkpoint_policy, mesh=None):
        _check_policy(checkpoint_policy)
        self.losses = losses
        self.augment_fn = augment_fn
        self.checkpoint_policy = checkpoint_policy
        self.mesh = _world_mesh(mesh)
        self.graphed = GraphedStep(losses, checkpoint_policy, self.mesh)
        self._said = False

    def replays(self, images) -> bool:
        """Whether the update of a batch ``images`` replays the CUDA graph:
        on the card, in one process or over NCCL. Over gloo the step runs
        eagerly (module docstring); that is logged once."""
        if not images.is_cuda:
            return False
        if self.mesh is None or self.mesh.backend == "nccl":
            return True
        if not self._said:
            logger.info("{} ranks over {}: the train step runs eagerly (a "
                        "CUDA graph holds NCCL collectives only)".format(
                            self.mesh.world, self.mesh.backend))
            self._said = True
        return False

    def __call__(self, state, images, labels, seed):
        if seed is not None:
            state.generator.manual_seed(step_seed(seed, state.step))
        with use_mesh(self.mesh):
            images, labels = _prepare(state, images, labels,
                                      self.augment_fn, self.mesh)
            if self.replays(images):
                metrics = self.graphed(state, images, labels)
            else:
                set_lr(state.optimizer, state.schedule(state.step))
                metrics = _update(state, images, labels, self.losses,
                                  self.checkpoint_policy, self.mesh)
        state.step += 1
        return metrics


def _stacked(metrics):
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_multi_step(losses: dict, n_steps: int,
                    augment_fn: Optional[Callable] = None,
                    checkpoint_policy: Optional[str] = None, mesh=None):
    """A train step that advances up to ``n_steps`` iterations a call.

    Returns multi(state, images, labels, seed=None) -> (state, metrics)
    for a super-batch of images [n, N, ...] and labels [n, N, ...] with
    1 <= n <= ``n_steps`` (a shorter one is the remainder before a log or
    save boundary): n updates, each the result of one eager step on its
    row, with the metrics stacked along a leading [n] axis. With ``seed``
    the generator is re-seeded from (``seed``, step) before each update,
    as the train loop does before each eager step (the JAX
    ``fold_in(key, step)``). On the card each update is a replay of one
    CUDA graph (:class:`GraphedStep`, ``multi.graphed``), also under a
    ``mesh`` of more than one process over NCCL; over gloo it is the eager
    sharded step (:func:`make_train_step`)."""
    run = _Updates(losses, augment_fn, checkpoint_policy, mesh)

    def multi(state, images, labels, seed=None):
        rows = images.shape[0]
        if not 1 <= rows <= n_steps or labels.shape[0] != rows:
            raise ValueError("a super-batch of 1 to {} steps, got images {} "
                             "and labels {}".format(n_steps,
                                                    tuple(images.shape),
                                                    tuple(labels.shape)))
        metrics = [run(state, images[i], labels[i], seed)
                   for i in range(rows)]
        return state, _stacked(metrics)

    multi.graphed = run.graphed
    return multi


def make_cached_train_step(losses: dict, n_steps: int = 1,
                           augment_fn: Optional[Callable] = None,
                           checkpoint_policy: Optional[str] = None,
                           mesh=None):
    """Train step over a dataset held on the device.

    Returns step(state, cache_images, cache_labels, idx, seed=None) ->
    (state, metrics). ``cache_images`` / ``cache_labels`` [V, D, H, W]
    are ``TrainLoader.build_device_cache``'s tensors; ``idx`` indexes them:
    [B] for one update (metrics as :func:`make_train_step`'s) or [n, B]
    with n <= ``n_steps`` for n updates (metrics stacked along [n]). The
    batch is gathered on the device (``index_select``), so a step uploads
    only its index vector. ``seed`` as in :func:`make_multi_step`; on the
    card each update is a replay of one CUDA graph (``step.graphed``),
    also under a ``mesh`` of more than one process over NCCL (eager over
    gloo), where ``idx`` holds the rank's rows of the global batch's
    indices."""
    run = _Updates(losses, augment_fn, checkpoint_policy, mesh)

    def one(state, cache_images, cache_labels, idx, seed):
        return run(state, cache_images.index_select(0, idx),
                   cache_labels.index_select(0, idx), seed)

    def step(state, cache_images, cache_labels, idx, seed=None):
        idx = torch.as_tensor(idx, dtype=torch.long)
        if cache_images.is_cuda and not idx.is_cuda:
            idx = idx.pin_memory().to(cache_images.device, non_blocking=True)
        if idx.dim() == 1:
            return state, one(state, cache_images, cache_labels, idx, seed)
        if not 1 <= idx.shape[0] <= n_steps:
            raise ValueError("index rows for 1 to {} steps, got {}".format(
                n_steps, tuple(idx.shape)))
        return state, _stacked([one(state, cache_images, cache_labels, row,
                                    seed) for row in idx])

    step.graphed = run.graphed
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
