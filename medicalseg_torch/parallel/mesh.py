# Copyright 2026. Apache License 2.0.
"""The process mesh: a ("data", "space") grid of processes over
``torch.distributed``, one process per GPU.

Counterpart of ``medicalseg_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` names the two axes and XLA inserts the collectives;
here every process is one cell of the grid and the port's modules insert
them by hand where the mesh is active (:func:`use_mesh`):

  * ``data`` shards the batch. BatchNorm's batch statistics, the losses
    and the gradients are reduced over the world, so every rank holds the
    numbers of one process at the global batch.
  * ``space`` shards the volume's H axis. The 5^3 convs (``ops/conv5.py``),
    the deep-supervision heads and their upsample exchange halo rows with
    their H neighbours (``parallel/collectives.py``).

Rank ``r`` sits at ``(r // space, r % space)``, the row-major order of
``mesh_utils.create_device_mesh((data, space))``. Besides the world the
mesh holds one group per data index (its ``space`` ranks, which share the
samples and split their H rows: :attr:`Mesh.space_group`) and one group
per space index (its ``data`` ranks: :attr:`Mesh.data_group`).

The backend is NCCL where every rank has a card of its own
(``torch.cuda.device_count()`` at least the local world size) and gloo
otherwise, also with CUDA tensors: several ranks then share one card, and
the halo exchange is staged through pinned host buffers, as gloo's send
and receive take host memory. ``--device cpu`` uses gloo. Every
initialisation logs the backend it took.

The input's H must divide by ``space`` (a JAX mesh cannot place an
uneven batch either). Deeper down, where a block would no longer hold
whole strides of a down conv, or where a down conv's H window is longer
than its stride, the model enters an H-replicated region, as the JAX
conv5 asks XLA to replicate H where it does not divide: every space rank
then holds the whole H axis of that level (:meth:`Mesh.whole`,
:func:`h_levels`), and the region leaves again through
:meth:`Mesh.keep_h` where the up path reaches a level that divides.
"""

import contextlib
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the mesh the port's modules shard over while it is active (use_mesh)
_ACTIVE = None
# how long a collective waits for the other ranks before it raises
_TIMEOUT_S = 600.0


class Mesh:
    """A ``data`` x ``space`` grid of processes; this process at
    (:attr:`d`, :attr:`s`). ``shape`` is the JAX mesh's
    ``{"data": ..., "space": ...}``. The groups are None for a one-process
    grid (and where the mesh was made without a process group)."""

    def __init__(self, data: int, space: int = 1, rank: int = 0,
                 backend: Optional[str] = None, space_group=None,
                 data_group=None, whole_h: bool = False):
        self.data, self.space, self.rank = int(data), int(space), int(rank)
        self.world = self.data * self.space
        self.d, self.s = divmod(self.rank, self.space)
        self.backend = backend
        self.space_group = space_group
        self.data_group = data_group
        # True in an H-replicated region: every space rank holds the whole
        # H axis (no halos; the world sums count each voxel space times)
        self.whole_h = bool(whole_h)
        self._whole = None

    @property
    def splits_h(self) -> bool:
        """True where each space rank holds an H block of the tensors."""
        return self.space > 1 and not self.whole_h

    def whole(self) -> "Mesh":
        """This mesh for an H-replicated region (the same ranks and
        groups, :attr:`whole_h` set)."""
        if self.whole_h:
            return self
        if self._whole is None:
            self._whole = Mesh(self.data, self.space, self.rank,
                               self.backend, self.space_group,
                               self.data_group, whole_h=True)
        return self._whole

    @property
    def shape(self):
        return {"data": self.data, "space": self.space}

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def rows(self, n_local: int):
        """The rank's rows [start, stop) of a global batch of ``n_local *
        data`` samples."""
        return self.d * n_local, (self.d + 1) * n_local

    def keep_h(self, x, axis: int = 2):
        """The rank's H block ``[s * H / space, (s + 1) * H / space)`` of
        ``x`` along ``axis`` (a view); ``x`` itself when ``space`` is 1.
        It also leaves an H-replicated region: its backward fills the
        other ranks' rows with zeros, so that each rank back-propagates
        only its own rows' share. Raises with the shape when H does not
        divide."""
        if self.space == 1:
            return x
        h = x.shape[axis]
        if h % self.space:
            raise ValueError(
                "H = {} of shape {} does not divide over space = {}".format(
                    h, tuple(x.shape), self.space))
        per = h // self.space
        return x.narrow(axis, self.s * per, per)


def h_levels(mesh: Optional[Mesh], h: int, windows):
    """The mesh each level of an encoder-decoder runs under, for an input
    H block of ``h`` rows and the ``(kh, sh)`` H windows and strides of
    the down convs between the levels: ``len(windows) + 1`` entries, the
    first ``mesh`` itself. A level stays H-sharded while the block above
    holds whole strides (``h % sh == 0``) and the window stays inside its
    stride (``kh <= sh``): its block is then ``h / sh`` rows and its H
    divides over space. From the first level where either fails on, every
    level runs under ``mesh.whole()`` (H replicated). Without a space
    axis every level runs under ``mesh``."""
    if mesh is None or not mesh.splits_h:
        return [mesh] * (len(windows) + 1)
    views, whole = [mesh], False
    for kh, sh in windows:
        whole = whole or kh > sh or h % sh != 0
        h //= sh
        views.append(mesh.whole() if whole else mesh)
    return views


def build_mesh(data: Optional[int] = None, space: int = 1) -> Mesh:
    """The ("data", "space") mesh over the initialised process group (one
    process, the world, when there is none). ``data`` defaults to world //
    space. Raises the JAX function's two errors. Every rank must call it
    (it creates the groups)."""
    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    rank = dist.get_rank() if ready else 0
    if data is None:
        if n % space != 0:
            raise ValueError(
                "device count {} not divisible by space={}".format(n, space))
        data = n // space
    if data * space != n:
        raise ValueError(
            "data({}) x space({}) != device count {}".format(data, space, n))
    space_group = data_group = backend = None
    if ready and n > 1:
        backend = dist.get_backend()
        # every rank creates every group, in one order
        for d in range(data):
            g = dist.new_group([d * space + s for s in range(space)])
            if d == rank // space:
                space_group = g
        for s in range(space):
            g = dist.new_group([d * space + s for d in range(data)])
            if s == rank % space:
                data_group = g
    return Mesh(data, space, rank, backend, space_group, data_group)


def process_shard(num_items: int, mesh: Optional[Mesh] = None):
    """The data index's contiguous slice [start, stop) of ``num_items``
    (the JAX function's arithmetic, over the data axis: the ranks of one
    data index take the same items). The whole range without a mesh."""
    pid, nproc = (0, 1) if mesh is None else (mesh.d, mesh.data)
    per = int(np.ceil(num_items / nproc))
    start = pid * per
    return start, min(start + per, num_items)


def shard_batch(mesh: Mesh, images, labels, spatial_axis: Optional[int] = 2):
    """The rank's share of a global batch: images [N, D, H, W(, C)] and
    labels [N, D, H, W] keep the rows ``[d * b, (d + 1) * b)`` (b = N /
    data) and, where ``space`` > 1 and ``spatial_axis`` is not None, the H
    block ``[s * H / S, (s + 1) * H / S)`` of that axis."""
    n = images.shape[0]
    if n % mesh.data:
        raise ValueError("batch of {} does not divide over data = {}".format(
            n, mesh.data))
    lo, hi = mesh.rows(n // mesh.data)
    images, labels = images[lo:hi], labels[lo:hi]
    if spatial_axis is not None:
        images = mesh.keep_h(images, spatial_axis)
        labels = mesh.keep_h(labels, spatial_axis)
    return images, labels


def init_process_group(rank: int, world: int, device="cuda",
                       local_rank: int = 0, local_world: Optional[int] = None,
                       store=None):
    """Join a process group of ``world`` ranks as ``rank`` and return (the
    rank's device, the backend). On CUDA the rank takes card
    ``local_rank`` where the host has a card for each of its
    ``local_world`` ranks, and NCCL; else card ``local_rank`` modulo the
    count, and gloo. ``device`` 'cpu' takes gloo. ``store`` (e.g. a
    ``FileStore``) replaces the ``MASTER_ADDR`` / ``MASTER_PORT``
    rendezvous."""
    device = torch.device(device)
    local_world = world if local_world is None else local_world
    backend = "gloo"
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device found; pass --device cpu to "
                               "run the ranks on the CPU")
        if count >= local_world:
            backend = "nccl"
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    kwargs = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    from ..utils import logger  # utils imports ops, which import this
    logger.info("process group: {} ranks over {} ({} per host), rank 0 on "
                "{}".format(world, backend, local_world, device))
    return device, backend


def init_from_env(device="cuda"):
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return (device, backend); (``device``, None)
    without joining when the world is one process (or already joined)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return torch.device(device), None
    if dist.is_initialized():
        return torch.device(device), dist.get_backend()
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return init_process_group(
        int(os.environ["RANK"]), world, device, local_rank,
        int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def active_mesh() -> Optional[Mesh]:
    """The mesh the modules shard over now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the block with ``mesh`` active: the conv5 ops, BatchNorm,
    dropout, the losses, the augmentation and the deep-supervision heads
    then work on this rank's shard and reduce over the mesh. A mesh of
    one process is no mesh."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.world > 1 else None
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = saved
