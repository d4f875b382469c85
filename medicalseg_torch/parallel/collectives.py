# Copyright 2026. Apache License 2.0.
"""The collectives the port's modules insert under a mesh.

Counterpart of the ``ppermute`` halo (``_halo_h`` / ``_halo_h_kl`` of
``medicalseg_tpu/ops/pallas_conv5.py``) and of the ``psum``s that XLA
inserts for the global batch:

* :func:`halo_h`: ``rows`` H rows from each space neighbour around the
  rank's block, zeros at the volume's edges, differentiable (its backward
  hands each halo row's cotangent back to the rank that owns the row and
  adds it there).
* :func:`all_reduce_sum`: a sum over the world whose backward
  all-reduces the cotangents. Each rank's objective is then the global
  loss over the world size, and after :func:`sum_grads` every parameter
  gradient is the gradient of the global-batch loss, as under JAX's
  ``psum``. (An all-reduce with an identity backward would drop
  BatchNorm's cross-rank terms.)
* :func:`sum_grads`: one flattened all-reduce of every parameter gradient.
* :func:`gather_h`: the space group's H blocks joined into the whole
  tensor (the sharded evaluation's logits, and the entry into an
  H-replicated region): differentiable, its backward sums the cotangent
  over the space group and keeps the rank's block (a reduce-scatter), as
  each rank's cotangent of a replicated tensor is only its own path's
  share.

On NCCL the tensors cross between cards as they are. On gloo, which sends
and receives host memory only, the halo rows and the gathered blocks are
staged through pinned host buffers; its all-reduce takes CUDA tensors.
A failed collective raises.
"""

import torch
import torch.distributed as dist


def _staged(mesh):
    return mesh.backend != "nccl"


def _to_host(t):
    t = t.contiguous()
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def _exchange(to_prev, to_next, mesh):
    """Send ``to_prev`` to the space neighbour before this rank (s - 1) and
    ``to_next`` to the one after it (s + 1), both posted together, and
    return (``from_prev``, ``from_next``): what those neighbours sent this
    rank, zeros where the rank is at an edge of the space axis."""
    s, space, rank = mesh.s, mesh.space, mesh.rank
    device = to_prev.device
    staged = _staged(mesh) and device.type != "cpu"
    sends = (_to_host(to_prev), _to_host(to_next)) if staged else (
        to_prev.contiguous(), to_next.contiguous())
    host = torch.device("cpu") if staged else device
    from_prev = torch.zeros(to_next.shape, dtype=to_next.dtype, device=host,
                            pin_memory=staged)
    from_next = torch.zeros(to_prev.shape, dtype=to_prev.dtype, device=host,
                            pin_memory=staged)
    ops = []
    if s > 0:
        ops += [dist.P2POp(dist.isend, sends[0], rank - 1),
                dist.P2POp(dist.irecv, from_prev, rank - 1)]
    if s < space - 1:
        ops += [dist.P2POp(dist.isend, sends[1], rank + 1),
                dist.P2POp(dist.irecv, from_next, rank + 1)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    if staged:
        from_prev = from_prev.to(device, non_blocking=True)
        from_next = from_next.to(device, non_blocking=True)
    return from_prev, from_next


def _halo(x, mesh, rows, axis):
    h = x.shape[axis]
    if h < rows:
        # the halo reaches past the next neighbour: the whole H axis,
        # zero-padded, and the rank's window of it
        full = _gather(x, mesh, axis)
        pad = [0, 0] * (x.dim() - 1 - axis) + [rows, rows]
        return torch.nn.functional.pad(full, pad).narrow(
            axis, mesh.s * h, h + 2 * rows).contiguous()
    top, bot = _exchange(x.narrow(axis, 0, rows),
                        x.narrow(axis, h - rows, rows), mesh)
    return torch.cat([top, x, bot], dim=axis)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, rows, axis):
        if x.shape[axis] < rows:
            raise ValueError("a differentiable halo of {} rows needs as "
                             "many rows on each shard, got shape {}".format(
                                 rows, tuple(x.shape)))
        ctx.mesh, ctx.rows, ctx.axis = mesh, rows, axis
        return _halo(x, mesh, rows, axis)

    @staticmethod
    def backward(ctx, g):
        rows, axis = ctx.rows, ctx.axis
        he = g.shape[axis]
        # the halo rows' cotangents go back to their owners
        from_prev, from_next = _exchange(g.narrow(axis, 0, rows),
                                        g.narrow(axis, he - rows, rows),
                                        ctx.mesh)
        dx = g.narrow(axis, rows, he - 2 * rows).clone()
        h = dx.shape[axis]
        dx.narrow(axis, 0, rows).add_(from_prev)
        dx.narrow(axis, h - rows, rows).add_(from_next)
        return dx, None, None, None


def halo_h(x, mesh, rows, axis=3):
    """``x`` with ``rows`` rows of each space neighbour added around its H
    axis (``axis``: 3 in the kernel layout [N, D, C, H, W], 2 in NDHWC):
    the predecessor's last rows on top, the successor's first rows below,
    zeros at the volume's edges (SAME zero padding of the global volume).
    A shard of fewer than ``rows`` rows takes its window of the gathered
    H axis instead (not differentiable). Differentiable in ``x``; under
    ``torch.no_grad`` it records nothing."""
    if mesh.space == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Halo.apply(x, mesh, rows, axis)
    return _halo(x, mesh, rows, axis)


def _all_reduce(x, group=None):
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


def all_reduce_sum(x):
    """The sum of ``x`` over the world, differentiable: the backward sums
    the cotangents over the world."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x)
    return _all_reduce(x)


def sum_grads(module, mesh):
    """Sum every parameter gradient of ``module`` over the world, as one
    flattened all-reduce (every parameter of the port is float32)."""
    if mesh is None or mesh.world == 1:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _gather(x, mesh, axis):
    staged = _staged(mesh) and x.device.type != "cpu"
    part = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.space)]
    dist.all_gather(parts, part, group=mesh.space_group)
    out = torch.cat(parts, dim=axis)
    return out.to(x.device, non_blocking=True) if staged else out


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.h = mesh, axis, x.shape[axis]
        return _gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, h = ctx.mesh, ctx.h
        g = _all_reduce(g, mesh.space_group)
        return g.narrow(ctx.axis, mesh.s * h, h).contiguous(), None, None


def gather_h(x, mesh, axis=2):
    """The space group's blocks of ``x`` along ``axis`` joined in space
    order: the whole tensor on every rank of the group. Differentiable in
    ``x`` (module docstring)."""
    if mesh.space == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherH.apply(x, mesh, axis)
    return _gather(x, mesh, axis)
