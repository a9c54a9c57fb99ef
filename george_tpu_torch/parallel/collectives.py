# -*- coding: utf-8 -*-
"""Collectives over a process group, with the adjoints the solvers need.

The JAX package shards arrays and lets XLA insert the ``psum`` and
``all_gather``; here every rank runs the same program on its own rows and
calls the collective itself. A sharded computation holds two kinds of
tensor: *replicated* ones, equal on every rank (parameters, small per-pair
cores, the log-likelihood), and *row-local* ones (each rank's rows of a
long axis). Two functions cross between them, and both compose with
autograd and with ``torch.func`` (``grad``, ``vjp``, ``jvp``, ``vmap``):

* :func:`sum_partials` turns per-rank partial sums into their replicated
  total: ``all_reduce`` forward; in reverse mode the cotangent of a
  replicated tensor is already the whole one, so it passes through;
* :func:`replicated` marks where a replicated tensor enters row-local
  work: the identity forward; in reverse mode each rank's rows contribute
  a part of the cotangent, so the parts are ``all_reduce``d.

A third, :func:`gather_rows`, turns row-local blocks into the replicated
whole: ``all_gather`` forward; in reverse mode the cotangent of the
replicated whole is already the whole one, so each rank takes its own
block of it. It brings a small row-local factor (one level of a
hierarchical factorization) to every rank for a computation that needs all
its rows, and gathers results leaving a sharded computation.

Forward-mode tangents follow the forward maps, and under ``vmap`` a batch
of any of them is one collective on the batched tensor (every rank must
batch the same count).

Gloo groups take CUDA tensors for ``all_reduce`` and ``all_gather``, so
ranks that share one card use gloo; the computation stays on the card.
"""

import torch
import torch.distributed as dist

__all__ = ["RowShard", "row_shard", "sum_partials", "replicated",
           "gather_rows", "all_reduce", "broadcast"]


def all_reduce(t, group, op=None):
    """The ``all_reduce`` (sum by default) of a copy of ``t``."""
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def broadcast(t, group, src_rank=0):
    """``t`` as held by the group's rank ``src_rank``, on every rank."""
    out = t.detach().clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, src_rank),
                   group=group)
    return out


def _all_gather(t, group, dim):
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return _SumPartials.apply(t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return _SumPartials.apply(x, group), None
        return _SumPartials.apply(x.movedim(in_dims[0], 0), group), 0


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _SumPartials.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return t

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Replicated.apply(x, group), in_dims[0]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(x, group, dim):
        return _all_gather(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        size = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        own = g.narrow(ctx.dim, dist.get_rank(ctx.group) * size, size)
        return own, None, None

    @staticmethod
    def jvp(ctx, t, _, __):
        return _GatherRows.apply(t, ctx.group, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        if in_dims[0] is None:
            return _GatherRows.apply(x, group, dim), None
        return _GatherRows.apply(x.movedim(in_dims[0], 0), group, dim + 1), 0


def gather_rows(t, group, dim=0):
    """Every rank's block of ``t`` (row-local) concatenated along ``dim``
    in rank order (blocks of equal shape): the replicated whole."""
    if dist.get_world_size(group) == 1:
        return t
    return _GatherRows.apply(t, group, dim % t.ndim)


def sum_partials(x, group):
    """The replicated sum over ranks of the partial sums ``x``."""
    return _SumPartials.apply(x, group)


def replicated(x, group):
    """``x`` (replicated) as it enters this rank's row-local work."""
    return _Replicated.apply(x, group)


class RowShard(object):
    """A long row axis split into equal contiguous blocks, one per rank of
    a one-dimensional ``DeviceMesh`` (or of a process group)."""

    def __init__(self, mesh):
        group = mesh.get_group() if hasattr(mesh, "get_group") else mesh
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def block(self, n):
        """``(start, stop)`` of this rank's rows of an axis of ``n``."""
        size = n // self.world
        return self.rank * size, (self.rank + 1) * size

    def sum(self, x):
        return sum_partials(x, self.group)

    def gather(self, x, dim=0):
        return gather_rows(x, self.group, dim=dim)


def row_shard(mesh):
    """The :class:`RowShard` of ``mesh``, or ``None`` when there is no
    mesh or it has one rank (nothing to split)."""
    if mesh is None:
        return None
    shard = RowShard(mesh)
    return shard if shard.world > 1 else None
