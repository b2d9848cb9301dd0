"""The collectives the port issues over a mesh, each counted.

Every collective goes through this module: the device collectives
(:func:`all_reduce`, :func:`all_gather` and the autograd pieces
:func:`copy_to`, :func:`reduce_from`, :func:`gather_from` of the tp
layers), and the host's messages to and from rank 0
(:func:`scatter_objects`, :func:`gather_objects`).  Each adds its call and
its bytes to the mesh's ``counts``, which ``parallel/mesh.collective_stats``
returns.  A mesh here is anything with ``group(axis)`` (None where the
axis has size 1), ``counts``, ``rank``, ``world``, ``shape`` and
``index(axis)``: this module knows nothing of models or of how the mesh
was made.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _count(mesh, op: str, nbytes: int) -> None:
    c = mesh.counts[op]
    c["count"] += 1
    c["bytes"] += int(nbytes)


def all_reduce(mesh, t: torch.Tensor, axis: str = "tp",
               op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``axis`` (``op``: "sum" or "max");
    nothing is issued on an axis of size 1."""
    g = mesh.group(axis)
    if g is None:
        return t
    dist.all_reduce(t, op=_REDUCE_OPS[op], group=g)
    _count(mesh, "all-reduce", t.numel() * t.element_size())
    return t


def all_gather(mesh, t: torch.Tensor, axis: str = "tp",
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along ``dim``, in axis
    order."""
    g = mesh.group(axis)
    if g is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=g)
    out = torch.cat(parts, dim)
    _count(mesh, "all-gather", out.numel() * out.element_size())
    return out


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return sum(_tensor_bytes(getattr(obj, f))
                   for f in obj.__dataclass_fields__)
    return 0


def scatter_objects(mesh, objs: Optional[Sequence] = None,
                    group: str = "host"):
    """Rank 0's ``objs[r]`` to rank r (pickled over a gloo group of the
    world, "host" or "command"; tensors travel on the CPU); returns this
    rank's.  Other ranks pass None."""
    out = [None]
    dist.scatter_object_list(out, list(objs) if mesh.rank == 0 else None,
                             src=0, group=mesh.group(group))
    if mesh.rank == 0:
        _count(mesh, "scatter", sum(_tensor_bytes(o) for o in objs[1:]))
    return out[0]


def gather_objects(mesh, obj) -> Optional[list]:
    """Every rank's ``obj`` at rank 0, in rank order (None elsewhere)."""
    out = [None] * mesh.world if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.group("host"))
    if mesh.rank == 0:
        _count(mesh, "gather", sum(_tensor_bytes(o) for o in out[1:]))
    return out


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel layer, replicated over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous().clone(), ctx.axis), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel layer."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice backward: a
    per-rank piece (a head shard) made whole for replicated code."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, x.shape[dim]
        return all_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    return x if mesh.group(axis) is None else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh,
                axis: str = "tp") -> torch.Tensor:
    return x if mesh.group(axis) is None else _ReduceFrom.apply(x, mesh,
                                                                axis)


def gather_from(x: torch.Tensor, mesh, axis: str = "tp",
                dim: int = 0) -> torch.Tensor:
    return x if mesh.group(axis) is None else _GatherFrom.apply(
        x, mesh, axis, dim)
