"""Collectives over the axes of a rank mesh (port only).

The reference writes ``psum``, ``pmean``, ``all_gather`` and
``axis_index`` inside ``shard_map`` (or lets GSPMD insert them).  Here a
rank mesh (``launch.mesh.RankMesh``) carries a ``Collectives`` object
(``attach``): one ``torch.distributed`` group per set of its axes, a
folded tuple such as ``("pod", "data")`` included, and every collective
goes through a ``core.halo.Transport`` (gloo, which stages CUDA tensors
through pinned host memory so that several ranks can share a card, or
NCCL, one card a rank).  The transport counts bytes and seconds; the
collectives add a count per *channel* (``"tp"``, ``"ep"``, ``"fsdp"``,
``"grad"``, ``"pod"``, ...), which the caller names.

Gradients.  Every rank runs the same program on its block, and a value
computed on several ranks (the residual stream on the ``model`` ranks,
the loss on all of them) is a *replicated* value.  The port follows
``shard_map``'s algebra: each rank seeds its backward with ``1 / R`` of
the replicated loss (R the ranks that hold it), so the cotangent of a
replicated value on a rank is that rank's share of the whole, and the
true cotangent is their sum.  Then

* ``psum`` (forward: all-reduce) has the backward all-reduce: the
  shares of the replicated result's cotangent, summed, are the
  cotangent of each rank's addend;
* ``all_gather`` along a dim has the backward reduce-scatter: the
  shares summed over the group, each rank keeping its block;
* the gradient of a parameter leaf is summed over the mesh axes that
  hold whole copies of it (``sharding.replicated_axes``).

(Megatron's pair, identity forward / all-reduce backward at the entry of
a tensor-parallel region and all-reduce / identity at its exit, is the
same algebra with the backward all-reduce moved from the exit to the
entry; there the gradients of replicated leaves used inside a region
are partial and those used outside it are whole, which this form does
not need to tell apart.)

A reduce-scatter is an all-reduce and a cut (gloo has no
reduce-scatter).  Every collective is one synchronising call on the
host; nothing overlaps them yet.  Nothing here runs at import.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch


def _names(axis) -> tuple:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Collectives:
    """The groups of one rank's mesh and the transport their collectives
    go through.  Every rank of the mesh builds it at the same point (it
    creates every group, in one order, as ``torch.distributed`` needs).

    ``stats``: per channel, ``calls``, ``bytes_sent``, ``bytes_received``
    and ``seconds`` (the transport's figures for that channel's
    calls)."""

    def __init__(self, mesh, transport):
        import torch.distributed as dist
        self.mesh = mesh
        self.transport = transport
        self._groups: Dict[tuple, object] = {}
        live = [a for a in mesh.axis_names if mesh.axis_size(a) > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                members = {}
                for r in range(mesh.size):
                    c = mesh.coordinate(r)
                    key = tuple(c[i] for i, a in enumerate(mesh.axis_names)
                                if a not in axes)
                    members.setdefault(key, []).append(r)
                ranks = [sorted(g, key=lambda r: mesh.axis_index(axes, r))
                         for g in members.values()]
                mine, _ = dist.new_subgroups_by_enumeration(ranks)
                self._groups[axes] = mine
        self.stats: Dict[str, dict] = {}

    def live(self, axis) -> tuple:
        """``axis`` (a name, a tuple of names, or None) without the
        mesh's axes of size 1."""
        return tuple(a for a in _names(axis) if self.mesh.axis_size(a) > 1)

    def _group(self, axes: tuple):
        try:
            return self._groups[axes]
        except KeyError:
            raise ValueError(f"no group for axes {axes}: fold axes in the "
                             f"mesh's order {self.mesh.axis_names}") from None

    def _count(self, channel: str, fn):
        t = self.transport
        before = (t.bytes_sent, t.bytes_received, t.seconds)
        out = fn()
        s = self.stats.setdefault(channel, {"calls": 0, "bytes_sent": 0,
                                            "bytes_received": 0,
                                            "seconds": 0.0})
        s["calls"] += 1
        s["bytes_sent"] += t.bytes_sent - before[0]
        s["bytes_received"] += t.bytes_received - before[1]
        s["seconds"] += t.seconds - before[2]
        return out

    def reset_stats(self) -> None:
        self.stats = {}

    def all_reduce(self, x: torch.Tensor, axis, op: str = "sum",
                   channel: str = "misc") -> torch.Tensor:
        """``x`` summed (or ``op="max"``) over the ranks along ``axis``;
        ``x`` itself when the axis holds one rank."""
        axes = self.live(axis)
        if not axes:
            return x
        group = self._group(axes)
        return self._count(channel, lambda: self.transport.all_reduce(
            x, group, op))

    def all_gather(self, x: torch.Tensor, axis, dim: int,
                   channel: str = "misc") -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` joined on ``dim`` in the
        axis's order (pod-major for a folded tuple)."""
        axes = self.live(axis)
        if not axes:
            return x
        group, n = self._group(axes), self.mesh.axis_size(axes)
        parts = self._count(channel, lambda: self.transport.all_gather(
            x, group, n))
        return torch.cat(parts, dim=dim)

    def all_gather_list(self, x: torch.Tensor, axis,
                        channel: str = "misc") -> list:
        """Every rank's ``x`` along ``axis``, as a list in the axis's
        order."""
        axes = self.live(axis)
        if not axes:
            return [x]
        group, n = self._group(axes), self.mesh.axis_size(axes)
        return self._count(channel, lambda: self.transport.all_gather(
            x, group, n))


def attach(mesh, transport):
    """``mesh`` with its ``Collectives`` (every rank calls it at the same
    point, after ``launch.mesh.init_ranks``)."""
    import dataclasses
    return dataclasses.replace(mesh, comm=Collectives(mesh, transport))


def _comm(mesh) -> Optional[Collectives]:
    comm = getattr(mesh, "comm", None)
    if comm is None:
        raise RuntimeError("this mesh has no collectives: build it in a "
                           "process group and parallel.collectives.attach")
    return comm


# ---------------------------------------------------------------------------
# Under autograd
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    """Sum over a mesh axis; the backward sums the shares of the
    result's cotangent (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, comm, axis, channel):
        ctx.comm, ctx.axis, ctx.channel = comm, axis, channel
        return comm.all_reduce(x, axis, channel=channel)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.all_reduce(g.contiguous(), ctx.axis,
                                    channel=ctx.channel), None, None, None)


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters (sums the
    cotangents over the group, each rank keeping its block)."""

    @staticmethod
    def forward(ctx, x, comm, axis, dim, channel):
        ctx.comm, ctx.axis, ctx.dim, ctx.channel = comm, axis, dim, channel
        ctx.size = x.shape[dim]
        ctx.index = comm.mesh.axis_index(comm.live(axis))
        return comm.all_gather(x, axis, dim, channel=channel)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.all_reduce(g.contiguous(), ctx.axis,
                                    channel=ctx.channel)
        return (total.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None, None)


def psum(x: torch.Tensor, mesh, axis, channel: str) -> torch.Tensor:
    """``x`` summed over ``axis`` of ``mesh`` (the identity without a
    mesh or over one rank), under autograd."""
    if mesh is None or not _comm(mesh).live(axis):
        return x
    return _PSum.apply(x, _comm(mesh), axis, channel)


def all_gather(x: torch.Tensor, mesh, axis, dim: int,
               channel: str) -> torch.Tensor:
    """The blocks of ``axis`` joined along ``dim`` (the identity without
    a mesh or over one rank), under autograd."""
    if mesh is None or not _comm(mesh).live(axis):
        return x
    return _AllGather.apply(x, _comm(mesh), axis, dim, channel)


# ---------------------------------------------------------------------------
# Without autograd
# ---------------------------------------------------------------------------

def all_reduce_plain(x: torch.Tensor, mesh, axis, op: str = "sum",
                     channel: str = "misc") -> torch.Tensor:
    """``x`` reduced over ``axis`` (``x`` itself over one rank)."""
    if mesh is None:
        return x
    with torch.no_grad():
        return _comm(mesh).all_reduce(x.detach(), axis, op, channel)


def all_gather_plain(x: torch.Tensor, mesh, axis, dim: int,
                     channel: str = "misc") -> torch.Tensor:
    if mesh is None:
        return x
    with torch.no_grad():
        return _comm(mesh).all_gather(x.detach(), axis, dim, channel)


def stats(mesh) -> dict:
    """The per-channel counts of ``mesh``'s collectives."""
    return {k: dict(v) for k, v in _comm(mesh).stats.items()}


# ---------------------------------------------------------------------------
# By logical axis name (what the model code calls)
# ---------------------------------------------------------------------------

def _mesh_of(rules):
    return None if rules is None else rules.mesh


def gather_dim(x: torch.Tensor, rules, logical: str, dim: int,
               channel: str = "fsdp") -> torch.Tensor:
    """``x``'s dim ``dim``, split over the mesh axes of ``logical``
    (``"fsdp"`` for a parameter's FSDP dim), gathered whole under
    autograd; ``x`` itself without a mesh or a split."""
    mesh = _mesh_of(rules)
    if mesh is None:
        return x
    return all_gather(x, mesh, rules.axis(logical), dim, channel)


def psum_over(x: torch.Tensor, rules, logical: str,
              channel: str) -> torch.Tensor:
    """``x`` summed over the mesh axes of ``logical`` under autograd;
    ``x`` itself without a mesh or a split."""
    mesh = _mesh_of(rules)
    if mesh is None:
        return x
    return psum(x, mesh, rules.axis(logical), channel)


def index_along(rules, logical: str) -> tuple:
    """``(index, count)`` of this rank along the mesh axes of
    ``logical``; ``(0, 1)`` without a mesh or a split."""
    mesh = _mesh_of(rules)
    if mesh is None or rules.axis(logical) is None:
        return 0, 1
    axis = rules.axis(logical)
    return mesh.axis_index(axis), mesh.axis_size(axis)
