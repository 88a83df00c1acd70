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
host; nothing overlaps them yet.  ``DryCollectives`` (``attach_dry``)
stands in for one rank of a mesh without a process group: the same
groups and counts, outputs of the right shape, the ring's wire bytes
(the dry run on the production meshes).  Nothing here runs at import.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch


def _names(axis) -> tuple:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_sets(mesh) -> list:
    """Every set of the mesh's live axes (in the mesh's order): one
    group per set and rank."""
    live = [a for a in mesh.axis_names if mesh.axis_size(a) > 1]
    return [axes for k in range(1, len(live) + 1)
            for axes in itertools.combinations(live, k)]


def _rank_groups(mesh, axes: tuple) -> list:
    """The groups of ranks along ``axes``: each the ranks that share
    every other coordinate, in the order of their index along ``axes``
    (pod-major for a folded tuple)."""
    members: Dict[tuple, list] = {}
    for r in range(mesh.size):
        c = mesh.coordinate(r)
        key = tuple(c[i] for i, a in enumerate(mesh.axis_names)
                    if a not in axes)
        members.setdefault(key, []).append(r)
    return [sorted(g, key=lambda r: mesh.axis_index(axes, r))
            for g in members.values()]


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
        for axes in _axis_sets(mesh):
            mine, _ = dist.new_subgroups_by_enumeration(
                _rank_groups(mesh, axes))
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


class DryTransport:
    """``core.halo.Transport``'s collectives without a wire, for a dry
    run: each returns a tensor of the right shape on its input's device
    (zeros; nothing is allocated on ``"meta"``), and counts what the
    transport would: an all-reduce its tensor's bytes sent and received,
    an all-gather its own block sent and the others' received.  It also
    sums the ring's wire bytes a rank by kind, the reference's
    convention (``repro.perf.hlo_analysis``): an all-reduce of S bytes
    over g ranks ``2 S (g - 1) / g``, an all-gather of a block of S
    bytes ``S (g - 1)`` (its output's ``(g - 1) / g``).  A group is the
    tuple of its ranks."""

    def __init__(self):
        self.bytes_sent = self.bytes_received = 0
        self.seconds = 0.0
        self.coll_bytes = 0.0
        self.coll_by_kind: Dict[str, float] = {}

    def _wire(self, kind: str, nbytes: float) -> None:
        self.coll_bytes += nbytes
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + nbytes

    def all_reduce(self, x: torch.Tensor, group, op: str = "sum"
                   ) -> torch.Tensor:
        n, g = x.numel() * x.element_size(), len(group)
        self.bytes_sent += n
        self.bytes_received += n
        self._wire("all-reduce", 2.0 * n * (g - 1) / g)
        return x.new_zeros(x.shape)

    def all_gather(self, x: torch.Tensor, group, n: int) -> list:
        size = x.numel() * x.element_size()
        self.bytes_sent += size
        self.bytes_received += (n - 1) * size
        self._wire("all-gather", float((n - 1) * size))
        return list(x.new_zeros((n,) + tuple(x.shape)).unbind(0))


class DryCollectives(Collectives):
    """``Collectives`` for one rank of a mesh with no process group: the
    same groups, built from the mesh's shape and ``mesh.rank``, and the
    same ``stats`` per channel (``seconds`` 0), through a
    ``DryTransport``, whose ``coll_bytes`` / ``coll_by_kind`` are the
    ring's wire bytes this rank moved.  A rank path runs under it
    unchanged (``attach_dry``): on ``"meta"`` tensors it is the dry run
    of that rank's step (``launch.dryrun``)."""

    def __init__(self, mesh):
        if mesh.rank is None:
            raise ValueError("a dry run traces one rank: give the mesh a "
                             "rank")
        self.mesh = mesh
        self.transport = DryTransport()
        self._groups = {axes: next(tuple(g) for g in _rank_groups(mesh, axes)
                                   if mesh.rank in g)
                        for axes in _axis_sets(mesh)}
        self.stats: Dict[str, dict] = {}

    def wire(self) -> tuple:
        """``(coll_bytes, coll_by_kind)`` so far (``perf.op_analysis.
        Costs``' fields)."""
        t = self.transport
        return t.coll_bytes, dict(t.coll_by_kind)

    def reset_stats(self) -> None:
        self.stats = {}
        self.transport = DryTransport()


def attach(mesh, transport):
    """``mesh`` with its ``Collectives`` (every rank calls it at the same
    point, after ``launch.mesh.init_ranks``)."""
    import dataclasses
    return dataclasses.replace(mesh, comm=Collectives(mesh, transport))


def attach_dry(mesh):
    """``mesh`` (shape, axes and a rank; no process group needed) with
    its ``DryCollectives``."""
    import dataclasses
    return dataclasses.replace(mesh, comm=DryCollectives(mesh))


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
