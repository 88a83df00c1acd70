"""Rank meshes: one simulator process per tile, over ``torch.distributed``.

The port of ``repro.launch.mesh``.  The reference lays its shards over
a mesh of TPU chips; here a mesh names the *ranks* of a process group
and arranges them on named axes.  DPSNN's MPI processes each own a set
of cortical columns; the SNN maps the mesh axes ``(axis_y, axis_x)`` to
the slab's tile rows and columns, one tile per rank
(``core.dist_engine``).

  single pod:  (16, 16)    axes ("data", "model")          = 256 ranks
  multi  pod:  (2, 16, 16) axes ("pod", "data", "model")   = 512 ranks

A mesh only names ranks and axes.  The device a rank computes on and
the transport that moves its halo strips (``core.halo.Transport``) are
separate, explicit arguments of the entry points.  Nothing here runs at
import.

Ranks rendezvous through a ``FileStore`` (``init_ranks``), never a
fixed TCP port, so that several groups may start on one machine at
once.  ``spawn_ranks`` starts N rank processes and fails the run when
any of them fails.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np

AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The ranks ``0 .. n-1`` laid row-major on ``shape``, one axis
    name per dimension; ``rank`` is this process's rank (None outside a
    process group, as for ``make_production_mesh``'s shape checks).
    ``devices`` is the array of ranks (``mesh_chips`` reads its shape,
    as the reference reads its device array's).  ``comm``: this rank's
    collectives over the mesh's axes (``parallel.collectives.attach``),
    None for a mesh of shapes only; it takes no part in equality."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: Optional[int] = None
    comm: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.shape)

    def coordinate(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        r = self.rank if rank is None else rank
        if r is None:
            raise ValueError("this mesh has no rank of its own")
        return tuple(int(i) for i in np.unravel_index(r, self.shape))

    def _dims(self, axis: AxisName) -> Tuple[int, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not one of the mesh's "
                                 f"{self.axis_names}")
        return tuple(self.axis_names.index(a) for a in names)

    def axis_size(self, axis: AxisName) -> int:
        """The size of ``axis``; a tuple of axes folds them into one
        logical axis (the product of their sizes)."""
        return int(np.prod([self.shape[d] for d in self._dims(axis)]))

    def axis_index(self, axis: AxisName, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) index along ``axis``; a folded
        axis counts its first name's coordinate most significant (pod
        major)."""
        c = self.coordinate(rank)
        i = 0
        for d in self._dims(axis):
            i = i * self.shape[d] + c[d]
        return i

    def neighbour(self, axis: AxisName, k: int) -> Optional[int]:
        """The rank ``k`` places along ``axis`` from this one, with every
        other coordinate the same; None off the end (the slab is flat)."""
        dims = self._dims(axis)
        i = self.axis_index(axis) + k
        if not 0 <= i < self.axis_size(axis):
            return None
        c = list(self.coordinate())
        for d in reversed(dims):
            c[d] = i % self.shape[d]
            i //= self.shape[d]
        return int(np.ravel_multi_index(c, self.shape))


def host_mesh_shape(n: int) -> Tuple[int, int]:
    """The reference's host-mesh shape rule for ``n`` devices (here
    ranks): the largest power of two ``m`` with ``m * m <= n`` that
    divides ``n``, as ``(n // m, m)``."""
    m = 1
    while m * 2 <= n // (m * 2) * (m * 2) and (m * 2) ** 2 <= n:
        m *= 2
    while n % m:
        m //= 2
    return n // m, m


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_ranks "
                           "in every rank first")
    return dist.get_rank(), dist.get_world_size()


def make_host_mesh(shape: Optional[Sequence[int]] = None,
                   axes: Sequence[str] = ("data", "model")) -> RankMesh:
    """The mesh of the current process group's ranks: ``shape``, or the
    reference's rule for the world size (``host_mesh_shape``)."""
    rank, n = _world()
    shape = host_mesh_shape(n) if shape is None else tuple(
        int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} "
                         f"ranks, the process group {n}")
    return RankMesh(shape, tuple(axes), rank)


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh: (16, 16) ``("data",
    "model")``, or (2, 16, 16) ``("pod", "data", "model")``.
    ``RankMesh(*production_mesh_shape(m), rank)`` is one rank's mesh of
    shapes, with no process group (the dry run's)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """The production mesh of the current process group's ranks
    (``production_mesh_shape``).  Raises unless the process group holds
    exactly 256 (512) ranks."""
    shape, axes = production_mesh_shape(multi_pod)
    rank, n = _world()
    want = int(np.prod(shape))
    if n != want:
        raise ValueError(f"the production mesh {shape} needs {want} ranks; "
                         f"the process group has {n}")
    return RankMesh(shape, axes, rank)


def mesh_chips(mesh) -> int:
    n = 1
    for s in mesh.devices.shape:
        n *= s
    return n


# how long a rank waits on a peer before the group fails
GROUP_TIMEOUT_S = 600.0


def init_ranks(rank: int, world_size: int, store_path: str,
               backend: str = "gloo", device="cuda") -> None:
    """Join the process group of ``world_size`` ranks through a
    ``FileStore`` at ``store_path`` (a file every rank can reach; no TCP
    port).  ``backend``: ``"gloo"`` (CPU tensors, and CUDA tensors
    staged through host memory by ``core.halo.Transport``) or
    ``"nccl"`` (CUDA tensors, one card a rank; host objects still go
    over gloo).  For ``"nccl"``, ``device`` is this rank's card (gloo
    ignores it), and the ranks compare their cards' UUIDs through the
    store before any communication: two ranks on one card raise
    ``SharedCardError`` (``core.halo.check_distinct_cards``)."""
    import torch
    import torch.distributed as dist
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend={backend!r}: expected 'gloo' or 'nccl'")
    store = dist.FileStore(store_path, world_size)
    pg_backend = "gloo"
    if backend == "nccl":
        from ..core.halo import card_uuid, check_distinct_cards
        if torch.device(device).type != "cuda":
            raise ValueError("backend='nccl' needs this rank's CUDA device")
        check_distinct_cards(store, rank, world_size, card_uuid(device))
        pg_backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(pg_backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S))


class RankFailure(RuntimeError):
    """A rank process raised, exited non-zero, or outlived the timeout."""


def _rank_main(rank: int, fn: Callable, world_size: int, store_path: str,
               backend: str, args: tuple) -> None:
    import torch.distributed as dist
    init_ranks(rank, world_size, store_path, backend,
               device=_rank_device(rank))
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def _rank_device(rank: int) -> str:
    import torch
    return f"cuda:{rank % max(torch.cuda.device_count(), 1)}"


def spawn_ranks(fn: Callable, nproc: int, args: tuple = (),
                backend: str = "gloo", store_dir: Optional[str] = None,
                timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, nproc, *args)`` in ``nproc`` fresh processes, each
    in the process group (``init_ranks`` through a ``FileStore`` under
    ``store_dir``, a new temporary directory by default).  ``fn`` must be
    importable by name (a module-level function).  Joins every rank:
    when one raises or exits non-zero the others are ended and
    ``RankFailure`` is raised; so it is when ``timeout_s`` passes first.
    Never goes on with fewer ranks."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="ranks-") if own else store_dir
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(fn, nproc, store, backend, tuple(args)),
        nprocs=nproc, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise RankFailure(f"the ranks outlived {timeout_s} s")
            try:
                if ctx.join(timeout=1.0 if left is None else min(left, 1.0)):
                    return
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:
                # every rank's traceback: the first to fail is often not
                # the one join() names (its peers fail on the broken link)
                raise RankFailure("\n".join(_tracebacks(ctx)) or str(e)) \
                    from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for f in ctx.error_files:
            if os.path.exists(f):
                os.remove(f)
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)


def _tracebacks(ctx) -> list:
    """The traceback each rank that raised left for its parent."""
    import pickle
    out = []
    for rank, path in enumerate(ctx.error_files):
        try:
            with open(path, "rb") as f:
                out.append(f"rank {rank}: {pickle.load(f)}")
        except (OSError, EOFError, pickle.UnpicklingError):
            continue
    return out
