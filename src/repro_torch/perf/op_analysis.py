"""Cost analysis of an eager PyTorch program, op by op: the port's
counterpart of ``repro.perf.hlo_analysis``, which parses compiled HLO
text.  This replaces that parser: the port compiles nothing, so
``analyze(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and
counts every aten op the eager program dispatches (forward, backward and
checkpoint recomputes alike).  Run on ``"meta"`` tensors it allocates
nothing and launches nothing.

Conventions, per op:

* ``dot_flops``: the matmul class (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; ``einsum`` and ``linear`` reach these) as 2 M N K, and
  ``_scaled_dot_product_*`` attention as its two products;
* ``flops``: ``dot_flops`` plus one FLOP per output element of every
  other op that computes (elementwise and reductions alike, as the
  reference counts them); ops that only move or fill data count none;
* ``bytes``: the op's operand bytes plus its result bytes.  Eager
  PyTorch launches one kernel per aten op, so this is the eager
  program's device traffic, the counterpart of the reference's bytes at
  fusion boundaries.  An operand broadcast by ``expand`` (stride 0)
  counts its stored elements once;
* views, reshapes, ``expand``, ``detach`` and factory ops of no data
  (``empty*``) cost 0;
* collectives: the port's go through ``parallel.collectives``, not
  through aten.  In a dry run on ranks (``launch.dryrun``) its
  ``DryCollectives`` stand in for them: each output is a fill of the
  right shape, whose bytes (the operand read, the output written) are
  the reference's bytes of a collective, and the ring's wire bytes a
  rank go into ``coll_bytes`` / ``coll_by_kind`` (the dry run copies
  them from ``DryCollectives.wire()``).  An aten collective (``c10d``)
  costs 0 and is listed in ``notes``.

The reference exists because XLA counts a ``while`` body once; Python
loops dispatch every iteration, so nothing here needs a trip count.
``peak_bytes`` is the peak of the bytes newly allocated during ``fn``
and still alive (each new storage added when an op makes it, released
when it dies, through ``weakref.finalize`` on the storage): the step's
counterpart of the reference's ``memory_analysis()`` temp bytes, on top
of the inputs that existed before the call.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_MATMUL = {"mm", "addmm", "bmm", "baddbmm"}
# ops that only move, gather or fill data: bytes, no FLOPs
_MOVE = {
    "copy_", "_to_copy", "clone", "cat", "stack", "index", "_unsafe_index",
    "index_select", "gather", "scatter", "scatter_add", "scatter_add_",
    "index_put", "index_put_", "_index_put_impl_", "index_copy_",
    "embedding", "constant_pad_nd", "repeat", "fill_", "fill", "zero_",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
    "lift_fresh_copy", "slice_scatter", "select_scatter", "flip", "roll",
    "masked_scatter", "repeat_interleave",
}
# ops of no data cost that are not view ops (``OpOverload.is_view``
# covers view, reshape, expand, detach, alias and the rest)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "set_", "resize_", "_local_scalar_dense",
         "_unsafe_view"}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "c10d_functional")


@dataclasses.dataclass
class Costs:
    """Totals of one traced call (the reference's fields), with the
    port's ``peak_bytes``, op count and per-op breakdown."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    dot_flops: float = 0.0
    notes: List[str] = dataclasses.field(default_factory=list)
    peak_bytes: float = 0.0
    n_ops: int = 0
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)

    def add(self, other: "Costs", weight: float = 1.0):
        self.flops += other.flops * weight
        self.bytes += other.bytes * weight
        self.coll_bytes += other.coll_bytes * weight
        self.dot_flops += other.dot_flops * weight
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v * weight
        self.notes.extend(n for n in other.notes if n not in self.notes)

    def top(self, n: int = 8, key: int = 1) -> list:
        """The ``n`` ops with the most bytes (``key=1``) or FLOPs (0):
        ``[(op, flops, bytes, calls), ...]``."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][key])[:n]
        return [(name,) + tuple(v) for name, v in rows]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements an operand holds: a broadcast (stride-0)
    axis counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _out_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args) -> float:
    if name == "mm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "baddbmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    # _scaled_dot_product_*: q (B, H, Sq, D), k (B, H, Sk, D): QK^T and
    # PV forward, twice that (four products) backward
    q, k = args[0], args[1]
    fwd = 4.0 * math.prod(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    return 2.0 * fwd if name.endswith("_backward") else fwd


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.live = 0
        self._tracked = set()

    def _release(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def _track(self, out_tensors, in_storages) -> None:
        for t in out_tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in in_storages or key in self._tracked:
                continue
            nbytes = st.nbytes()
            self._tracked.add(key)
            self.live += nbytes
            weakref.finalize(st, self._release, key, nbytes)
        if self.live > self.costs.peak_bytes:
            self.costs.peak_bytes = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ns = func.namespace
        c = self.costs
        c.n_ops += 1
        if ns in _COLLECTIVE_NS:
            note = f"collective {ns}.{name} (not counted)"
            if note not in c.notes:
                c.notes.append(note)
            return out
        if func.is_view or name in _FREE:
            return out
        ins = list(_tensors(args)) + list(_tensors(list(kwargs.values())))
        outs = list(_tensors(out))
        nbytes = (sum(_read_bytes(t) for t in ins)
                  + sum(_out_bytes(t) for t in outs))
        if name in _MATMUL or name.startswith("_scaled_dot_product"):
            dot = _dot_flops(name, args)
            flops = dot
            c.dot_flops += dot
        elif name in _MOVE:
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in outs))
        c.flops += flops
        c.bytes += nbytes
        row = c.by_op.setdefault(name, [0.0, 0.0, 0])
        row[0] += flops
        row[1] += nbytes
        row[2] += 1
        self._track(outs, {id(t.untyped_storage()) for t in ins})
        return out


def analyze(fn, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once under the counting mode and
    return its ``Costs`` (module docstring).  Nothing is kept of the
    call's result."""
    costs = Costs()
    with _Counter(costs):
        fn(*args, **kwargs)
    return costs
