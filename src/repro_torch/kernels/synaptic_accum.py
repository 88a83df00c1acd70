"""Event-driven synaptic delivery: compaction plus the CUDA delivery kernel.

Replaces the TPU pipeline ``repro/kernels/synaptic_accum.py``
(``event_delivery_banded`` -> ``_scatter_entries`` / ``_accum_kernel``).
Per tier (the local table, then each halo fan-out band):

  * **compaction** (``compact_events``, plain PyTorch): the ascending
    indices of the first ``active_cap`` spiking rows, padded with the sink
    row, by a fixed-size cumsum and scatter -- no ``torch.nonzero``, which
    would synchronize the host every step;
  * **delivery** (``csrc/event_delivery.cu``): one warp per compacted
    row gathers the row's ``nnz`` entries and atomically adds each weight
    into ``ring[(t_slot + dslot) % d_ring, tgt]``; the row's ``nnz`` goes
    into the event counter.  Gather and scatter are one pass, so the
    entry stream never lands in device memory (the TPU version
    materialized it, lane-packed, for its one-hot MXU scatter).

Bound: memory traffic, ~7 B of table entries per synaptic event (int32
ids; 5 B with int16) plus one ring word per touched target.  The atomic
adds land in no fixed order, which is exact only for bfloat16 weights
(every ring value a multiple of 2^-9 far below 2^15): the kernel refuses
float32 weights, which take the fixed-order kernel of
``kernels/plastic_step.py``.  Tiers are
one launch each.  Drop semantics match the reference exactly: only the
first ``active_cap`` spiking rows, in ascending order, are delivered, and
``n_dropped = max(n_spikes - active_cap, 0)``.

The ring is updated in place (the JAX reference returns a new one).
Wrappers launch the kernel for CUDA tensors and take the plain version
(``ref.deliver_rows_ref``: gather plus ``index_add_``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .ref import compact_events, deliver_rows_ref, synaptic_accum_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

_TGT_BYTES = {torch.int16: 2, torch.int32: 4}
_W_BYTES = {torch.bfloat16: 2, torch.float32: 4}
# weights the atomic kernel may add in any order and still be exact
_ORDER_FREE_W = (torch.bfloat16,)


def _launcher():
    lib = _build.library("event_delivery")
    fn = lib.deliver_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P, _I, _I,
                       _I, _P, _P]
        fn.restype = _I
    return fn


# ---------------------------------------------------------------------------
# The delivery kernel
# ---------------------------------------------------------------------------

def _check_tier(tables: dict, ring: torch.Tensor):
    """Validate one tier's tables (``nnz`` optional) against the ring."""
    tgt, w, dslot = tables["tgt"], tables["w"], tables["dslot"]
    nnz = tables.get("nnz")
    rows1, cap = tgt.shape
    arrays = [x for x in (tgt, w, dslot, nnz) if x is not None]
    ok = (tgt.dtype in _TGT_BYTES and w.dtype in _W_BYTES
          and dslot.dtype == torch.int8
          and w.shape == dslot.shape == (rows1, cap)
          and (nnz is None or (nnz.dtype == torch.int32
                               and nnz.shape == (rows1,)))
          and ring.dtype == torch.float32 and ring.dim() == 2
          and ring.is_contiguous()
          and all(x.is_contiguous() and x.device == ring.device
                  for x in arrays))
    if not ok:
        raise ValueError(
            "delivery takes contiguous tables on the ring's device: tgt "
            "int16/int32, w bfloat16/float32, dslot int8 (rows+1, cap), nnz "
            "int32 (rows+1,), and a float32 (d_ring, n_local) ring; got "
            + ", ".join(f"{k} {v.dtype} {tuple(v.shape)} on {v.device}"
                        for k, v in tables.items())
            + f", ring {ring.dtype} {tuple(ring.shape)}")


def deliver_rows_cuda(tables: dict, idx: torch.Tensor, ring: torch.Tensor,
                      t_slot: int, events) -> torch.Tensor:
    """Launch the delivery kernel over the compacted rows ``idx`` (int32)
    of one tier.  ``events``: int32 (1,) counter (or None); ``tables`` may
    omit ``nnz`` (every row is then read to its capacity)."""
    _check_tier(tables, ring)
    if tables["w"].dtype not in _ORDER_FREE_W:
        raise ValueError(
            f"the atomic delivery kernel adds in no fixed order, which is "
            f"exact only for bfloat16 weights; {tables['w'].dtype} weights "
            "take the fixed-order kernel (kernels.plastic_step)")
    nnz = tables.get("nnz")
    if ring.device.type != "cuda" or idx.device != ring.device \
            or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("deliver_rows_cuda takes a CUDA ring and a "
                         "contiguous int32 idx on its device")
    if events is not None and (events.dtype != torch.int32
                               or events.device != ring.device):
        raise ValueError("events must be an int32 counter on the ring's "
                         "device")
    tgt = tables["tgt"]
    d_ring, n_local = ring.shape
    err = _launcher()(
        idx.data_ptr(), idx.shape[0], tgt.data_ptr(), _TGT_BYTES[tgt.dtype],
        tables["w"].data_ptr(), _W_BYTES[tables["w"].dtype],
        tables["dslot"].data_ptr(),
        nnz.data_ptr() if nnz is not None else None, tgt.shape[1],
        tgt.shape[0] - 1, ring.data_ptr(), n_local, d_ring, int(t_slot),
        events.data_ptr() if events is not None else None,
        _build.stream_ptr(ring))
    _build.check(err, "event_delivery")
    _build.count_launch("event_delivery")
    return ring


def deliver_rows(tables: dict, idx: torch.Tensor, ring: torch.Tensor,
                 t_slot: int, events: torch.Tensor) -> torch.Tensor:
    """Deliver one tier's compacted rows into ``ring`` (in place) and add
    their synaptic events to ``events``.  CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    if _build.on_cuda(ring):
        return deliver_rows_cuda(tables, idx, ring, t_slot, events)
    _check_tier(tables, ring)
    return deliver_rows_ref(tables, idx, ring, t_slot, events)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def event_delivery_banded(tiers: Sequence[Tuple[dict, torch.Tensor, int]],
                          i_ring: torch.Tensor, t_slot: int, d_ring: int, *,
                          plan=None):
    """Multi-tier delivery: the local table plus every halo fan-out band.

    ``tiers``: sequence of (tables, spikes_src, active_cap).  ``plan``:
    optional per-tier ``TierPlan`` sequence from
    ``SynapseTableSpec.delivery_plan()`` the tables are validated
    against.  Returns (ring, n_events int32, n_dropped) summed over tiers;
    the ring is updated in place.
    """
    if i_ring.shape[0] != d_ring:
        raise ValueError(f"ring has {i_ring.shape[0]} slots, d_ring is "
                         f"{d_ring}")
    if plan is not None and len(plan) != len(tiers):
        raise ValueError(f"delivery plan has {len(plan)} tiers, "
                         f"got {len(tiers)}")
    events = torch.zeros((1,), dtype=torch.int32, device=i_ring.device)
    n_dropped = torch.zeros((), dtype=torch.int64, device=i_ring.device)
    for ti, (tables, spikes_src, active_cap) in enumerate(tiers):
        n_rows, cap = tables["tgt"].shape[0] - 1, tables["tgt"].shape[1]
        if plan is not None:
            p = plan[ti]
            if (p.rows, p.cap, p.active_cap) != (n_rows, cap, active_cap):
                raise ValueError(
                    f"tier {ti} does not match its delivery plan: tables "
                    f"are rows={n_rows} cap={cap} active_cap={active_cap}, "
                    f"plan says rows={p.rows} cap={p.cap} "
                    f"active_cap={p.active_cap}")
        idx, n_spk = compact_events(spikes_src, n_rows, active_cap)
        deliver_rows(tables, idx, i_ring, t_slot, events)
        n_dropped = n_dropped + torch.clamp(n_spk - active_cap, min=0)
    return i_ring, events[0], n_dropped


def event_delivery(tables: dict, spikes_src, i_ring, t_slot: int,
                   d_ring: int, active_cap: int):
    """Single-tier delivery.  Drop-in for ``core.synapses.deliver_events``:
    returns (ring, n_events, n_dropped)."""
    return event_delivery_banded([(tables, spikes_src, active_cap)],
                                 i_ring, t_slot, d_ring)


def synaptic_accum(idx, t_slot: int, tgt, w, dslot, ring):
    """Deliver the pre-compacted event rows ``idx`` (A,) through the
    tables into ``ring`` (in place; returned).  Every listed row is read
    to its capacity (no ``nnz``); rows equal to the sink row
    ``tgt.shape[0]-1`` are skipped.  Equivalent to
    ``ref.synaptic_accum_ref``."""
    idx = idx.to(torch.int32).contiguous()
    tables = {"tgt": tgt, "w": w, "dslot": dslot}
    if _build.on_cuda(ring):
        return deliver_rows_cuda(tables, idx, ring, t_slot, None)
    _check_tier(tables, ring)
    return synaptic_accum_ref(idx, t_slot, tgt, w, dslot, ring)
