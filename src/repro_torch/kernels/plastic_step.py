"""Fixed-order event delivery fused with STDP's LTD: the CUDA kernel's
wrapper.

Replaces the TPU kernel ``repro/kernels/plastic_step.py:
plastic_delivery_ltd`` (``_plastic_kernel``).  One step of a plastic run
delivers the spiking rows' *old* weights into the delay ring and
depresses every plastic synapse of those rows by ``a_minus *
x_post[target]``; LTP, the clamp and the trace increments stay in plain
PyTorch (``core.stdp.stdp_ltp_finalize``), as they stay in XLA in the
reference.

Weights here are float32, so the ring must receive its additions in the
reference's order, which float atomics cannot give.  The kernel
(``csrc/plastic_delivery.cu``) pulls instead: one warp per target walks
the target-major inverse index (``core.stdp.build_inverse_index``),
whose per-target slot order is the reference's (row, k) order, and adds
the delivered weights into its ring words one after another.  It is
bound by device-memory traffic: every slot of the index is read (4 B per
synapse), the delivered synapses' weight, delay and mask are gathered
(9 B) and their new weight written (4 B), and the ring is read and
written once.  The TPU version's resident-ring envelope (``RING_N_MAX``)
and its routing predicate have no counterpart: there is one route.

With ``masks=None`` the same kernel is the fixed-order delivery of a
static run with float32 weights (no weight is written).

Delivered rows are the first ``active_cap`` spiking rows, ascending, as
in ``compact_events``.  The ring and the tiers' weights are updated in
place (the reference returns new arrays).  Wrappers launch the kernel
for CUDA tensors and take the plain version
(``ref.plastic_delivery_ltd_ref``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .ref import plastic_delivery_ltd_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _launcher():
    lib = _build.library("plastic_delivery")
    fn = lib.plastic_delivery_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _L, _L, _I, _P, _P, _P, _P, _P, _F,
                       _P, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def delivered_flags(spikes_src: torch.Tensor, n_rows: int, active_cap: int):
    """One byte per row (the sink row last, always 0): 1 for the first
    ``active_cap`` spiking rows, the rows the compaction delivers.
    Returns (flag uint8 (n_rows + 1,), n_spikes int64 0-d)."""
    spk = spikes_src[:n_rows] > 0
    rank = torch.cumsum(spk, 0, dtype=torch.int32)
    flag = torch.zeros((n_rows + 1,), dtype=torch.uint8,
                       device=spikes_src.device)
    flag[:n_rows] = spk & (rank <= active_cap)
    return flag, spk.sum()


def _check(tables: dict, ring: torch.Tensor, inv: dict, tier: int,
           mask: Optional[torch.Tensor], x_post: Optional[torch.Tensor]):
    w, dslot, tgt = tables["w"], tables["dslot"], tables["tgt"]
    d_ring, n_local = ring.shape
    slots, n_in = inv["slots"], inv["n_in"]
    ok = (w.dtype == torch.float32 and dslot.dtype == torch.int8
          and w.shape == dslot.shape == tgt.shape
          and ring.dtype == torch.float32 and 1 <= d_ring <= 32
          and slots.dtype == torch.int32 and n_in.dtype == torch.int32
          and slots.dim() == 2 and slots.shape[0] == n_local
          and n_in.shape == (n_local,)
          and int(inv["sizes"][tier]) == w.numel()
          and (mask is None) == (x_post is None)
          and (mask is None or (mask.dtype == torch.float32
                                and mask.shape == w.shape))
          and (x_post is None or (x_post.dtype == torch.float32
                                  and x_post.shape == (n_local,))))
    arrays = [x for x in (w, dslot, tables["nnz"], slots, n_in, mask, x_post)
              if x is not None]
    if not ok or not ring.is_contiguous() or not all(
            x.is_contiguous() and x.device == ring.device for x in arrays):
        raise ValueError(
            "plastic delivery takes contiguous tensors on the ring's "
            "device: w float32 and dslot int8 (rows+1, cap), mask float32 "
            "like w (or None with x_post None), x_post float32 (n_local,), "
            "a float32 (d_ring <= 32, n_local) ring, and the inverse index "
            "of these tiers (slots int32 (n_local, K_in), n_in int32); got "
            f"w {w.dtype} {tuple(w.shape)}, dslot {dslot.dtype}, ring "
            f"{ring.dtype} {tuple(ring.shape)}, slots {slots.dtype} "
            f"{tuple(slots.shape)}, tier size {w.numel()} vs index "
            f"{int(inv['sizes'][tier])}")


def plastic_delivery_ltd_cuda(tables: dict, flag: torch.Tensor, inv: dict,
                              tier: int, ring: torch.Tensor, t_slot: int,
                              mask=None, x_post=None,
                              neg_a_minus: float = 0.0) -> torch.Tensor:
    """Launch the kernel for one tier (``tier``: its position in the
    inverse index) over the rows flagged in ``flag`` (uint8 (rows+1,)).
    Updates ``ring`` and, with ``mask``, ``tables["w"]`` in place."""
    _check(tables, ring, inv, tier, mask, x_post)
    w = tables["w"]
    if ring.device.type != "cuda" or flag.dtype != torch.uint8 \
            or flag.shape != (w.shape[0],) or flag.device != ring.device:
        raise ValueError("plastic_delivery_ltd_cuda takes a CUDA ring and "
                         "a uint8 (rows+1,) flag on its device")
    d_ring, n_local = ring.shape
    slots = inv["slots"]
    err = _launcher()(
        slots.data_ptr(), inv["n_in"].data_ptr(), n_local, slots.shape[1],
        int(inv["bases"][tier]), int(inv["sizes"][tier]), w.shape[1],
        flag.data_ptr(), w.data_ptr(), tables["dslot"].data_ptr(),
        mask.data_ptr() if mask is not None else None,
        x_post.data_ptr() if x_post is not None else None,
        float(neg_a_minus), ring.data_ptr(), n_local, d_ring, int(t_slot),
        _build.stream_ptr(ring))
    _build.check(err, "plastic_delivery_ltd")
    _build.count_launch("plastic_delivery_ltd")
    return ring


def plastic_delivery_ltd(tiers: Sequence[Tuple[dict, torch.Tensor, int]],
                         masks: Optional[Sequence[torch.Tensor]],
                         x_post_decayed: Optional[torch.Tensor],
                         i_ring: torch.Tensor, t_slot: int, d_ring: int,
                         neg_a_minus: float, *, inv: dict, plan=None):
    """Fixed-order delivery + LTD over every tier, one launch per tier.

    ``tiers``: [(tables, spikes_src, active_cap)], tier i being tier i
    of the inverse index ``inv``; ``masks``: per-tier float32 plastic
    masks, or None for delivery only; ``x_post_decayed``: the (n_local,)
    post trace after this step's decay; ``neg_a_minus``:
    ``-params.a_minus``.  Returns ``(ring, new_w, n_events int32,
    n_dropped int64)``; ``new_w`` lists the tiers' weight tensors,
    updated in place (None when ``masks`` is None)."""
    if i_ring.shape[0] != d_ring:
        raise ValueError(f"ring has {i_ring.shape[0]} slots, d_ring is "
                         f"{d_ring}")
    if plan is not None and len(plan) != len(tiers):
        raise ValueError(f"delivery plan has {len(plan)} tiers, "
                         f"got {len(tiers)}")
    if inv["clipped"] != 0:
        raise ValueError(
            f"the inverse index clipped {inv['clipped']} synapses: a "
            "fixed-order delivery through it would drop them")
    cuda = _build.on_cuda(i_ring)
    events = torch.zeros((), dtype=torch.int32, device=i_ring.device)
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
        mask = masks[ti] if masks is not None else None
        x_post = x_post_decayed if masks is not None else None
        if cuda:
            flag, n_spk = delivered_flags(spikes_src, n_rows, active_cap)
            plastic_delivery_ltd_cuda(tables, flag, inv, ti, i_ring, t_slot,
                                      mask, x_post, neg_a_minus)
            ev = (tables["nnz"] * flag).sum(dtype=torch.int32)
        else:
            _check(tables, i_ring, inv, ti, mask, x_post)
            ev, n_spk = plastic_delivery_ltd_ref(
                tables, spikes_src, active_cap, i_ring, t_slot, mask,
                x_post, neg_a_minus)
        events = events + ev
        n_dropped = n_dropped + torch.clamp(n_spk - active_cap, min=0)
    new_w = [t["w"] for t, _, _ in tiers] if masks is not None else None
    return i_ring, new_w, events, n_dropped
