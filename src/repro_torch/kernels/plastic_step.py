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
the delivered weights into its ring words, one ordered chain per word.
A slot's row comes from a 32-bit multiply-high (``magic_u31``), its
delivery from the delivered-row bitmap in shared memory, its delay and
plastic bit from the index's target-major byte array (``inv["tm"]``,
``core.stdp.target_major_meta``).  The plastic bits have one source,
the masks passed to ``plastic_delivery_ltd``: before each launch it
binds them into ``tm`` (``bind_plastic_bits``), again whenever a mask
is replaced or edited in place.  The function is bound by
device-memory traffic over the delivered synapses' entries, the new
weights, the ring and x_post; the kernel also reads every slot of the
index and its byte (5 B per synapse, whatever fires), the cost of its
pull design, then gathers the delivered weights and writes the plastic
ones' new weights (4 B each).  The TPU version's resident-ring envelope (``RING_N_MAX``) and its
routing predicate have no counterpart: there is one route.

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
from .ref import delivered_bits, plastic_delivery_ltd_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# shared memory the kernel declares statically (kStaticSmem): what is
# left of a block's holds the delivered-row bitmap
STATIC_SMEM = 64


def _launcher():
    lib = _build.library("plastic_delivery")
    fn = lib.plastic_delivery_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _U, _I, _P, _I, _P, _P,
                       _P, _P, _F, _I, _P, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def magic_u31(d: int) -> Tuple[int, int]:
    """Constants ``(m, l)`` with ``v // d == ((2v * m) >> 32) >> l`` for
    every ``0 <= v < 2**31``: ``l = ceil(log2 d)``, ``m = ceil(2**(31 +
    l) / d) < 2**32``.  Then ``m * d - 2**(31 + l) < d <= 2**l``, the
    Granlund-Montgomery condition for 31-bit dividends; ``2v`` fits 32
    bits, so the kernel computes ``__umulhi(v << 1, m) >> l``."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} outside 1..2**31-1")
    l = (d - 1).bit_length()
    return -(-(1 << (31 + l)) // d), l


def magic_div(v, m: int, l: int):
    """The kernel's ``__umulhi(v << 1, m) >> l`` on Python ints or int64
    arrays (``0 <= v < 2**31``)."""
    return (((v << 1) * m) >> 32) >> l


def _target_major(inv: dict, dev: torch.device) -> torch.Tensor:
    tm = inv.get("tm")
    if tm is None or tm.dtype != torch.int8 \
            or tm.shape != inv["slots"].shape or tm.device != dev:
        raise ValueError("the inverse index has no target-major delay/"
                         "plastic array on the ring's device (inv['tm'], "
                         "core.stdp.target_major_meta)")
    return tm


def bind_plastic_bits(inv: dict, tier: int, mask: torch.Tensor) -> None:
    """Make bit 7 of ``inv["tm"]`` over tier ``tier``'s slots the plastic
    mask ``mask`` (exactly 0 or 1, shaped like the tier's weights), in
    place, unless it already is.  The binding is kept per tier with the
    ``tm`` tensor, the mask tensor and its version counter, so a mask
    that is replaced or edited in place (or a new ``tm``) is bound again
    at its next use; the check is free otherwise."""
    tm = _target_major(inv, inv["slots"].device)
    bound = inv.setdefault("tm_masks", {})
    seen = bound.get(tier)
    if seen is not None and seen[0] is tm and seen[1] is mask \
            and seen[2] == mask._version:
        return
    flat = mask.reshape(-1)
    if bool(((flat != 0) & (flat != 1)).any()):
        raise ValueError("plastic masks must be exactly 0 or 1: the "
                         "kernel's LTD adds dw_unit where the bit is set")
    local = inv["slots"].long() - int(inv["bases"][tier])
    inside = (local >= 0) & (local < flat.numel())
    plastic = torch.where(inside,
                          flat.to(tm.device)[local.clamp(0, flat.numel() - 1)]
                          > 0, tm < 0)     # other tiers keep their bits
    byte = tm.view(torch.uint8)
    byte.copy_((byte & 0x7F) | (plastic.to(torch.uint8) << 7))
    bound[tier] = (tm, mask, mask._version)


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


def plastic_delivery_ltd_cuda(tables: dict, bits: torch.Tensor, inv: dict,
                              tier: int, ring: torch.Tensor, t_slot: int,
                              x_post=None, neg_a_minus: float = 0.0,
                              events=None) -> torch.Tensor:
    """Launch the kernel for one tier (``tier``: its position in the
    inverse index) over the rows set in ``bits`` (int32,
    ``ref.delivered_bits``).  Updates ``ring``, ``events`` (int32 (1,),
    optional) and, with ``x_post`` (LTD on), the plastic weights of
    ``tables["w"]`` in place: those whose bit is set in the index's
    ``tm``, as ``bind_plastic_bits`` (or ``core.stdp.target_major_meta``)
    left it."""
    _check(tables, ring, inv, tier, None, x_post)
    w = tables["w"]
    n_rows, cap = w.shape[0] - 1, w.shape[1]
    n_words = (n_rows + 32) // 32
    tm = _target_major(inv, ring.device)
    if ring.device.type != "cuda" or bits.dtype != torch.int32 \
            or bits.shape != (n_words,) or bits.device != ring.device:
        raise ValueError("plastic_delivery_ltd_cuda takes a CUDA ring and "
                         "an int32 bitmap of ceil((rows + 1) / 32) words on "
                         "its device")
    if 4 * n_words > _build.SMEM_BYTES - STATIC_SMEM:
        raise ValueError(f"the delivered-row bitmap of {n_rows + 1} rows "
                         f"exceeds the {_build.SMEM_BYTES - STATIC_SMEM} B "
                         "of shared memory a block has beside the kernel's "
                         f"{STATIC_SMEM} B of static arrays")
    base, size = int(inv["bases"][tier]), int(inv["sizes"][tier])
    if base + size >= 2 ** 31:
        raise ValueError("the inverse index's virtual slots exceed int32")
    if events is not None and (events.dtype != torch.int32
                               or events.device != ring.device):
        raise ValueError("events must be an int32 counter on the ring's "
                         "device")
    d_ring, n_local = ring.shape
    slots = inv["slots"]
    magic, shift = magic_u31(cap)
    err = _launcher()(
        slots.data_ptr(), inv["n_in"].data_ptr(), tm.data_ptr(), n_local,
        slots.shape[1], base, size, magic, shift, bits.data_ptr(), n_words,
        tables["nnz"].data_ptr(),
        events.data_ptr() if events is not None else None, w.data_ptr(),
        x_post.data_ptr() if x_post is not None else None,
        float(neg_a_minus), int(x_post is not None), ring.data_ptr(), n_local,
        d_ring, int(t_slot), _build.stream_ptr(ring))
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
        mask = masks[ti] if masks is not None else None
        x_post = x_post_decayed if masks is not None else None
        _check(tables, i_ring, inv, ti, mask, x_post)
        if cuda:
            if mask is not None:
                bind_plastic_bits(inv, ti, mask)
            bits, n_spk = delivered_bits(spikes_src, n_rows, active_cap)
            plastic_delivery_ltd_cuda(tables, bits, inv, ti, i_ring, t_slot,
                                      x_post, neg_a_minus, events)
        else:
            ev, n_spk = plastic_delivery_ltd_ref(
                tables, spikes_src, active_cap, i_ring, t_slot, mask,
                x_post, neg_a_minus)
            events += ev
        n_dropped = n_dropped + torch.clamp(n_spk - active_cap, min=0)
    new_w = [t["w"] for t, _, _ in tiers] if masks is not None else None
    return i_ring, new_w, events[0], n_dropped
