"""Plain PyTorch versions of the CUDA kernels.

These are the semantics of record, mirroring ``repro/kernels/ref.py``.
Each kernel wrapper takes its plain version for CPU tensors, and
``chip_smoke.py`` holds every kernel against its plain version on the
card.  They run on any device.
"""

from __future__ import annotations

import math

import torch

# repro-lint: ignore[dtype-bounds] the plain LIF evaluates each fused
# multiply-add in double and rounds once to float32 (the product of two
# float32 values is exact in double); nothing is stored in double
_F64 = torch.float64


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (to the precision of a fused
    multiply-add, up to double-rounding ties)."""
    return (a.to(_F64) * b + c.to(_F64)).to(torch.float32)


# ---------------------------------------------------------------------------
# LIF + SFA fused neuron update (kernels/lif_step.py)
# ---------------------------------------------------------------------------

def lif_step_ref(v, c, refrac, i_total, active, *, leak_decay, sfa_decay,
                 neg_g_dt, v_rest, v_reset, theta, alpha_c, refrac_steps):
    """Returns (v', c', refrac', spk f32).  Same arithmetic as the CUDA
    kernel: ``v_int = fma(neg_g_dt, c, fma(v - v_rest, leak, i)) + v_rest``
    (the ``v_rest`` terms only when it is nonzero), ``c' = fma(c,
    sfa_decay, alpha_c * spk)``."""
    u = v - v_rest if v_rest != 0.0 else v
    v_int = _fma(c, neg_g_dt, _fma(u, leak_decay, i_total))
    if v_rest != 0.0:
        v_int = v_int + v_rest
    v_new = torch.where(refrac > 0, torch.full_like(v, v_reset), v_int)
    spiked = (v_new >= theta) & active
    v_new = torch.where(spiked, torch.full_like(v, v_reset), v_new)
    spk = spiked.to(torch.float32)
    c_new = _fma(c, sfa_decay, alpha_c * spk)
    refrac_new = torch.where(spiked, torch.full_like(refrac, refrac_steps),
                             torch.clamp(refrac - 1, min=0))
    return v_new, c_new, refrac_new, spk


# ---------------------------------------------------------------------------
# Spike compaction (kernels/spike_compact.py; also the first stage of
# event delivery)
# ---------------------------------------------------------------------------

def compact_events(spikes_src: torch.Tensor, n_rows: int, active_cap: int):
    """Spiking-row compaction: ascending row indices of the (at most
    ``active_cap``) spiking sources, padded with the sink row ``n_rows``.

    Returns (idx int32 (active_cap,), n_spikes int64 0-d tensor).  A
    fixed-size cumsum and scatter, no ``torch.nonzero``: the sizes are
    static, so nothing waits for the device.
    """
    spk = spikes_src[:n_rows] > 0
    dev = spikes_src.device
    rank = torch.cumsum(spk, 0, dtype=torch.int32) - 1
    dest = torch.where(spk & (rank < active_cap), rank,
                       torch.full_like(rank, active_cap))
    idx = torch.full((active_cap + 1,), n_rows, dtype=torch.int32,
                     device=dev)
    # every non-delivered row lands in the dump slot ``active_cap``
    idx.scatter_(0, dest.long(),
                 torch.arange(n_rows, dtype=torch.int32, device=dev))
    return idx[:active_cap], spk.sum()


def spike_compact_ref(spikes, n_rows: int, active_cap: int):
    """Plain version of the compaction kernel: ``compact_events`` with
    the uncapped count as an int32 0-d tensor."""
    idx, n = compact_events(spikes, n_rows, active_cap)
    return idx, n.to(torch.int32)


def delivered_flags(spikes_src: torch.Tensor, n_rows: int, active_cap: int):
    """The rows ``compact_events`` delivers, one byte per row (the sink
    row last, always 0): 1 for the first ``active_cap`` spiking rows.
    Returns (flag uint8 (n_rows + 1,), n_spikes int64 0-d)."""
    spk = spikes_src[:n_rows] > 0
    rank = torch.cumsum(spk, 0, dtype=torch.int32)
    flag = torch.zeros((n_rows + 1,), dtype=torch.uint8,
                       device=spikes_src.device)
    flag[:n_rows] = spk & (rank <= active_cap)
    return flag, spk.sum()


_SHIFTS: dict = {}     # per device: 0..31, the bit of each row in its word


def delivered_bits(spikes_src: torch.Tensor, n_rows: int, active_cap: int):
    """``delivered_flags`` packed 32 rows to a word: bit ``r % 32`` of word
    ``r // 32`` is row r's flag; the sink row's bit and the padding bits
    are 0.  Eight launches, none waits for the device.  ``spikes_src``
    may carry leading axes (one row of spikes per tile): each is packed
    on its own, in the same launches.  Returns (bits int32 (...,
    ceil((n_rows + 1) / 32)), n_spikes int (...))."""
    dev = spikes_src.device
    spk = spikes_src[..., :n_rows] > 0
    if spk.dim() > 1 and n_rows:
        # one scan over the rows end to end, less the count before each
        # row: a scan along a few long rows at once runs a block a row
        flat = torch.cumsum(spk.reshape(-1), 0, dtype=torch.int32).view(
            -1, n_rows)
        before = torch.nn.functional.pad(flat[:-1, -1], (1, 0))
        rank = (flat - before[:, None]).view(spk.shape)
    else:
        rank = torch.cumsum(spk, -1, dtype=torch.int32)
    n_words = (n_rows + 32) // 32
    flag = torch.nn.functional.pad(spk & (rank <= active_cap),
                                   (0, n_words * 32 - n_rows))
    if dev not in _SHIFTS:
        _SHIFTS[dev] = torch.arange(32, dtype=torch.int32, device=dev)
    # distinct powers of two: the int32 sum is their bitwise or
    bits = (flag.to(torch.int32).view(flag.shape[:-1] + (n_words, 32))
            << _SHIFTS[dev]).sum(-1, dtype=torch.int32)
    return bits, (rank[..., -1] if n_rows else rank.sum(-1))


# ---------------------------------------------------------------------------
# The step's head (kernels/neuron_step.py)
# ---------------------------------------------------------------------------

def neuron_step_ref(ring, slot: int, drive, v, c, refrac, active, *,
                    active_cap=None, **params):
    """Plain version of the step-head kernel, the engine's step head
    composed of its plain pieces in the reference's order: ``i =
    ring[slot] + drive``, ``lif_step_ref``, ``ring[slot] = 0`` (in
    place), then with ``active_cap`` the delivered-row bitmap
    (``delivered_bits``).  Returns (v', c', refrac', spk f32, bits int32
    or None, count int32 0-d)."""
    i_total = ring[slot] + drive
    v, c, refrac, spk = lif_step_ref(v, c, refrac, i_total, active,
                                     **params)
    ring[slot] = 0.0
    if active_cap is None:
        return v, c, refrac, spk, None, (spk > 0).sum(dtype=torch.int32)
    bits, count = delivered_bits(spk, spk.shape[0], active_cap)
    return v, c, refrac, spk, bits, count.to(torch.int32)


# ---------------------------------------------------------------------------
# Event-driven synaptic accumulation (kernels/synaptic_accum.py)
# ---------------------------------------------------------------------------

def synaptic_accum_ref(idx, t_slot: int, tgt, w, dslot, ring):
    """Deliver the rows listed in ``idx`` into the delay ring, in place.

    idx: (A,) row indices (padding rows point at the all-zero sink row
    ``tgt.shape[0]-1``); ring: (D, n_local) f32, updated and returned.
    """
    d_ring, n_local = ring.shape
    idx = idx.long()
    rows_t = tgt[idx].long()
    rows_w = w[idx].to(torch.float32)
    slots = (t_slot + dslot[idx].long()) % d_ring
    ring.view(-1).index_add_(0, (slots * n_local + rows_t).ravel(),
                             rows_w.ravel())
    return ring


def deliver_rows_ref(tables: dict, idx, ring, t_slot: int, events):
    """Plain version of the delivery kernel: ``synaptic_accum_ref`` over
    the tier's tables, plus the tier's synaptic events (``nnz`` of the
    delivered rows) added into the int32 counter ``events``."""
    synaptic_accum_ref(idx, t_slot, tables["tgt"], tables["w"],
                       tables["dslot"], ring)
    events += tables["nnz"][idx.long()].sum().to(torch.int32)
    return ring


def run_fields(runs: torch.Tensor):
    """(start, length) of a run descriptor's int64 words ``start << 32 |
    len`` (``synaptic_accum.build_column_runs``)."""
    return runs >> 32, runs & 0xFFFFFFFF


def deliver_runs_ref(runs: dict, flag, ring, t_slot: int, events):
    """Plain version of the column-delivery kernel: delivery through the
    tier's run descriptor (``synaptic_accum.build_column_runs``).  For
    every pair (source group S -> target column, delay) and every
    flagged row of S, the row's run ``[start, start + len)`` of the
    descriptor's entry arrays is added into the ring at the pair's delay
    slot; the flagged rows' run lengths (their ``nnz``: the runs cover
    every valid entry once) go into ``events``.  ``flag``:
    bool/uint8 (rows + 1,).  The adds come in another order than the
    reference's, which is exact for bfloat16 weights only."""
    d_ring, n_local = ring.shape
    dev = ring.device
    g = runs["row_group"]
    n_rows = runs["tgt"].shape[0] - 1
    rows = (runs["pair_src"].long()[:, None] * g
            + torch.arange(g, device=dev)[None, :])
    start, length = run_fields(runs["runs"])
    flag = flag.bool()
    on = (rows < n_rows) & flag[rows.clamp(max=n_rows)] & (length > 0)
    p_i, g_i = on.nonzero(as_tuple=True)
    lens = length[p_i, g_i]
    rep = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                  lens)
    first = torch.cumsum(lens, 0) - lens
    k = start[p_i, g_i][rep] + torch.arange(rep.numel(), device=dev) \
        - first[rep]
    r = rows[p_i, g_i][rep]
    slot = (t_slot + runs["pair_dslot"].long()[p_i][rep]) % d_ring
    ring.view(-1).index_add_(0, slot * n_local + runs["tgt"][r, k].long(),
                             runs["w"][r, k].to(torch.float32))
    events += lens.sum().to(torch.int32)
    return ring


# ---------------------------------------------------------------------------
# Delivery + LTD in one pass (kernels/plastic_step.py)
# ---------------------------------------------------------------------------

def plastic_delivery_ltd_ref(tables: dict, spikes_src, active_cap: int,
                             ring, t_slot: int, mask=None, x_post=None,
                             neg_a_minus: float = 0.0):
    """Plain version of the fixed-order delivery + LTD kernel, one tier.

    Compaction, then the delivery of the compacted rows' old weights by a
    sequential ``index_add_`` in (row, k) order (``synaptic_accum_ref``;
    sequential on the CPU only), then, where ``mask`` is given, LTD on
    every plastic synapse of the delivered rows:
    ``w' = w + (f32(neg_a_minus) * x_post[tgt]) * mask``, each operation
    rounded to float32 on its own.  ``ring`` and ``tables["w"]`` are
    updated in place.  Returns (n_events int32, n_spikes int64)."""
    n_rows = tables["tgt"].shape[0] - 1
    idx, n_spk = compact_events(spikes_src, n_rows, active_cap)
    synaptic_accum_ref(idx, t_slot, tables["tgt"], tables["w"],
                       tables["dslot"], ring)
    rows = idx.long()
    if mask is not None:
        w = tables["w"]
        m = mask[rows]
        neg_a = torch.tensor(neg_a_minus, dtype=torch.float32,
                             device=w.device)
        dw = (neg_a * x_post[tables["tgt"][rows].long()]) * m
        w_rows = w[rows]
        w.index_copy_(0, rows, torch.where(m > 0, w_rows + dw, w_rows))
    n_events = tables["nnz"][rows].sum(dtype=torch.int32)
    return n_events, n_spk


# ---------------------------------------------------------------------------
# Blocked online-softmax attention (kernels/flash_attention.py)
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                  q_offset: int = 0, return_lse: bool = False):
    """Masked multi-head attention, the plain version of the flash kernel.

    q: (BH, Sq, D); k, v: (BH_kv, Sk, D) with BH % BH_kv == 0 (GQA:
    query head ``bh`` reads kv head ``bh // (BH // BH_kv)``).  KV is
    repeated, the scores are a float32 einsum, masked with ``-inf``
    (``window``: keys with ``q_pos - k_pos >= window`` are masked;
    ``q_offset``: the absolute position of ``q[:, 0]``), softmaxed, and
    fully masked rows give 0.  Returns (BH, Sq, D) in q's dtype; with
    ``return_lse`` also each row's statistic ``L = logsumexp`` of its
    scaled, masked scores, ``(BH, Sq)`` float32, ``+1e30`` on a fully
    masked row (as the reference's ``_flash_fwd_impl`` writes it).
    """
    bh, sq, d = q.shape
    bh_kv, sk = k.shape[0], k.shape[1]
    group = bh // bh_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k, group, dim=0)
    vv = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    out = torch.einsum("bqk,bkd->bqd", p, vv.to(torch.float32)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, torch.where(mask.any(-1)[None], lse,
                            torch.full_like(lse, 1e30))


# ---------------------------------------------------------------------------
# The TF32 flash route's pre-pass (kernels/flash_attention.py)
# ---------------------------------------------------------------------------

# keys are padded with zeros to a multiple of this in the split scratch
TF32_KEY_PAD = 64
# slot j of each group of 8 keys of the split V^T holds key
# TF32_KEY_ORDER[j] (the order of the TF32 kernel's P fragment)
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, on the bit pattern: add ``0x1000`` and clear
    the low 13 bits (``cvt.rna.tf32.f32`` for finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` with ``hi = tf32(x)``, ``lo = tf32(x - hi)``: x = hi +
    lo to about 2^-22 of x, each part exact in TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_split_ref(k: torch.Tensor, v: torch.Tensor):
    """Plain version of the TF32 route's pre-pass: float32 k, v ``(BH_kv,
    Sk, D)`` -> ``(k_split, vt_split)``: ``k_split`` ``(2, BH_kv, Sk_pad,
    D)`` holds ``tf32_split(k)`` (hi, lo), ``vt_split`` ``(2, BH_kv, D,
    Sk_pad)`` the split of V transposed, slot j of each group of 8 keys
    holding key ``TF32_KEY_ORDER[j]``; keys past Sk are 0 and Sk_pad is
    Sk rounded up to a positive multiple of ``TF32_KEY_PAD``."""
    bh_kv, sk, d = k.shape
    sk_pad = max(-(-sk // TF32_KEY_PAD), 1) * TF32_KEY_PAD

    def pad(x):
        return torch.nn.functional.pad(x.to(torch.float32),
                                       (0, 0, 0, sk_pad - sk))

    order = torch.tensor(TF32_KEY_ORDER, device=k.device)
    keys = (torch.arange(sk_pad, device=k.device) // 8 * 8).view(-1, 8)
    vt = pad(v)[:, (keys + order).view(-1)].transpose(1, 2)
    return (torch.stack(tf32_split(pad(k))),
            torch.stack(tf32_split(vt.contiguous())))

