"""Spike-timing-dependent plasticity (the "P" in DPSNN).

The port of ``repro.core.stdp``.  Pair-based STDP with exponential
traces, applied event-driven on the source-major synapse tables:

  * every step:  x_pre <- x_pre * exp(-dt/tau+) + pre_spike
                 x_post <- x_post * exp(-dt/tau-) + post_spike
  * LTD, at pre-spike time: every synapse of each delivered source row
    depresses by ``a_minus * x_post[target]``;
  * LTP, at post-spike time: every *incoming* synapse of each spiking
    target potentiates by ``a_plus * x_pre[source row]``, reached through
    the target-major *inverse index* (flat "virtual slot" pointers into
    the tiered tables).

Only excitatory synapses are plastic (mask fixed at build time).  Weights
clamp to [0, w_max].  Weights are float32 (``EngineConfig.spec`` forces
it), so the order of every float sum is part of the result: each
multiply and add here is a separate float32 operation, as XLA computes
them in the reference (no fused multiply-add; the one exception is the
post trace of a sharded run, ``post_trace``), and every scatter-add is
``index_add_``, which is sequential on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels.ref import _fma, compact_events


@dataclasses.dataclass(frozen=True)
class STDPParams:
    tau_plus_ms: float = 20.0
    tau_minus_ms: float = 20.0
    a_plus: float = 0.005        # LTP amplitude (mV of efficacy per pair)
    a_minus: float = 0.00525     # LTD amplitude (slightly dominant)
    w_max: float = 1.0
    dt_ms: float = 1.0

    @property
    def decay_plus(self) -> float:
        return float(math.exp(-self.dt_ms / self.tau_plus_ms))

    @property
    def decay_minus(self) -> float:
        return float(math.exp(-self.dt_ms / self.tau_minus_ms))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """The Python float ``x`` as a float32 scalar on ``like``'s device:
    the reference's weak-typed constants round to float32 first."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def post_trace(x_post: torch.Tensor, spikes: torch.Tensor,
               params: STDPParams, fused: bool) -> torch.Tensor:
    """The post trace carried to the next step, ``x_post * decay_minus +
    spikes``, rounded as the reference rounds it: its single-shard scan
    rounds the decay and the increment apart (``fused=False``); in its
    sharded scan (``shard_map``) XLA:CPU fuses the two into one
    multiply-add, rounded once (``fused=True``; the decay rounded to
    float32 first, as the reference's constants are).  The pre trace is
    rounded twice in both, and LTD and LTP read the decayed post trace
    rounded on its own in both."""
    if fused:
        return _fma(x_post, float(np.float32(params.decay_minus)), spikes)
    return x_post * params.decay_minus + spikes


def _tier_sizes(tiers: Sequence[dict]) -> Tuple[np.ndarray, np.ndarray]:
    sizes = np.array([int(np.prod(tuple(t["tgt"].shape))) for t in tiers],
                     dtype=np.int64)
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return bases, sizes


def build_inverse_index(tiers: Sequence[dict], n_targets: int,
                        cap_pad: float = 1.3, device="cuda") -> dict:
    """Target-major index over all tiers (host-side numpy, the
    reference's layout), placed on ``device``.

    Returns a dict with ``slots`` ((n_targets, K_in) int32 virtual flat
    slots, padded with ``total``), ``n_in`` ((n_targets,) int32 in-degree
    clipped to K_in), ``bases``/``sizes`` (per-tier virtual offsets and
    sizes, numpy int64), ``total`` and ``clipped`` (ints).  Per-target
    slot order is (tier, row, k) ascending: the order in which the
    sequential delivery adds each target's weights."""
    dev = resolve_device(device)
    bases, sizes = _tier_sizes(tiers)
    total = int(bases[-1] + sizes[-1]) if len(sizes) else 0
    tgt_parts: List[np.ndarray] = []
    slot_parts: List[np.ndarray] = []
    for t, base in zip(tiers, bases):
        tgt = np.asarray(t["tgt"].cpu() if isinstance(t["tgt"], torch.Tensor)
                         else t["tgt"])
        nnz = np.asarray(t["nnz"].cpu() if isinstance(t["nnz"], torch.Tensor)
                         else t["nnz"])
        cap = tgt.shape[1]
        valid = np.arange(cap)[None, :] < nnz[:, None]
        rr, kk = np.nonzero(valid)
        tgt_parts.append(tgt[rr, kk].astype(np.int64))
        slot_parts.append(base + rr * cap + kk)
    tgts = (np.concatenate(tgt_parts) if tgt_parts
            else np.empty(0, np.int64))
    vslots = (np.concatenate(slot_parts) if slot_parts
              else np.empty(0, np.int64))
    counts = np.bincount(tgts, minlength=max(n_targets, 1))[:n_targets]
    mean_in = max(1.0, len(tgts) / max(n_targets, 1))
    maxdeg = int(counts.max()) if n_targets else 1
    k_in = int(math.ceil(cap_pad * max(mean_in, maxdeg)))
    slots = np.full((n_targets, k_in), total, dtype=np.int32)
    n_in = np.minimum(counts, k_in).astype(np.int32)
    if len(tgts):
        order = np.argsort(tgts, kind="stable")
        ts, vs = tgts[order], vslots[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(len(ts)) - np.repeat(starts, counts)
        keep = within < k_in
        slots[ts[keep], within[keep]] = vs[keep]
    clipped = int(len(tgts) - n_in.sum())
    return {"slots": torch.from_numpy(slots).to(dev),
            "n_in": torch.from_numpy(n_in).to(dev),
            "bases": bases, "sizes": sizes, "total": total,
            "clipped": clipped}


def target_major_meta(tiers: Sequence[dict], inv: dict,
                      masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The delay slot and plastic bit of every slot of the inverse index,
    target-major like ``inv["slots"]``: int8 ``(n_targets, K_in)``
    holding ``dslot`` in bits 0-6 and ``mask > 0`` in bit 7 (padding
    slots 0).  Built with torch ops on the index's device.  The masks
    must be exactly 0 or 1 (``plastic_masks``), so the fixed-order
    kernel's LTD, ``w + dw_unit`` where the bit is set, is the
    reference's ``w + dw_unit * mask`` bit for bit."""
    slots = inv["slots"]
    dev = slots.device
    dslot = torch.cat([t["dslot"].reshape(-1).to(dev) for t in tiers]
                      + [torch.zeros(1, dtype=torch.int8, device=dev)])
    mask = torch.cat([m.reshape(-1).to(dev) for m in masks]
                     + [torch.zeros(1, dtype=torch.float32, device=dev)])
    if dslot.numel() != inv["total"] + 1 or mask.numel() != dslot.numel():
        raise ValueError("the tiers or masks do not match the inverse "
                         "index")
    if bool(((dslot < 0) | (dslot > 127)).any()):
        raise ValueError("delay slots must lie in 0..127 to share a byte "
                         "with the plastic bit")
    if bool(((mask != 0) & (mask != 1)).any()):
        raise ValueError("plastic masks must be exactly 0 or 1")
    idx = slots.long()
    plastic = (mask[idx] > 0).to(torch.int16) << 7
    return (dslot[idx].to(torch.int16) | plastic).to(torch.uint8).view(
        torch.int8)


def init_stdp_state(tiers: Sequence[dict], n_local: int,
                    device="cuda") -> dict:
    dev = resolve_device(device)
    return {
        "x_pre": [torch.zeros((t["tgt"].shape[0],), dtype=torch.float32,
                              device=dev) for t in tiers],
        "x_post": torch.zeros((n_local,), dtype=torch.float32,
                              device=dev),
    }


def plastic_masks(tiers: Sequence[dict]) -> list:
    """Excitatory (w > 0 at build time) synapses are plastic; the mask is
    float32, the dtype every STDP product reads it at."""
    return [(t["w"] > 0).to(torch.float32) for t in tiers]


def check_weight_invariant(tiers: Sequence[dict], params: STDPParams):
    """Refuse build weights above ``w_max`` at plasticity init: the
    kernel path applies LTD without the full-tier ``clamp(max=w_max)``
    of the two-pass reference, which is a no-op only while every weight
    stays <= w_max."""
    hi = max(float(t["w"].to(torch.float32).max()) for t in tiers)
    if hi > params.w_max:
        raise ValueError(
            f"build weight {hi} exceeds STDP w_max={params.w_max}; the "
            "plastic step requires w <= w_max at init (raise w_max or "
            "lower j_exc_mv)")


def stdp_step(tiers: Sequence[dict], masks: Sequence[torch.Tensor],
              inv: dict, state: dict, spike_tiers: Sequence[torch.Tensor],
              spikes_local: torch.Tensor, params: STDPParams,
              pre_caps: Sequence[int], post_cap: int,
              fused_post: bool = False):
    """One STDP update, the plain two-pass form: the LTD phase here, then
    ``stdp_ltp_finalize``.  ``fused_post``: the post trace's rounding
    (``post_trace``).  Returns (new_tiers, new_state); the input tiers
    are not modified."""
    p = params
    new_tiers = [dict(t) for t in tiers]
    x_pre = [xp * p.decay_plus for xp in state["x_pre"]]
    x_post = state["x_post"] * p.decay_minus

    for i, (t, mask, spk, cap) in enumerate(
            zip(tiers, masks, spike_tiers, pre_caps)):
        n_rows = t["tgt"].shape[0] - 1
        rows, _ = compact_events(spk, n_rows, cap)
        rows = rows.long()
        dw = (_f32(-p.a_minus, x_post) * x_post[t["tgt"][rows].long()]) \
            * mask[rows]
        w_old = t["w"]
        w = w_old.index_add(0, rows, dw)
        new_tiers[i]["w"] = torch.clamp(torch.where(mask > 0, w, w_old),
                                        max=p.w_max)

    return stdp_ltp_finalize(new_tiers, masks, inv, x_pre, state["x_post"],
                             spike_tiers, spikes_local, params, post_cap,
                             fused_post)


def stdp_ltp_finalize(tiers: Sequence[dict], masks: Sequence[torch.Tensor],
                      inv: dict, x_pre: Sequence[torch.Tensor],
                      x_post: torch.Tensor,
                      spike_tiers: Sequence[torch.Tensor],
                      spikes_local: torch.Tensor, params: STDPParams,
                      post_cap: int, fused_post: bool = False):
    """LTP + final clamp + trace increments on post-LTD tiers.

    ``x_pre`` are the *decayed* pre traces, ``x_post`` the post trace
    the step started with (LTD read its decayed value), advanced here by
    ``post_trace(..., fused_post)``.  Shared by the
    two-pass path and the kernel path (which applies LTD inside the
    delivery launch).  Plain PyTorch on every device: its scatter indices
    are unique apart from lanes that add +0.0, so the order of the adds
    does not show even where ``index_add_`` uses atomics.  The tiers'
    weights and the decayed ``x_pre`` are updated in place (every caller
    hands over tensors of its own).  Returns (new_tiers, new_state)."""
    p = params
    new_tiers = [dict(t) for t in tiers]
    n_local = spikes_local.shape[0]
    tgts, _ = compact_events(spikes_local, n_local, post_cap)
    tgts = tgts.long()
    # only lanes that add a nonzero change need walking: on the CPU the
    # walk keeps just those (the live rows, and below each tier's own
    # lanes); on the card it stays padded, as selecting them would sync
    # the host.  The weights come out the same either way.
    compact = tgts.device.type == "cpu"
    if compact:
        tgts = tgts[tgts < n_local]
    safe = torch.clamp(tgts, max=n_local - 1)
    live = (tgts < n_local)[:, None]
    vslots = torch.where(live, inv["slots"][safe].long(),
                         torch.full_like(live, inv["total"],
                                         dtype=torch.int64))
    for i, (t, mask) in enumerate(zip(tiers, masks)):
        base, size = int(inv["bases"][i]), int(inv["sizes"][i])
        cap = t["tgt"].shape[1]
        sel = (vslots >= base) & (vslots < base + size)
        if compact:
            local_v = vslots[sel] - base
            rows, ks = local_v // cap, local_v % cap
            dw = (_f32(p.a_plus, x_post) * x_pre[i][rows]) * mask[rows, ks]
        else:
            # lanes outside the tier add +0.0.  The reference sends them
            # all to w[0, 0]; here each goes to a weight of its own, since
            # adding +0.0 changes no weight (none is ever -0.0) and one
            # shared address would serialize the atomics of a CUDA
            # ``index_add_``
            spread = torch.arange(vslots.numel(), device=vslots.device)
            spread = (spread % t["w"].numel()).view_as(vslots)
            local_v = torch.where(sel, vslots - base, spread)
            rows, ks = local_v // cap, local_v % cap
            dw = torch.where(
                sel,
                (_f32(p.a_plus, x_post) * x_pre[i][rows]) * mask[rows, ks],
                torch.zeros((), dtype=torch.float32, device=x_post.device))
        w = new_tiers[i]["w"]
        w.view(-1).index_add_(0, local_v.reshape(-1), dw.reshape(-1))
        w.clamp_(max=p.w_max)

    # final clamp to [0, w_max] on plastic synapses
    for i, mask in enumerate(masks):
        w = new_tiers[i]["w"]
        torch.where(mask > 0, torch.clamp(w, 0.0, p.w_max), w, out=w)

    for xp, spk in zip(x_pre, spike_tiers):
        xp[:spk.shape[0]] += spk
    new_state = {"x_pre": list(x_pre),
                 "x_post": post_trace(x_post, spikes_local, p, fused_post)}
    return new_tiers, new_state
