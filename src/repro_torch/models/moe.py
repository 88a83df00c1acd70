"""Mixture-of-Experts layer with sort-based, fixed-capacity dispatch: the
port of ``repro.models.moe`` (its meshless dispatch, ``_apply_moe_dense``).

The token -> expert assignments are the "events" of the engine's
delivery idiom:

  1. router top-k per token (float32 router), weights renormalised;
  2. the (T*k) assignments flattened and stably sorted by expert id;
     rank in expert = position - segment start (``searchsorted``);
     assignments beyond ``capacity`` go to the dump slot ``E * cap``;
  3. tokens scattered into an (E * cap + 1, d) buffer;
  4. the per-expert gated FFN as batched products (``torch.bmm``, plain
     products as XLA's in the reference);
  5. gathered back, weighted and summed over the k copies.

No shape depends on the data.  The reference's expert-parallel
dispatch (``_apply_moe_ep``, ``shard_map`` over a mesh) has no
counterpart on one card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _normal


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                    / cfg.n_experts)
    return max(256, -(-cap // 256) * 256)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _normal(gen, (d, e), 1 / math.sqrt(d), torch.float32),
        "gate": _normal(gen, (e, d, f), 1 / math.sqrt(d), dtype),
        "up": _normal(gen, (e, d, f), 1 / math.sqrt(d), dtype),
        "down": _normal(gen, (e, f, d), 1 / math.sqrt(f), dtype),
    }


def _route(probs, k: int):
    """The top-k experts of each token and their renormalised weights:
    ``(top_w, top_e)``, (T, k) each."""
    top_w, top_e = torch.topk(probs, k, dim=-1)
    return top_w / top_w.sum(dim=-1, keepdim=True), top_e


def _topk_capacity_slots(probs, k: int, e: int, cap: int):
    """Routing: the top-k experts of each token, their renormalised
    weights (``_route``), and each assignment's capacity-ranked slot.
    Returns ``(top_w (T, k), flat_e (T*k,), slot (T*k,) int32, kept
    (T*k,) bool)``: ``slot = expert * cap + rank`` for the first ``cap``
    assignments of each expert in (token, k) order, ``e * cap`` (the
    dump slot) for the rest."""
    t = probs.shape[0]
    top_w, top_e = _route(probs, k)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(t * k, device=probs.device) - seg_start
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    kept = rank < cap
    slot = torch.where(kept, flat_e * cap + rank,
                       torch.full_like(rank, e * cap))
    return top_w, flat_e, slot.to(torch.int32), kept


def _expert_ffn(ebuf, p, act: str):
    """(E, cap, d) -> (E, cap, d): each expert's gated FFN."""
    a = torch.bmm(ebuf, p["gate"])
    a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
    h = a * torch.bmm(ebuf, p["up"])
    return torch.bmm(h, p["down"])


def apply_moe(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux): ``aux`` holds the switch-style
    ``load_balance`` loss, the router's ``router_z`` loss and
    ``frac_dropped`` (the share of assignments past capacity), float32
    scalars."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.moe_top_k, cfg.n_experts
    cap = moe_capacity(cfg, t)
    xt = x.reshape(t, d)

    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, flat_e, slot, kept = _topk_capacity_slots(probs, k, e, cap)
    slot = slot.long()

    # dispatch: every assignment's token into its slot (the dump slot's
    # row is dropped)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, slot, xt[tok])
    out = _expert_ffn(buf[:-1].view(e, cap, d), p, cfg.mlp_act)

    # combine
    out_flat = torch.cat([out.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    gathered = out_flat[slot]                               # (T*k, d)
    kept_f = kept.to(torch.float32)
    w = (top_w.reshape(-1) * kept_f)[:, None].to(x.dtype)
    y = (gathered * w).reshape(t, k, d).sum(dim=1)

    # aux losses
    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                              device=x.device))
    aux = {"load_balance": e * torch.sum(me * ce),
           "router_z": torch.mean(torch.square(torch.logsumexp(logits,
                                                               dim=-1))),
           "frac_dropped": 1.0 - kept_f.sum() / (t * k)}
    return y.reshape(b, s, d), aux
