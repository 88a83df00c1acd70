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

No shape depends on the data.  On ranks (``rules`` with a mesh)
``apply_moe`` takes the expert-parallel dispatch (``_apply_moe_ep``, the
reference's ``shard_map`` body): tokens never move; every rank routes
its own tokens over all experts, serves its own ``E / model`` experts
with a local fixed-capacity scatter (``cap_loc`` from its token count)
and the k expert outputs of a token are summed over the experts axes.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import (all_reduce_plain, gather_dim,
                                    index_along, psum, psum_over)
from ..parallel.sharding import on_ranks
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


def _topk_capacity_slots(probs, k: int, e: int, cap: int, e0=None,
                         e_span: int = 0):
    """Routing: the top-k experts of each token, their renormalised
    weights (``_route``), and each assignment's capacity-ranked slot.
    Returns ``(top_w (T, k), flat_e (T*k,), slot (T*k,) int32, kept
    (T*k,) bool)``: ``slot = expert * cap + rank`` for the first ``cap``
    assignments of each expert in (token, k) order, ``e * cap`` (the
    dump slot) for the rest.  With ``(e0, e_span)`` only experts in
    ``[e0, e0 + e_span)`` get live slots (``(expert - e0) * cap +
    rank``), every other assignment the dump slot ``e_span * cap``;
    ``kept`` is still kept on any rank."""
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
    if e0 is None:
        e0, e_span = 0, e
    local = (flat_e >= e0) & (flat_e < e0 + e_span) & kept
    slot = torch.where(local, (flat_e - e0) * cap + rank,
                       torch.full_like(rank, e_span * cap))
    return top_w, flat_e, slot.to(torch.int32), kept


def _expert_ffn(ebuf, p, act: str):
    """(E, cap, d) -> (E, cap, d): each expert's gated FFN."""
    a = torch.bmm(ebuf, p["gate"])
    a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
    h = a * torch.bmm(ebuf, p["up"])
    return torch.bmm(h, p["down"])


def apply_moe(p, cfg: ModelConfig, x,
              rules=None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux): ``aux`` holds the switch-style
    ``load_balance`` loss, the router's ``router_z`` loss and
    ``frac_dropped`` (the share of assignments past capacity), float32
    scalars.  On ranks: ``_apply_moe_ep``."""
    if on_ranks(rules):
        return _apply_moe_ep(p, cfg, x, rules)
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


def _apply_moe_ep(p, cfg: ModelConfig, x, rules) -> Tuple[torch.Tensor,
                                                          dict]:
    """Expert parallelism on ranks: ``x`` (B_loc, S, d) is this rank's
    tokens (whole on its experts axes), ``gate``/``up`` its experts'
    ``("experts", "fsdp", None)`` blocks, ``down`` ``("experts", None,
    "fsdp")``, ``router`` ``("fsdp", "experts")``.  The FSDP dims and the
    router are gathered (the reference replicates the router inside its
    ``shard_map``); ``cap_loc`` comes from the local token count.

    Aux values: ``router_z`` and ``frac_dropped`` are each shard's,
    averaged over all shards (every mesh axis), as the reference's.
    ``load_balance`` is ``E * sum(me * ce)`` over the *global* means
    (``me``, ``ce`` averaged over all shards first), which is the
    meshless layer's value; the reference averages each shard's product
    instead, which differs from it by the spread of the shards' routing.
    So a step on ranks is the single-process step, and the pod step's
    first loss the exact step's."""
    if rules.axis("experts") is None:
        raise NotImplementedError(
            "MoE on ranks needs the experts split (rules.experts): the "
            "reference's meshless dispatch over the global batch has no "
            "rank form")
    mesh = rules.mesh
    b, s, d = x.shape
    k, e = cfg.moe_top_k, cfg.n_experts
    tl = b * s
    cap_loc = max(32, -(-math.ceil(tl * k * cfg.capacity_factor / e)
                        // 32) * 32)
    gate = gather_dim(p["gate"], rules, "fsdp", 1)
    up = gather_dim(p["up"], rules, "fsdp", 1)
    down = gather_dim(p["down"], rules, "fsdp", 2)
    router = gather_dim(gather_dim(p["router"], rules, "fsdp", 0), rules,
                        "experts", 1, channel="ep")
    e_loc = gate.shape[0]
    e0 = index_along(rules, "experts")[0] * e_loc
    xt = x.reshape(tl, d)

    logits = xt.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, flat_e, slot, kept = _topk_capacity_slots(
        probs, k, e, cap_loc, e0=e0, e_span=e_loc)
    slot = slot.long()

    tok = torch.arange(tl, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e_loc * cap_loc + 1, d), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_copy(0, slot, xt[tok])
    out = _expert_ffn(buf[:-1].view(e_loc, cap_loc, d),
                      {"gate": gate, "up": up, "down": down}, cfg.mlp_act)
    out_flat = torch.cat([out.reshape(e_loc * cap_loc, d),
                          torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    gathered = out_flat[slot]                      # dump slot -> zeros
    live = (slot < e_loc * cap_loc).to(torch.float32)
    w = (top_w.reshape(-1) * live)[:, None].to(x.dtype)
    y = (gathered * w).reshape(tl, k, d).sum(dim=1)
    y = psum_over(y, rules, "experts", "ep")   # k experts on k ranks

    # every shard's means, averaged over all of them (the reference's
    # aux mean runs over every mesh axis, the pod step's "pod" too)
    axes, n = mesh.axis_names, mesh.size
    me = psum(probs.mean(dim=0), mesh, axes, "aux") / n
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.full((tl * k,), 1.0 / (tl * k), dtype=torch.float32,
                              device=x.device))
    ce = all_reduce_plain(ce, mesh, axes, channel="aux") / n
    lb = e * torch.sum(me * ce)
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - kept.to(torch.float32).sum() / (tl * k)
    aux = psum(torch.stack([lb, zl, dropped]), mesh, axes, "aux") / n
    return y.reshape(b, s, d), {"load_balance": aux[0],
                                "router_z": aux[1],
                                "frac_dropped": aux[2]}
