"""GQA self-attention of the LM stack (the port of
``repro.models.attention``): prefill through the flash kernel, the plain
version or the chunked online softmax, and decode over a KV cache
(ring-buffered for sliding windows).

Layouts are the reference's: activations (B, S, H, D), caches
(B, S_cache, Kv, D), projections ``wq`` (d, H, D), ``wk``/``wv``
(d, Kv, D), ``wo`` (H, D, d).  GQA never repeats KV: the query heads of
one kv head are grouped as (B, Kv, group, S, D), and the flash kernel
picks the kv head of query head ``bh`` as ``bh // group``.  (The
reference repeats KV to the query-head count before the kernel, for
tensor-parallel sharding; each query head sees the same values either
way.)

One card has no mesh, so the reference's ``rules``/``constrain``
sharding has no counterpart here.  Caches are updated in place, which
saves a copy of every layer's cache per step; the functions still return
the cache, as the reference does.  Cross-attention (whisper) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import resolve_device
from ..kernels import ops, ref
from .config import ModelConfig
from .layers import _normal, apply_rmsnorm, apply_rope

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    sc = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, h, hd), sc, dtype),
        "wk": _normal(gen, (d, kv, hd), sc, dtype),
        "wv": _normal(gen, (d, kv, hd), sc, dtype),
        "wo": _normal(gen, (h, hd, d), 1.0 / math.sqrt(h * hd), dtype),
    }

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=gen.device)

    if cfg.qkv_bias:
        p.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd))
    if cfg.qk_norm:
        p.update(q_norm=zeros(hd), k_norm=zeros(hd))
    return p


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (B, S_cache, Kv, D)
    v: torch.Tensor
    ring: bool = False       # sliding-window ring buffer


def _heads(x, w):
    """(B, S, d) @ (d, N, D) -> (B, S, N, D)."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(b, s, *w.shape[1:])


def _project_qkv(p, cfg: ModelConfig, x, kv_x, positions, kv_positions):
    q = _heads(x, p["wq"])
    k = _heads(kv_x, p["wk"])
    v = _heads(kv_x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = apply_rmsnorm({"scale": p["q_norm"]}, q)
        k = apply_rmsnorm({"scale": p["k_norm"]}, k)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _grouped(q, n_kv: int):
    """(B, S, H, D) -> (B, Kv, group, S, D)."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh).permute(0, 2, 3, 1, 4)


def _chunk_mask(q_pos, k_pos, k_valid, causal, window):
    mask = (k_pos < k_valid)[None, :].expand(q_pos.shape[0],
                                             k_pos.shape[0])
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def chunked_attention(q, k, v, *, causal, window, scale, q_offset=0,
                      chunk_q=1024, chunk_k=1024, k_valid=None):
    """Online-softmax attention over (chunk_q, chunk_k) score blocks, the
    forward of the reference's chunked path in plain PyTorch (its
    flash-style backward comes with training).

    q: (B, Sq, H, D); k, v: (B, Sk, Kv, D).  Matches the flash kernel and
    ``kernels.ref.attention_ref``.
    """
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    chunk_q = min(chunk_q, sq)
    chunk_k = min(chunk_k, sk)
    pad_q, pad_k = -sq % chunk_q, -sk % chunk_k
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    k_valid = sk if k_valid is None else k_valid
    dev = q.device
    f32 = torch.float32

    qg = _grouped(q, kvh)                        # (B, Kv, g, Sq', D)
    kg = k.permute(0, 2, 1, 3).to(f32)           # (B, Kv, Sk', D)
    vg = v.permute(0, 2, 1, 3).to(f32)
    g = qg.shape[2]
    chunks = []
    for qi in range((sq + pad_q) // chunk_q):
        qc = qg[:, :, :, qi * chunk_q:(qi + 1) * chunk_q].to(f32)
        q_pos = q_offset + qi * chunk_q + torch.arange(chunk_q, device=dev)
        m = torch.full((b, kvh, g, chunk_q, 1), NEG_INF, dtype=f32,
                       device=dev)
        l = torch.zeros((b, kvh, g, chunk_q, 1), dtype=f32, device=dev)
        acc = torch.zeros((b, kvh, g, chunk_q, dh), dtype=f32, device=dev)
        for ki in range((sk + pad_k) // chunk_k):
            kc = kg[:, :, ki * chunk_k:(ki + 1) * chunk_k]
            vc = vg[:, :, ki * chunk_k:(ki + 1) * chunk_k]
            k_pos = ki * chunk_k + torch.arange(chunk_k, device=dev)
            s = torch.einsum("bkgqd,bksd->bkgqs", qc, kc) * scale
            mask = _chunk_mask(q_pos, k_pos, k_valid, causal, window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new) * mask
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqs,bksd->bkgqd", p, vc)
            m = m_new
        safe = torch.where(l > 0, l, torch.ones_like(l))
        chunks.append((acc / safe * (l > 0)).to(q.dtype))
    og = torch.cat(chunks, dim=3)                # (B, Kv, g, Sq', D)
    out = og.permute(0, 3, 1, 2, 4).reshape(b, sq + pad_q, h, dh)
    return out[:, :sq]


def _flat_heads(x):
    """(B, S, N, D) -> contiguous (B*N, S, D)."""
    b, s, n, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * n, s, dh).contiguous()


def _full_attention(q, k, v, cfg: ModelConfig, *, causal, window,
                    q_offset=0, k_valid=None):
    """Dispatch on ``cfg.attn_impl`` for the prefill path: ``"pallas"``
    is the flash kernel (``ops.attention``), ``"naive"`` its plain
    version, ``"chunked"`` the plain chunked online softmax.  KV stays
    un-repeated in every route."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if cfg.attn_impl in ("pallas", "naive"):
        fn = ops.attention if cfg.attn_impl == "pallas" \
            else ref.attention_ref
        b, sq, h, dh = q.shape
        of = fn(_flat_heads(q), _flat_heads(k), _flat_heads(v),
                causal=causal, window=window, scale=scale,
                q_offset=q_offset)
        return of.reshape(b, h, sq, dh).permute(0, 2, 1, 3)
    if cfg.attn_impl != "chunked":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return chunked_attention(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset,
                             chunk_q=cfg.attn_chunk_q,
                             chunk_k=cfg.attn_chunk_k, k_valid=k_valid)


def _decode_attention(q, cache: KVCache, cur_len: int, window):
    """One-token attention over the cache.  q: (B, 1, H, D)."""
    b, _, h, dh = q.shape
    kvh, s_cache = cache.k.shape[2], cache.k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qg = _grouped(q, kvh)                        # (B, Kv, g, 1, D)
    kc = cache.k.permute(0, 2, 1, 3)             # (B, Kv, S, D)
    vc = cache.v.permute(0, 2, 1, 3)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.to(torch.float32),
                     kc.to(torch.float32)) * scale
    pos = torch.arange(s_cache, device=q.device)
    if cache.ring:
        # the ring holds the last W keys: slots < min(len, W) are valid
        mask = pos < min(cur_len, s_cache)
    else:
        mask = pos < cur_len
        if window is not None:
            mask = mask & (pos >= cur_len - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, vc.to(torch.float32))
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh).to(q.dtype)


def apply_attention(p, cfg: ModelConfig, x, positions, *, causal=True,
                    window=None, kv_x=None, cache: Optional[KVCache] = None,
                    cache_pos: Optional[int] = None):
    """Self-attention.  Returns (out (B, S, d), cache).

    Modes:
      * cache None:        full attention over ``x`` (train / prefill);
      * cache, S > 1:      prefill: full attention over the prompt, then
                           its keys/values (the last window of them for a
                           ring cache) are written at ``cache_pos``;
      * cache, S == 1:     decode: the token's key/value is written at
                           ``cache_pos`` and it attends over the cache.
    The cache is written in place.
    """
    if kv_x is not None:
        raise NotImplementedError(
            "cross-attention (whisper) is not ported yet: ROADMAP.md, "
            "item 10 (LM side)")
    kv_positions = (torch.arange(x.shape[1], device=x.device)
                    if cache is None else positions)
    q, k, v = _project_qkv(p, cfg, x, x, positions, kv_positions)

    s_q = x.shape[1]
    if cache is None:
        out = _full_attention(q, k, v, cfg, causal=causal, window=window)
    elif s_q > 1:
        out = _full_attention(q, k, v, cfg, causal=causal, window=window)
        w_cache = cache.k.shape[1]
        if cache.ring:
            take = min(w_cache, s_q)
            idx = (cache_pos + s_q - take
                   + torch.arange(take, device=x.device)) % w_cache
            cache.k[:, idx] = k[:, -take:]
            cache.v[:, idx] = v[:, -take:]
        else:
            cache.k[:, cache_pos:cache_pos + s_q] = k
            cache.v[:, cache_pos:cache_pos + s_q] = v
    else:
        idx = cache_pos % cache.k.shape[1] if cache.ring else cache_pos
        cache.k[:, idx:idx + 1] = k
        cache.v[:, idx:idx + 1] = v
        out = _decode_attention(q, cache, cache_pos + s_q, window)

    b, s = out.shape[:2]
    wo = p["wo"]
    out = out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return out, cache


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
               window: Optional[int] = None, device="cuda") -> KVCache:
    """Zeroed cache for ``seq`` positions (``min(seq, window)`` slots as
    a ring when the window is shorter than ``seq``)."""
    dev = resolve_device(device)
    s = min(seq, window) if window else seq
    shape = (batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   ring=window is not None and window < seq)
