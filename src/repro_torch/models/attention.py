"""GQA self-attention of the LM stack (the port of
``repro.models.attention``): prefill through the flash kernel, the plain
version or the chunked online softmax, and decode over a KV cache
(ring-buffered for sliding windows).

Training goes through ``_Flash``, the counterpart of the reference's
flash ``custom_vjp``: its forward is the flash kernel (``"pallas"``) or
the plain chunked forward (``"chunked"``), both with the row statistic
``L = m + log l``, and its backward the plain chunked flash backward.

Layouts are the reference's: activations (B, S, H, D), caches
(B, S_cache, Kv, D), projections ``wq`` (d, H, D), ``wk``/``wv``
(d, Kv, D), ``wo`` (H, D, d).  GQA never repeats KV: the query heads of
one kv head are grouped as (B, Kv, group, S, D), and the flash kernel
picks the kv head of query head ``bh`` as ``bh // group``.  (The
reference repeats KV to the query-head count before the kernel, for
tensor-parallel sharding; each query head sees the same values either
way.)

On ranks (``rules`` with a mesh) the query heads are split over the
``heads`` axes: ``wq`` and ``wo`` are this rank's heads (``("fsdp",
"heads", None)`` / ``("heads", None, "fsdp")``), ``wk``/``wv`` stay
whole (``kv_heads`` is None, as the reference specs them) and each rank
attends with only the KV heads its query heads group onto; the FSDP
dims are gathered per call and the output is summed over the heads
axes.  A self-attention cache is split by sequence (``kv_seq``): each
rank holds the slots ``[r W/M, (r+1) W/M)`` of every KV head, so
prefill writes the keys whose slots it holds, decode writes the token's
key on the rank that holds its slot, and a decode step is the
reference's "flash-decoding pattern" (``_rank_decode``): every rank
takes the partial softmax of every query head over its own slots and
the partials are combined over the ``kv_seq`` axes.  A cross cache is
split by batch only: every ``model`` rank holds all of it.  Caches are
updated in place, which
saves a copy of every layer's cache per step; the functions still return
the cache, as the reference does.  Cross-attention (whisper's decoder)
takes its keys and values from the encoder's output (``kv_x``) or from a
static cross cache that the prefill wrote (``update_cache=False``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.profiler import record_function

from .. import resolve_device
from ..kernels import ops, ref
from ..parallel.collectives import (all_gather_plain, gather_dim,
                                    index_along, psum_over)
from ..parallel.sharding import live_axes, on_ranks
from .config import ModelConfig
from .layers import _normal, apply_rmsnorm, apply_rope

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   cross: bool = False) -> dict:
    """The projections; a cross-attention (``cross``) has no QKV bias,
    as the reference's has none."""
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

    if cfg.qkv_bias and not cross:
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


def _project_q(p, cfg: ModelConfig, x, positions):
    q = _heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = apply_rmsnorm({"scale": p["q_norm"]}, q)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(p, cfg: ModelConfig, kv_x, kv_positions):
    k = _heads(kv_x, p["wk"])
    v = _heads(kv_x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = apply_rmsnorm({"scale": p["k_norm"]}, k)
    if cfg.use_rope:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return k, v


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


def _live(q_first: int, q_last: int, k_first: int, k_last: int, k_valid,
          causal, window) -> bool:
    """Whether any (q, k) pair of a chunk pair can be unmasked (the flash
    kernel's liveness test).  A dead pair adds exactly nothing to any
    accumulator, so skipping it changes no value."""
    if k_first >= k_valid:
        return False
    if causal and k_first > q_last:
        return False
    return not (window is not None and q_first - k_last >= window)


def _pad_to(x, dim: int, multiple: int, value: float = 0.0):
    pad = -x.shape[dim] % multiple
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return torch.nn.functional.pad(x, widths, value=value)


def _flash_fwd_impl(qg, kg, vg, cfgt):
    """The chunked online-softmax forward.  qg: (B, Kv, G, Sq, D); kg,
    vg: (B, Kv, Sk, D), padded to whole chunks.  Returns (out in q's
    dtype, L) with ``L = m + log l`` the (B, Kv, G, Sq) row statistic
    (``+1e30`` on a row that saw no key), in float32 (float64 for
    float64 inputs)."""
    causal, window, scale, q_offset, cq, ck, k_valid = cfgt
    b, kvh, g, sq, dh = qg.shape
    sk = kg.shape[2]
    dev = qg.device
    acc_t = torch.promote_types(qg.dtype, torch.float32)
    kf, vf = kg.to(acc_t), vg.to(acc_t)
    chunks, lses = [], []
    for qi in range(sq // cq):
        qc = qg[:, :, :, qi * cq:(qi + 1) * cq].to(acc_t)
        q_first = q_offset + qi * cq
        q_pos = q_first + torch.arange(cq, device=dev)
        m = torch.full((b, kvh, g, cq, 1), NEG_INF, dtype=acc_t, device=dev)
        l = torch.zeros((b, kvh, g, cq, 1), dtype=acc_t, device=dev)
        acc = torch.zeros((b, kvh, g, cq, dh), dtype=acc_t, device=dev)
        for ki in range(sk // ck):
            if not _live(q_first, q_first + cq - 1, ki * ck,
                         (ki + 1) * ck - 1, k_valid, causal, window):
                continue
            kc = kf[:, :, ki * ck:(ki + 1) * ck]
            vc = vf[:, :, ki * ck:(ki + 1) * ck]
            k_pos = ki * ck + torch.arange(ck, device=dev)
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
        chunks.append((acc / safe * (l > 0)).to(qg.dtype))
        lses.append(torch.where(l[..., 0] > 0,
                                m[..., 0] + torch.log(safe[..., 0]),
                                torch.full_like(m[..., 0], -NEG_INF)))
    return torch.cat(chunks, dim=3), torch.cat(lses, dim=3)


def _flash_bwd(qg, kg, vg, out, lse, dout, cfgt):
    """The flash backward: recompute s and p chunk pair by chunk pair
    from the row statistic, never an (Sq, Sk) matrix; float32
    accumulators (float64 for float64 inputs).  Layouts as
    ``_flash_fwd_impl``, all padded to whole chunks.  GQA: dk and dv sum
    over the group inside each chunk pair's product (the reference
    repeats KV and sums the group in the repeat's transpose), an order
    of summation of its own.  Returns (dq, dk, dv) in their inputs'
    dtypes."""
    causal, window, scale, q_offset, cq, ck, k_valid = cfgt
    b, kvh, g, sq, dh = qg.shape
    sk = kg.shape[2]
    dev = qg.device
    acc_t = torch.promote_types(qg.dtype, torch.float32)
    kf, vf = kg.to(acc_t), vg.to(acc_t)
    delta = (dout.to(acc_t) * out.to(acc_t)).sum(dim=-1)   # (B,Kv,G,Sq)
    dq = torch.zeros((b, kvh, g, sq, dh), dtype=acc_t, device=dev)
    dk = torch.zeros((b, kvh, sk, dh), dtype=acc_t, device=dev)
    dv = torch.zeros_like(dk)
    for qi in range(sq // cq):
        rows = slice(qi * cq, (qi + 1) * cq)
        qc = qg[:, :, :, rows].to(acc_t)
        doc = dout[:, :, :, rows].to(acc_t)
        lc, dc = lse[:, :, :, rows], delta[:, :, :, rows]
        q_first = q_offset + qi * cq
        q_pos = q_first + torch.arange(cq, device=dev)
        dqc = dq[:, :, :, rows]
        for ki in range(sk // ck):
            if not _live(q_first, q_first + cq - 1, ki * ck,
                         (ki + 1) * ck - 1, k_valid, causal, window):
                continue
            keys = slice(ki * ck, (ki + 1) * ck)
            kc, vc = kf[:, :, keys], vf[:, :, keys]
            k_pos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bkgqd,bksd->bkgqs", qc, kc) * scale
            mask = _chunk_mask(q_pos, k_pos, k_valid, causal, window)
            p = torch.exp(torch.where(mask, s, torch.full_like(s, NEG_INF))
                          - lc[..., None]) * mask
            dv[:, :, keys] += torch.einsum("bkgqs,bkgqd->bksd", p, doc)
            dp = torch.einsum("bkgqd,bksd->bkgqs", doc, vc)
            ds = p * (dp - dc[..., None]) * scale
            dqc += torch.einsum("bkgqs,bksd->bkgqd", ds, kc)
            dk[:, :, keys] += torch.einsum("bkgqs,bkgqd->bksd", ds, qc)
    return dq.to(qg.dtype), dk.to(kg.dtype), dv.to(vg.dtype)


def _flat_heads(x):
    """(B, S, N, D) -> contiguous (B*N, S, D)."""
    b, s, n, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * n, s, dh).contiguous()


class _Flash(torch.autograd.Function):
    """Flash attention under autograd: the counterpart of the reference's
    ``jax.custom_vjp`` (``_flash_fwd`` / ``_flash_bwd``).

    ``apply(q, k, v, cfgt, kernel)`` with q (B, Sq, H, D), k, v (B, Sk,
    Kv, D) returns (B, Sq, H, D).  ``forward`` returns ``out`` and saves
    ``(q, k, v, out, L)``: with ``kernel`` the flash kernel writes both
    (``ops.attention(..., return_lse=True)``: on a CUDA tensor it
    launches the route's kernel or raises, on a CPU tensor it takes the
    plain version); otherwise the plain chunked forward
    (``_flash_fwd_impl``, the reference's own route) does.  ``backward``
    is ``_flash_bwd`` in plain PyTorch on every route, as the
    reference's is plain JAX.  KV is never repeated.  ``cfgt``:
    ``(causal, window, scale, q_offset, chunk_q, chunk_k, k_valid)``;
    the chunks pad the chunked forward and the backward only.  The two
    passes run in ``torch.profiler`` ranges (``flash_attention_forward``,
    ``flash_attention_backward``) that a profile attributes device time
    to; without a profiler a range costs a host call and nothing on the
    device."""

    @staticmethod
    @record_function("flash_attention_forward")
    def forward(ctx, q, k, v, cfgt, kernel: bool):
        causal, window, scale, q_offset, cq, ck, k_valid = cfgt
        b, sq, h, dh = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        if kernel:
            if k_valid != sk:
                raise ValueError("the flash kernel takes no k_valid")
            of, lf = ops.attention(_flat_heads(q), _flat_heads(k),
                                   _flat_heads(v), causal=causal,
                                   window=window, scale=scale,
                                   q_offset=q_offset, return_lse=True)
            og = of.view(b, kvh, h // kvh, sq, dh)
            lse = lf.view(b, kvh, h // kvh, sq)
        else:
            og, lse = _flash_fwd_impl(
                _pad_to(_grouped(q, kvh), 3, cq),
                _pad_to(k.permute(0, 2, 1, 3), 2, ck),
                _pad_to(v.permute(0, 2, 1, 3), 2, ck), cfgt)
            og, lse = og[:, :, :, :sq], lse[:, :, :, :sq]
        ctx.save_for_backward(q, k, v, og, lse)
        ctx.cfgt = cfgt
        return og.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)

    @staticmethod
    @record_function("flash_attention_backward")
    def backward(ctx, dout):
        q, k, v, og, lse = ctx.saved_tensors
        cfgt = ctx.cfgt
        cq, ck = cfgt[4], cfgt[5]
        b, sq, h, dh = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        # padded query rows have zero dout, so they add nothing; their
        # statistic pads with 0 (finite: exp(s - 0) of a zero q row is 1)
        dq, dk, dv = _flash_bwd(
            _pad_to(_grouped(q, kvh), 3, cq),
            _pad_to(k.permute(0, 2, 1, 3), 2, ck),
            _pad_to(v.permute(0, 2, 1, 3), 2, ck),
            _pad_to(og, 3, cq), _pad_to(lse, 3, cq),
            _pad_to(_grouped(dout, kvh), 3, cq), cfgt)
        dq = dq[:, :, :, :sq].permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
        dk = dk[:, :, :sk].permute(0, 2, 1, 3)
        dv = dv[:, :, :sk].permute(0, 2, 1, 3)
        return dq, dk, dv, None, None


def chunked_attention(q, k, v, *, causal, window, scale, q_offset=0,
                      chunk_q=1024, chunk_k=1024, k_valid=None,
                      kernel: bool = False):
    """Online-softmax attention, O(chunk^2) memory in both directions
    (``_Flash``: the backward recomputes each chunk pair).

    q: (B, Sq, H, D); k, v: (B, Sk, Kv, D).  Matches the flash kernel and
    ``kernels.ref.attention_ref``.  ``kernel``: the forward is the flash
    kernel (``k_valid`` must then be None), else the plain chunked
    forward.
    """
    sk = k.shape[1]
    cfgt = (causal, window, scale, q_offset, min(chunk_q, q.shape[1]),
            min(chunk_k, sk), sk if k_valid is None else k_valid)
    return _Flash.apply(q, k, v, cfgt, kernel)


def _full_attention(q, k, v, cfg: ModelConfig, *, causal, window,
                    q_offset=0, k_valid=None):
    """Dispatch on ``cfg.attn_impl`` for the prefill / train path:
    ``"pallas"`` is the flash kernel, ``"naive"`` its plain version
    under plain autograd, ``"chunked"`` the plain chunked online softmax
    with the flash backward (``_Flash``).  Where a gradient is wanted,
    ``"pallas"`` runs ``_Flash`` with the kernel's forward (which also
    writes the row statistic); without one it is the serving path's
    kernel call.  KV stays un-repeated in every route."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    impl = cfg.attn_impl
    if impl not in ("pallas", "naive", "chunked"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if impl == "naive" or (impl == "pallas" and not grad):
        fn = ops.attention if impl == "pallas" else ref.attention_ref
        b, sq, h, dh = q.shape
        of = fn(_flat_heads(q), _flat_heads(k), _flat_heads(v),
                causal=causal, window=window, scale=scale,
                q_offset=q_offset)
        return of.reshape(b, h, sq, dh).permute(0, 2, 1, 3)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset,
                             chunk_q=cfg.attn_chunk_q,
                             chunk_k=cfg.attn_chunk_k, k_valid=k_valid,
                             kernel=impl == "pallas")


def _cached_prefix(cache: KVCache, cache_pos: int, k, v):
    """The keys and values a prefill at ``cache_pos > 0`` attends over:
    the cached positions before ``cache_pos`` (a ring holds the last
    ``W`` of them), in position order, then the prompt's own.  Returns
    (k, v, q_offset): the prompt's first position relative to the first
    key, so causal and window masks see the true distances."""
    w_cache = cache.k.shape[1]
    if cache.ring:
        n_prev = min(cache_pos, w_cache)
        slots = (cache_pos - n_prev
                 + torch.arange(n_prev, device=k.device)) % w_cache
        k_prev, v_prev = cache.k[:, slots], cache.v[:, slots]
    else:
        n_prev = cache_pos
        k_prev, v_prev = cache.k[:, :cache_pos], cache.v[:, :cache_pos]
    return (torch.cat([k_prev, k], dim=1), torch.cat([v_prev, v], dim=1),
            n_prev)


def _decode_partial(q, cache: KVCache, cur_len: int, window, lo: int,
                    w: int):
    """One query token's softmax over the slots ``lo ..`` (on ranks,
    this rank's) of a cache of ``w`` slots, unnormalised, in float32
    (the reference's ``_decode_attention`` masks): ``(m, l, o)``,
    the row maxima (B, Kv, g, 1, 1), the sums of ``exp(s - m)`` and the
    weighted values (B, Kv, g, 1, D).  A row whose slots are all masked
    has ``m = NEG_INF`` and ``l = o = 0``."""
    dh = q.shape[-1]
    kvh, w_loc = cache.k.shape[2], cache.k.shape[1]
    qg = _grouped(q, kvh).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg,
                     cache.k.permute(0, 2, 1, 3).to(torch.float32)) \
        * (1.0 / math.sqrt(dh))
    pos = lo + torch.arange(w_loc, device=q.device)
    if cache.ring:
        mask = pos < min(cur_len, w)
    else:
        mask = pos < cur_len
        if window is not None:
            mask = mask & (pos >= cur_len - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    o = torch.einsum("bkgqs,bksd->bkgqd", p,
                     cache.v.permute(0, 2, 1, 3).to(torch.float32))
    return m, p.sum(dim=-1, keepdim=True), o


def _decode_attention(q, cache: KVCache, cur_len: int, window):
    """One-token attention over the cache.  q: (B, 1, H, D); the
    softmax in float32 (``_decode_partial`` over every slot)."""
    b, _, _, dh = q.shape
    _, l, o = _decode_partial(q, cache, cur_len, window, 0,
                              cache.k.shape[1])
    return (o / l).permute(0, 3, 1, 2, 4).reshape(b, 1, -1, dh).to(q.dtype)


def _cross_attention(p, cfg: ModelConfig, x, positions, kv_x,
                     cache: Optional[KVCache], sel=slice(None)):
    """Cross-attention's (B, S, H, D) output (the modes of
    ``apply_attention``).  Keys sit at positions ``arange(Sk)``; nothing
    is causal.  A cache written here holds every KV head; the attention
    reads the KV heads ``sel`` (on ranks, those of the local query
    heads)."""
    q = _project_q(p, cfg, x, positions)
    if kv_x is not None:
        sk = kv_x.shape[1]
        k, v = _project_kv(p, cfg, kv_x, torch.arange(sk, device=x.device))
        if cache is not None:
            if cache.ring or cache.k.shape[1] != sk:
                raise ValueError(
                    f"a cross cache holds all {sk} encoder positions "
                    f"(got {cache.k.shape[1]}, ring={cache.ring})")
            cache.k.copy_(k)
            cache.v.copy_(v)
    elif cache is None:
        raise ValueError("update_cache=False reads a static cross cache: "
                         "pass cache=")
    else:
        k, v = cache.k, cache.v
    k, v = k[:, :, sel], v[:, :, sel]
    if kv_x is None and x.shape[1] == 1:
        return _decode_attention(q, KVCache(k, v), k.shape[1], None)
    return _full_attention(q, k, v, cfg, causal=False, window=None)


def local_kv_heads(n_heads: int, n_kv: int, h0: int, h_loc: int):
    """The KV heads that query heads ``h0 .. h0 + h_loc`` group onto
    (query head ``i`` reads KV head ``i // (n_heads // n_kv)``): a
    slice of the KV heads when the local heads are whole groups or lie
    in one group, else an index of one KV head per query head."""
    group = n_heads // n_kv
    first, last = h0 // group, (h0 + h_loc - 1) // group
    if (h0 % group == 0 and h_loc % group == 0) or first == last:
        return slice(first, last + 1)
    return torch.arange(h0, h0 + h_loc) // group


def _rank_params(p, cfg: ModelConfig, rules, select_kv: bool):
    """This rank's projections, the FSDP dims gathered: ``wq``/``bq``/
    ``wo`` its query heads, ``wk``/``wv``/``bk``/``bv`` every KV head
    (``select_kv``: only those its query heads read).  Returns ``(p,
    sel, h0)``: ``sel`` the KV heads its query heads read
    (``local_kv_heads``), ``h0`` its first query head."""
    if rules.kv_heads is not None:
        raise NotImplementedError("kv_heads split over ranks: the "
                                  "reference keeps K/V whole")
    wq = gather_dim(p["wq"], rules, "fsdp", 0)
    pl = dict(p, wq=wq, wk=gather_dim(p["wk"], rules, "fsdp", 0),
              wv=gather_dim(p["wv"], rules, "fsdp", 0),
              wo=gather_dim(p["wo"], rules, "fsdp", 2))
    h_loc = wq.shape[1]
    h0 = index_along(rules, "heads")[0] * h_loc
    sel = local_kv_heads(cfg.n_heads, cfg.n_kv_heads, h0, h_loc)
    if isinstance(sel, torch.Tensor):
        sel = sel.to(wq.device)
    if select_kv:
        for k, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if k in pl:
                pl[k] = pl[k][(slice(None),) * dim + (sel,)]
    return pl, sel, h0


def _rank_attention(p, cfg: ModelConfig, x, positions, causal, window,
                    rules):
    """Self-attention (no cache) of this rank's query heads and the KV
    heads they read; the output summed over the heads axes."""
    pl, _, _ = _rank_params(p, cfg, rules, select_kv=True)
    q = _project_q(pl, cfg, x, positions)
    k, v = _project_kv(pl, cfg, x, torch.arange(x.shape[1],
                                                  device=x.device))
    out = _full_attention(q, k, v, cfg, causal=causal, window=window)
    return psum_over(_project_out(pl, out), rules, "heads", "tp")


def _slot_range(cache: KVCache, rules) -> tuple:
    """``(lo, W)``: the first global slot of this rank's part of a
    ``kv_seq``-split cache, and the cache's global slot count."""
    part, parts = index_along(rules, "kv_seq")
    w_loc = cache.k.shape[1]
    return part * w_loc, parts * w_loc


def _write_own(cache: KVCache, k, v, first: int, rules) -> None:
    """Write the keys and values of positions ``first, first + 1, ..``
    (``k``'s rows) whose slots (``position % W`` in a ring) this rank
    holds."""
    lo, w = _slot_range(cache, rules)
    pos = torch.arange(first, first + k.shape[1])
    slot = pos % w if cache.ring else pos
    mine = (slot >= lo) & (slot < lo + cache.k.shape[1])
    if bool(mine.any()):
        rows = (pos[mine] - first).to(k.device)
        idx = (slot[mine] - lo).to(k.device)
        cache.k[:, idx] = k[:, rows]
        cache.v[:, idx] = v[:, rows]


def _rank_decode(q, cache: KVCache, cur_len: int, window, sel, h0: int,
                 rules):
    """One token's attention over a ``kv_seq``-split cache: q (B, 1,
    H_loc, D), this rank's heads from ``h0``.  The query of every head
    is gathered over the heads axes; each rank takes the partial softmax
    of every head over its slots (``_decode_partial``); the partials
    ``(m, l, o)`` of every rank are gathered over the ``kv_seq`` axes
    (one call) and combined alike on each rank, ``M`` the maximum of
    the ranks' ``m`` and each rank's ``l`` and ``o`` weighed by ``exp(m
    - M)`` (exactly 0 for a rank whose slots are all masked: ``m =
    NEG_INF``); each rank keeps its own heads.  Without a split
    ``kv_seq`` the rank attends with its own heads over the whole cache
    (the KV heads ``sel``).  Returns (B, 1, H_loc, D) in q's dtype."""
    b, _, h_loc, dh = q.shape
    lo, w = _slot_range(cache, rules)
    seq_axes = live_axes(rules, rules.kv_seq)
    if not seq_axes:
        cache = KVCache(cache.k[:, :, sel], cache.v[:, :, sel], cache.ring)
    else:
        q = gather_dim(q, rules, "heads", 2, "tp")
    m, l, o = _decode_partial(q, cache, cur_len, window, lo, w)
    if seq_axes:
        parts = all_gather_plain(torch.cat([m, l, o], -1)[None],
                                 rules.mesh, seq_axes, 0, "kv")
        scale = torch.exp(parts[..., :1] - parts[..., :1].amax(dim=0))
        l = (parts[..., 1:2] * scale).sum(dim=0)
        o = (parts[..., 2:] * scale).sum(dim=0)
    out = (o / l).permute(0, 3, 1, 2, 4).reshape(b, 1, -1, dh)
    return out[:, :, h0:h0 + h_loc].to(q.dtype) if seq_axes \
        else out.to(q.dtype)


def _rank_cached_attention(p, cfg: ModelConfig, x, positions, causal,
                           window, cache: KVCache, cache_pos: int, rules):
    """Self-attention with a ``kv_seq``-split cache on ranks (the
    prefill and decode modes of ``apply_attention``): this rank's query
    heads, every KV head projected (the rank writes every KV head of
    the slots it holds).  A prefill attends through the flash route
    (at ``cache_pos > 0`` over the cache gathered over ``kv_seq`` and
    the prompt, ``_cached_prefix``), then writes its slots of the
    prompt's keys (the last ``W`` of them in a ring); a decode step
    writes the token's key on the rank that holds its slot and attends
    through ``_rank_decode``.  The output is summed over the heads
    axes."""
    pl, sel, h0 = _rank_params(p, cfg, rules, select_kv=False)
    q = _project_q(pl, cfg, x, positions)
    k, v = _project_kv(pl, cfg, x, positions)
    s_q = x.shape[1]
    if s_q > 1:
        if cache_pos:
            whole = KVCache(gather_dim(cache.k, rules, "kv_seq", 1, "kv"),
                            gather_dim(cache.v, rules, "kv_seq", 1, "kv"),
                            cache.ring)
            kc, vc, q_off = _cached_prefix(whole, cache_pos, k, v)
        else:
            kc, vc, q_off = k, v, 0
        out = _full_attention(q, kc[:, :, sel], vc[:, :, sel], cfg,
                              causal=causal, window=window, q_offset=q_off)
        w = _slot_range(cache, rules)[1]
        skip = s_q - min(w, s_q) if cache.ring else 0
        _write_own(cache, k[:, skip:], v[:, skip:], cache_pos + skip, rules)
    else:
        _write_own(cache, k, v, cache_pos, rules)
        out = _rank_decode(q, cache, cache_pos + 1, window, sel, h0, rules)
    return psum_over(_project_out(pl, out), rules, "heads", "tp")


def apply_attention(p, cfg: ModelConfig, x, positions, *, causal=True,
                    window=None, kv_x=None, cache: Optional[KVCache] = None,
                    cache_pos: Optional[int] = None, update_cache=True,
                    rules=None):
    """Self- or cross-attention.  Returns (out (B, S, d), cache).

    Self-attention (``kv_x`` None, ``update_cache``):
      * cache None:        full attention over ``x`` (train / prefill);
      * cache, S > 1:      prefill: full attention over the prompt, then
                           its keys/values (the last window of them for a
                           ring cache) are written at ``cache_pos``; at
                           ``cache_pos > 0`` the prompt continues the
                           cache and attends over its keys too
                           (``_cached_prefix``; the reference's prefill
                           always starts at 0);
      * cache, S == 1:     decode: the token's key/value is written at
                           ``cache_pos`` and it attends over the cache.
    Cross-attention (keys and values at positions ``arange(Sk)``, never
    causal):
      * ``kv_x`` (B, Sk, d): full attention over ``kv_x``'s keys (train,
                           or prefill, which writes them into the cross
                           cache at 0);
      * static cache (``kv_x`` None, ``update_cache=False``): S == 1
                           decodes over the whole cache (the plain
                           ``_decode_attention``); S > 1, a prefill
                           continued without the encoder's input, attends
                           over the whole cache through the flash route
                           (the reference would run causal self-attention
                           over the chunk with the cross weights there).
    The cache is written in place.  On ranks (``rules`` with a mesh)
    every mode runs on this rank's heads and cache slots (the module
    docstring).
    """
    if on_ranks(rules):
        if kv_x is not None or not update_cache:
            pl, sel, _ = _rank_params(p, cfg, rules, select_kv=False)
            out = _cross_attention(pl, cfg, x, positions, kv_x, cache, sel)
            return psum_over(_project_out(pl, out), rules, "heads",
                             "tp"), cache
        if cache is None:
            return _rank_attention(p, cfg, x, positions, causal, window,
                                   rules), None
        return _rank_cached_attention(p, cfg, x, positions, causal, window,
                                      cache, cache_pos, rules), cache
    if kv_x is not None or not update_cache:
        out = _cross_attention(p, cfg, x, positions, kv_x, cache)
        return _project_out(p, out), cache
    kv_positions = (torch.arange(x.shape[1], device=x.device)
                    if cache is None else positions)
    q = _project_q(p, cfg, x, positions)
    k, v = _project_kv(p, cfg, x, kv_positions)

    s_q = x.shape[1]
    if cache is None:
        out = _full_attention(q, k, v, cfg, causal=causal, window=window)
    elif s_q > 1:
        if cache_pos:
            kc, vc, q_off = _cached_prefix(cache, cache_pos, k, v)
            out = _full_attention(q, kc, vc, cfg, causal=causal,
                                  window=window, q_offset=q_off)
        else:
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
    return _project_out(p, out), cache


def _project_out(p, out):
    """(B, S, H, D) @ wo (H, D, d) -> (B, S, d)."""
    b, s = out.shape[:2]
    wo = p["wo"]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
               window: Optional[int] = None, device="cuda") -> KVCache:
    """Zeroed cache for ``seq`` positions (``min(seq, window)`` slots as
    a ring when the window is shorter than ``seq``)."""
    return _cache(cfg, batch, seq, dtype, window, resolve_device(device))


def abstract_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
                   window: Optional[int] = None) -> KVCache:
    """``init_cache``'s shapes and dtypes as ``"meta"`` tensors."""
    return _cache(cfg, batch, seq, dtype, window, torch.device("meta"))


def _cache(cfg: ModelConfig, batch: int, seq: int, dtype,
           window: Optional[int], dev: torch.device) -> KVCache:
    s = min(seq, window) if window else seq
    shape = (batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev),
                   ring=window is not None and window < seq)
