"""Block assembly and the full-model forward of the dense LM stack (the
port of ``repro.models.transformer``, ``"attn"`` blocks only).

Parameters are plain dicts: ``{"embed": {"table"}, "ln_f": {"scale"},
"layers": [block, ...]}``, one dict per layer in layer order (the
reference stacks the layers of each pattern position and drives them
with ``lax.scan``; here a Python loop runs them).  The decode state is
``{"layers": [KVCache, ...]}``; a training forward returns
``{"layers": [None, ...]}``.

An ``"attn"`` block is pre-norm attention plus a pre-norm gated MLP.
The other block kinds and the encoder/frontend families are not ported
yet and are refused by name.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .attention import KVCache, apply_attention, init_attention, init_cache
from .config import ModelConfig
from .layers import (apply_embedding, apply_mlp, apply_rmsnorm,
                     init_embedding, init_mlp, init_rmsnorm,
                     logits_from_embedding, torch_dtype)

_NOT_PORTED = {
    "moe": "MoE blocks (granite, kimi)",
    "mamba": "mamba blocks (falcon-mamba)",
    "rglru": "RG-LRU blocks (recurrentgemma)",
}


def _require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    for kind in set(cfg.layer_kinds):
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {_NOT_PORTED.get(kind, repr(kind))} are not "
                "ported yet: ROADMAP.md, item 10 (LM side)")
    if cfg.encoder_layers or cfg.cross_attn or cfg.encoder_seq \
            or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend families (whisper, "
            "internvl) are not ported yet: ROADMAP.md, item 10 (LM side)")


def _require_attn(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: ROADMAP.md, item 10")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> dict:
    _require_attn(kind)
    dev = gen.device
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, dev),
            "attn": init_attention(gen, cfg, dtype),
            "ln2": init_rmsnorm(cfg.d_model, dtype, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)}


def apply_block(p, cfg: ModelConfig, kind: str, x, positions, *,
                state: Optional[KVCache] = None,
                cache_pos: Optional[int] = None, window=None, causal=True):
    """Returns (x, new_state)."""
    _require_attn(kind)
    h = apply_rmsnorm(p["ln1"], x)
    a, new_state = apply_attention(p["attn"], cfg, h, positions,
                                   causal=causal, window=window,
                                   cache=state, cache_pos=cache_pos)
    x = x + a
    x = x + apply_mlp(p["mlp"], apply_rmsnorm(p["ln2"], x), cfg.mlp_act)
    return x, new_state


def block_state_init(cfg: ModelConfig, kind: str, batch: int, seq: int,
                     dtype, device="cuda") -> KVCache:
    """Decode-time state of one block: its KV cache."""
    _require_attn(kind)
    return init_cache(cfg, batch, seq, dtype, window=cfg.window or None,
                      device=device)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device``: the reference's distributions (normal projections
    scaled by 1/sqrt(fan-in), unit-normal embedding, zero norm scales
    and biases), not its numbers."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "ln_f": init_rmsnorm(cfg.d_model, dtype, dev),
        "layers": [init_block(gen, cfg, kind, dtype)
                   for kind in cfg.layer_kinds],
    }


def _block_out(lp, cfg: ModelConfig, kind: str, x, positions, window):
    """One training block's output (no cache), the checkpointed unit."""
    return apply_block(lp, cfg, kind, x, positions, window=window)[0]


def forward(p, cfg: ModelConfig, batch: Dict, *, state=None,
            cache_pos: Optional[int] = None):
    """Full forward.  Returns (final-norm hidden (B, S, d), new_state).

    ``batch["tokens"]``: (B, S) integer.  ``state``/``cache_pos`` (an
    int) enable prefill into and decode from the KV caches of
    ``init_decode_state``.  Training (no ``state``, grad enabled) with
    ``cfg.remat`` runs each layer under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the layer from its input,
    so only the layers' inputs stay alive (the reference's
    ``jax.checkpoint``; its sqrt(L) grouping exists for ``lax.scan``,
    which the port's loop does not have)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = apply_embedding(p["embed"], tokens, scale=cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)
    if cache_pos is not None:
        positions = positions + cache_pos
    states = state["layers"] if state else [None] * len(p["layers"])
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    new_states = []
    for lp, kind, st in zip(p["layers"], cfg.layer_kinds, states):
        win = cfg.window if kind in ("attn", "moe") else None
        if remat:
            x = checkpoint(_block_out, lp, cfg, kind, x, positions, win,
                           use_reentrant=False)
            new_states.append(None)
            continue
        x, ns = apply_block(lp, cfg, kind, x, positions, state=st,
                            cache_pos=cache_pos, window=win)
        new_states.append(ns)
    x = apply_rmsnorm(p["ln_f"], x)
    return x, {"layers": new_states}


def logits(p, x):
    return logits_from_embedding(p["embed"], x)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict:
    """Zeroed KV caches of every layer for ``max_len`` positions."""
    _require_dense(cfg)
    dtype = torch_dtype(cfg.dtype)
    return {"layers": [block_state_init(cfg, kind, batch, max_len, dtype,
                                        device)
                       for kind in cfg.layer_kinds]}
