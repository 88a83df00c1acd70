"""Block assembly and the full-model forward of the LM stack (the port of
``repro.models.transformer``): the dense, MoE, mamba and RG-LRU
families.

Parameters are plain dicts: ``{"embed": {"table"}, "ln_f": {"scale"},
"layers": [block, ...]}``, one dict per layer in layer order; layer
``i``'s kind is ``cfg.layer_kinds[i]`` (the config's pattern cycled over
the layers, so recurrentgemma's two remainder layers are RG-LRU).  The
reference stacks the layers of each pattern position and drives them
with ``lax.scan``; here a Python loop runs them.  The decode state is
``{"layers": [state, ...]}`` (a ``KVCache`` for attention layers, ring-
buffered under a sliding window; ``{"conv", "ssm"}`` for mamba;
``{"conv", "h"}`` for RG-LRU); a training forward returns
``{"layers": [None, ...]}``.

Block kinds:
  attn   -- pre-norm attention + pre-norm gated MLP
  moe    -- pre-norm attention + pre-norm MoE FFN
  mamba  -- pre-norm mamba mixer (no MLP; the mamba1 convention)
  rglru  -- pre-norm RG-LRU mixer + pre-norm gated MLP

The encoder-decoder and frontend families (whisper, internvl) are not
ported yet and are refused by name.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .attention import apply_attention, init_attention, init_cache
from .config import ModelConfig
from .layers import (apply_embedding, apply_mlp, apply_rmsnorm,
                     init_embedding, init_mlp, init_rmsnorm,
                     logits_from_embedding, torch_dtype)
from .moe import apply_moe, init_moe
from .rglru import apply_rglru, init_rglru, init_rglru_state
from .ssm import apply_mamba, init_mamba, init_mamba_state

AUX_KEYS = ("load_balance", "router_z", "frac_dropped")
BLOCK_KINDS = ("attn", "moe", "mamba", "rglru")


def _zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _require_ported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    for kind in set(cfg.layer_kinds):
        _require_kind(kind)
    if cfg.encoder_layers or cfg.cross_attn or cfg.encoder_seq \
            or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend families (whisper, "
            "internvl) are not ported yet: ROADMAP.md, item 10 (LM side)")


def _require_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> dict:
    _require_kind(kind)
    dev, d = gen.device, cfg.d_model
    p = {"ln1": init_rmsnorm(d, dtype, dev)}
    if kind in ("attn", "moe"):
        p["attn"] = init_attention(gen, cfg, dtype)
        p["ln2"] = init_rmsnorm(d, dtype, dev)
        if kind == "moe":
            p["moe"] = init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype)
    elif kind == "mamba":
        p["mamba"] = init_mamba(gen, cfg, dtype)
    else:
        p["rglru"] = init_rglru(gen, cfg, dtype)
        p["ln2"] = init_rmsnorm(d, dtype, dev)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype)
    return p


def apply_block(p, cfg: ModelConfig, kind: str, x, positions, *,
                state=None, cache_pos: Optional[int] = None, window=None,
                causal=True):
    """Returns (x, new_state, aux): ``aux`` the MoE block's auxiliary
    values, None for the other kinds (the reference returns zeros, which
    add nothing to the model's sums)."""
    _require_kind(kind)
    aux = None
    h = apply_rmsnorm(p["ln1"], x)
    if kind in ("attn", "moe"):
        a, new_state = apply_attention(p["attn"], cfg, h, positions,
                                       causal=causal, window=window,
                                       cache=state, cache_pos=cache_pos)
        x = x + a
        h2 = apply_rmsnorm(p["ln2"], x)
        if kind == "moe":
            m, aux = apply_moe(p["moe"], cfg, h2)
        else:
            m = apply_mlp(p["mlp"], h2, cfg.mlp_act)
        x = x + m
    elif kind == "mamba":
        m, new_state = apply_mamba(p["mamba"], cfg, h, state=state)
        x = x + m
    else:
        r, new_state = apply_rglru(p["rglru"], cfg, h, state=state)
        x = x + r
        x = x + apply_mlp(p["mlp"], apply_rmsnorm(p["ln2"], x), cfg.mlp_act)
    return x, new_state, aux


def block_state_init(cfg: ModelConfig, kind: str, batch: int, seq: int,
                     dtype, device="cuda"):
    """Decode-time state of one block: a KV cache (a ring of the last
    ``window`` positions under a sliding window shorter than ``seq``), or
    the recurrent state."""
    _require_kind(kind)
    if kind in ("attn", "moe"):
        return init_cache(cfg, batch, seq, dtype, window=cfg.window or None,
                          device=device)
    if kind == "mamba":
        return init_mamba_state(cfg, batch, dtype, device=device)
    return init_rglru_state(cfg, batch, dtype, device=device)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device``: the reference's distributions (normal projections
    scaled by 1/sqrt(fan-in), unit-normal embedding, zero norm scales
    and biases, the float32 leaves of the recurrent and MoE blocks), not
    its numbers."""
    _require_ported(cfg)
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


def param_count_gap(cfg: ModelConfig) -> int:
    """``init_model``'s parameter count less ``cfg.param_count()``.  The
    reference's formula (kept as it is in ``models.config``) is off for
    the recurrent blocks, whose leaves the port makes as the reference
    does: a mamba block holds ``2 d_inner - d_model`` more (its conv
    bias and one of ``dt_bias`` / ``d_skip`` uncounted, a second
    pre-norm counted that it lacks), an RG-LRU block ``w (2 - k)`` more
    (its conv counted as ``2 w k`` where it holds ``w k + w``, and
    ``lam`` and the two gate biases as ``2 w``).  Zero for attention
    and MoE blocks."""
    gap = 0
    for kind in cfg.layer_kinds:
        if kind == "mamba":
            gap += 2 * cfg.d_inner - cfg.d_model
        elif kind == "rglru":
            gap += cfg.resolved_rglru_width * (2 - cfg.conv_k)
    return gap


def _block_out(lp, cfg: ModelConfig, kind: str, x, positions, window):
    """One training block's output and its aux values (no cache), the
    checkpointed unit."""
    x, _, aux = apply_block(lp, cfg, kind, x, positions, window=window)
    aux = aux or _zero_aux(x.device)
    return (x,) + tuple(aux[k] for k in AUX_KEYS)


def forward(p, cfg: ModelConfig, batch: Dict, *, state=None,
            cache_pos: Optional[int] = None):
    """Full forward.  Returns (final-norm hidden (B, S, d), new_state,
    aux): ``aux`` is each of ``AUX_KEYS`` summed over the layers (zeros
    for a model without MoE blocks), as the reference returns it.

    ``batch["tokens"]``: (B, S) integer.  ``state``/``cache_pos`` (an
    int) enable prefill into and decode from the states of
    ``init_decode_state``; a prefill at ``cache_pos > 0`` continues the
    state (the recurrent layers from their carry, attention over the
    cached keys too).  Training (no ``state``, grad enabled) with
    ``cfg.remat`` runs each layer under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the layer from its input,
    so only the layers' inputs stay alive (the reference's
    ``jax.checkpoint``; its sqrt(L) grouping exists for ``lax.scan``,
    which the port's loop does not have)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    x = apply_embedding(p["embed"], tokens, scale=cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)
    if cache_pos is not None:
        positions = positions + cache_pos
    states = state["layers"] if state else [None] * len(p["layers"])
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    aux_total = _zero_aux(x.device)
    new_states = []
    for lp, kind, st in zip(p["layers"], cfg.layer_kinds, states):
        win = cfg.window if kind in ("attn", "moe") else None
        if remat:
            x, *vals = checkpoint(_block_out, lp, cfg, kind, x, positions,
                                  win, use_reentrant=False)
            aux = dict(zip(AUX_KEYS, vals))
            new_states.append(None)
        else:
            x, ns, aux = apply_block(lp, cfg, kind, x, positions, state=st,
                                     cache_pos=cache_pos, window=win)
            new_states.append(ns)
        if aux is not None:
            aux_total = {k: aux_total[k] + aux[k] for k in AUX_KEYS}
    x = apply_rmsnorm(p["ln_f"], x)
    return x, {"layers": new_states}, aux_total


def logits(p, x):
    return logits_from_embedding(p["embed"], x)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict:
    """The zeroed decode state of every layer for ``max_len`` positions:
    KV caches (rings under a shorter sliding window) and recurrent
    states."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return {"layers": [block_state_init(cfg, kind, batch, max_len, dtype,
                                        dev)
                       for kind in cfg.layer_kinds]}
