"""Block assembly and the full-model forward of the LM stack (the port of
``repro.models.transformer``): the dense, MoE, mamba and RG-LRU
families, the encoder-decoder (whisper) and the VLM (internvl).

Parameters are plain dicts: ``{"embed": {"table"}, "ln_f": {"scale"},
"layers": [block, ...]}``, one dict per layer in layer order; layer
``i``'s kind is ``cfg.layer_kinds[i]`` (the config's pattern cycled over
the layers, so recurrentgemma's two remainder layers are RG-LRU).  With
``cfg.cross_attn`` each decoder layer also holds ``ln_x`` and
``cross``; an encoder adds ``enc_layers`` (``cfg.encoder_layers``
"attn" blocks, run non-causal) and ``enc_ln_f``; a frontend
(``cfg.encoder_seq`` or ``cfg.n_patches``) adds ``frontend``
(``{"adapter"}``).  The reference stacks the layers of each pattern
position (and the encoder's) and drives them with ``lax.scan``; here a
Python loop runs them, and ``stack_groups`` names the reference's groups
(Adafactor factors and clips each as one stacked leaf).  The decode
state is ``{"layers": [state, ...]}`` (a ``KVCache`` for attention
layers, ring-buffered under a sliding window; ``{"conv", "ssm"}`` for
mamba; ``{"conv", "h"}`` for RG-LRU), plus ``"cross": [KVCache,
...]`` (one static cache of the encoder's keys per decoder layer) with
cross-attention; a training forward returns ``{"layers": [None,
...]}``.

Block kinds:
  attn   -- pre-norm attention + pre-norm gated MLP
  moe    -- pre-norm attention + pre-norm MoE FFN
  mamba  -- pre-norm mamba mixer (no MLP; the mamba1 convention)
  rglru  -- pre-norm RG-LRU mixer + pre-norm gated MLP
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..parallel.collectives import all_gather
from ..parallel.sharding import block, block_shape, live_axes, on_ranks
from .attention import (KVCache, abstract_cache, apply_attention,
                        init_attention, init_cache)
from .config import ModelConfig
from .frontends import (STUB_WIDTH, apply_audio_frontend,
                        apply_patch_frontend, init_frontend)
from .layers import (apply_embedding, apply_mlp, apply_rmsnorm,
                     init_embedding, init_mlp, init_rmsnorm,
                     logical_names, logits_from_embedding, META_GEN,
                     sinusoidal_positions, torch_dtype)
from .moe import apply_moe, init_moe
from .rglru import (abstract_rglru_state, apply_rglru, init_rglru,
                    init_rglru_state)
from .ssm import (abstract_mamba_state, apply_mamba, init_mamba,
                  init_mamba_state)

AUX_KEYS = ("load_balance", "router_z", "frac_dropped")
BLOCK_KINDS = ("attn", "moe", "mamba", "rglru")


def _zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _require_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype, cross: bool = False) -> dict:
    """One block's parameters; ``cross`` adds the decoder's
    cross-attention (``ln_x``, ``cross``)."""
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
    if cross:
        p["ln_x"] = init_rmsnorm(d, dtype, dev)
        p["cross"] = init_attention(gen, cfg, dtype, cross=True)
    return p


def apply_block(p, cfg: ModelConfig, kind: str, x, positions, *,
                state=None, cache_pos: Optional[int] = None, window=None,
                enc_out=None, cross_state=None, causal=True, rules=None):
    """Returns (x, new_state, aux): ``aux`` the MoE block's auxiliary
    values, None for the other kinds (the reference returns zeros, which
    add nothing to the model's sums).

    A block with ``cross`` attends over the encoder's output after its
    self-attention: ``enc_out`` (train, or prefill, which also fills
    ``cross_state`` in place), or the static ``cross_state`` alone
    (decode, continued prefill); with neither it skips that step, as
    the reference's does."""
    _require_kind(kind)
    aux = None
    h = apply_rmsnorm(p["ln1"], x)
    if kind in ("attn", "moe"):
        a, new_state = apply_attention(p["attn"], cfg, h, positions,
                                       causal=causal, window=window,
                                       cache=state, cache_pos=cache_pos,
                                       rules=rules)
        x = x + a
        if "cross" in p and (enc_out is not None
                             or cross_state is not None):
            hx = apply_rmsnorm(p["ln_x"], x)
            cx, _ = apply_attention(p["cross"], cfg, hx, positions,
                                    kv_x=enc_out, cache=cross_state,
                                    update_cache=enc_out is not None,
                                    rules=rules)
            x = x + cx
        h2 = apply_rmsnorm(p["ln2"], x)
        if kind == "moe":
            m, aux = apply_moe(p["moe"], cfg, h2, rules)
        else:
            m = apply_mlp(p["mlp"], h2, cfg.mlp_act, rules)
        x = x + m
    elif kind == "mamba":
        m, new_state = apply_mamba(p["mamba"], cfg, h, state=state,
                                   rules=rules)
        x = x + m
    else:
        r, new_state = apply_rglru(p["rglru"], cfg, h, state=state,
                                   rules=rules)
        x = x + r
        x = x + apply_mlp(p["mlp"], apply_rmsnorm(p["ln2"], x), cfg.mlp_act,
                          rules)
    return x, new_state, aux


def block_state_init(cfg: ModelConfig, kind: str, batch: int, seq: int,
                     dtype, device="cuda", abstract: bool = False):
    """Decode-time state of one block: a KV cache (a ring of the last
    ``window`` positions under a sliding window shorter than ``seq``), or
    the recurrent state; ``abstract``: its shapes and dtypes as
    ``"meta"`` tensors (``device`` unread)."""
    _require_kind(kind)
    win = cfg.window or None
    if abstract:
        if kind in ("attn", "moe"):
            return abstract_cache(cfg, batch, seq, dtype, window=win)
        if kind == "mamba":
            return abstract_mamba_state(cfg, batch, dtype)
        return abstract_rglru_state(cfg, batch, dtype)
    if kind in ("attn", "moe"):
        return init_cache(cfg, batch, seq, dtype, window=win, device=device)
    if kind == "mamba":
        return init_mamba_state(cfg, batch, dtype, device=device)
    return init_rglru_state(cfg, batch, dtype, device=device)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               rules=None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device``: the reference's distributions (normal projections
    scaled by 1/sqrt(fan-in), unit-normal embedding, zero norm scales
    and biases, the float32 leaves of the recurrent and MoE blocks), not
    its numbers.  ``rules`` with a mesh: this rank's blocks of the same
    numbers (``param_specs``), each part (the embedding, a layer, the
    frontend) cut as soon as it is drawn, so no more than one whole
    part is held at once."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    if not on_ranks(rules):
        return _init_params(cfg, gen)

    def place(key, part):
        specs = param_specs({key: part})[key]
        return _map_named(lambda x, n: block(x, n, rules), part, specs)
    return _init_params(cfg, gen, place)


def abstract_model(cfg: ModelConfig):
    """``(params, specs)`` without allocating anything: ``init_model``'s
    tree built by the same code on ``"meta"`` (its draws through
    ``layers.META_GEN``), and the tree of each leaf's logical axis names
    (``param_specs``)."""
    params = _init_params(cfg, META_GEN)
    return params, param_specs(params)


def param_specs(params):
    """The tree of ``params`` with each leaf replaced by the reference's
    logical axis names (a tuple; ``layers.logical_names``).  The
    reference's stacked layers lead theirs with ``"stack"``; the port's
    per-layer leaves have no such axis."""
    def walk(node, parent=""):
        if isinstance(node, dict):
            return {k: (walk(v, k) if isinstance(v, (dict, list))
                        else logical_names(parent, k))
                    for k, v in node.items()}
        return [walk(v, parent) for v in node]
    return walk(params)


def _map_named(fn, tree, names):
    """``fn(leaf, names)`` over a parameter (or decode-state) tree and
    its tree of logical names (a ``KVCache`` of two name tuples for a
    cache)."""
    if isinstance(names, tuple):
        return fn(tree, names)
    if isinstance(names, KVCache):
        return KVCache(fn(tree.k, names.k), fn(tree.v, names.v), tree.ring)
    if isinstance(names, dict):
        return {k: _map_named(fn, tree[k], v) for k, v in names.items()}
    return [_map_named(fn, t, n) for t, n in zip(tree, names)]


def _init_params(cfg: ModelConfig, gen, place=None) -> Dict:
    """The parameter tree, drawn in one order from ``gen``; ``place(key,
    part)`` (default: the part itself) receives each top-level part, and
    each layer as ``(key, [layer])``, as soon as it is drawn."""
    dev = gen.device
    dtype = torch_dtype(cfg.dtype)
    if place is None:
        def place(key, part):
            return part
    p = {
        "embed": place("embed", init_embedding(gen, cfg.padded_vocab,
                                               cfg.d_model, dtype)),
        "ln_f": place("ln_f", init_rmsnorm(cfg.d_model, dtype, dev)),
        "layers": [place("layers", [init_block(gen, cfg, kind, dtype,
                                               cross=cfg.cross_attn)])[0]
                   for kind in cfg.layer_kinds],
    }
    if cfg.encoder_layers:
        p["enc_layers"] = [place("enc_layers",
                                 [init_block(gen, cfg, "attn", dtype)])[0]
                           for _ in range(cfg.encoder_layers)]
        p["enc_ln_f"] = place("enc_ln_f", init_rmsnorm(cfg.d_model, dtype,
                                                       dev))
    if cfg.encoder_seq or cfg.n_patches:
        p["frontend"] = place("frontend", init_frontend(gen, cfg, dtype))
    return p


def stack_groups(cfg: ModelConfig) -> Dict:
    """The reference's layout of the layers (``repro.models.transformer.
    init_model``), as the port's layer indices: ``{"blocks": ("layers",
    [group, ...]), "rest": ("layers", [i, ...])}``, with an encoder also
    ``"enc_blocks": ("enc_layers", group)``.  A group is a tuple of
    layer indices that the reference stacks into one leaf: with
    ``cfg.scan_layers`` and more than one period, the layers at each
    pattern position of the whole periods (period-major); the encoder's
    layers always.  The remainder layers (all of them with one period or
    without ``scan_layers``) stay single.  ``optim.adafactor(...,
    stacks=)`` factors and clips each group as the reference does its
    stacked leaf."""
    per = len(cfg.pattern)
    n_periods, _ = cfg.pattern_periods
    if cfg.scan_layers and n_periods > 1:
        blocks = [tuple(i * per + pos for i in range(n_periods))
                  for pos in range(per)]
        rest = list(range(n_periods * per, cfg.n_layers))
    else:
        blocks, rest = [], list(range(cfg.n_layers))
    out = {"blocks": ("layers", blocks), "rest": ("layers", rest)}
    if cfg.encoder_layers:
        out["enc_blocks"] = ("enc_layers", tuple(range(cfg.encoder_layers)))
    return out


def param_count_gap(cfg: ModelConfig) -> int:
    """``init_model``'s parameter count less ``cfg.param_count()``.  The
    reference's formula (kept as it is in ``models.config``) is off for
    the recurrent blocks, whose leaves the port makes as the reference
    does: a mamba block holds ``2 d_inner - d_model`` more (its conv
    bias and one of ``dt_bias`` / ``d_skip`` uncounted, a second
    pre-norm counted that it lacks), an RG-LRU block ``w (2 - k)`` more
    (its conv counted as ``2 w k`` where it holds ``w k + w``, and
    ``lam`` and the two gate biases as ``2 w``).  The formula also
    leaves out the frontend's adapter (``STUB_WIDTH x d_model``) and the
    encoder's final norm (``d_model``).  Zero for attention and MoE
    blocks."""
    gap = 0
    if cfg.encoder_seq or cfg.n_patches:
        gap += STUB_WIDTH * cfg.d_model
    if cfg.encoder_layers:
        gap += cfg.d_model
    for kind in cfg.layer_kinds:
        if kind == "mamba":
            gap += 2 * cfg.d_inner - cfg.d_model
        elif kind == "rglru":
            gap += cfg.resolved_rglru_width * (2 - cfg.conv_k)
    return gap


def seq_axes(rules, length: int) -> tuple:
    """The live mesh axes that split a stream of ``length`` positions
    between blocks (sequence parallelism, ``rules.seq``): ``()`` off
    ranks, without ``seq``, or for one position (decode stays whole).
    Raises ``ValueError`` where ``seq`` names a mesh axis that ``batch``
    uses (the reference's ``PartitionSpec`` refuses one mesh axis on two
    dims).

    Any length splits, as the reference's padded GSPMD layout does:
    between blocks each of the n ranks holds ``ceil(length / n)``
    positions of the stream padded to ``n * ceil(length / n)``
    (``own_positions``: the last ranks' blocks end in padding, or are
    all padding).  The padding is only a carry between blocks: each
    block's ``"seq"`` gather joins the n blocks and slices the padding
    off (``whole_positions``), so every block, kernel and collective
    inside it sees the ``length`` true positions; the loss gives the
    padded positions the label -1."""
    if not on_ranks(rules) or rules.seq is None:
        return ()
    both = set(_axis_names(rules.seq)) & set(_axis_names(rules.batch))
    if both:
        raise ValueError(f"sequence parallelism: seq {rules.seq!r} shares "
                         f"the mesh axis {sorted(both)} with batch "
                         f"{rules.batch!r} ({length} positions)")
    axes = live_axes(rules, rules.seq)
    if length <= 1 or not axes:
        return ()
    return axes


def prefix_len(cfg: ModelConfig, batch: Dict) -> int:
    """The positions a VLM's patches prefix the tokens with (0 without
    ``patch_embeds``)."""
    return (batch["patch_embeds"].shape[1]
            if cfg.n_patches and "patch_embeds" in batch else 0)


def _axis_names(axis) -> tuple:
    return () if axis is None else (axis,) if isinstance(axis, str) \
        else tuple(axis)


def own_positions(x, rules, axes: tuple, fill=0):
    """This rank's block of ``x``'s positions (dim 1) along the ``seq``
    axes ``axes`` (``x`` itself for none): ``x`` padded with ``fill`` to
    a multiple of the ranks along ``axes``, then cut (``seq_axes``)."""
    if not axes:
        return x
    n = rules.mesh.axis_size(axes)
    size = -(-x.shape[1] // n)
    pad = n * size - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_full((x.shape[0], pad) + tuple(x.shape[2:]),
                                     fill)], dim=1)
    return x.narrow(1, rules.mesh.axis_index(axes) * size, size)


def whole_positions(x, rules, axes: tuple, length: int):
    """Every rank's block joined and the padding sliced off: the
    ``length`` true positions (under autograd: the backward sums the
    blocks' cotangents and keeps this rank's)."""
    if not axes:
        return x
    return all_gather(x, rules.mesh, axes, 1, "seq")[:, :length]


def _seq_block(lp, cfg: ModelConfig, kind: str, x, positions, sp=(), *,
               rules=None, **kw):
    """``apply_block`` on this rank's positions ``x`` under sequence
    parallelism (``sp``: the seq axes): the input gathered whole along
    the sequence (``positions``' length, the padding sliced off), the
    block run as without ``seq`` (whole positions, mask and RoPE), this
    rank's padded block of its output kept."""
    x, new_state, aux = apply_block(
        lp, cfg, kind, whole_positions(x, rules, sp, positions.shape[0]),
        positions, rules=rules, **kw)
    return own_positions(x, rules, sp), new_state, aux


def _block_out(lp, cfg: ModelConfig, kind: str, x, positions, window,
               enc_out=None, causal=True, rules=None, sp=()):
    """One training block's output and its aux values (no cache), the
    checkpointed unit (on ranks, its FSDP gathers with it, and under
    ``seq`` the gather of its input along the sequence)."""
    x, _, aux = _seq_block(lp, cfg, kind, x, positions, sp, window=window,
                           enc_out=enc_out, causal=causal, rules=rules)
    aux = aux or _zero_aux(x.device)
    return (x,) + tuple(aux[k] for k in AUX_KEYS)


def _encode(p, cfg: ModelConfig, frames, dtype, remat: bool, rules=None):
    """Whisper's encoder: the audio frontend, ``cfg.encoder_layers``
    non-causal "attn" blocks (each under ``torch.utils.checkpoint`` with
    ``remat``), the final norm.  Under ``seq`` the frames are split as
    the decoder's stream is (padded to a multiple of the ranks), and the
    output gathered whole for the cross-attention."""
    e = apply_audio_frontend(p["frontend"], frames, rules).to(dtype)
    e_pos = torch.arange(e.shape[1], device=e.device)
    sp = seq_axes(rules, e.shape[1])
    e = own_positions(e, rules, sp)
    for lp in p["enc_layers"]:
        if remat:
            e = checkpoint(_block_out, lp, cfg, "attn", e, e_pos, None,
                           None, False, rules, sp, use_reentrant=False)[0]
        else:
            e = _seq_block(lp, cfg, "attn", e, e_pos, sp, causal=False,
                           rules=rules)[0]
    return whole_positions(apply_rmsnorm(p["enc_ln_f"], e), rules, sp,
                            e_pos.shape[0])


def forward(p, cfg: ModelConfig, batch: Dict, *, state=None,
            cache_pos: Optional[int] = None, rules=None):
    """Full forward.  Returns (final-norm hidden (B, S, d), new_state,
    aux): ``aux`` is each of ``AUX_KEYS`` summed over the layers (zeros
    for a model without MoE blocks), as the reference returns it.

    ``batch["tokens"]``: (B, S) integer; ``batch["patch_embeds"]`` (B,
    n_patches, STUB_WIDTH) for a VLM: the projected patches are a prefix
    of the sequence (positions run over prefix and tokens; the prefix
    rows are dropped from the output only without ``cache_pos``, the
    path of the loss); ``batch["frames"]`` (B, encoder_seq, STUB_WIDTH)
    for whisper: the encoder runs and the decoder's cross-attention
    attends over its output (and a prefill writes it into the cross
    caches); whisper's decoder adds sinusoidal positions at
    ``cache_pos + arange(S)``.  ``state``/``cache_pos`` (an int) enable
    prefill into and decode from the states of ``init_decode_state``; a
    prefill at ``cache_pos > 0`` continues the state (the recurrent
    layers from their carry, attention over the cached keys too, cross-
    attention over the cross caches when no frames come).  Training (no
    ``state``, grad enabled) with ``cfg.remat`` runs each layer (the
    encoder's too) under ``torch.utils.checkpoint`` (non-reentrant): the
    backward recomputes the layer from its input, so only the layers'
    inputs stay alive (the reference's ``jax.checkpoint``; its sqrt(L)
    grouping exists for ``lax.scan``, which the port's loop does not
    have).

    On ranks (``rules`` with a mesh; ``p`` this rank's blocks, ``batch``
    its slice, ``state`` its blocks of ``init_decode_state(...,
    rules=)``): every family, training (each layer with its FSDP gathers
    under the checkpoint), prefill and decode.  Sequence parallelism
    (``rules.seq``, ``seq_axes``), at any length: between blocks each
    rank holds its block of the positions padded to a multiple of the
    ranks (split after the embedding, the patch prefix and the
    sinusoidal add; whisper's frames alike); each block gathers its
    input along the sequence, runs on the true positions and keeps its
    own padded block of the output.  Without ``state`` the result is
    then this rank's padded block (a VLM's prefix rows included:
    ``model.loss_fn`` masks them and the padding); a prefill returns
    the whole sequence at its true length; decode's one position stays
    whole."""
    tokens = batch["tokens"]
    n_prefix = prefix_len(cfg, batch)
    length = n_prefix + tokens.shape[1]
    sp = seq_axes(rules, length)
    x = apply_embedding(p["embed"], tokens, scale=cfg.embed_scale,
                        rules=rules)
    if n_prefix:
        px = apply_patch_frontend(p["frontend"], batch["patch_embeds"],
                                  rules)
        x = torch.cat([px.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    if cache_pos is not None:
        positions = positions + cache_pos
    if not cfg.use_rope and cfg.encoder_layers:
        # whisper's decoder: sinusoidal absolute positions at the live
        # offsets (no table)
        x = x + sinusoidal_positions(positions, cfg.d_model).to(
            x.dtype)[None]
    x = own_positions(x, rules, sp)
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    enc_out = None
    if cfg.encoder_layers and "frames" in batch:
        enc_out = _encode(p, cfg, batch["frames"], x.dtype, remat, rules)
    n = len(p["layers"])
    states = state["layers"] if state else [None] * n
    crosses = (state or {}).get("cross") or [None] * n
    aux_total = _zero_aux(x.device)
    new_states = []
    for lp, kind, st, cst in zip(p["layers"], cfg.layer_kinds, states,
                                 crosses):
        win = cfg.window if kind in ("attn", "moe") else None
        if remat:
            x, *vals = checkpoint(_block_out, lp, cfg, kind, x, positions,
                                  win, enc_out, True, rules, sp,
                                  use_reentrant=False)
            aux = dict(zip(AUX_KEYS, vals))
            new_states.append(None)
        else:
            x, ns, aux = _seq_block(lp, cfg, kind, x, positions, sp,
                                    state=st, cache_pos=cache_pos,
                                    window=win, enc_out=enc_out,
                                    cross_state=cst, rules=rules)
            new_states.append(ns)
        if aux is not None:
            aux_total = {k: aux_total[k] + aux[k] for k in AUX_KEYS}
    x = apply_rmsnorm(p["ln_f"], x)
    if state is not None:
        x = whole_positions(x, rules, sp, length)
    elif n_prefix and cache_pos is None and not sp:
        x = x[:, n_prefix:]
    new_state = {"layers": new_states}
    if state and "cross" in state:
        new_state["cross"] = state["cross"]
    return x, new_state, aux_total


def logits(p, x):
    return logits_from_embedding(p["embed"], x)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda", abstract: bool = False,
                      rules=None) -> Dict:
    """The zeroed decode state of every layer for ``max_len`` positions
    (a VLM's count its patch prefix): KV caches (rings under a shorter
    sliding window) and recurrent states; with cross-attention also
    ``"cross"``, one (batch, encoder_seq, Kv, D) cache per decoder
    layer.  ``abstract``: the same tree of ``"meta"`` tensors, nothing
    allocated (``device`` unread).  ``rules`` with a mesh: this rank's
    block of every leaf (``decode_state_names``), zeroed."""
    dev = None if abstract else resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    if on_ranks(rules):
        whole = init_decode_state(cfg, batch, max_len, abstract=True)
        out_dev = torch.device("meta") if abstract else dev
        return _map_named(
            lambda x, n: torch.zeros(block_shape(tuple(x.shape), n, rules),
                                     dtype=x.dtype, device=out_dev),
            whole, decode_state_names(whole))
    st = {"layers": [block_state_init(cfg, kind, batch, max_len, dtype,
                                      dev, abstract)
                     for kind in cfg.layer_kinds]}
    if cfg.cross_attn and cfg.encoder_seq:
        st["cross"] = [
            abstract_cache(cfg, batch, cfg.encoder_seq, dtype) if abstract
            else init_cache(cfg, batch, cfg.encoder_seq, dtype, device=dev)
            for _ in range(cfg.n_layers)]
    return st


_RECURRENT_NAMES = {"conv": ("batch", None, "d_inner"),
                    "ssm": ("batch", "d_inner", None),
                    "h": ("batch", "d_inner")}


def decode_state_names(state: Dict) -> Dict:
    """The reference's logical axis names of every leaf of a decode
    state (``init_decode_state``'s tree; a ``KVCache`` of two name
    tuples per attention layer): KV caches shard (batch, kv_seq),
    recurrent states their channel axis, whisper's cross caches batch
    only.  The port's per-layer leaves have no ``"stack"`` axis."""
    def cache(c: KVCache, cross: bool) -> KVCache:
        nd = c.k.dim()
        names = (("batch",) + (None,) * (nd - 1) if cross else
                 ("batch", "kv_seq") + (None,) * (nd - 2))
        return KVCache(names, names, c.ring)

    out = {"layers": [cache(st, False) if isinstance(st, KVCache)
                      else {k: _RECURRENT_NAMES[k] for k in st}
                      for st in state["layers"]]}
    if "cross" in state:
        out["cross"] = [cache(c, True) for c in state["cross"]]
    return out


def gather_decode_state(state: Dict, rules) -> Dict:
    """The whole decode state from every rank's blocks (each rank calls
    it; every rank gets the whole), without autograd.  A leaf that no
    live axis splits comes back as the rank's own tensor."""
    from ..parallel.sharding import gather_block
    return _map_named(lambda x, n: gather_block(x, n, rules), state,
                      decode_state_names(state))


def decode_state_leaves(state: Dict) -> list:
    """``(tensor, logical names)`` of every leaf of a decode state, in
    ``decode_state_names``' order (a cache's ``k``, then its ``v``)."""
    out: list = []
    _map_named(lambda x, n: out.append((x, n)), state,
               decode_state_names(state))
    return out
