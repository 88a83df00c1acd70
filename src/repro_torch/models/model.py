"""Public model API of the LM stack (the port of ``repro.models.model``):
the chunked loss, the train and eval steps, prefill and decode.

The reference's functions take sharding ``rules``; one card has none,
so these take the config alone.  The abstract inputs of a shape cell
(``input_specs``, ``abstract_params``, ``abstract_decode_state``) are
``"meta"`` tensors, the dry run's inputs (``launch.dryrun``).  Nothing is jitted: the returned
functions run eagerly.  The train step updates the parameters and the
optimizer state in place (the counterpart of the reference's donated
buffers) and returns them.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_flatten, tree_unflatten
from .attention import KVCache
from .config import ModelConfig, ShapeConfig
from .frontends import STUB_WIDTH
from .layers import torch_dtype
from .transformer import (abstract_model, forward, init_decode_state,
                          logits as lm_logits)


# ---------------------------------------------------------------------------
# Loss (chunked over the sequence: never the (B, S, V) logits at once)
# ---------------------------------------------------------------------------

def _chunk_nll(table, xc, lc):
    """Summed cross-entropy of one chunk: ``xc`` (B, C, d) hidden,
    ``lc`` (B, C) labels (-1 = masked); the chunk's (B, C, Vpad) logits
    in float32 live only here."""
    lg = lm_logits({"embed": {"table": table}}, xc).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    valid = lc >= 0
    lab = torch.where(valid, lc, torch.zeros_like(lc)).long()
    picked = torch.gather(lg, -1, lab[..., None])[..., 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse)).sum()


def chunked_xent(p, cfg: ModelConfig, x, labels):
    """x: (B, S, d) final hidden; labels: (B, S) integer, -1 = masked.

    Returns (sum_nll float32, n_valid int32), chunk by chunk of
    ``cfg.loss_chunk`` positions.  Under autograd each chunk runs under
    ``torch.utils.checkpoint``: the backward recomputes that chunk's
    logits instead of keeping all of them (the reference's
    ``jax.checkpoint`` scan body)."""
    b, s, _ = x.shape
    chunk = min(cfg.loss_chunk, s)
    table = p["embed"]["table"]
    grad = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        nll = nll + (checkpoint(_chunk_nll, table, xc, lc,
                                use_reentrant=False)
                     if grad else _chunk_nll(table, xc, lc))
    n = (labels >= 0).sum(dtype=torch.int32)
    return nll, n


def loss_fn(params, cfg: ModelConfig, batch: Dict):
    """(loss, metrics): the mean next-token loss over the valid labels,
    plus ``router_aux_coef * load_balance + 1e-4 * router_z`` for a MoE
    config (the aux values summed over the layers, as the reference adds
    them); ``metrics`` = ``{"nll", "tokens"}`` and the aux values."""
    x, _, aux = forward(params, cfg, batch)
    nll, n = chunked_xent(params, cfg, x, batch["labels"])
    loss = nll / torch.clamp(n, min=1)
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux["load_balance"] \
            + 1e-4 * aux["router_z"]
    return loss, {"nll": nll, "tokens": n, **aux}


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def _grads_of(params, cfg: ModelConfig, batch: Dict):
    """(loss, metrics, grads): the loss's gradient with respect to every
    parameter leaf, as a tree of the parameters' structure.  The leaves
    require grad only inside this call, so the parameters stay plain
    tensors for serving."""
    leaves, treedef = tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, list(grads)))


def make_train_step(cfg: ModelConfig, optimizer, microbatches: int = 1):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    out)``, ``out = {"loss", "grad_norm", "nll", "tokens"}`` and the
    aux values of ``loss_fn``.

    ``optimizer``: an ``optim.Optimizer``.  ``microbatches > 1`` splits
    the batch along its first axis and accumulates the gradients in the
    parameters' dtype (the reference's ``zeros_like(params)`` carry),
    then divides by their number; the loss is the microbatches' mean and
    ``nll`` / ``tokens`` the last microbatch's, as the reference reports
    them.  The parameters and the state are updated in place."""

    def step(params, opt_state, batch):
        if microbatches > 1:
            parts = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                     for i in range(microbatches)]
            gsum = None
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for part in parts:
                loss_i, metrics, g = _grads_of(params, cfg, part)
                g_leaves, treedef = tree_flatten(g)
                gsum = g_leaves if gsum is None else [
                    a + x for a, x in zip(gsum, g_leaves)]
                lsum = lsum + loss_i
            grads = tree_unflatten(treedef, [a / microbatches
                                             for a in gsum])
            loss = lsum / microbatches
        else:
            loss, metrics, grads = _grads_of(params, cfg, batch)
        params, opt_state, gnorm = optimizer.update(params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return step


def make_eval_step(cfg: ModelConfig):
    """``step(params, batch) -> (loss, metrics)``, without gradients."""

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, cfg, batch)

    return step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_prefill(cfg: ModelConfig):
    """prefill(params, batch, state) -> (last-position logits (B, 1, V),
    state).

    Runs the full forward on the prompt (``batch``: ``tokens``, and
    whisper's ``frames`` or a VLM's ``patch_embeds``) while writing the
    KV caches, the cross caches and the recurrent states, so decode
    continues from ``pos = prompt_len`` (a VLM's ``n_patches +
    prompt_len``: the patches prefix the prompt)."""

    def prefill(params, batch, state):
        x, new_state, _ = forward(params, cfg, batch, state=state,
                                  cache_pos=0)
        return lm_logits(params, x[:, -1:, :]), new_state

    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, state, token, pos) -> (logits (B, 1, V), state).

    One decode step: ``token`` (B, 1) at position ``pos`` (an int) given
    states filled up to ``pos``."""

    def serve_step(params, state, token, pos: int):
        x, new_state, _ = forward(params, cfg, {"tokens": token},
                                  state=state, cache_pos=pos)
        return lm_logits(params, x), new_state

    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs for the dry run (``"meta"`` tensors: no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """``"meta"`` stand-ins for every model input of a shape cell: a
    decode cell's ``(B, 1)`` int32 token; otherwise int32 ``tokens``
    (and ``labels`` to train), with a VLM's ``patch_embeds`` (its
    patches count toward the cell's sequence) and whisper's ``frames``
    (``encoder_seq`` long) in the model's dtype."""
    b = shape.global_batch

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": sd((b, 1), torch.int32)}
    dtype = torch_dtype(cfg.dtype)
    s = shape.seq_len
    specs: Dict = {}
    if cfg.n_patches:
        specs["patch_embeds"] = sd((b, cfg.n_patches, STUB_WIDTH), dtype)
        s = s - cfg.n_patches
    if cfg.encoder_seq:
        specs["frames"] = sd((b, cfg.encoder_seq, STUB_WIDTH), dtype)
    specs["tokens"] = sd((b, s), torch.int32)
    if shape.kind == "train":
        specs["labels"] = sd((b, s), torch.int32)
    return specs


def abstract_params(cfg: ModelConfig):
    """``(params, specs)`` on ``"meta"`` (``transformer.abstract_model``)."""
    return abstract_model(cfg)


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig):
    """The decode state of ``shape.global_batch`` rows and
    ``shape.seq_len`` positions on ``"meta"``."""
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             abstract=True)


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The reference's logical axis names of every decode-state leaf, in
    the state's tree (a ``KVCache`` of two name tuples per attention
    layer): KV caches shard (batch, kv_seq), recurrent states their
    channel axis, whisper's cross caches batch only.  The port's
    per-layer leaves have no ``"stack"`` axis.  No mesh is needed: the
    names are data that a placement maps to devices."""
    def cache(c: KVCache, cross: bool) -> KVCache:
        nd = c.k.dim()
        names = (("batch",) + (None,) * (nd - 1) if cross else
                 ("batch", "kv_seq") + (None,) * (nd - 2))
        return KVCache(names, names, c.ring)

    recurrent = {"conv": ("batch", None, "d_inner"),
                 "ssm": ("batch", "d_inner", None),
                 "h": ("batch", "d_inner")}
    state = abstract_decode_state(cfg, shape)
    out = {"layers": [cache(st, False) if isinstance(st, KVCache)
                      else {k: recurrent[k] for k in st}
                      for st in state["layers"]]}
    if "cross" in state:
        out["cross"] = [cache(c, True) for c in state["cross"]]
    return out
