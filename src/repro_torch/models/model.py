"""Public model API of the LM stack (the port of ``repro.models.model``):
the chunked loss, the train and eval steps, prefill and decode.

The reference's functions take sharding ``rules``; here ``rules`` is
an optional keyword: None is one card, and rules with a rank mesh
(``parallel.sharding.MeshRules``) train and evaluate on the ranks of a
process group, each rank with its block of every parameter (the
``param_specs`` names) and its slice of the batch
(``data.pipeline.rank_batch``); ``make_compressed_pod_train_step``
carries the gradient across pods in int8, and ``make_prefill`` /
``make_serve_step`` serve from this rank's blocks of the decode state
(KV caches split by sequence, ``kv_seq``).  The abstract inputs of a shape cell
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

from ..parallel.collectives import (all_gather, all_gather_plain,
                                    all_reduce_plain, gather_dim,
                                    index_along, psum, psum_over)
from ..parallel.sharding import (live_axes, on_ranks, replicated_axes,
                                 rule_axes, spec_leaves)
from ..tree import tree_flatten, tree_unflatten
from .config import ModelConfig, ShapeConfig
from .frontends import STUB_WIDTH
from .layers import torch_dtype
from .transformer import (abstract_model, decode_state_names, forward,
                          init_decode_state, logits as lm_logits,
                          own_positions, prefix_len, seq_axes,
                          whole_positions)


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


def _chunk_nll_ranks(table, xc, lc, rules):
    """``_chunk_nll`` with the vocabulary split over the vocab axes:
    ``table`` is this rank's rows.  The logsumexp takes the max and the
    sum across the ranks (the max without a gradient: it cancels), the
    label's logit comes from the rank that holds it; every padded row
    counts in the logsumexp, as the reference's."""
    lg = lm_logits({"embed": {"table": table}}, xc).to(torch.float32)
    v_loc = table.shape[0]
    m = all_reduce_plain(lg.detach().amax(dim=-1), rules.mesh,
                         rules.axis("vocab"), op="max", channel="tp")
    s = psum_over(torch.exp(lg - m[..., None]).sum(dim=-1), rules,
                  "vocab", "tp")
    lse = m + torch.log(s)
    valid = lc >= 0
    lab = lc.long() - index_along(rules, "vocab")[0] * v_loc
    mine = valid & (lab >= 0) & (lab < v_loc)
    picked = torch.gather(lg, -1, torch.where(mine, lab, torch.zeros_like(
        lab))[..., None])[..., 0]
    picked = psum_over(torch.where(mine, picked, torch.zeros_like(picked)),
                       rules, "vocab", "tp")
    return torch.where(valid, lse - picked, torch.zeros_like(lse)).sum()


def chunked_xent(p, cfg: ModelConfig, x, labels, rules=None,
                 seq_gather=()):
    """x: (B, S, d) final hidden; labels: (B, S) integer, -1 = masked.

    Returns (sum_nll float32, n_valid int32), chunk by chunk of
    ``cfg.loss_chunk`` positions.  Under autograd each chunk runs under
    ``torch.utils.checkpoint``: the backward recomputes that chunk's
    logits instead of keeping all of them (the reference's
    ``jax.checkpoint`` scan body).  On ranks the sums are this rank's
    batch slice's (the vocabulary split: ``_chunk_nll_ranks``); under
    sequence parallelism ``x`` and ``labels`` are this rank's padded
    block of positions (the padding labelled -1), joined first with
    those of the ranks along the mesh axes ``seq_gather``."""
    if seq_gather:
        x = all_gather(x, rules.mesh, seq_gather, 1, "seq")
        labels = all_gather_plain(labels, rules.mesh, seq_gather, 1, "seq")
    b, s, _ = x.shape
    chunk = min(cfg.loss_chunk, s)
    table = p["embed"]["table"]
    fn = _chunk_nll
    if on_ranks(rules):
        table = gather_dim(table, rules, "fsdp", 1)
        if index_along(rules, "vocab")[1] > 1:
            def fn(t, xc, lc):
                return _chunk_nll_ranks(t, xc, lc, rules)
    grad = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        nll = nll + (checkpoint(fn, table, xc, lc, use_reentrant=False)
                     if grad else fn(table, xc, lc))
    n = (labels >= 0).sum(dtype=torch.int32)
    return nll, n


def loss_fn(params, cfg: ModelConfig, batch: Dict, rules=None):
    """(loss, metrics): the mean next-token loss over the valid labels,
    plus ``router_aux_coef * load_balance + 1e-4 * router_z`` for a MoE
    config (the aux values summed over the layers, as the reference adds
    them); ``metrics`` = ``{"nll", "tokens"}`` and the aux values.  On
    ranks the loss is the global ``sum nll / sum n`` over the batch
    axes, the same on every rank.  Under sequence parallelism each rank
    scores its own block of positions: its labels padded with -1 and
    cut as ``forward`` pads and cuts the stream (a VLM's prefix -1 too),
    so the padding scores nothing and the sums, run over the seq axes
    too, are the one-card loss at any length.  Where the seq axes also
    split the vocabulary (the vocabulary's logsumexp needs the same
    positions on every vocab rank), the positions are joined first: all
    of them, the padding sliced off, where every seq axis splits it;
    else along the shared axes, the padding masked."""
    x, _, aux = forward(params, cfg, batch, rules=rules)
    labels = batch["labels"]
    n_prefix = prefix_len(cfg, batch)
    length = n_prefix + labels.shape[1]
    sp = seq_axes(rules, length)
    if sp and n_prefix:
        labels = torch.cat([torch.full_like(labels[:, :1], -1).expand(
            -1, n_prefix), labels], dim=1)
    shared = tuple(a for a in sp if a in live_axes(rules, rules.vocab))
    if sp and shared == sp:
        x, sp, shared = whole_positions(x, rules, sp, length), (), ()
    elif sp:
        labels = own_positions(labels, rules, sp, fill=-1)
    nll, n = chunked_xent(params, cfg, x, labels, rules, shared)
    if on_ranks(rules):
        axes = set(live_axes(rules, rules.batch)) | (set(sp) - set(shared))
        axes = tuple(a for a in rules.mesh.axis_names if a in axes)
        nll = psum(nll, rules.mesh, axes, "loss")
        n = all_reduce_plain(n, rules.mesh, axes, channel="loss")
    loss = nll / torch.clamp(n, min=1)
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux["load_balance"] \
            + 1e-4 * aux["router_z"]
    return loss, {"nll": nll, "tokens": n, **aux}


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def _grads_of(params, cfg: ModelConfig, batch: Dict, rules=None,
              seed: float = 1.0):
    """(loss, metrics, grads): the loss's gradient with respect to every
    parameter leaf, as a tree of the parameters' structure.  The leaves
    require grad only inside this call, so the parameters stay plain
    tensors for serving.  ``seed`` scales the backward's seed: on ranks
    ``1 / R``, R the ranks that hold the loss (``parallel.collectives``),
    so each rank's gradient is its share."""
    leaves, treedef = tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = loss_fn(params, cfg, batch, rules)
            grads = torch.autograd.grad(loss * seed if seed != 1.0
                                        else loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, list(grads)))


def _accumulated(params, cfg, batch, microbatches: int, rules, seed):
    """``_grads_of`` over ``microbatches`` parts of the batch: the
    gradients summed in the parameters' dtype (the reference's
    ``zeros_like(params)`` carry) then divided by their number, the
    loss the parts' mean, the metrics the last part's."""
    if microbatches == 1:
        return _grads_of(params, cfg, batch, rules, seed)
    parts = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                           + tuple(v.shape[1:]))[i]
              for k, v in batch.items()} for i in range(microbatches)]
    gsum = None
    lsum = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    for part in parts:
        loss_i, metrics, g = _grads_of(params, cfg, part, rules, seed)
        g_leaves, treedef = tree_flatten(g)
        gsum = g_leaves if gsum is None else [
            a + x for a, x in zip(gsum, g_leaves)]
        lsum = lsum + loss_i
    return (lsum / microbatches, metrics,
            tree_unflatten(treedef, [a / microbatches for a in gsum]))


def _seed(rules) -> float:
    """1 / the ranks that hold one copy of the loss (those along
    ``rule_axes(rules)``)."""
    return 1.0 / rules.mesh.axis_size(rule_axes(rules))


def sync_grads(grads, specs, rules, within=None, channel: str = "grad"):
    """Each leaf's gradient summed over the mesh axes (of ``within``,
    default all) that hold whole copies of it (``specs``: the leaves'
    logical names); the FSDP dims were summed by their gathers'
    backward.  Returns the tree."""
    leaves, treedef = tree_flatten(grads)
    out = [all_reduce_plain(g, rules.mesh,
                            replicated_axes(names, rules, within),
                            channel=channel)
           for g, names in zip(leaves, spec_leaves(specs))]
    return tree_unflatten(treedef, out)


def make_train_step(cfg: ModelConfig, optimizer, microbatches: int = 1,
                    rules=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    out)``, ``out = {"loss", "grad_norm", "nll", "tokens"}`` and the
    aux values of ``loss_fn``.

    ``optimizer``: an ``optim.Optimizer``.  ``microbatches > 1`` splits
    the batch along its first axis and accumulates the gradients in the
    parameters' dtype (the reference's ``zeros_like(params)`` carry),
    then divides by their number; the loss is the microbatches' mean and
    ``nll`` / ``tokens`` the last microbatch's, as the reference reports
    them.  The parameters and the state are updated in place.

    On ranks (``rules`` with a mesh): ``params`` and ``opt_state`` are
    this rank's blocks, ``batch`` its slice; each rank seeds its
    backward with ``1 / ranks``, sums each leaf's gradient over the axes
    that hold whole copies of it (``sync_grads``), and the optimizer
    takes every reduction over the whole leaf (the global norm,
    Adafactor's factored moments and update clip: ``Optimizer.update(...,
    specs=, rules=)``); its state is this rank's blocks
    (``Optimizer.state_specs``)."""
    from .transformer import param_specs

    def step(params, opt_state, batch):
        if not on_ranks(rules):
            loss, metrics, grads = _accumulated(params, cfg, batch,
                                                microbatches, None, 1.0)
            params, opt_state, gnorm = optimizer.update(params, grads,
                                                        opt_state)
        else:
            specs = param_specs(params)
            loss, metrics, grads = _accumulated(
                params, cfg, batch, microbatches, rules, _seed(rules))
            grads = sync_grads(grads, specs, rules, rule_axes(rules))
            params, opt_state, gnorm = optimizer.update(
                params, grads, opt_state, specs=specs, rules=rules)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return step


def make_eval_step(cfg: ModelConfig, rules=None):
    """``step(params, batch) -> (loss, metrics)``, without gradients (on
    ranks: this rank's blocks and slice, the global loss)."""

    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, cfg, batch, rules)

    return step


def make_compressed_pod_train_step(cfg: ModelConfig, rules, optimizer):
    """Train step with an int8 + error-feedback gradient sync across
    pods (the reference's ``shard_map`` over ``"pod"``).  Inside a pod
    the gradient is reduced exactly, under ``replace(rules,
    batch="data")`` (each pod's loss over its own tokens); across pods
    ``optim.compression.CompressedAllReduce`` carries each leaf with its
    float32 residual; the loss is the mean over the pods.

    ``step(params, opt_state, residuals, batch) -> (params, opt_state,
    residuals, out)``: this rank's blocks, residuals
    (``optim.compression.init_residuals(params)``) and batch slice
    (``data.pipeline.rank_batch`` under ``rules``), all updated in
    place."""
    import dataclasses as dc
    from ..optim.compression import CompressedAllReduce
    from .transformer import param_specs

    mesh = rules.mesh
    if mesh is None or "pod" not in mesh.axis_names:
        raise ValueError("the compressed pod step needs a rank mesh with "
                         "a 'pod' axis")
    inner = dc.replace(rules, batch="data")      # per-pod rules
    car = CompressedAllReduce(axis="pod")
    n_pods = mesh.axis_size("pod")

    def step(params, opt_state, residuals, batch):
        specs = param_specs(params)
        loss, metrics, grads = _grads_of(params, cfg, batch, inner,
                                         _seed(inner))
        grads = sync_grads(grads, specs, inner, rule_axes(inner))
        flat_g, treedef = tree_flatten(grads)
        flat_r = tree_flatten(residuals)[0]
        synced = []
        for g, r in zip(flat_g, flat_r):
            s, nr = car(g, r, mesh)
            synced.append(s.to(g.dtype))
            r.copy_(nr)
        grads = tree_unflatten(treedef, synced)
        loss = all_reduce_plain(loss, mesh, "pod", channel="loss") / n_pods
        params, opt_state, gnorm = optimizer.update(
            params, grads, opt_state, specs=specs, rules=rules)
        return params, opt_state, residuals, {"loss": loss,
                                              "grad_norm": gnorm, **metrics}

    return step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def serve_logits(params, x, rules=None):
    """The padded-vocabulary logits of the hidden ``x`` (B, S, d).  On
    ranks the table is this rank's ``("vocab", "fsdp")`` block: its
    FSDP dim gathered, its vocabulary range's logits gathered over the
    vocab axes, so every rank holds the whole row (whose ``argmax``,
    the first index on ties as the reference's, is then the same token
    on every rank)."""
    if not on_ranks(rules):
        return lm_logits(params, x)
    table = gather_dim(params["embed"]["table"], rules, "fsdp", 1)
    part = lm_logits({"embed": {"table": table}}, x)
    return gather_dim(part, rules, "vocab", part.dim() - 1, "tp")


def make_prefill(cfg: ModelConfig, rules=None):
    """prefill(params, batch, state) -> (last-position logits (B, 1, V),
    state).

    Runs the full forward on the prompt (``batch``: ``tokens``, and
    whisper's ``frames`` or a VLM's ``patch_embeds``) while writing the
    KV caches, the cross caches and the recurrent states, so decode
    continues from ``pos = prompt_len`` (a VLM's ``n_patches +
    prompt_len``: the patches prefix the prompt).  On ranks (``rules``
    with a mesh): this rank's blocks, batch slice and state blocks
    (``init_decode_state(..., rules=)``); the logits are the slice's
    whole rows (``serve_logits``)."""

    def prefill(params, batch, state):
        x, new_state, _ = forward(params, cfg, batch, state=state,
                                  cache_pos=0, rules=rules)
        return serve_logits(params, x[:, -1:, :], rules), new_state

    return prefill


def make_serve_step(cfg: ModelConfig, rules=None):
    """serve_step(params, state, token, pos) -> (logits (B, 1, V), state).

    One decode step: ``token`` (B, 1) at position ``pos`` (an int) given
    states filled up to ``pos`` (on ranks, as ``make_prefill``)."""

    def serve_step(params, state, token, pos: int):
        x, new_state, _ = forward(params, cfg, {"tokens": token},
                                  state=state, cache_pos=pos, rules=rules)
        return serve_logits(params, x, rules), new_state

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
    the state's tree (``transformer.decode_state_names``): KV caches
    shard (batch, kv_seq), recurrent states their channel axis,
    whisper's cross caches batch only.  No mesh is needed: the names
    are data that a placement maps to devices."""
    return decode_state_names(abstract_decode_state(cfg, shape))
