"""Rank workers of ``tests/test_torch_serve_ranks.py``: the function each
rank process runs (``launch.mesh.spawn_ranks``).  It imports torch and
the port only, never jax, so a rank starts in a few seconds.

The job is a ``torch.save`` of the cases that the test made from the
reference.  Every rank runs every case on every mesh in the same order
(the ranks meet in each collective: one process group, a mesh attached
over it per leg) and writes ``result_{rank}.json``: per case, a list of
what differs (empty when nothing does) and the figures the test reads.
A rank that raises ends the job (``spawn_ranks`` raises
``RankFailure``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch

from repro_torch.core.halo import Transport
from repro_torch.data.pipeline import rank_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import serve_batch, serve_rules
from repro_torch.launch.train import rules_for
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import param_specs
from repro_torch.optim import adamw, constant
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_flatten

from _torch_lm_ranks import LEAF_TOL, LOSS_TOL, LR, leaf_errors

LOGIT_TOL = 1e-4      # of the largest |logit|, float32
STATE_TOL = 1e-5      # decode-state leaves, float32 (rtol and atol)
SERVE_MESHES = {"2x2": ((2, 2), ("data", "model")),
                "1x4": ((1, 4), ("data", "model"))}
TRAIN_MESH = ((2, 1, 2), ("pod", "data", "model"))
# served on 2x2 with the prompt's positions split over model (seq): the
# dense model, the d_inner mixer, the encoder's frames
SEQ_SERVE = ("qwen2-1.5b", "falcon-mamba-7b", "whisper-small")


def attached(shape, axes):
    """The mesh (shape, axes) over this process group with its
    collectives (gloo, CPU tensors)."""
    return C.attach(make_host_mesh(shape, axes), Transport("gloo", "cpu"))


def logit_gap(want: torch.Tensor, got: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def state_errors(want: dict, got: dict, what: str) -> list:
    """Each leaf of the decode state ``got`` against ``want`` (both
    whole), within ``STATE_TOL``."""
    bad = []
    pairs = zip(tt.decode_state_leaves(want), tt.decode_state_leaves(got))
    for i, ((w, n), (g, _)) in enumerate(pairs):
        if w.shape != g.shape or not torch.allclose(g, w, rtol=STATE_TOL,
                                                    atol=STATE_TOL):
            d = float((g - w).abs().max()) if w.shape == g.shape else None
            bad.append(f"{what} leaf {i} {n}: {d}")
    return bad


def rank_serve(case: dict, rules, params, inputs: dict, gen: int,
               max_len: int):
    """Prefill this rank's slice of ``inputs``, then ``gen`` greedy steps
    on ranks: ``(logits, tokens, state after the prefill (gathered),
    state at the end)``."""
    cfg, b = case["cfg"], inputs["tokens"].shape[0]
    start = cfg.n_patches + inputs["tokens"].shape[1]
    state = tt.init_decode_state(cfg, b, max_len, device="cpu", rules=rules)
    lg, state = tm.make_prefill(cfg, rules)(params, rank_batch(inputs,
                                                               rules), state)
    # a leaf that no axis splits is gathered as itself: copy it before
    # decode writes the state in place
    after_prefill = _clone_state(tt.gather_decode_state(state, rules))
    step = tm.make_serve_step(cfg, rules)
    logits, toks = [lg], []
    for i in range(gen):
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        toks.append(tok)
        lg, state = step(params, state, tok, start + i)
        logits.append(lg)
    return logits, torch.cat(toks, dim=1), after_prefill, state


def one_serve(case: dict, inputs: dict, tokens: torch.Tensor,
              max_len: int):
    """The one-process port's prefill and decode of ``inputs`` with
    ``tokens`` fed: its state after the prefill and at the end."""
    cfg, params = case["cfg"], case["params"]
    start = cfg.n_patches + inputs["tokens"].shape[1]
    state = tt.init_decode_state(cfg, tokens.shape[0], max_len,
                                 device="cpu")
    _, state = tm.make_prefill(cfg)(params, inputs, state)
    after_prefill = _clone_state(state)
    step = tm.make_serve_step(cfg)
    for i in range(tokens.shape[1]):
        _, state = step(params, state, tokens[:, i:i + 1], start + i)
    return after_prefill, state


def _clone_state(state: dict) -> dict:
    return tt._map_named(lambda x, n: x.clone(), state,
                         tt.decode_state_names(state))


def case_serve(case: dict, mesh, seq=None) -> dict:
    """One reduced config served on ``mesh`` under ``serve_rules``
    (``seq``: the axis that splits the prompt's positions) against the
    reference (logits and greedy tokens), the one-process port (the
    decode state after the prefill and at the end) and the dry run's
    bytes; its blocks against the whole parameters."""
    cfg, inputs = case["cfg"], case["inputs"]
    b, gen, max_len = inputs["tokens"].shape[0], case["gen"], \
        case["max_len"]
    rules = dataclasses.replace(serve_rules(cfg, mesh, b, max_len), seq=seq)
    if seq is not None:
        mesh.comm.reset_stats()
    specs = param_specs(case["params"])
    blocks = S.block_tree(case["params"], specs, rules)
    bad = []
    # the blocks: the whole back, bit for bit; their bytes the dry run's
    whole = S.gather_tree(blocks, specs, rules)
    for i, (w, g) in enumerate(zip(tree_flatten(case["params"])[0],
                                   tree_flatten(whole)[0])):
        if not torch.equal(w, g):
            bad.append(f"gathered leaf {i} differs")
    held = sum(x.numel() * x.element_size()
               for x in tree_flatten(blocks)[0])
    counted = S.rank_nbytes(case["params"], specs, rules)
    if held != counted:
        bad.append(f"rank_nbytes {counted} vs {held} B held")
    logits, toks, st_pre, st_end = rank_serve(case, rules, blocks, inputs,
                                              gen, max_len)
    want_rows = S.block(case["ref_tokens"], ("batch", None), rules)
    if not torch.equal(toks, want_rows):
        bad.append(f"tokens {toks.tolist()} vs {want_rows.tolist()}")
    gaps = []
    for i, (lg, ref) in enumerate(zip(logits, case["ref_logits"])):
        ref = S.block(ref, ("batch", None, None), rules)
        if not bool(torch.isfinite(lg).all()):
            bad.append(f"step {i}: logits not finite")
        gaps.append(logit_gap(ref, lg))
    if not max(gaps) <= LOGIT_TOL:
        bad.append(f"logit gaps {gaps}")
    one_pre, one_end = one_serve(case, inputs, case["ref_tokens"], max_len)
    bad += state_errors(one_pre, st_pre, "prefill state")
    bad += state_errors(one_end, tt.gather_decode_state(st_end, rules),
                        "final state")
    state_bytes = sum(x.numel() * x.element_size()
                      for x, _ in tt.decode_state_leaves(st_end))
    planned = dryrun.rank_bytes(cfg, rules, serving=ShapeConfig(
        "serve", max_len, b, "decode"))["decode_state"]
    if state_bytes != planned:
        bad.append(f"decode state {state_bytes} B vs the dry run's "
                   f"{planned}")
    return {"errors": bad, "gaps": gaps,
            "kv_seq": rules.kv_seq, "heads": rules.heads,
            "seq_calls": mesh.comm.stats.get("seq", {}).get("calls", 0)}


def case_two_part(case: dict, mesh) -> dict:
    """A prefill in two parts, the second at ``cache_pos > 0`` (whisper's
    frames and a VLM's patches with the first part), on ranks against
    the same two parts in one process: the last logits and every
    decode-state leaf."""
    cfg, inputs = case["cfg"], case["inputs"]
    b, max_len = inputs["tokens"].shape[0], case["max_len"]
    half = inputs["tokens"].shape[1] // 2
    first = dict(inputs, tokens=inputs["tokens"][:, :half])
    rest = {"tokens": inputs["tokens"][:, half:]}
    pos = cfg.n_patches + half
    rules = serve_rules(cfg, mesh, b, max_len)
    blocks = S.block_tree(case["params"], param_specs(case["params"]),
                          rules)

    def two_parts(params, rules_, part1, part2, state):
        _, state = tm.make_prefill(cfg, rules_)(params, part1, state)
        x, state, _ = tt.forward(params, cfg, part2, state=state,
                                 cache_pos=pos, rules=rules_)
        return tm.serve_logits(params, x[:, -1:], rules_), state
    want_lg, want_st = two_parts(
        case["params"], None, first, rest,
        tt.init_decode_state(cfg, b, max_len, device="cpu"))
    lg, st = two_parts(blocks, rules, rank_batch(first, rules),
                       rank_batch(rest, rules),
                       tt.init_decode_state(cfg, b, max_len, device="cpu",
                                            rules=rules))
    gap = logit_gap(S.block(want_lg, ("batch", None, None), rules), lg)
    bad = [] if gap <= LOGIT_TOL else [f"two-part logits {gap}"]
    bad += state_errors(want_st, tt.gather_decode_state(st, rules),
                        "two-part state")
    return {"errors": bad, "gap": gap}


def case_serve_batch(job: dict, mesh) -> dict:
    """``launch.serve.serve_batch(mesh=)`` against one process: the same
    tokens on every rank."""
    kw = dict(device="cpu")
    arch, b, prompt, gen = job["arch"], job["batch"], job["prompt"], \
        job["gen"]
    one = serve_batch(arch, b, prompt, gen, **kw)
    ranks = serve_batch(arch, b, prompt, gen, mesh=mesh, **kw)
    bad = []
    if (ranks["tokens"] != one["tokens"]).any():
        bad.append(f"tokens {ranks['tokens'].tolist()} vs one process "
                   f"{one['tokens'].tolist()}")
    calls = {stage: sum(c["calls"] for c in chans.values())
             for stage, chans in ranks["collectives"].items()}
    return {"errors": bad, "calls": calls}


def case_train(case: dict, mesh) -> dict:
    """One AdamW step of a reduced config on (pod 2, data 1, model 2)
    against the one-process step: the loss within ``LOSS_TOL``, every
    leaf within ``LEAF_TOL`` (the flat-gradient elements within lr)."""
    cfg, params = case["cfg"], case["params"]
    rules = rules_for(cfg, mesh)
    specs = param_specs(params)
    blocks = S.block_tree(params, specs, rules)
    opt = adamw(constant(LR))
    blocks, _, out = tm.make_train_step(cfg, opt, rules=rules)(
        blocks, opt.init(blocks), rank_batch(case["batch"], rules))
    bad = []
    if not abs(float(out["loss"]) - case["loss"]) <= LOSS_TOL * abs(
            case["loss"]):
        bad.append(f"loss {float(out['loss'])} vs {case['loss']}")
    bad += leaf_errors(case["p1"], blocks, specs, rules, LEAF_TOL, "leaf",
                       case["grads"])
    return {"errors": bad, "loss": float(out["loss"])}


def worker(rank: int, world: int, job_path: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    out = {}
    for name, (shape, axes) in SERVE_MESHES.items():
        mesh = attached(shape, axes)
        for key, case in job["serve"].items():
            out[f"serve/{key}/{name}"] = case_serve(case, mesh)
            if case.get("two_part"):
                out[f"two_part/{key}/{name}"] = case_two_part(case, mesh)
        if name == "2x2":
            out["serve_batch"] = case_serve_batch(job["serve_batch"], mesh)
            for key in SEQ_SERVE:
                out[f"serve_seq/{key}"] = case_serve(job["serve"][key], mesh,
                                                     seq="model")
            for key, case in job["serve_seq_odd"].items():
                out[f"serve_seq_odd/{key}"] = case_serve(case, mesh,
                                                         seq="model")
    mesh = attached(*TRAIN_MESH)
    for key, case in job["train"].items():
        out[f"train/{key}"] = case_train(case, mesh)
    assert all(math.isfinite(g) for r in out.values()
               for g in r.get("gaps", []))
    Path(job_path).with_name(f"result_{rank}.json").write_text(
        json.dumps(out))
