"""Rank workers of ``tests/test_torch_lm_ranks.py``: the function each
rank process runs (``launch.mesh.spawn_ranks``).  It imports torch and
the port only, never jax, so a rank starts in a few seconds.

The job is a ``torch.save`` of the cases that the test made from the
reference; every rank runs every case in the same order (the ranks meet
in each collective) and writes ``result_{rank}.json``: per case, a list
of what differs from the reference (empty when nothing does) and the
figures the test reads.  A rank that raises ends the job
(``spawn_ranks`` raises ``RankFailure``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.core.halo import Transport
from repro_torch.data.pipeline import rank_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.models import model as tm
from repro_torch.models.layers import logical_names
from repro_torch.models.moe import _apply_moe_ep
from repro_torch.models.transformer import param_specs, stack_groups
from repro_torch.optim import adafactor, adamw, constant
from repro_torch.optim.compression import (CompressedAllReduce,
                                           init_residuals)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_flatten

# the reference tests' tolerances (tests/test_multidevice.py)
EP_TOL, EP_GRAD_TOL = 2e-5, 5e-4
LOSS_TOL, LEAF_TOL, GNORM_TOL = 1e-5, 2e-5, 5e-5
POD_PARAM_TOL = 5e-3
LR = 1e-3
FLAT_GRAD = 1e-6          # 100 x AdamW's eps


def mesh_rules(shape, axes):
    """The mesh of this process group (shape, axes) with its collectives
    (gloo, CPU tensors), and the reference's default rules for it."""
    mesh = C.attach(make_host_mesh(shape, axes), Transport("gloo", "cpu"))
    return mesh, S.rules_for_mesh(mesh)


def rel_err(want: torch.Tensor, got: torch.Tensor) -> float:
    """|got - want| over |want| (norms of the whole leaf)."""
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def leaf_errors(want_tree, got_tree, specs, rules, tol: float,
                what: str, grads=None) -> list:
    """Each leaf of ``got_tree`` (this rank's blocks) against its block
    of ``want_tree`` (whole tensors): the relative error norm.

    With ``grads`` (the reference's gradient, whole) the leaves are
    parameters after one AdamW step, whose first update is
    ``lr * g / (|g| + 1e-8)``: where the gradient lies within
    ``FLAT_GRAD`` of zero that quotient turns the gradient's rounding
    (about 1e-6 of the leaf's) into a move of up to ``lr``.  Those
    elements are held to ``lr`` and the rest to ``tol``."""
    bad = []
    for i, (w, g, n) in enumerate(zip(tree_flatten(want_tree)[0],
                                      tree_flatten(got_tree)[0],
                                      S.spec_leaves(specs))):
        w = S.block(w, n, rules)
        if grads is not None:
            flat = S.block(tree_flatten(grads)[0][i], n, rules).abs() \
                < FLAT_GRAD
            far = float((g - w).abs()[flat].max()) if flat.any() else 0.0
            if not far <= LR:
                bad.append(f"{what} {n}: {far:.3g} where |g| < {FLAT_GRAD}")
            g = torch.where(flat, w, g)
        e = rel_err(w, g)
        if not e <= tol:
            bad.append(f"{what} {n}: {e:.3g}")
    return bad


COUNTED = ("calls", "bytes_sent", "bytes_received")


def counts(stats: dict) -> dict:
    """Each channel's calls and bytes of ``stats``
    (``Collectives.stats``), without the seconds."""
    return {ch: {f: v[f] for f in COUNTED} for ch, v in stats.items()}


def dry_counts(rules, make_step, args) -> dict:
    """The dry run of a step on this rank's coordinates: ``make_step``
    (a function of the rules) under ``rules`` on a mesh of shapes with
    ``DryCollectives``, run once on ``"meta"`` copies of ``args``
    (``launch.dryrun.trace_rank_step``): each channel's calls and
    bytes."""
    mesh = rules.mesh
    dry = C.attach_dry(RankMesh(mesh.shape, mesh.axis_names, mesh.rank))
    _, stats = dryrun.trace_rank_step(
        make_step(dataclasses.replace(rules, mesh=dry)),
        dryrun.meta_like(args), dry)
    return counts(stats)


def rank_grads(blocks, cfg, batch, rules):
    """This rank's gradient blocks of the loss, as the train step
    computes them (before clipping)."""
    specs = param_specs(blocks)
    _, _, grads = tm._grads_of(blocks, cfg, batch, rules, tm._seed(rules))
    return tm.sync_grads(grads, specs, rules, S.rule_axes(rules))


def case_ep(job: dict) -> dict:
    """The EP dispatch on a (data 4, model 2) mesh against the
    reference's dense dispatch: y and the gradients of sum(sin(y))."""
    mesh, rules = mesh_rules((4, 2), ("data", "model"))
    cfg = job["cfg"]
    names = {k: logical_names("moe", k) for k in job["p"]}
    p = {k: S.block(v, names[k], rules).requires_grad_(True)
         for k, v in job["p"].items()}
    x = S.block(job["x"], ("batch", None, None), rules)
    with torch.enable_grad():
        y, aux = _apply_moe_ep(p, cfg, x, rules)
        aux = {k: v.detach() for k, v in aux.items()}
        # the objective sums over every token; y is whole on the model
        # ranks, so each holds 1 / model of its share
        share = torch.sin(y).sum() / mesh.axis_size("model")
        grads = torch.autograd.grad(share, list(p.values()))
    grads = tm.sync_grads(dict(zip(p, grads)), names, rules)
    bad = []
    want_y = S.block(job["y"], ("batch", None, None), rules)
    if not torch.allclose(y.detach(), want_y, rtol=EP_TOL, atol=EP_TOL):
        bad.append(f"y: {float((y - want_y).abs().max()):.3g}")
    for k, g in grads.items():
        want = S.block(job["grads"][k], names[k], rules)
        if not torch.allclose(g, want, rtol=EP_GRAD_TOL, atol=EP_GRAD_TOL):
            bad.append(f"grad {k}: {float((g - want).abs().max()):.3g}")
    for k in ("load_balance", "router_z"):
        if abs(float(aux[k]) - job["aux"][k]) > EP_TOL * abs(job["aux"][k]):
            bad.append(f"{k}: {float(aux[k])} vs {job['aux'][k]}")
    return {"errors": bad, "frac_dropped": float(aux["frac_dropped"])}


def case_train(job: dict) -> dict:
    """The dense config's loss and one AdamW step on (data 4, model 2)."""
    mesh, rules = mesh_rules((4, 2), ("data", "model"))
    cfg, params = job["cfg"], job["params"]
    specs = param_specs(params)
    blocks = S.block_tree(params, specs, rules)
    batch = rank_batch(job["batch"], rules)
    bad = []
    loss, _ = tm.make_eval_step(cfg, rules)(blocks, batch)
    if abs(float(loss) - job["loss"]) > LOSS_TOL * abs(job["loss"]):
        bad.append(f"loss {float(loss)} vs {job['loss']}")
    bad += leaf_errors(job["grads"], rank_grads(blocks, cfg, batch, rules),
                       specs, rules, LEAF_TOL, "gradient")
    opt = adamw(constant(LR))
    state = opt.init(blocks)
    held = {"params": sum(x.numel() * x.element_size()
                          for x in tree_flatten(blocks)[0]),
            "optimizer": sum(x.numel() * x.element_size()
                             for x in tree_flatten(state)[0])}
    dry = dry_counts(rules, lambda r: tm.make_train_step(cfg, opt, rules=r),
                     (blocks, state, batch))
    mesh.comm.reset_stats()
    blocks, state, out = tm.make_train_step(cfg, opt, rules=rules)(
        blocks, state, batch)
    measured = counts(mesh.comm.stats)
    if abs(float(out["loss"]) - job["loss"]) > LOSS_TOL * abs(job["loss"]):
        bad.append(f"step loss {float(out['loss'])} vs {job['loss']}")
    if abs(float(out["grad_norm"]) - job["grad_norm"]) \
            > GNORM_TOL * job["grad_norm"]:
        bad.append(f"grad_norm {float(out['grad_norm'])} vs "
                   f"{job['grad_norm']}")
    bad += leaf_errors(job["p1"], blocks, specs, rules, LEAF_TOL, "leaf",
                       job["grads"])
    want = dryrun.rank_bytes(cfg, rules, opt)
    return {"errors": bad, "held_bytes": held,
            "dryrun_bytes": {k: want[k] for k in held},
            "measured": measured, "dry": dry}


def case_train_seq(job: dict) -> dict:
    """The dense config's AdamW step on (data 4, model 2) with the
    positions split over ``model`` (``seq``): the loss, the grad norm
    and every leaf as ``case_train`` holds them.  The job's length need
    not divide over ``model``."""
    mesh, rules = mesh_rules((4, 2), ("data", "model"))
    rules = dataclasses.replace(rules, seq="model")
    cfg, params = job["cfg"], job["params"]
    specs = param_specs(params)
    blocks = S.block_tree(params, specs, rules)
    opt = adamw(constant(LR))
    state, batch = opt.init(blocks), rank_batch(job["batch"], rules)
    dry = dry_counts(rules, lambda r: tm.make_train_step(cfg, opt, rules=r),
                     (blocks, state, batch))
    mesh.comm.reset_stats()
    blocks, _, out = tm.make_train_step(cfg, opt, rules=rules)(
        blocks, state, batch)
    bad = []
    for key, tol in (("loss", LOSS_TOL), ("grad_norm", GNORM_TOL)):
        if abs(float(out[key]) - job[key]) > tol * abs(job[key]):
            bad.append(f"{key} {float(out[key])} vs {job[key]}")
    bad += leaf_errors(job["p1"], blocks, specs, rules, LEAF_TOL, "leaf",
                       job["grads"])
    return {"errors": bad, "seq_calls": mesh.comm.stats["seq"]["calls"],
            "length": job["batch"]["tokens"].shape[1],
            "measured": counts(mesh.comm.stats), "dry": dry}


def adafactor_steps(job: dict, rules) -> tuple:
    """``ADAFACTOR_STEPS`` Adafactor steps (over the config's stack
    groups) of this rank's blocks of the job's parameters, on its slices
    of the job's batches, the collectives counted from zero: (per-step
    outs, blocks, state, held bytes, the optimizer, the dry run's
    counts of the same steps)."""
    cfg = job["cfg"]
    specs = param_specs(job["params"])
    blocks = S.block_tree(job["params"], specs, rules)
    opt = adafactor(constant(LR), stacks=stack_groups(cfg))
    state = opt.init(blocks)
    held = sum(x.numel() * x.element_size()
               for x in tree_flatten(state)[0])
    batches = [rank_batch(b, rules) for b in job["batches"]]

    def steps(r):
        def run(blocks, state, batches):
            step = tm.make_train_step(cfg, opt, rules=r)
            return [step(blocks, state, b)[2] for b in batches]
        return run
    dry = dry_counts(rules, steps, (blocks, state, batches))
    rules.mesh.comm.reset_stats()
    outs = [{k: float(out[k]) for k in ("loss", "grad_norm")}
            for out in steps(rules)(blocks, state, batches)]
    return outs, blocks, state, held, opt, dry


def case_adafactor(jobs: dict, seqs=(None, "model")) -> dict:
    """Each reduced config's Adafactor steps on (pod 2, data 2, model 2)
    (the dry run's rules: FSDP over ``data``, heads, MLP, experts and
    vocabulary over ``model``), then the same with the positions split
    over ``model`` (``seq``), against the reference's single-device
    steps: every loss within ``LOSS_TOL``, every grad norm within
    ``GNORM_TOL``, every parameter block and every moment block
    (``row`` / ``col`` / ``full``, ``Optimizer.state_specs``) within
    ``LEAF_TOL``; the moments' bytes the dry run's.  ``seqs``: the legs'
    ``seq`` axes.  A job's positions need not divide over ``model``."""
    mesh, _ = mesh_rules((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for arch, job in jobs.items():
        cfg = job["cfg"]
        for seq in seqs:
            rules = dataclasses.replace(dryrun._rules_for(cfg, mesh)[0],
                                        seq=seq)
            outs, blocks, state, held, opt, dry = adafactor_steps(job,
                                                                  rules)
            bad = []
            for i, (got, want) in enumerate(zip(outs, job["outs"])):
                for key, tol in (("loss", LOSS_TOL),
                                 ("grad_norm", GNORM_TOL)):
                    if abs(got[key] - want[key]) > tol * abs(want[key]):
                        bad.append(f"step {i} {key} {got[key]} vs "
                                   f"{want[key]}")
            specs = param_specs(job["params"])
            bad += leaf_errors(job["p_end"], blocks, specs, rules, LEAF_TOL,
                               "leaf")
            bad += leaf_errors(job["v_end"], state["v"],
                               opt.state_specs(specs)["v"], rules, LEAF_TOL,
                               "moment")
            stats = mesh.comm.stats
            out[f"{arch}/{seq}"] = {
                "errors": bad, "losses": [o["loss"] for o in outs],
                "held_bytes": held,
                "dryrun_bytes": dryrun.rank_bytes(cfg, rules, opt)[
                    "optimizer"],
                "opt_calls": stats.get("opt", {}).get("calls", 0),
                "seq_calls": stats.get("seq", {}).get("calls", 0),
                "measured": counts(stats), "dry": dry}
    return out


def case_pod(job: dict) -> dict:
    """(pod 2, data 2, model 2): the exact rank step, then six
    compressed pod steps held to the reference's docstring."""
    mesh, rules = mesh_rules((2, 2, 2), ("pod", "data", "model"))
    cfg, params = job["cfg"], job["params"]
    specs = param_specs(params)
    batch = rank_batch(job["batch"], rules)
    opt = adamw(constant(LR))
    blocks = S.block_tree(params, specs, rules)
    state = opt.init(blocks)
    exact, _, out = tm.make_train_step(cfg, opt, rules=rules)(
        blocks, state, batch)
    bad = leaf_errors(job["p1"], exact, specs, rules, LEAF_TOL,
                      "exact leaf", job["grads"])
    if abs(float(out["loss"]) - job["loss"]) > LOSS_TOL * abs(job["loss"]):
        bad.append(f"exact loss {float(out['loss'])} vs {job['loss']}")
    blocks = S.block_tree(params, specs, rules)
    state = opt.init(blocks)
    resid = init_residuals(blocks)
    dry = dry_counts(rules, lambda r: tm.make_compressed_pod_train_step(
        cfg, r, opt), (blocks, state, resid, batch))
    step = tm.make_compressed_pod_train_step(cfg, rules, opt)
    comm = mesh.comm
    losses, wire, d, measured = [], [], None, []
    for i in range(6):
        comm.reset_stats()
        blocks, state, resid, o = step(blocks, state, resid, batch)
        losses.append(float(o["loss"]))
        wire.append(comm.stats["pod"]["bytes_sent"])
        measured.append(counts(comm.stats))
        if i == 0:
            d = max(float((S.block(w, n, rules) - g).abs().max())
                    for w, g, n in zip(tree_flatten(job["p1"])[0],
                                       tree_flatten(blocks)[0],
                                       S.spec_leaves(specs)))
    if abs(losses[0] - float(out["loss"])) > LOSS_TOL:
        bad.append(f"compressed loss {losses[0]} vs exact "
                   f"{float(out['loss'])}")
    if not d < POD_PARAM_TOL:
        bad.append(f"compressed params {d} from the exact step's")
    if not losses[-1] < losses[0]:
        bad.append(f"losses do not fall: {losses}")
    car = CompressedAllReduce()
    want_wire = sum(car.wire_bytes(x.numel())
                    for x in tree_flatten(blocks)[0])
    if any(w != want_wire for w in wire):
        bad.append(f"pod wire {wire} B a step, wire_bytes {want_wire}")
    if any(m != measured[0] for m in measured):
        bad.append("the compressed steps' collectives differ step to step")
    return {"errors": bad, "losses": losses, "max_param_diff": d,
            "measured": measured[0], "dry": dry}


def case_compression(job: dict) -> dict:
    """``CompressedAllReduce`` across two pods, each pod's gradient and
    residual from the job: the mean and the new residual bit for bit
    the reference's ``psum(sent) / n`` (the reference under ``vmap``
    over its pod axis); the payload ``wire_bytes``."""
    mesh, _ = mesh_rules((2, 2, 2), ("pod", "data", "model"))
    pod = mesh.axis_index("pod")
    car = CompressedAllReduce()
    bad = []
    for i, c in enumerate(job["cases"]):
        mesh.comm.reset_stats()
        avg, res = car(c["g"][pod], c["r"][pod], mesh)
        for what, got, want in (("mean", avg, c["avg"]),
                                ("residual", res, c["res"][pod])):
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                bad.append(f"case {i} {what} differs")
        sent = mesh.comm.stats["pod"]["bytes_sent"]
        if sent != car.wire_bytes(c["g"][pod].numel()):
            bad.append(f"case {i}: {sent} B on the wire")
    return {"errors": bad}


CASES = {"ep": case_ep, "train": case_train, "pod": case_pod,
         "compression": case_compression, "train_seq": case_train_seq,
         "train_seq_odd": case_train_seq, "adafactor": case_adafactor,
         "adafactor_odd": lambda jobs: case_adafactor(jobs, ("model",))}


def worker(rank: int, world: int, job_path: str) -> None:
    torch.set_num_threads(1)
    jobs = torch.load(job_path, weights_only=False)
    out = {name: CASES[name](jobs[name]) for name in CASES}
    Path(job_path).with_name(f"result_{rank}.json").write_text(
        json.dumps(out))
