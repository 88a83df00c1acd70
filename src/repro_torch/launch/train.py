"""Runnable training launcher (the port of ``repro.launch.train``): a
reduced ``--arch`` variant trained with the fault-tolerant runtime
(checkpoints, retry, straggler watchdog, preemption) on the synthetic
pipeline, with AdamW (or ``--optimizer adafactor``, over the config's
stack groups) under a warmup-cosine schedule, on one card or on the
ranks of a process group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 200 --ckpt-dir RUN [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 200 --ckpt-dir RUN --nproc 4 [--mesh 2x1x2] \\
        [--transport gloo|nccl] [--optimizer adafactor] \\
        [--seq-axis model] [--device cpu]

A run resumes from the newest checkpoint in ``--ckpt-dir``.  The
parameters and the optimizer state are updated in place (the port
donates nothing), so the first-checkpoint-less retry path rebuilds them
from the seed.

``--nproc N`` spawns N rank processes (``launch.mesh.spawn_ranks``) on
a mesh of ``("data", "model")`` (the reference's host-mesh shape for N,
or ``--mesh DxM``) or ``("pod", "data", "model")`` (``--mesh PxDxM``):
each builds the whole model from the seed and keeps its blocks under the
rules of ``rules_for`` (tensor-, expert- and FSDP-parallel,
``parallel.sharding``), takes its slice of each batch, and runs
``models.model.make_train_step(..., rules=)``.  Checkpoints hold the
whole tree (rank 0 writes it; Adafactor's moments too), so a run on
ranks resumes on one card and back.  ``--seq-axis`` splits each
sequence's positions between blocks over that mesh axis (sequence
parallelism; the axis must not be the batch's).  Ranks on one card
need ``--transport gloo`` (CUDA tensors staged through host memory);
``nccl`` needs one card a rank.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..checkpoint.store import LeafSpec
from ..configs import get_reduced
from ..data.pipeline import LMBatchPipeline, rank_batch
from ..models import model as M
from ..models.config import ShapeConfig
from ..models.transformer import (abstract_model, init_model, param_specs,
                                  stack_groups)
from ..optim import adafactor, adamw, warmup_cosine
from ..runtime import DriverConfig, TrainDriver
from ..tree import tree_flatten, tree_unflatten


def rules_for(cfg, mesh):
    """The reference launcher's rules for ``cfg`` on ``mesh``: heads,
    mlp and experts left whole where they do not divide over the
    ``model`` axis."""
    from ..parallel.sharding import rules_for_mesh
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    ov = {}
    if cfg.n_heads % axes.get("model", 1):
        ov["heads"] = None
    if cfg.d_ff % axes.get("model", 1) or not cfg.d_ff:
        ov["mlp"] = None
    if cfg.n_experts and cfg.n_experts % axes.get("model", 1):
        ov["experts"] = None
    return rules_for_mesh(mesh, **ov)


def rank_model(cfg, rules, seed: int = 0, device="cuda"):
    """``(blocks, specs)``: the model drawn from ``seed`` on ``device``
    (the same numbers on every rank), cut to this rank's blocks under
    ``rules`` part by part (``init_model(..., rules=)``)."""
    blocks = init_model(cfg, seed, device=device, rules=rules)
    return blocks, param_specs(blocks)


def _leaf_specs(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [LeafSpec(tuple(x.shape), x.dtype)
                                    for x in leaves])


def build_trainer(arch: str, batch: int, seq: int, steps: int,
                  ckpt_dir: str, mesh=None, seed: int = 0, fault_hook=None,
                  lr: float = 3e-4, ckpt_every: int = 50, device="cuda",
                  optimizer: str = "adamw", seq_axis=None):
    """``(TrainDriver, cfg)`` for the reduced ``arch`` on ``device``:
    parameters from ``init_model(cfg, seed)``, AdamW (``optimizer=
    "adafactor"``: Adafactor over ``stack_groups(cfg)``) with
    ``warmup_cosine(lr, min(50, steps // 4 + 1), steps)``, batches
    ``LMBatchPipeline(cfg, (seq, batch), seed).batch(step)``, a
    checkpoint every ``ckpt_every`` steps in ``ckpt_dir``.  The driver's
    state is ``(params, opt_state)``.

    ``mesh``: a ``launch.mesh.RankMesh`` with its collectives
    (``parallel.collectives.attach``): the state is this rank's blocks
    under ``rules_for(cfg, mesh)`` (``seq=seq_axis``), each batch this
    rank's slice, and the checkpoints the whole tree (``TrainDriver``'s
    ``rank_layout``)."""
    dev = resolve_device(device)
    cfg = get_reduced(arch)
    shape = ShapeConfig("custom", seq, batch, "train")
    sched = warmup_cosine(lr, min(50, steps // 4 + 1), steps)
    if optimizer == "adafactor":
        opt = adafactor(sched, stacks=stack_groups(cfg))
    elif optimizer == "adamw":
        opt = adamw(sched)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    pipe = LMBatchPipeline(cfg=cfg, shape=shape, seed=seed)
    rules = None
    if mesh is not None:
        import dataclasses
        rules = dataclasses.replace(rules_for(cfg, mesh), seq=seq_axis)
    step_fn = M.make_train_step(cfg, opt, rules=rules)

    def fresh_state():
        if rules is None:
            params = init_model(cfg, seed, device=dev)
        else:
            params = rank_model(cfg, rules, seed, dev)[0]
        return params, opt.init(params)

    def batch_fn(i):
        b = pipe.batch(i)
        if rules is not None:
            b = rank_batch(b, rules)
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

    def driver_step(state, batch):
        params, opt_state = state
        params, opt_state, out = step_fn(params, opt_state, batch)
        return (params, opt_state), out

    # the step updates the state in place, so a retry-restore before
    # the first checkpoint rebuilds it from the seed (identical params)
    # rather than handing back the first state, which training changed
    first_state = [fresh_state()]

    def init_state_fn():
        return first_state.pop() if first_state else fresh_state()

    layout = None
    abstract = _leaf_specs(first_state[0])
    if rules is not None:
        from ..parallel.sharding import block_tree, gather_tree
        whole_params, specs = abstract_model(cfg)
        state_specs = [specs, opt.state_specs(specs)]
        abstract = _leaf_specs((whole_params,
                                opt.abstract_state(whole_params)))
        layout = (lambda st: tuple(gather_tree(list(st), state_specs,
                                               rules)),
                  lambda tree: tuple(block_tree(list(tree), state_specs,
                                                rules)))
    driver = TrainDriver(
        DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                     handle_sigterm=mesh is None),
        step_fn=driver_step, batch_fn=batch_fn,
        init_state_fn=init_state_fn, device=dev, fault_hook=fault_hook,
        abstract_state=abstract, rank_layout=layout)
    return driver, cfg


def _report(out: dict, cfg) -> None:
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"arch={cfg.name} steps={out['final_step']} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"stragglers={len(out['stragglers'])}")
    else:
        print(f"arch={cfg.name} steps={out['final_step']}: nothing to run")


def _mesh_arg(text: str):
    dims = tuple(int(v) for v in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise argparse.ArgumentTypeError("--mesh is DxM or PxDxM")
    return dims, axes


def _rank_main(rank: int, world: int, args: dict) -> None:
    """One rank of ``--nproc``: its mesh and collectives, then the
    trainer on its blocks; rank 0 reports."""
    from ..core.halo import Transport
    from ..parallel.collectives import attach
    from .mesh import make_host_mesh
    dims, axes = args["mesh"] or (None, ("data", "model"))
    dev = args["device"]
    if dev == "cuda":
        dev = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(dev)
    mesh = attach(make_host_mesh(dims, axes),
                  Transport(args["transport"], dev))
    driver, cfg = build_trainer(args["arch"], args["batch"], args["seq"],
                                args["steps"], args["ckpt_dir"], mesh=mesh,
                                lr=args["lr"], device=dev,
                                optimizer=args["optimizer"],
                                seq_axis=args["seq_axis"])
    out = driver.run(args["steps"])
    if rank == 0:
        _report(out, cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=0,
                    help="rank processes (0: this process, no mesh)")
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="DxM or PxDxM (default: the host-mesh shape)")
    ap.add_argument("--transport", default="gloo",
                    choices=("gloo", "nccl"))
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--seq-axis", default=None, choices=("data", "model"),
                    help="with --nproc: the mesh axis that splits each "
                         "sequence's positions (sequence parallelism)")
    args = ap.parse_args(argv)

    if args.nproc:
        from .mesh import spawn_ranks
        spawn_ranks(_rank_main, args.nproc, args=(vars(args),),
                    backend=args.transport)
        return None
    driver, cfg = build_trainer(args.arch, args.batch, args.seq,
                                args.steps, args.ckpt_dir, lr=args.lr,
                                device=args.device,
                                optimizer=args.optimizer)
    out = driver.run(args.steps)
    _report(out, cfg)
    return out


if __name__ == "__main__":
    main()
