"""Runnable training launcher on one card (the port of
``repro.launch.train``): a reduced ``--arch`` variant trained with the
fault-tolerant runtime (checkpoints, retry, straggler watchdog,
preemption) on the synthetic pipeline, with AdamW under a warmup-cosine
schedule.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 200 --ckpt-dir RUN [--device cpu]

A run resumes from the newest checkpoint in ``--ckpt-dir``.  The
parameters and the optimizer state are updated in place (the port
donates nothing), so the first-checkpoint-less retry path rebuilds them
from the seed.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..checkpoint.store import LeafSpec
from ..configs import get_reduced
from ..data.pipeline import LMBatchPipeline
from ..models import model as M
from ..models.config import ShapeConfig
from ..models.transformer import init_model
from ..optim import adamw, warmup_cosine
from ..runtime import DriverConfig, TrainDriver
from ..tree import tree_flatten, tree_unflatten


def build_trainer(arch: str, batch: int, seq: int, steps: int,
                  ckpt_dir: str, seed: int = 0, fault_hook=None,
                  lr: float = 3e-4, ckpt_every: int = 50, device="cuda"):
    """``(TrainDriver, cfg)`` for the reduced ``arch`` on ``device``:
    parameters from ``init_model(cfg, seed)``, AdamW with
    ``warmup_cosine(lr, min(50, steps // 4 + 1), steps)``, batches
    ``LMBatchPipeline(cfg, (seq, batch), seed).batch(step)``, a
    checkpoint every ``ckpt_every`` steps in ``ckpt_dir``.  The driver's
    state is ``(params, opt_state)``."""
    dev = resolve_device(device)
    cfg = get_reduced(arch)
    shape = ShapeConfig("custom", seq, batch, "train")
    opt = adamw(warmup_cosine(lr, min(50, steps // 4 + 1), steps))
    pipe = LMBatchPipeline(cfg=cfg, shape=shape, seed=seed)
    step_fn = M.make_train_step(cfg, opt)

    def fresh_state():
        params = init_model(cfg, seed, device=dev)
        return params, opt.init(params)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(i).items()}

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

    leaves, treedef = tree_flatten(first_state[0])
    abstract = tree_unflatten(treedef, [LeafSpec(tuple(x.shape), x.dtype)
                                        for x in leaves])
    driver = TrainDriver(
        DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        step_fn=driver_step, batch_fn=batch_fn,
        init_state_fn=init_state_fn, device=dev, fault_hook=fault_hook,
        abstract_state=abstract)
    return driver, cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    driver, cfg = build_trainer(args.arch, args.batch, args.seq,
                                args.steps, args.ckpt_dir, lr=args.lr,
                                device=args.device)
    out = driver.run(args.steps)
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"arch={cfg.name} steps={out['final_step']} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"stragglers={len(out['stragglers'])}")
    else:
        print(f"arch={cfg.name} steps={out['final_step']}: nothing to run")
    return out


if __name__ == "__main__":
    main()
