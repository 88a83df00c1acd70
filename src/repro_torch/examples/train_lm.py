"""Train a reduced LM end to end with the fault-tolerant runtime on one
device: the synthetic pipeline, AdamW, checkpoints and a loss curve that
goes down (the port's counterpart of the reference's
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch qwen2-1.5b --steps 200 [--device cpu] [--out curve.json]

Checkpoints go to ``--ckpt-dir`` (default: a temporary directory,
removed at the end).
"""

from __future__ import annotations

import argparse
import json
import tempfile

from ..launch.train import build_trainer


def run(arch: str, steps: int, batch: int, seq: int, ckpt_dir: str,
        device="cuda") -> list:
    """Train ``steps`` steps; returns the loss per step."""
    driver, cfg = build_trainer(arch, batch, seq, steps, ckpt_dir,
                                device=device)
    print(f"training {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) for "
          f"{steps} steps on {device} ...")
    out = driver.run(steps)
    metrics = out["metrics"]
    losses = [m["loss"] for m in metrics]
    k = max(len(losses) // 10, 1)
    for i in range(0, len(losses), k):
        print(f"  step {metrics[i]['step']:5d}  loss {losses[i]:8.4f}  "
              f"({metrics[i]['dt'] * 1e3:.0f} ms)")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not decrease")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="loss curve (JSON)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        losses = run(args.arch, args.steps, args.batch, args.seq,
                     args.ckpt_dir or tmp, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(losses, f)
        print(f"loss curve -> {args.out}")
    return losses


if __name__ == "__main__":
    main()
