"""Fault-tolerance demo: inject a worker failure mid-training and watch
the driver restore from the last checkpoint and replay to the same
result (the port's counterpart of the reference's
``examples/fault_tolerance_demo.py``).

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo \\
        [--device cpu]

Reduced qwen2-1.5b, batch 4 x 64 tokens, 50 steps, a checkpoint every
10; step 30 fails once.
"""

from __future__ import annotations

import argparse
import tempfile

from ..launch.train import build_trainer


def run(ckpt_dir: str, device="cuda") -> dict:
    crashed = []

    def chaos(step):
        if step == 30 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated worker loss at step 30")

    driver, _ = build_trainer("qwen2-1.5b", batch=4, seq=64, steps=50,
                              ckpt_dir=ckpt_dir, ckpt_every=10,
                              fault_hook=chaos, device=device)
    out = driver.run(50)
    losses = {m["step"]: m["loss"] for m in out["metrics"]}
    print("injected a crash at step 30 -> restored from the step-30 "
          "checkpoint and replayed")
    print(f"completed {out['final_step']} steps; "
          f"loss {losses[0]:.3f} -> {losses[max(losses)]:.3f}")
    # the abandoned timeline is pruned: the log carries each step once
    steps = [m["step"] for m in out["metrics"]]
    if steps != sorted(set(steps)) or len(losses) != 50 or not crashed:
        raise RuntimeError(f"replayed steps must appear once: {steps}")
    print(f"the metrics log carries each of the {len(steps)} steps "
          "exactly once despite the crash and replay")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        run(tmp, device=args.device)
    print("ok")


if __name__ == "__main__":
    main()
