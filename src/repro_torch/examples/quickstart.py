"""Quickstart: the two halves of the framework on one card (the port's
counterpart of the reference's ``examples/quickstart.py``).

1. The DPSNN core: a 6x6 grid of 50-neuron columns under both of the
   paper's connectivity laws, 200 steps each, with the rate, the
   synaptic events and the paper's headline metric, seconds per event.
2. The LM stack: one AdamW train step and one decode step of reduced
   qwen3-8b under meshless ``MeshRules`` (one card).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..configs import get_reduced
from ..core import (ColumnGrid, EngineConfig, TileDecomposition,
                    exponential_law, gaussian_law)
from ..core.engine import (build_shard_tables, firing_rate_hz,
                           init_sim_state, simulate)
from ..data.pipeline import LMBatchPipeline
from ..models.config import ShapeConfig
from ..models.model import make_serve_step, make_train_step
from ..models.transformer import init_decode_state, init_model
from ..optim import adamw
from ..optim.schedules import constant
from ..parallel.sharding import MeshRules

SNN_GRID, SNN_NEURONS, SNN_STEPS = 6, 50, 200
LM_ARCH = "qwen3-8b"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def snn_config(law) -> EngineConfig:
    """One shard of the quickstart's slab under ``law``."""
    dec = TileDecomposition(grid=ColumnGrid(SNN_GRID, SNN_GRID, SNN_NEURONS),
                            tiles_y=1, tiles_x=1, radius=law.radius)
    return EngineConfig(decomp=dec, law=law)


def snn_half(device="cuda", steps: int = SNN_STEPS) -> dict:
    """Both laws, ``steps`` steps each; per law the rate (Hz), the
    events, seconds per event (host clock around the run,
    CUDA-synchronised) and the synapse count."""
    dev = resolve_device(device)
    print("== DPSNN core ==")
    out = {}
    for law in (gaussian_law(), exponential_law()):
        cfg = snn_config(law)
        tabs = build_shard_tables(cfg, device=dev)
        state = init_sim_state(cfg, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, _ = simulate(state, tabs, cfg, steps, device=dev)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        events = float(state["metrics"]["events"])
        res = {"rate_hz": firing_rate_hz(state, cfg, steps),
               "events": events, "s_per_event": elapsed / max(events, 1.0),
               "n_synapses": int(tabs.stats["n_synapses"])}
        print(f"  {law.kind:12s} stencil {law.stencil_width}x"
              f"{law.stencil_width}: rate {res['rate_hz']:5.1f} Hz, "
              f"{int(events)} synaptic events, "
              f"{res['s_per_event']:.2e} s/event")
        out[law.kind] = res
    return out


def lm_half(device="cuda") -> dict:
    """One AdamW train step and one decode step of reduced qwen3-8b."""
    dev = resolve_device(device)
    print(f"== LM stack ({LM_ARCH} reduced) ==")
    rules = MeshRules(batch=None, fsdp=None, heads=None, mlp=None,
                      experts=None, vocab=None, kv_seq=None, d_inner=None)
    cfg = get_reduced(LM_ARCH)
    params = init_model(cfg, seed=0, device=dev)
    pipe = LMBatchPipeline(cfg=cfg, shape=ShapeConfig("q", 64, 2, "train"))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(0).items()}
    opt = adamw(constant(1e-3))
    step = make_train_step(cfg, opt, rules=rules)
    params, opt_state, out = step(params, opt.init(params), batch)
    loss, gnorm = float(out["loss"]), float(out["grad_norm"])
    print(f"  train step: loss {loss:.3f}, grad norm {gnorm:.3f}")

    state = init_decode_state(cfg, 2, 32, device=dev)
    serve = make_serve_step(cfg, rules)
    logits, state = serve(params, state, batch["tokens"][:, :1], 0)
    argmax = torch.argmax(logits[:, 0], -1).tolist()
    print(f"  decode step: logits {tuple(logits.shape)}, argmax {argmax}")
    return {"loss": loss, "grad_norm": gnorm,
            "logits_shape": tuple(logits.shape), "argmax": argmax,
            "vocab_size": cfg.vocab_size}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"snn": snn_half(args.device), "lm": lm_half(args.device)}
    print("ok")
    return out


if __name__ == "__main__":
    main()
