"""Dry run on one card: prove that every (architecture x shape) cell and
every one of the paper's SNN cases can be built, and record what one
step costs, with nothing allocated (the port of
``repro.launch.dryrun``, which lowers and compiles each cell for a TPU
mesh).

Per LM cell this module:
  1. builds the published config (``attn_impl="chunked"``: the plain
     chunked attention, as the reference's dry run lowers it) and its
     abstract inputs on ``"meta"``: params (``abstract_params``), the
     batch (``input_specs``), the decode state
     (``abstract_decode_state``) and, to train, the optimizer state
     (``abstract_state``);
  2. runs the port's own step once under ``perf.op_analysis``
     (``make_prefill``, ``make_serve_step`` or ``make_train_step``):
     every aten op's FLOPs and bytes, and the peak bytes the step holds
     on top of its inputs;
  3. reports the inputs' exact bytes (``analytic_memory``), the peak,
     whether it fits one 80 GB card, and the roofline terms against
     H100 constants (``perf.roofline``), with the flash kernel's credit
     (``perf.attention_credit.flash_credit_bytes``: forward chunks only,
     since the port's training backward is plain chunked PyTorch).

Per SNN case (``configs.snn.CASES``, at ``--tiles``, default 1x1: the
whole grid on one card) it reports the bytes of the abstract state and
tables (``dist_engine.abstract_dist_inputs``) beside
``metrics.shard_memory_bytes``, and the step-time terms of
``metrics.step_time_model`` at ``--rate-hz`` (the paper's 38 Hz).  The
SNN step is not traced: the port's step needs the tables' run
descriptors and inverse index, built from real tables
(``synaptic_accum.build_column_runs``, ``stdp.build_inverse_index``),
which no abstract input has, and its work depends on which neurons
fire.  (The reference lowers a 10-step scan instead.)  The descriptors
and index are not in the bytes either.

Each cell writes ``results/dryrun_torch/<cell>.json`` and prints one
``[OK ]`` / ``[FAIL]`` line; the run exits non-zero if a cell fails.
A cell that does not fit one card is an answer, not a failure.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all --snn [--force] [--jobs 8]
  python -m repro_torch.launch.dryrun --arch snn-96x96-gaussian --tiles 2x2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")
CARD_BYTES = 80e9                 # one H100 SXM's device memory
SNN_RATE_HZ = 38.0                # the paper's exponential-law rate


# ---------------------------------------------------------------------------
# Variants: named config overrides on top of the baseline (the
# reference's set)
# ---------------------------------------------------------------------------

VARIANTS = {
    "padded_heads": {"pad_heads_to": 16},
    "micro1": {"microbatches": 1},
    "micro2": {"microbatches": 2},
    "micro4": {"microbatches": 4},
    "chunk512": {"attn_chunk_q": 512, "attn_chunk_k": 512},
    "chunk2048": {"attn_chunk_q": 2048, "attn_chunk_k": 2048},
    "snn_f32_spikes": {"pack_spikes": False},
    "snn_block_halo": {"halo_mode": "block", "pack_spikes": False},
    "snn_packed": {"pack_spikes": True},
    "snn_tight_caps": {"pack_spikes": True, "rate_cap_hz": 60.0,
                       "cap_headroom": 1.5},
    "snn_bf16_w": {"pack_spikes": True, "rate_cap_hz": 60.0,
                   "cap_headroom": 1.5, "weight_dtype": "bfloat16"},
    "padded_chunk512": {"pad_heads_to": 16, "attn_chunk_q": 512,
                        "attn_chunk_k": 512},
    "padded_chunk2048": {"pad_heads_to": 16, "attn_chunk_q": 2048,
                         "attn_chunk_k": 2048},
    "micro2_chunk512": {"microbatches": 2, "attn_chunk_q": 512,
                        "attn_chunk_k": 512},
}


def _apply_cfg_variant(cfg, overrides: dict):
    cfg_fields = {f.name for f in dataclasses.fields(cfg)}
    patch = {}
    if overrides.get("pad_heads_to"):
        m = overrides["pad_heads_to"]
        h = -(-cfg.n_heads // m) * m
        kv = cfg.n_kv_heads if h % cfg.n_kv_heads == 0 else \
            -(-cfg.n_kv_heads // m) * m
        hd = cfg.resolved_head_dim
        patch.update(n_heads=h, n_kv_heads=kv, head_dim=hd)
    for k, v in overrides.items():
        if k in cfg_fields:
            patch[k] = v
    return dataclasses.replace(cfg, **patch) if patch else cfg


def _overrides(variant) -> dict:
    return VARIANTS.get(variant, {}) if variant else {}


def cell_config(arch: str, variant=None, reduced: bool = False):
    """The published config (the reduced one with ``reduced``) with the
    variant applied, on the plain chunked attention route."""
    from ..configs import get_config, get_reduced
    base = get_reduced(arch) if reduced else get_config(arch)
    cfg = _apply_cfg_variant(base, _overrides(variant))
    return dataclasses.replace(cfg, attn_impl="chunked")


# ---------------------------------------------------------------------------
# Rules for a rank mesh (the reference's, for its TPU meshes)
# ---------------------------------------------------------------------------

def _rules_for(cfg, mesh):
    """Divisibility-aware logical rules for this arch on this mesh (a
    ``launch.mesh.RankMesh``, or anything with ``axis_names`` and
    ``devices.shape``), and the data-parallel degree."""
    from ..parallel.sharding import rules_for_mesh
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model = axes.get("model", 1)
    dp = axes.get("data", 1) * axes.get("pod", 1)
    ov = {}
    ov["heads"] = "model" if cfg.n_heads % model == 0 else None
    ov["mlp"] = "model" if cfg.d_ff and cfg.d_ff % model == 0 else None
    ov["experts"] = "model" if cfg.n_experts % model == 0 and \
        cfg.n_experts else None
    ov["d_inner"] = "model" if cfg.d_inner % model == 0 else None
    ov["vocab"] = "model" if cfg.padded_vocab % model == 0 else None
    return rules_for_mesh(mesh, **ov), dp


def _batch_rules(rules, shape, dp):
    """``rules`` with the batch replicated when the shape's global batch
    does not divide over the data-parallel ranks (e.g. long_500k's
    B = 1: the model axis still splits)."""
    if shape.global_batch % dp:
        return dataclasses.replace(rules, batch=None)
    return rules


def rank_bytes(cfg, rules, optimizer=None, residuals: bool = False,
               serving=None) -> dict:
    """The bytes one rank holds under ``rules`` (whose mesh need only
    carry its shape): the parameters' blocks, the optimizer state's
    (``optimizer``: an ``optim.Optimizer``), the pod step's float32
    residuals, and with ``serving`` (a decode or prefill shape cell)
    the decode state's blocks (``decode_state_specs``: what
    ``init_decode_state(..., rules=)`` allocates), from the abstract
    trees (nothing allocated)."""
    from ..models import model as M
    from ..models.transformer import decode_state_leaves
    from ..optim.compression import init_residuals
    from ..parallel.sharding import block_shape, rank_nbytes
    params, specs = M.abstract_params(cfg)
    out = {"params": rank_nbytes(params, specs, rules)}
    if optimizer is not None:
        out["optimizer"] = rank_nbytes(optimizer.abstract_state(params),
                                       optimizer.state_specs(specs), rules)
    if residuals:
        out["residuals"] = rank_nbytes(init_residuals(params), specs, rules)
    if serving is not None:
        state = M.abstract_decode_state(cfg, _shape(serving))
        out["decode_state"] = sum(
            math.prod(block_shape(tuple(x.shape), n, rules))
            * x.element_size() for x, n in decode_state_leaves(state))
    out["total"] = sum(out.values())
    return out


def train_setup(cfg, n_params: int, overrides: dict):
    """The reference's choice for a train cell of ``cfg`` (``n_params``
    parameters): Adafactor (factored moments, over ``cfg``'s stack
    groups) above 15e9 parameters, else AdamW; 8 microbatches above 15e9
    parameters, 4 above 4e9, else 1, unless ``overrides`` names them."""
    from ..models.transformer import stack_groups
    from ..optim import adafactor, adamw, warmup_cosine
    big = n_params > 15e9
    opt = adafactor(warmup_cosine(1e-4, 100, 10000),
                    stacks=stack_groups(cfg)) if big \
        else adamw(warmup_cosine(3e-4, 100, 10000))
    micro = 8 if big else (4 if n_params > 4e9 else 1)
    return opt, overrides.get("microbatches", micro)


def _shape(shape):
    """A shape cell by name (``models.config.SHAPES``), or as given."""
    from ..models.config import SHAPES
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: str, shape_name, variant=None,
               reduced: bool = False):
    """Returns ``(step_fn, abstract_args, meta)``: the port's step for
    the cell and its inputs on ``"meta"``; ``shape_name`` a shape
    cell's name or a ``ShapeConfig``."""
    from ..models import model as M
    from ..tree import tree_flatten

    cfg = cell_config(arch, variant, reduced)
    shape = _shape(shape_name)
    params, _ = M.abstract_params(cfg)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    meta = {"params": int(n_params),
            "active_params": cfg.active_param_count()}

    if shape.kind == "decode":
        state = M.abstract_decode_state(cfg, shape)
        token = M.input_specs(cfg, shape)["token"]
        return (M.make_serve_step(cfg),
                (params, state, token, shape.seq_len - 1), meta)

    batch = M.input_specs(cfg, shape)
    if shape.kind == "prefill":
        state = M.abstract_decode_state(cfg, shape)
        return M.make_prefill(cfg), (params, batch, state), meta

    opt, micro = train_setup(cfg, n_params, _overrides(variant))
    meta["microbatches"] = micro
    meta["optimizer"] = "adafactor" if n_params > 15e9 else "adamw"
    step = M.make_train_step(cfg, opt, microbatches=micro)
    return step, (params, opt.abstract_state(params), batch), meta


def build_snn_cell(case_name: str, tiles=(1, 1), variant=None):
    """Returns ``(DistConfig, (state, tables), meta)``: the case at
    ``tiles`` with the variant's engine and exchange settings, its
    abstract inputs on ``"meta"``."""
    from ..configs.snn import CASES
    from ..core.dist_engine import DistConfig, abstract_dist_inputs
    case = CASES[case_name]
    overrides = _overrides(variant)
    ty, tx = tiles
    eng_kw = {k: v for k, v in overrides.items()
              if k in ("rate_cap_hz", "cap_headroom", "d_ring", "mode",
                       "weight_dtype")}
    ecfg = case.engine_config(ty, tx, **eng_kw)
    dcfg = DistConfig(engine=ecfg,
                      halo_mode=overrides.get("halo_mode", "strip"),
                      pack_spikes=overrides.get("pack_spikes", True))
    spec = ecfg.spec()
    meta = {"neurons": case.grid[0] * case.grid[1] * case.n_per_column,
            "synapses_per_shard": spec.expected_synapses(),
            "table_bytes_per_shard": spec.table_bytes(),
            "halo_radius": ecfg.law.radius, "tiles": (ty, tx),
            "weight_dtype": spec.weight_dtype}
    return dcfg, abstract_dist_inputs(dcfg), meta


def analytic_memory(abstract_args, n_shards: int = 1) -> dict:
    """Exact bytes of every input of the step (params, optimizer state,
    decode state, batch; the SNN state and tables), per shard, from the
    abstract tree (``tree.tree_nbytes``).  The step's transient bytes
    come on top (``op_analysis``'s ``peak_bytes``)."""
    from ..tree import tree_nbytes
    return {"input_state_bytes_per_device":
            int(tree_nbytes(abstract_args) // max(n_shards, 1))}


def _run_lm(arch: str, shape_name, variant, reduced: bool) -> dict:
    from ..perf.attention_credit import flash_credit_bytes
    from ..perf.op_analysis import analyze
    from ..perf.roofline import HW, model_flops, roofline_terms

    t0 = time.time()
    fn, args, meta = build_cell(arch, shape_name, variant, reduced)
    t_build = time.time() - t0
    mem = analytic_memory(args)
    costs = analyze(fn, *args)
    t_trace = time.time() - t0 - t_build
    cfg = cell_config(arch, variant, reduced)
    shape = _shape(shape_name)
    peak = mem["input_state_bytes_per_device"] + costs.peak_bytes
    mem.update(step_peak_bytes_above_inputs=costs.peak_bytes,
               peak_bytes=peak, fits_one_card=peak <= CARD_BYTES)
    hw = HW()
    rep = roofline_terms(arch, shape.name, "1xh100", 1, costs,
                         model_flops(cfg, shape), peak_bytes=peak, hw=hw)
    credit = flash_credit_bytes(cfg, shape,
                                microbatches=meta.get("microbatches", 1))
    return {"kind": "lm", "build_s": round(t_build, 2),
            "trace_s": round(t_trace, 2), "meta": meta, "memory": mem,
            "op_cost": {"flops": costs.flops, "dot_flops": costs.dot_flops,
                        "bytes": costs.bytes, "ops": costs.n_ops,
                        "top_bytes": costs.top(6)},
            "kernelized": {"attn_chunk_bytes": credit,
                           "memory_s_flash": max(costs.bytes - credit, 0.0)
                           / hw.hbm_bw},
            "roofline": rep.to_dict()}


def _run_snn(case: str, tiles, variant, rate_hz: float) -> dict:
    from ..core.metrics import shard_memory_bytes, step_time_model
    from ..perf.roofline import HW

    t0 = time.time()
    dcfg, args, meta = build_snn_cell(case, tiles, variant)
    n_shards = tiles[0] * tiles[1]
    mem = analytic_memory(args, n_shards)
    spec = dcfg.engine.spec()
    model = shard_memory_bytes(spec)
    per_shard = mem["input_state_bytes_per_device"]
    mem.update(peak_bytes=per_shard, fits_one_card=per_shard <= CARD_BYTES,
               shard_memory_bytes=model,
               bytes_per_expected_synapse=per_shard
               / max(spec.expected_synapses(), 1.0))
    terms = step_time_model(spec, rate_hz, pack_spikes=dcfg.pack_spikes)
    dom = max(("compute", "memory", "collective"),
              key=lambda k: terms[f"{k}_s"])
    return {"kind": "snn", "build_s": round(time.time() - t0, 2),
            "meta": meta, "memory": mem, "rate_hz": rate_hz,
            "step_time_model": terms, "traced": False,
            "roofline": {"dominant": dom, "step_time_s": terms["step_s"],
                         "hw": dataclasses.asdict(HW())}}


def run_cell(arch: str, shape_name, out_dir: str = RESULTS,
             force: bool = False, variant=None, tiles=(1, 1),
             rate_hz: float = SNN_RATE_HZ, reduced: bool = False) -> dict:
    """Build and trace (LM) or size (SNN) one cell; its record, also
    written to ``out_dir/<cell>.json`` (read back unless ``force``; no
    file for ``out_dir=None``).  ``reduced``: an LM cell on the
    architecture's reduced (test-size) config."""
    snn = arch.startswith("snn-")
    cell_id = (f"{arch}__sim__{tiles[0]}x{tiles[1]}" if snn
               else f"{arch}__{_shape(shape_name).name}__1xh100")
    if variant:
        cell_id += f"__{variant}"
    if reduced and not snn:
        cell_id += "__reduced"
    path = os.path.join(out_dir, cell_id + ".json") if out_dir else None
    if path and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        body = (_run_snn(arch, tiles, variant, rate_hz) if snn
                else _run_lm(arch, shape_name, variant, reduced))
        out = {"cell": cell_id, "ok": True, **body}
    except Exception as e:  # noqa: BLE001 - recorded as the cell's failure
        out = {"cell": cell_id, "ok": False, "error": repr(e),
               "traceback": traceback.format_exc()[-4000:]}
    if path:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return out


def _tiles(text: str):
    ty, tx = (int(v) for v in text.lower().split("x"))
    return ty, tx


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--snn", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS))
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--tiles", type=_tiles, default=(1, 1),
                    help="SNN tiling TYxTX (default 1x1: one card)")
    ap.add_argument("--rate-hz", type=float, default=SNN_RATE_HZ)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    cells = []
    if args.all or (not args.arch and not args.snn):
        from ..configs import all_cells
        cells = [(a, s.name) for a, s in all_cells()]
    elif args.arch and not args.arch.startswith("snn-"):
        from ..configs import shape_cells
        shapes = [args.shape] if args.shape else \
            [s.name for s in shape_cells(args.arch)]
        cells = [(args.arch, s) for s in shapes]
    if args.snn:
        from ..configs.snn import CASES
        cells += [(c, "sim") for c in CASES]
    if args.arch and args.arch.startswith("snn-"):
        cells = [(args.arch, "sim")]

    failures = 0
    t_all = time.time()
    kw = dict(out_dir=args.out, force=args.force, variant=args.variant,
              tiles=args.tiles, rate_hz=args.rate_hz)
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futures = [pool.submit(run_cell, a, s, **kw) for a, s in cells]
            results = [f.result() for f in futures]
    else:
        results = (run_cell(a, s, **kw) for a, s in cells)
    for (arch, shape), r in zip(cells, results):
        status = "OK " if r["ok"] else "FAIL"
        if r["ok"]:
            m = r["memory"]
            extra = (f"dom={r['roofline']['dominant']:10s} "
                     f"peakGB={m['peak_bytes'] / 1e9:9.2f} "
                     f"fits1={'yes' if m['fits_one_card'] else 'no ':3s} "
                     f"step<={r['roofline']['step_time_s'] * 1e3:11.4f}ms")
            if r["kind"] == "lm":
                extra += f" trace={r['trace_s']:6.1f}s"
            else:
                shape = "sim {}x{}".format(*r["meta"]["tiles"])
        else:
            failures += 1
            extra = r["error"][:120]
        print(f"[{status}] {arch:24s} {shape:12s} {extra}", flush=True)
    print(f"{len(cells)} cells in {time.time() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
