"""Dry run: prove that every (architecture x shape) cell and every one
of the paper's SNN cases can be built, on one card or on a rank of the
production meshes, and record what one step costs, with nothing
allocated (the port of ``repro.launch.dryrun``, which lowers and
compiles each cell for a TPU mesh).

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

``--mesh single`` / ``multi`` (``both``: each) runs the cell on the
production mesh, (data 16, model 16) or (pod 2, data 16, model 16): 256
or 512 H100s, one rank a card.  The rules are the reference's
(``_rules_for``, then ``_batch_rules``); the inputs are rank 0's blocks
on ``"meta"`` (the parameters', optimizer state's and decode state's
under ``param_specs`` / ``state_specs`` / ``decode_state_specs``, the
batch's ``data.pipeline.rank_batch`` slice), and the step is the port's
rank step under those rules (``make_train_step(..., rules=)``,
``make_prefill(cfg, rules)``, ``make_serve_step(cfg, rules)``), traced
once with ``parallel.collectives.DryCollectives`` in place of a process
group: the rank's FLOPs, bytes and peak, its calls and bytes per
channel, and its ring wire bytes by kind, the roofline's collective
term.  Every rank runs the same shapes under ``_rules_for`` (each split
divides evenly), so rank 0 stands for all of them.

Per SNN case (``configs.snn.CASES``, at ``--tiles``, default 1x1: the
whole grid on one card; on a production mesh the reference's tiles,
(pod x data, model) = (16, 16) or (32, 16)) it reports one tile's bytes
of the abstract state and tables (``dist_engine.abstract_dist_inputs``)
beside ``metrics.shard_memory_bytes``, and the step-time terms of
``metrics.step_time_model`` at ``--rate-hz`` (the paper's 38 Hz), the
halo exchange's collective term among them.  The SNN step is not
traced: the port's step needs the tables' run descriptors and inverse
index, built from real tables (``synaptic_accum.build_column_runs``,
``stdp.build_inverse_index``), which no abstract input has, and its
work depends on which neurons fire.  (The reference lowers a 10-step
scan instead.)  The descriptors and index are not in the bytes either.

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(mesh ``1xh100``, ``single`` or ``multi``; an SNN case's one-card cell
is ``<case>__sim__<TY>x<TX>``) and prints one ``[OK ]`` / ``[FAIL]``
line; the run exits non-zero if a cell fails.  A cell that does not fit
one card is an answer, not a failure.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape prefill_32k
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --snn [--mesh both] [--force] [--jobs 8]
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


MESHES = ("single", "multi")      # the production meshes (``--mesh``)


def production_rank_mesh(mesh_kind: str):
    """Rank 0 of the ``"single"`` or ``"multi"`` production mesh, shapes
    only, with its ``DryCollectives``."""
    from ..launch.mesh import RankMesh, production_mesh_shape
    from ..parallel.collectives import attach_dry
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}: expected one of {MESHES}")
    return attach_dry(RankMesh(*production_mesh_shape(mesh_kind == "multi"),
                               0))


def meta_like(tree):
    """``tree`` with every tensor leaf replaced by an empty ``"meta"``
    tensor of its shape and dtype (the dry run of a step that ran); a
    ``KVCache``'s tensors alike."""
    import torch
    from ..models.attention import KVCache
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, KVCache):
        return KVCache(meta_like(tree.k), meta_like(tree.v), tree.ring)
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    return tree


def build_cell(arch: str, shape_name, variant=None,
               reduced: bool = False, mesh=None):
    """Returns ``(step_fn, abstract_args, meta)``: the port's step for
    the cell and its inputs on ``"meta"``; ``shape_name`` a shape
    cell's name or a ``ShapeConfig``.  ``mesh``: a ``RankMesh`` with a
    rank and collectives (shapes only: ``parallel.collectives.
    attach_dry``): the rank's step under the reference's rules for the
    cell (``_rules_for``, ``_batch_rules``) and the rank's blocks of the
    inputs."""
    from ..models import model as M
    from ..tree import tree_flatten

    cfg = cell_config(arch, variant, reduced)
    shape = _shape(shape_name)
    params, specs = M.abstract_params(cfg)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    meta = {"params": int(n_params),
            "active_params": cfg.active_param_count()}
    rules = None
    if mesh is not None:
        from ..data.pipeline import rank_batch
        from ..parallel.sharding import block_tree
        rules, dp = _rules_for(cfg, mesh)
        rules = _batch_rules(rules, shape, dp)
        params = block_tree(params, specs, rules)
        meta.update(mesh=dict(zip(mesh.axis_names, mesh.shape)),
                    rank=mesh.rank, rules={
                        f.name: getattr(rules, f.name)
                        for f in dataclasses.fields(rules)
                        if f.name != "mesh"})

        def rows(batch):
            return rank_batch(batch, rules)
    else:
        def rows(batch):
            return batch

    def state():
        return M.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                   abstract=True, rules=rules)

    if shape.kind == "decode":
        token = rows(M.input_specs(cfg, shape))["token"]
        return (M.make_serve_step(cfg, rules),
                (params, state(), token, shape.seq_len - 1), meta)

    batch = rows(M.input_specs(cfg, shape))
    if shape.kind == "prefill":
        return M.make_prefill(cfg, rules), (params, batch, state()), meta

    opt, micro = train_setup(cfg, n_params, _overrides(variant))
    meta["microbatches"] = micro
    meta["optimizer"] = opt.kind
    step = M.make_train_step(cfg, opt, microbatches=micro, rules=rules)
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


def mesh_tiles(mesh_kind: str) -> tuple:
    """The SNN tiles of a production mesh, as the reference's
    ``build_snn_cell`` lays them: (pod x data, model)."""
    from ..launch.mesh import production_mesh_shape
    shape, axes = production_mesh_shape(mesh_kind == "multi")
    size = dict(zip(axes, shape))
    return size.get("pod", 1) * size.get("data", 1), size.get("model", 1)


def analytic_memory(abstract_args, n_shards: int = 1) -> dict:
    """Exact bytes of every input of the step (params, optimizer state,
    decode state, batch; the SNN state and tables), per shard, from the
    abstract tree (``tree.tree_nbytes``); a rank's blocks are already
    one shard's.  The step's transient bytes come on top
    (``op_analysis``'s ``peak_bytes``)."""
    from ..tree import tree_nbytes
    return {"input_state_bytes_per_device":
            int(tree_nbytes(abstract_args) // max(n_shards, 1))}


def trace_rank_step(fn, args, mesh):
    """``fn(*args)`` once under ``perf.op_analysis`` with ``mesh``'s
    ``DryCollectives`` counting from zero: ``(Costs, stats)``, the wire
    bytes in the costs' ``coll_bytes`` / ``coll_by_kind`` and each
    channel's calls and bytes in ``stats``."""
    from ..perf.op_analysis import analyze
    mesh.comm.reset_stats()
    costs = analyze(fn, *args)
    costs.coll_bytes, costs.coll_by_kind = mesh.comm.wire()
    return costs, {k: dict(v) for k, v in mesh.comm.stats.items()}


def _run_lm(arch: str, shape_name, variant, reduced: bool, mesh=None,
            mesh_name: str = "1xh100") -> dict:
    from ..perf.attention_credit import flash_credit_bytes
    from ..perf.op_analysis import analyze
    from ..perf.roofline import HW, model_flops, roofline_terms

    if mesh is not None and mesh.comm is None:
        from ..parallel.collectives import attach_dry
        mesh = attach_dry(mesh)
    t0 = time.time()
    fn, args, meta = build_cell(arch, shape_name, variant, reduced, mesh)
    t_build = time.time() - t0
    mem = analytic_memory(args)
    channels = None
    if mesh is None:
        costs = analyze(fn, *args)
    else:
        costs, channels = trace_rank_step(fn, args, mesh)
    t_trace = time.time() - t0 - t_build
    cfg = cell_config(arch, variant, reduced)
    shape = _shape(shape_name)
    peak = mem["input_state_bytes_per_device"] + costs.peak_bytes
    mem.update(step_peak_bytes_above_inputs=costs.peak_bytes,
               peak_bytes=peak, fits_one_card=peak <= CARD_BYTES)
    hw = HW()
    chips = 1 if mesh is None else mesh.size
    rep = roofline_terms(arch, shape.name, mesh_name, chips, costs,
                         model_flops(cfg, shape), peak_bytes=peak, hw=hw)
    model_axis = 1 if mesh is None else dict(zip(
        mesh.axis_names, mesh.shape)).get("model", 1)
    credit = flash_credit_bytes(cfg, shape,
                                microbatches=meta.get("microbatches", 1),
                                chips=chips, model_axis=model_axis)
    out = {"kind": "lm", "mesh": mesh_name, "chips": chips,
           "build_s": round(t_build, 2), "trace_s": round(t_trace, 2),
           "meta": meta, "memory": mem,
           "op_cost": {"flops": costs.flops, "dot_flops": costs.dot_flops,
                       "bytes": costs.bytes, "ops": costs.n_ops,
                       "top_bytes": costs.top(6)},
           "kernelized": {"attn_chunk_bytes": credit,
                          "memory_s_flash": max(costs.bytes - credit, 0.0)
                          / hw.hbm_bw},
           "roofline": rep.to_dict()}
    if channels is not None:
        out["collectives"] = {"coll_bytes": costs.coll_bytes,
                              "coll_by_kind": dict(costs.coll_by_kind),
                              "channels": channels,
                              "share_of_step": rep.collective_s
                              / rep.step_time_s if rep.step_time_s else 0.0}
    return out


def _run_snn(case: str, tiles, variant, rate_hz: float,
             mesh_name: str = "1xh100") -> dict:
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
    return {"kind": "snn", "mesh": mesh_name, "chips": n_shards,
            "build_s": round(time.time() - t0, 2),
            "meta": meta, "memory": mem, "rate_hz": rate_hz,
            "step_time_model": terms, "traced": False,
            "roofline": {"dominant": dom, "step_time_s": terms["step_s"],
                         "collective_s": terms["collective_s"],
                         "hw": dataclasses.asdict(HW())}}


def run_cell(arch: str, shape_name, out_dir: str = RESULTS,
             force: bool = False, variant=None, tiles=(1, 1),
             rate_hz: float = SNN_RATE_HZ, reduced: bool = False,
             mesh_kind: str = "1xh100") -> dict:
    """Build and trace (LM) or size (SNN) one cell; its record, also
    written to ``out_dir/<cell>.json`` (read back unless ``force``; no
    file for ``out_dir=None``).  ``reduced``: an LM cell on the
    architecture's reduced (test-size) config.  ``mesh_kind``:
    ``"1xh100"`` (one card; an SNN case at ``tiles``), or a production
    mesh, ``"single"`` or ``"multi"`` (rank 0's step; an SNN case at the
    mesh's tiles, ``mesh_tiles``)."""
    snn = arch.startswith("snn-")
    on_mesh = mesh_kind != "1xh100"
    if on_mesh and mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}: expected 1xh100 or one of "
                         f"{MESHES}")
    if snn:
        tiles = mesh_tiles(mesh_kind) if on_mesh else tiles
        cell_id = f"{arch}__sim__" + (mesh_kind if on_mesh
                                      else f"{tiles[0]}x{tiles[1]}")
    else:
        cell_id = f"{arch}__{_shape(shape_name).name}__{mesh_kind}"
    if variant:
        cell_id += f"__{variant}"
    if reduced and not snn:
        cell_id += "__reduced"
    path = os.path.join(out_dir, cell_id + ".json") if out_dir else None
    if path and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        if snn:
            body = _run_snn(arch, tiles, variant, rate_hz, mesh_kind)
        else:
            body = _run_lm(arch, shape_name, variant, reduced,
                           production_rank_mesh(mesh_kind) if on_mesh
                           else None, mesh_kind)
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
    ap.add_argument("--mesh", default="1xh100",
                    choices=("1xh100",) + MESHES + ("both",),
                    help="one card (default), a rank of the single-pod "
                    "(256) or multi-pod (512) production mesh, or both")
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

    meshes = {"both": MESHES}.get(args.mesh, (args.mesh,))
    runs = [(a, s, mk) for a, s in cells for mk in meshes]
    failures = 0
    t_all = time.time()
    kw = dict(out_dir=args.out, force=args.force, variant=args.variant,
              tiles=args.tiles, rate_hz=args.rate_hz)
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futures = [pool.submit(run_cell, a, s, mesh_kind=mk, **kw)
                       for a, s, mk in runs]
            results = [f.result() for f in futures]
    else:
        results = (run_cell(a, s, mesh_kind=mk, **kw) for a, s, mk in runs)
    for (arch, shape, mk), r in zip(runs, results):
        status = "OK " if r["ok"] else "FAIL"
        if r["ok"]:
            m, rl = r["memory"], r["roofline"]
            extra = (f"dom={rl['dominant']:10s} "
                     f"peakGB={m['peak_bytes'] / 1e9:9.2f} "
                     f"fits1={'yes' if m['fits_one_card'] else 'no ':3s} "
                     f"step<={rl['step_time_s'] * 1e3:11.4f}ms "
                     f"coll={rl['collective_s'] / rl['step_time_s']:6.1%}")
            if r["kind"] == "lm":
                extra += f" trace={r['trace_s']:6.1f}s"
            else:
                shape = "sim {}x{}".format(*r["meta"]["tiles"])
        else:
            failures += 1
            extra = r["error"][:120]
        print(f"[{status}] {arch:24s} {shape:12s} {mk:6s} {extra}",
              flush=True)
    print(f"{len(runs)} cells in {time.time() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
