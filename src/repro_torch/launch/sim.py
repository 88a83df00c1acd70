"""Segmented, checkpointed long-run SNN simulation launcher.

The port of ``repro.launch.sim``.  The paper's DPSNN jobs are
multi-hour distributed runs that must survive preemption and come back
on whatever process geometry the scheduler grants next.  This CLI
drives the multi-shard engine the same way, every tile on one device
(``--device``, default ``cuda``): fixed-size segments (on the card a
static run replays one captured CUDA graph in every segment), async
checkpoints between segments, SIGTERM preemption, and elastic
re-tiling on resume.

A run at the paper's column width on one H100::

    PYTHONPATH=src python -m repro_torch.launch.sim --grid 8 \
        --neurons-per-column 1240 --tiles 2x2 --law gaussian \
        --steps 400 --segment-steps 50 --record --ckpt-dir RUN

Preempt it (``kill -TERM <pid>``, or deterministically with
``--preempt-after N`` segments), then resume -- optionally on a
different tiling::

    PYTHONPATH=src python -m repro_torch.launch.sim ... --resume
    PYTHONPATH=src python -m repro_torch.launch.sim ... --tiles 1x2 \
        --resume --retile
    PYTHONPATH=src python -m repro_torch.launch.analyze --run RUN

Flags mirror the reference's and parse into the same typed
:class:`repro_torch.runtime.SimJobSpec`.  ``--seeds 0,1,2`` runs an
ensemble: member m as if ``--state-seed seeds[m]``, every member through
one sim function, each spooled to its own ``member_{m:03d}/`` stream;
the payload carries ``ensemble_seeds`` and each member's learned-weight
digest.  ``--sanitize`` turns on
the async writers' owning-thread assertions; the reference's JAX debug
flags (``jax_debug_nans``, ``jax_check_tracer_leaks``) have no torch
meaning and are left out.  ``--trace-dir`` takes a ``torch.profiler``
trace (Chrome JSON) of the whole run.

``--nproc N`` runs the job on N rank processes, one tile each (DPSNN's
layout; ``launch.mesh.spawn_ranks``), their halo strips moved by
``--transport`` (``gloo``: CPU tensors, and CUDA ones staged through
host memory, so several ranks may share one card; ``nccl``: one card a
rank).  The tiling defaults to the host-mesh shape of N ranks
(``launch.mesh.host_mesh_shape``: 4 -> 2x2, 2 -> 2x1); rank 0 writes the
checkpoints, the spool and the report, which a single-process run on
any tiling resumes.  A rank that fails fails the run (non-zero exit)::

    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu \
        --nproc 2 --transport gloo --grid 4 --neurons-per-column 20 \
        --steps 40 --segment-steps 10 --ckpt-dir RUN
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..checkpoint.store import set_thread_asserts
from ..obs.telemetry import (NULL, Telemetry, enable_json_logging,
                             set_default)
from ..perf.trace import torch_profiler_trace, write_chrome_trace
from ..runtime import JobError, SimDriver, SimJobSpec, build_sim_driver


def enable_sanitizers():
    """Turn on the runtime sanitizer (the ``--sanitize`` flag):
    ``set_thread_asserts`` makes the async writers' single-owner
    contract loud (see ``AsyncWriterThread``).  The reference's JAX
    debug flags have no torch counterpart."""
    set_thread_asserts(True)


def parse_tiles(spec):
    if spec is None:
        return None
    try:
        ty, tx = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(
            f"--tiles {spec!r}: expected TYxTX, e.g. 2x1") from None
    return ty, tx


def spec_from_args(args) -> SimJobSpec:
    """CLI flags -> the same typed job spec the job server accepts."""
    stdp = None
    if args.plastic:
        stdp = {k: v for k, v in
                (("a_plus", args.stdp_a_plus),
                 ("a_minus", args.stdp_a_minus)) if v is not None}
        stdp = stdp or None
    seeds = None
    if args.seeds:
        try:
            seeds = tuple(int(s) for s in args.seeds.split(","))
        except ValueError:
            raise SystemExit(
                f"--seeds {args.seeds!r}: expected a comma-separated "
                "list of ints, e.g. 0,1,2") from None
    try:
        return SimJobSpec(
            ckpt_dir=args.ckpt_dir, grid=args.grid,
            n_per_column=args.neurons_per_column, law=args.law,
            seed=args.seed, state_seed=args.state_seed, seeds=seeds,
            t_steps=args.steps, segment_steps=args.segment_steps,
            tiles=parse_tiles(args.tiles),
            ckpt_every=args.ckpt_every, keep=args.keep,
            record=args.record, record_cap=args.record_cap,
            plastic=args.plastic, stdp=stdp,
            resume=args.resume, retile=args.retile,
            preempt_after=args.preempt_after)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def build_driver(args, telemetry: Telemetry = NULL,
                 mesh=None) -> SimDriver:
    try:
        return build_sim_driver(spec_from_args(args), device=args.device,
                                telemetry=telemetry, mesh=mesh,
                                transport=args.transport)
    except JobError as e:
        raise SystemExit(str(e)) from None


def _rank_entry(rank: int, world: int, argv) -> None:
    """One rank of ``--nproc``: the job on this rank's tile."""
    import torch
    from .mesh import make_host_mesh
    args = _parser().parse_args(argv)
    if torch.device(args.device).type == "cuda":
        args.device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
        torch.cuda.set_device(args.device)
    _run(args, make_host_mesh(parse_tiles(args.tiles)))


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.nproc is None:
        return _run(args)
    if args.nproc < 1:
        raise SystemExit(f"--nproc {args.nproc}: expected >= 1")
    from .mesh import RankFailure, spawn_ranks
    try:
        spawn_ranks(_rank_entry, args.nproc, args=(argv,),
                    backend=args.transport)
    except RankFailure as e:
        raise SystemExit(f"a rank failed: {e}") from None
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--law", default="gaussian",
                    choices=("gaussian", "exponential"))
    ap.add_argument("--grid", type=int, default=8)
    ap.add_argument("--neurons-per-column", type=int, default=60)
    ap.add_argument("--steps", type=int, default=300,
                    help="target sim step (rounded up to whole segments)")
    ap.add_argument("--segment-steps", type=int, default=50)
    ap.add_argument("--tiles", default=None,
                    help="TYxTX tiling, every tile on the one device "
                         "(default 1x1)")
    ap.add_argument("--device", default="cuda",
                    help="where the run lives (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every N segments")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0,
                    help="synapse-table realization seed")
    ap.add_argument("--state-seed", type=int, default=None,
                    help="initial-state/noise seed (default: follows "
                         "--seed); lets two runs share one network "
                         "realization under different dynamics")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated member state seeds: run an "
                         "ensemble, every member through one sim "
                         "function (mutually exclusive with "
                         "--state-seed)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint")
    ap.add_argument("--retile", action="store_true",
                    help="allow resuming a checkpoint written under a "
                         "different tiling (elastic restart)")
    ap.add_argument("--preempt-after", type=int, default=None,
                    help="simulate a SIGTERM after N segments (testing)")
    ap.add_argument("--metrics-out", default=None,
                    help="write driver metrics_log JSON here")
    ap.add_argument("--record", action="store_true",
                    help="spike observatory: record every (step, neuron) "
                         "spike event and spool it to <ckpt-dir>/spool "
                         "(analyze with python -m "
                         "repro_torch.launch.analyze)")
    ap.add_argument("--record-cap", type=int, default=None,
                    help="recorder event capacity per shard per segment "
                         "(default: the no-drop bound; overflow is "
                         "counted, never silent)")
    ap.add_argument("--plastic", action="store_true",
                    help="STDP plasticity: weight tables + traces ride "
                         "the state and every checkpoint, and "
                         "elastic retiles relay them by global synapse "
                         "id (a plastic checkpoint only resumes with "
                         "--plastic and identical STDP parameters)")
    ap.add_argument("--stdp-a-plus", type=float, default=None,
                    help="LTP amplitude override (with --plastic)")
    ap.add_argument("--stdp-a-minus", type=float, default=None,
                    help="LTD amplitude override (with --plastic)")
    ap.add_argument("--telemetry-out", default=None,
                    help="append the runtime telemetry stream (spans + "
                         "structured events + per-segment metrics) as "
                         "JSON lines here; a resumed run appends to the "
                         "same file (exactly-once records per process)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace JSON of the run's spans "
                         "here (open in chrome://tracing or "
                         "ui.perfetto.dev; async checkpoint/spool "
                         "writer threads render as their own lanes)")
    ap.add_argument("--trace-dir", default=None,
                    help="opt-in torch.profiler trace into this "
                         "directory (host operators and the card's "
                         "kernels, as Chrome JSON; heavyweight -- the "
                         "span tracer stays cheap and separate)")
    ap.add_argument("--log-json", action="store_true",
                    help="emit repro_torch.* logs as JSON lines (one "
                         "object per record, structured event payload "
                         "attached) instead of human-readable text")
    ap.add_argument("--sanitize", action="store_true",
                    help="debug/CI mode: owning-thread assertions on "
                         "the async writers (catches writer races at "
                         "their origin)")
    ap.add_argument("--nproc", type=int, default=None,
                    help="run on N rank processes, one tile each (the "
                         "tiling defaults to the host-mesh shape of N); "
                         "default: one process holding every tile")
    ap.add_argument("--transport", default="gloo",
                    choices=("gloo", "nccl"),
                    help="how the ranks move their halo strips (gloo: "
                         "CUDA strips staged through host memory, ranks "
                         "may share a card; nccl: one card a rank)")
    return ap


def _run(args, mesh=None):
    """The job in this process: every tile, or (``mesh``) this rank's;
    rank 0 reports."""
    root = mesh is None or mesh.rank == 0
    if args.sanitize:
        enable_sanitizers()
    if args.log_json:
        enable_json_logging()
    tel = NULL
    if root and (args.telemetry_out or args.trace_out):
        tel = Telemetry(jsonl_path=args.telemetry_out)
        set_default(tel)
    driver = build_driver(args, telemetry=tel, mesh=mesh)
    with torch_profiler_trace(args.trace_dir if root else None,
                              cuda=driver.device.type == "cuda"):
        out = driver.run(args.steps)
    t = int(np.max(out["state"]["t"]))
    rate = driver.firing_rate_hz(out["state"])
    totals = driver.metric_totals(out["state"])
    plastic = plastic_members = None
    if driver.plastic:
        if driver.n_members is None:
            plastic = driver.plastic_summary(out["state"])
        else:
            plastic_members = [driver.plastic_summary(out["state"], member=m)
                               for m in range(driver.n_members)]
            plastic = plastic_members[0]
    if not root:
        return out
    extra = (f" plastic_checksum={plastic['weight_checksum'][:12]} "
             f"w_l1_delta={plastic['w_l1_delta']:.4f}"
             if plastic else "")
    if driver.n_members is not None:
        extra += f" members={driver.n_members}"
    print(f"final_step={t} preempted={out['preempted']} "
          f"rate_hz={rate:.2f} "
          f"synapses={driver.table_stats['n_synapses']} "
          f"dropped_events={totals['dropped']:.0f} "
          f"stragglers={len(out['stragglers'])} "
          f"captures={driver.captures()}" + extra)
    if args.metrics_out:
        d = os.path.dirname(args.metrics_out)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {"final_step": t, "preempted": out["preempted"],
                   "rate_hz": rate,
                   "tiles": list(driver.dist_cfg.tiles),
                   "ranks": 1 if mesh is None else mesh.size,
                   "totals": totals,
                   # active_cap compaction overflow, surfaced explicitly
                   # (nonzero means results undercount synaptic events)
                   "dropped_events": totals["dropped"],
                   "captures": driver.captures(),
                   "metrics": out["metrics"]}
        if driver.n_members is not None:
            payload["ensemble_seeds"] = list(driver.dist_cfg.ensemble_seeds)
        if plastic_members is not None:
            # per-member learned-weight digests: member m's equals the
            # solo run's with state seed seeds[m]
            payload["plastic_members"] = plastic_members
        if driver.spool is not None:
            payload["recording"] = {
                "spooled_events": sum(driver.spool.offsets().values()),
                "recorder_dropped": driver.recorder_dropped,
                "spool_dir": driver.spool.directory}
        if plastic is not None:
            # weight_checksum is tiling-invariant (global synapse ids,
            # canonical order): preempt->resume->retile runs compare
            # with an unpreempted one through it
            payload["plastic"] = plastic
        with open(args.metrics_out, "w") as f:
            json.dump(payload, f, indent=1)
    if args.telemetry_out:
        tel.flush_jsonl()
    if args.trace_out:
        write_chrome_trace(tel, args.trace_out)
    return out


if __name__ == "__main__":
    main()
