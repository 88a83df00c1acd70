"""The paper's own experiment, end to end (the port's counterpart of the
reference's ``examples/snn_simulation.py``): a multi-shard
spiking-network run comparing the two connectivity laws, with the halo
exchange, the paper's cost metric, and an STDP demo.

By default the slab runs as 2x2 tiles stacked on one device
(``core.dist_engine``'s single-device form); ``--nproc N`` runs one tile
per rank process instead (``launch.mesh.spawn_ranks``, the tiles laid
out by the reference's host-mesh rule), their halo strips moved over
``torch.distributed`` (gloo; CUDA strips staged through host memory, so
the ranks may share a card).  Both go through
``dist_engine.simulate(cfg, n_steps, timed, device, mesh)``.

    PYTHONPATH=src python -m repro_torch.examples.snn_simulation [--steps 300]
"""

from __future__ import annotations

import argparse
import sys

from .. import resolve_device
from ..configs.snn import reduced_case
from ..core.dist_engine import DistConfig, simulate
from ..core.engine import (EngineConfig, build_shard_tables,
                           init_plasticity, init_sim_state)
from ..core.engine import simulate as engine_simulate
from ..core.grid import ColumnGrid, TileDecomposition
from ..core.stdp import STDPParams
from ..kernels import _build

LAWS = ("gaussian", "exponential")
TILES = (2, 2)                       # the stacked form's tiling
STDP_GRID, STDP_NEURONS, STDP_STEPS = 4, 40, 150


def law_config(law_name: str, grid: int, n_per_column: int,
               tiles) -> DistConfig:
    case = reduced_case(law_name, grid=grid, n_per_column=n_per_column)
    law = case.connectivity()
    dec = TileDecomposition(grid=ColumnGrid(*case.grid, case.n_per_column),
                            tiles_y=tiles[0], tiles_x=tiles[1],
                            radius=law.radius)
    return DistConfig(engine=EngineConfig(decomp=dec, law=law))


def compare_laws(args, device, mesh=None, report=True) -> dict:
    """Both laws, ``args.steps`` timed steps each (after as many
    untimed); per law the rate, cost per event, events, drops,
    synapses and the kernels this process launched."""
    tiles = TILES if mesh is None else tuple(mesh.shape)
    if report:
        where = (f"{tiles[0]}x{tiles[1]} tiles stacked on one device"
                 if mesh is None else
                 f"{tiles[0]}x{tiles[1]} tiles on {mesh.size} ranks")
        print(f"mesh: {where}")
    results = {}
    for law_name in LAWS:
        cfg = law_config(law_name, args.grid, args.neurons_per_column, tiles)
        before = _build.launch_counts()
        out = simulate(cfg, args.steps, timed=True, device=device,
                       mesh=mesh)
        cost = out["elapsed_s"] / max(out["events_timed"], 1)
        results[law_name] = dict(
            rate=out["rate_hz"], cost=cost, events=out["events"],
            dropped=out["dropped"], syn=out["stats"]["n_synapses"],
            launches=_build.launches_since(before))
        if report:
            print(f"{law_name:12s} stencil "
                  f"{cfg.engine.law.stencil_width:2d}: "
                  f"rate {out['rate_hz']:6.2f} Hz, "
                  f"{int(out['events']):9d} events, "
                  f"cost/event {cost:.2e} s, dropped {int(out['dropped'])}")
    r = results
    ratio = r["exponential"]["cost"] / r["gaussian"]["cost"]
    results["cost_ratio"] = ratio
    if report:
        print(f"\ncost ratio exp/gauss: {ratio:.2f} (paper measured "
              "1.9-2.3 on CPU/MPI; see benchmarks/fig2)")
    return results


def stdp_demo(device) -> dict:
    """Single shard, 4x4x40, 150 plastic steps: how many plastic synapses
    moved, and their mean |dw|."""
    law = reduced_case("gaussian", grid=STDP_GRID,
                       n_per_column=STDP_NEURONS).connectivity()
    dec = TileDecomposition(grid=ColumnGrid(STDP_GRID, STDP_GRID,
                                            STDP_NEURONS),
                            tiles_y=1, tiles_x=1, radius=law.radius)
    cfg = EngineConfig(decomp=dec, law=law, stdp=STDPParams())
    tabs = build_shard_tables(cfg, device=device)
    aux = init_plasticity(tabs, cfg)
    w0 = tabs["local"]["w"].clone()
    (_, tabs2, _), _ = engine_simulate(init_sim_state(cfg, device=device),
                                       tabs, cfg, STDP_STEPS, device=device,
                                       plasticity=aux)
    moved = (tabs2["local"]["w"] - w0).abs()[w0 > 0]
    n_moved = int((moved > 1e-6).sum())
    mean = float(moved.mean())
    print(f"\nSTDP: {n_moved} plastic synapses moved, "
          f"mean |dw| {mean:.2e} over {STDP_STEPS} ms")
    return {"moved": n_moved, "mean_abs_dw": mean}


def _rank_entry(rank: int, world: int, argv) -> None:
    """One rank of ``--nproc``: its tile of both laws' runs; rank 0
    reports (the metrics are the whole slab's on every rank)."""
    import torch
    from ..launch.mesh import make_host_mesh
    args = _parser().parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
        torch.cuda.set_device(device)
    compare_laws(args, resolve_device(device), make_host_mesh(),
                 report=rank == 0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--grid", type=int, default=8)
    ap.add_argument("--neurons-per-column", type=int, default=60)
    ap.add_argument("--nproc", type=int, default=None,
                    help="one tile per rank process (default: 2x2 tiles "
                    "stacked on one device)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    if args.nproc is None:
        out["laws"] = compare_laws(args, device)
    else:
        from ..launch.mesh import RankFailure, spawn_ranks
        try:
            spawn_ranks(_rank_entry, args.nproc, args=(argv,))
        except RankFailure as e:
            raise SystemExit(f"a rank failed: {e}") from None
    out["stdp"] = stdp_demo(device)
    return out


if __name__ == "__main__":
    main()
