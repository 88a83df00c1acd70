"""Rank workers of ``tests/test_torch_ranks.py``: the functions each
rank process runs (``launch.mesh.spawn_ranks``).  They import torch,
numpy and the port only, never jax, so a rank starts in a few seconds.

A job is a pickle of cases that the test writes; each rank runs every
case in the same order (a run exchanges strips with the neighbours, so
the ranks go in lockstep) and writes ``result_{rank}.json``: per case,
None when its block equals the stacked form's ``[y, x]`` slice, else
what differs, and the bytes its transport moved.  A rank that raises
ends the job (``spawn_ranks`` raises ``RankFailure``).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core import halo as thalo
from repro_torch.core.stdp import STDPParams
from repro_torch.launch.mesh import RankMesh, make_host_mesh
from repro_torch.obs import record as trec

GRID, N_PER_COL, STEPS = 6, 30, 60
KW = {"cap_headroom": 1.0, "ext_rate_hz": 20.0}
SMALL_CAPACITY = 500


def port_config(law: str, ty: int, tx: int, kind: str, seeds=None,
                axis_y="data", axis_x="model", halo_mode="strip",
                pack_spikes=True) -> tde.DistConfig:
    """The 6x6x30 configuration of ``tests/test_torch_dist.py``'s case
    ``kind`` on a ``ty x tx`` tiling (``seeds``: an ensemble)."""
    kw = dict(KW)
    if kind.endswith("gather_all"):
        kw["mode"] = "gather_all"
    if kind.startswith("plastic"):
        kw["stdp"] = STDPParams()
    lw = getattr(tconn, f"{law}_law")()
    return tde.DistConfig(
        engine=teng.EngineConfig(decomp=tgrid.TileDecomposition(
            tgrid.ColumnGrid(GRID, GRID, N_PER_COL), ty, tx, lw.radius),
            law=lw, **kw),
        axis_y=axis_y, axis_x=axis_x, halo_mode=halo_mode,
        pack_spikes=pack_spikes, ensemble_seeds=seeds)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.view(np.dtype(f"u{x.dtype.itemsize}"))
    return x


def differs(want, got, what: str) -> Optional[str]:
    a, b = bits(want), bits(got)
    if a.shape != b.shape:
        return f"{what}: shape {b.shape}, want {a.shape}"
    n = int((a != b).sum())
    return f"{what}: {n} of {a.size} values differ" if n else None


def run_dict(out, kind: str) -> dict:
    """A run's leaves under the names of the reference's ``.npz``
    files (``tests/test_torch_dist.py``), as numpy bits."""
    state, per = out[0], out[1]
    d = {"per_step": bits(per), "i_ring": bits(state["i_ring"]),
         "t": np.asarray(state["t"])}
    for k in ("v", "c", "refrac"):
        d[f"neuron_{k}"] = bits(state["neuron"][k])
    for k in ("spikes", "events", "dropped"):
        d[f"metrics_{k}"] = bits(state["metrics"][k])
    if kind.startswith("plastic"):
        pl = state["plastic"]
        for ti, w in enumerate(pl["w"]):
            d[f"plastic_w_{ti}"] = bits(w)
        d["plastic_x_pre"] = bits(pl["x_pre"][0])
        d["plastic_x_post"] = bits(pl["x_post"])
    if kind.startswith("recorded"):
        for k in ("step", "gid", "count", "dropped"):
            d[f"rec_{k}"] = bits(out[2][k])
    return d


def compare(want: dict, got: dict, y: int, x: int) -> Optional[str]:
    """None when every leaf of ``got`` (a rank's block) equals the
    ``[y, x]`` slice of ``want``'s (stacked), else the differences."""
    bad = []
    for k, v in got.items():
        if k not in want:
            bad.append(f"{k}: missing from the stacked run")
            continue
        d = differs(np.asarray(want[k])[y:y + 1, x:x + 1], v, k)
        if d:
            bad.append(d)
    return "; ".join(bad) or None


def rank_run(cfg: tde.DistConfig, kind: str, mesh, drive=None,
             steps: int = STEPS):
    """A rank's run of case ``kind`` on its own build of its tile;
    ``drive`` the stacked drive (its block is injected), or None to draw
    on the rank's generators.  Returns ``(out, sim, tables, slots)``."""
    tables, _ = tde.build_dist_tables(cfg, device="cpu", mesh=mesh)
    state = tde.init_dist_state(cfg, device="cpu", mesh=mesh)
    inputs = tde.SimInputs(tables=tables)
    if drive is not None:
        y, x = tde.rank_tile(cfg, mesh)
        inputs.drive = torch.from_numpy(np.ascontiguousarray(
            drive[:, y:y + 1, x:x + 1]))
    recorder = slots = None
    if kind.startswith("plastic"):
        state["plastic"] = tde.init_dist_plastic_state(cfg, tables)
        slots, _ = tde.build_dist_inverse_index(cfg, tables, mesh=mesh)
        inputs.inv_slots = slots
        inputs.tables = tde.fold_plastic_tables(tables)
    if kind.startswith("recorded"):
        recorder = trec.recorder_spec(
            cfg.engine, steps,
            capacity=SMALL_CAPACITY if kind == "recorded_small" else None)
        inputs.gids = torch.from_numpy(tde.rank_block(
            cfg, trec.stacked_gid_maps(cfg.engine.decomp), mesh))
    sim = tde.make_sim_fn(cfg, steps, recorder=recorder,
                          storage=tables.storage, device="cpu", mesh=mesh,
                          transport="gloo")
    return sim(state, inputs), sim, tables, slots


def run_import_bytes(cfg: tde.DistConfig, y: int, x: int) -> int:
    """``halo_import_bytes`` of one step of tile ``(y, x)``: its
    excitatory spikes (bit-packed when ``pack_spikes``), and a plastic
    run's float32 pre-traces, of every member."""
    spec, d = cfg.engine.spec(), cfg.engine.decomp
    n_exc, m = spec.n_exc_per_col, cfg.n_members or 1
    per_col = m * (thalo.packed_width(n_exc) if cfg.pack_spikes
                   else 4 * n_exc)
    if cfg.engine.stdp is not None:
        per_col += m * 4 * n_exc
    return thalo.halo_import_bytes(d.tile_h, d.tile_w, d.radius, per_col,
                                   cfg.halo_mode, tiles=cfg.tiles,
                                   at=(y, x))


def exchange_case(mesh, case: dict) -> dict:
    """One exchange on ranks against the stacked exchange of the same
    slab, and the bytes moved against ``halo_import_bytes``."""
    ty, tx = mesh.axis_size(case["axis_y"]), mesh.axis_size(case["axis_x"])
    th, tw, f, radius = case["tile"] + (case["f"], case["radius"])
    rng = np.random.default_rng(case["seed"])
    glob = rng.integers(0, 2, size=(ty * th, tx * tw, f)).astype(np.float32)
    tiles = torch.from_numpy(np.ascontiguousarray(
        glob.reshape(ty, th, tx, tw, f).transpose(0, 2, 1, 3, 4)))
    y, x = mesh.axis_index(case["axis_y"]), mesh.axis_index(case["axis_x"])
    want = thalo.exchange_halo_2d(tiles, radius=radius,
                                  mode=case["mode"])[y, x]
    t = thalo.Transport("gloo", "cpu")
    payload = tiles[y, x]
    if case["packed"]:
        payload = thalo.pack_bits(payload)
    got = thalo.exchange_halo_2d(payload, radius=radius, mode=case["mode"],
                                 mesh=mesh, axis_y=case["axis_y"],
                                 axis_x=case["axis_x"], transport=t)
    if case["packed"]:
        got = thalo.unpack_bits(got, f)
    bad = differs(want, got, "region")
    expect = thalo.halo_import_bytes(th, tw, radius, payload.shape[-1]
                                     * payload.element_size(), case["mode"],
                                     tiles=(ty, tx), at=(y, x))
    if bad is None and t.bytes_received != expect:
        bad = (f"received {t.bytes_received} B, halo_import_bytes "
               f"{expect} B")
    return {"error": bad, "sent": t.bytes_sent,
            "received": t.bytes_received}


def wait_for(path: str, abort: Path, timeout_s: float = 900.0) -> None:
    """Return once ``path`` exists (the test makes the stacked runs and
    the reference's while the ranks run); raise if ``abort`` appears
    first (the test failed to make them) or at the timeout."""
    import time
    deadline = time.monotonic() + timeout_s
    while not Path(path).exists():
        if abort.exists() or time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)


def worker(rank: int, world: int, job_path: str) -> None:
    """Run every case of the job at ``job_path`` on this rank."""
    torch.set_num_threads(1)
    job = pickle.loads(Path(job_path).read_bytes())
    out = {}
    for name, case in job["cases"].items():
        kind = case["kind"]
        if "ready" in case:
            wait_for(case["ready"], Path(job["dir"], "abort"))
        if kind == "exchange":
            mesh = RankMesh(tuple(case["mesh"]), tuple(case["axes"]), rank)
            out[name] = exchange_case(mesh, case)
            continue
        cfg = port_config(*case["config"], seeds=case.get("seeds"))
        mesh = make_host_mesh(cfg.tiles)
        y, x = tde.rank_tile(cfg, mesh)
        if kind == "tables":
            tables, _ = tde.build_dist_tables(cfg, device="cpu", mesh=mesh)
            want = np.load(case["want"])
            got = {f"table_{ti}_{k}": bits(v)
                   for ti, tier in enumerate(tables.tiers())
                   for k, v in tier.items()}
            if case.get("inverse"):
                got["inv_slots"] = bits(tde.build_dist_inverse_index(
                    cfg, tables, mesh=mesh)[0])
            err = compare(want, got, y, x)
            out[name] = {"error": err}
            continue
        if kind == "simulate":
            res = tde.simulate(cfg, case["steps"], device="cpu", mesh=mesh)
            want = json.loads(Path(case["want"]).read_text())
            got = {k: res[k] for k in ("rate_hz", "events", "dropped")}
            got["n_synapses"] = res["stats"]["n_synapses"]
            out[name] = {"error": None if got == want
                         else f"{got} != {want}"}
            continue
        want = np.load(case["want"])
        drive = want["drive"] if case["inject"] else None
        res, sim, _, _ = rank_run(cfg, case["run"], mesh, drive)
        got = run_dict(res, case["run"])
        err = compare(want, got, y, x)
        expect = STEPS * run_import_bytes(cfg, y, x)
        if err is None and sim.transport.bytes_received != expect:
            err = (f"received {sim.transport.bytes_received} B, "
                   f"halo_import_bytes x steps {expect} B")
        out[name] = {"error": err, "sent": sim.transport.bytes_sent,
                     "received": sim.transport.bytes_received}
    Path(job["dir"], f"result_{rank}.json").write_text(json.dumps(out))


def failing_worker(rank: int, world: int) -> None:
    """A rank that raises (rank 1) while the others wait on it."""
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def driver_worker(rank: int, world: int, job_path: str) -> None:
    """Run the job's driver operations for this world size, in order:
    ``{"op": "run", "spec": SimJobSpec fields}`` (rank 0 writes the
    plastic digest to ``"summary"`` when given) or ``{"op": "copy",
    "src", "dst"}`` (a checkpoint directory, by rank 0)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.runtime import SimJobSpec, build_sim_driver
    torch.set_num_threads(1)
    job = pickle.loads(Path(job_path).read_bytes())
    for op in job[world]:
        if op["op"] == "copy":
            if rank == 0:
                shutil.copytree(op["src"], op["dst"])
            dist.barrier()
            continue
        spec = SimJobSpec(**op["spec"])
        mesh = make_host_mesh(spec.tiles)
        drv = build_sim_driver(spec, device="cpu", mesh=mesh)
        out = drv.run(spec.t_steps)
        if op.get("summary"):
            summary = drv.plastic_summary(out["state"])
            if rank == 0:
                Path(op["summary"]).write_text(json.dumps(summary))
        dist.barrier()
