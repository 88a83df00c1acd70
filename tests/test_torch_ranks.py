"""Port parity: the SNN on ranks, one tile per process over
``torch.distributed`` (gloo, CPU), against the reference's ``shard_map``
runs and against the port's stacked single-device runs, bit for bit.

Each rank runs in a process of its own (``launch.mesh.spawn_ranks``,
one torch thread, a ``FileStore`` rendezvous); a job of many cases runs
in one spawn of 2 ranks (the 1x2 and 2x1 tilings) and one of 4 (2x2),
and every rank writes its verdict per case (``tests/_torch_ranks.py``).
The reference's runs come from ``tests/test_torch_dist.py``'s
``reference_runs`` (one 4-device subprocess a session); the ranks inject
their tile's block of the reference's drive.  The stacked runs with the
port's own drive are made here; the ranks draw theirs on their own
generators, seeded as the stacked state seeds their tile.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core import dist_engine as tde
from repro_torch.core import halo as thalo
from repro_torch.launch import mesh as tmesh
from repro_torch.obs import record as trec

import _torch_ranks as R
from test_torch_dist import CASES, ENSEMBLE, reference_dir
from test_torch_dist import reference_runs  # noqa: F401  (fixture)

# the exchange cases: (mesh shape, axes, axis_y, axis_x, tile, f, radius,
# mode, packed); radii past the tile take several hops
EXCHANGES = {
    2: [((1, 2), ("data", "model"), "data", "model", (3, 2), 5, 1,
         "strip", False),
        ((1, 2), ("data", "model"), "data", "model", (3, 2), 5, 3,
         "strip", True),
        ((2, 1), ("data", "model"), "data", "model", (2, 3), 9, 5,
         "block", True),
        ((2, 1), ("data", "model"), "data", "model", (2, 3), 3, 4,
         "block", False)],
    4: [((2, 2), ("data", "model"), "data", "model", (3, 3), 5, 2,
         "strip", False),
        ((2, 2), ("data", "model"), "data", "model", (2, 3), 8, 4,
         "strip", True),
        ((2, 2), ("data", "model"), "data", "model", (3, 2), 7, 5,
         "block", True),
        ((4, 1), ("data", "model"), "data", "model", (2, 2), 3, 5,
         "strip", True),
        ((1, 4), ("data", "model"), "data", "model", (2, 2), 3, 5,
         "block", False),
        # ("pod", "data") folded into the tile rows, pod major
        ((2, 1, 2), ("pod", "data", "model"), ("pod", "data"), "model",
         (2, 3), 6, 3, "strip", True)],
}
RUNS = {2: [n for n, c in CASES.items() if c[1:3] in ((1, 2), (2, 1))],
        4: [n for n, c in CASES.items() if c[1:3] == (2, 2)]
        + list(ENSEMBLE["dist"])}
TABLES = {2: ["exponential_1x2", "gaussian_2x1"],
          4: ["gaussian_2x2", "exponential_2x2_plastic",
              "gaussian_2x2_plastic_gather_all"]}


def exchange_name(c) -> str:
    mesh, _, ay, _, tile, f, r, mode, packed = c
    fold = "-folded" if not isinstance(ay, str) else ""
    return (f"{'x'.join(map(str, mesh))}{fold}-tile{tile[0]}x{tile[1]}-"
            f"f{f}-r{r}-{mode}" + ("-packed" if packed else ""))


def case_config(name: str):
    """(law, ty, tx, kind, ensemble seeds) of a reference case."""
    if name in ENSEMBLE["dist"]:
        law, kind = ENSEMBLE["dist"][name]
        return law, 2, 2, kind, tuple(ENSEMBLE["seeds"])
    law, ty, tx, kind = CASES[name]
    return law, ty, tx, kind, None


def stacked_run(name: str) -> dict:
    """The port's stacked run of case ``name`` with its own drive."""
    law, ty, tx, kind, seeds = case_config(name)
    cfg = R.port_config(law, ty, tx, kind, seeds=seeds)
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state = tde.init_dist_state(cfg, device="cpu")
    inputs = tde.SimInputs(tables=tables)
    recorder = None
    if kind.startswith("plastic"):
        state["plastic"] = tde.init_dist_plastic_state(cfg, tables)
        inputs.inv_slots = tde.build_dist_inverse_index(cfg, tables)[0]
        inputs.tables = tde.fold_plastic_tables(tables)
    if kind.startswith("recorded"):
        recorder = trec.recorder_spec(
            cfg.engine, R.STEPS,
            capacity=R.SMALL_CAPACITY if kind == "recorded_small" else None)
        inputs.gids = torch.from_numpy(
            trec.stacked_gid_maps(cfg.engine.decomp))
    sim = tde.make_sim_fn(cfg, R.STEPS, recorder=recorder,
                          storage=tables.storage, device="cpu")
    return R.run_dict(sim(state, inputs), kind)


def make_job(world: int, ref_dir, out_dir) -> dict:
    """The job's cases in the order the ranks run them: those that need
    neither the reference's files nor the stacked runs first, then the
    reference's and the stacked runs', which the test makes while the
    ranks run (the ranks wait for each; the reference's first when its
    ``done`` file is already there)."""
    cases = {}
    for c in EXCHANGES[world]:
        mesh, axes, ay, ax, tile, f, r, mode, packed = c
        cases[f"exchange-{exchange_name(c)}"] = {
            "kind": "exchange", "mesh": mesh, "axes": axes, "axis_y": ay,
            "axis_x": ax, "tile": tile, "f": f, "radius": r, "mode": mode,
            "packed": packed, "seed": len(cases)}
    if world == 4:
        cfg = R.port_config("gaussian", 2, 2, "static")
        res = tde.simulate(cfg, 20, device="cpu")
        want = {k: res[k] for k in ("rate_hz", "events", "dropped")}
        want["n_synapses"] = res["stats"]["n_synapses"]
        (out_dir / "simulate.json").write_text(json.dumps(want))
        cases["simulate-gaussian_2x2"] = {
            "kind": "simulate", "config": ("gaussian", 2, 2, "static"),
            "steps": 20, "want": str(out_dir / "simulate.json")}
    ref_ready = (ref_dir / "done").exists()
    for inject in (ref_ready, not ref_ready):
        for name in RUNS[world]:
            law, ty, tx, kind, seeds = case_config(name)
            want = (ref_dir / f"{name}.npz" if inject
                    else out_dir / f"stacked-{name}.npz")
            cases[f"{'reference' if inject else 'stacked'}-{name}"] = {
                "kind": "run", "run": kind, "config": (law, ty, tx, kind),
                "seeds": seeds, "inject": inject, "want": str(want),
                "ready": str(ref_dir / "done" if inject else want)}
    for name in TABLES[world]:
        law, ty, tx, kind, _ = case_config(name)
        cases[f"tables-{name}"] = {
            "kind": "tables", "config": (law, ty, tx, kind),
            "want": str(ref_dir / f"{name}.npz"),
            "ready": str(ref_dir / "done"),
            "inverse": kind.startswith("plastic")}
    return {"cases": cases, "dir": str(out_dir)}


def stacked_runs(world: int, out_dir) -> None:
    """Each run case's stacked run, saved where the ranks wait for it
    (written whole, then renamed)."""
    for name in RUNS[world]:
        tmp = out_dir / f"partial-{name}.npz"
        np.savez(tmp, **stacked_run(name))
        tmp.rename(out_dir / f"stacked-{name}.npz")


def run_job(world: int, request, tmp_path_factory) -> dict:
    """Spawn the ranks on the job, make the stacked runs beside them,
    then see the reference's runs made (``reference_runs``, which the
    ranks wait for)."""
    import threading
    ref_dir = reference_dir(tmp_path_factory)
    out_dir = tmp_path_factory.mktemp(f"ranks{world}")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        job = make_job(world, ref_dir, out_dir)
        path = out_dir / "job.pkl"
        path.write_bytes(pickle.dumps(job))
        failed = []

        def spawn():
            try:
                tmesh.spawn_ranks(R.worker, world, args=(str(path),),
                                  timeout_s=600, store_dir=str(out_dir))
            except tmesh.RankFailure as e:
                failed.append(e)
        ranks = threading.Thread(target=spawn)
        ranks.start()
        try:
            stacked_runs(world, out_dir)
            request.getfixturevalue("reference_runs")
        except BaseException:
            (out_dir / "abort").write_text("")     # the ranks stop waiting
            raise
        finally:
            ranks.join()
    finally:
        torch.set_num_threads(n)
    if failed:
        raise failed[0]
    per_rank = [json.loads((out_dir / f"result_{r}.json").read_text())
                for r in range(world)]
    return {name: [r[name] for r in per_rank] for name in job["cases"]}


@pytest.fixture(scope="module")
def ranks2(request, tmp_path_factory):
    return run_job(2, request, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(request, tmp_path_factory):
    return run_job(4, request, tmp_path_factory)


def check(results: list) -> None:
    errors = [(rank, r["error"]) for rank, r in enumerate(results)
              if r["error"]]
    assert not errors, errors
    if "sent" in results[0]:
        # every byte a rank sent, another received
        assert sum(r["sent"] for r in results) == \
            sum(r["received"] for r in results) > 0


@pytest.mark.parametrize("c", EXCHANGES[2], ids=exchange_name)
def test_exchange_on_two_ranks_is_the_stacked_exchange(ranks2, c):
    check(ranks2[f"exchange-{exchange_name(c)}"])


@pytest.mark.parametrize("c", EXCHANGES[4], ids=exchange_name)
def test_exchange_on_four_ranks_is_the_stacked_exchange(ranks4, c):
    check(ranks4[f"exchange-{exchange_name(c)}"])


@pytest.mark.parametrize("name", TABLES[2])
def test_rank_tables_are_the_stacked_slices_two_ranks(ranks2, name):
    check(ranks2[f"tables-{name}"])


@pytest.mark.parametrize("name", TABLES[4])
def test_rank_tables_are_the_stacked_slices_four_ranks(ranks4, name):
    """Each rank builds its own tile and the ranks agree on the caps:
    the reference's stacked tables' slices, caps included; plastic
    cases also the stacked inverse index's slices (padded K agreed)."""
    check(ranks4[f"tables-{name}"])


@pytest.mark.parametrize("name", RUNS[2])
def test_two_rank_runs_match_reference(ranks2, name):
    check(ranks2[f"reference-{name}"])


@pytest.mark.parametrize("name", RUNS[2])
def test_two_rank_runs_match_stacked_native_drive(ranks2, name):
    check(ranks2[f"stacked-{name}"])


@pytest.mark.parametrize("name", RUNS[4])
def test_four_rank_runs_match_reference(ranks4, name):
    """Static, gather_all, plastic, recorded and M = 3 ensembles on a
    2x2 mesh: every rank's state, per-step spikes, metrics, plastic
    weights and traces, and recorder are its tile of the reference's
    ``shard_map`` run, and it received ``halo_import_bytes`` a step."""
    check(ranks4[f"reference-{name}"])


@pytest.mark.parametrize("name", RUNS[4])
def test_four_rank_runs_match_stacked_native_drive(ranks4, name):
    check(ranks4[f"stacked-{name}"])


def test_simulate_on_ranks_reports_the_stacked_keys(ranks4):
    check(ranks4["simulate-gaussian_2x2"])


def test_nccl_refuses_ranks_on_one_card():
    import torch.distributed as dist
    store = dist.HashStore()
    store.set("card/1", "GPU-0000")
    store.set("card/2", "GPU-0001")
    thalo.check_distinct_cards(store, 0, 3, "GPU-0002")
    with pytest.raises(thalo.SharedCardError, match="rank"):
        thalo.check_distinct_cards(store, 0, 3, "GPU-0001")


def test_transport_refuses_what_it_cannot_carry():
    class Fake:
        device = torch.device("cuda", 0)

    with pytest.raises(thalo.TransportError, match="cuda"):
        thalo.Transport("gloo", "cpu").check(Fake())
    with pytest.raises(thalo.TransportError, match="CUDA"):
        thalo.Transport("nccl", "cpu")
    with pytest.raises(ValueError, match="needs a transport"):
        thalo.exchange_halo_2d(torch.zeros(2, 2, 1), radius=1,
                               mesh=tmesh.RankMesh((1, 1), ("data",
                                                            "model"), 0))


def test_a_failed_rank_fails_the_run(tmp_path):
    with pytest.raises(tmesh.RankFailure, match="fails on purpose"):
        tmesh.spawn_ranks(R.failing_worker, 2, timeout_s=120,
                          store_dir=str(tmp_path))


def test_mesh_shapes_and_axes():
    assert tmesh.host_mesh_shape(4) == (2, 2)
    assert tmesh.host_mesh_shape(2) == (2, 1)
    assert tmesh.host_mesh_shape(8) == (4, 2)
    m = tmesh.RankMesh((2, 2, 3), ("pod", "data", "model"), 7)
    assert m.coordinate() == (1, 0, 1)
    assert m.axis_size(("pod", "data")) == 4
    assert m.axis_index(("pod", "data")) == 2
    assert m.neighbour(("pod", "data"), 1) == 10
    assert m.neighbour(("pod", "data"), -2) == 1
    assert m.neighbour("model", 2) is None
    assert tmesh.mesh_chips(m) == 12
    cfg = R.port_config("gaussian", 4, 3, "static", axis_y=("pod", "data"))
    assert tde.rank_tile(cfg, m) == (2, 1)
    with pytest.raises(ValueError, match="tiling"):
        tde.rank_tile(R.port_config("gaussian", 2, 2, "static"), m)
    with pytest.raises(RuntimeError, match="init_ranks"):
        tmesh.make_production_mesh()


def test_edge_aware_import_bytes_sum_to_the_strips():
    """``halo_import_bytes`` of a tile whose neighbours all exist is the
    reference's formula; at an edge, the strips from off the slab go."""
    from repro.core import halo as jhalo
    for args in ((3, 2, 1, 5), (2, 3, 5, 2), (4, 4, 10, 16)):
        for mode in ("strip", "block"):
            assert thalo.halo_import_bytes(*args, mode) == \
                jhalo.halo_import_bytes(*args, mode)
            inner = thalo.halo_import_bytes(*args, mode, tiles=(9, 9),
                                            at=(4, 4))
            assert inner == jhalo.halo_import_bytes(*args, mode)
    # a 2x2 tiling at 4x4 tiles, radius 10: one neighbour a side
    assert thalo.halo_import_bytes(4, 4, 10, 1, "strip", tiles=(2, 2),
                                   at=(0, 0)) == 4 * 4 + 4 * 24
