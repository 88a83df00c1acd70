"""Port parity: the multi-shard engine (stacked tiles on one device)
against the reference's distributed engine, bit for bit.

The reference runs ``make_sim_fn`` under ``shard_map`` on fake host
devices (``--xla_force_host_platform_device_count=4``), which must be
set before jax starts, so all its runs happen in one subprocess, once
per test session (``reference_runs``); its results and the per-tile drive
it drew (each tile's key split every step as ``shard_step`` splits it)
cross as ``.npz`` files.  The port runs on the CPU with that drive
injected (``SimInputs.drive``), on its own build of the same tables.
Configuration: 6x6 columns of 30 neurons, ``cap_headroom=1.0`` and
``ext_rate_hz=20.0``, so that halo delivery carries real spikes and
the drop rule above ``active_cap`` is exercised.
"""

import dataclasses
import fcntl
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import metrics as jmetrics
from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core import metrics as tmetrics
from repro_torch.core import synapses as tsyn
from repro_torch.core.stdp import STDPParams
from repro_torch.obs import record as trec

from _torch_parity import LAWS, assert_bits_equal, configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 60
GRID, N_PER_COL = 6, 30
KW = {"cap_headroom": 1.0, "ext_rate_hz": 20.0}
SMALL_CAPACITY = 500

# name -> (law, ty, tx, kind); kind: "static", "gather_all", "plastic",
# "plastic_gather_all", "recorded" (default capacity) or
# "recorded_small" (SMALL_CAPACITY)
CASES = {f"{law}_{ty}x{tx}": (law, ty, tx, "static")
         for law in LAWS for ty, tx in ((1, 2), (2, 1), (2, 2))}
CASES.update({
    "gaussian_2x2_gather_all": ("gaussian", 2, 2, "gather_all"),
    "exponential_2x2_plastic": ("exponential", 2, 2, "plastic"),
    "gaussian_2x2_plastic_gather_all": ("gaussian", 2, 2,
                                        "plastic_gather_all"),
    "exponential_2x2_recorded": ("exponential", 2, 2, "recorded"),
    "exponential_2x2_recorded_small": ("exponential", 2, 2,
                                       "recorded_small"),
})
# the ensembles' reference runs (tests/test_torch_ensemble.py): member
# seeds; single-shard ``simulate(..., ensemble=M)`` and 2x2
# ``make_sim_fn`` with ``ensemble_seeds``, name -> (law, kind); and one
# recorded ensemble ``SimDriver`` (seed 3, 4x4x20 in 2x1 tiles, 40
# steps in segments of 10)
ENSEMBLE = {
    "seeds": [0, 7, 13],
    "single": {"ens1_gaussian_static": ["gaussian", "static"],
               "ens1_exponential_recorded": ["exponential", "recorded"],
               "ens1_exponential_plastic": ["exponential", "plastic"]},
    "dist": {"ens_gaussian_2x2": ["gaussian", "static"],
             "ens_exponential_2x2_recorded": ["exponential", "recorded"],
             "ens_exponential_2x2_plastic": ["exponential", "plastic"]},
    "driver": {"grid": 4, "npc": 20, "seed": 3, "tiles": [2, 1],
               "steps": 40, "seg": 10},
}

REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.core import connectivity, engine as jeng, grid as jgrid
from repro.core import dist_engine as de
from repro.core.stdp import STDPParams
from repro.obs.record import recorder_spec, stacked_gid_maps

out_dir, steps, grid, n_per_col, small = sys.argv[1], *map(int, sys.argv[2:6])
cases = json.loads(sys.argv[6])


def raw(a):
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.view(np.dtype(f"u{a.dtype.itemsize}"))
    return a


def drives(cfg, keys, n_local):
    def body(k, _):
        k, k_ext = jax.random.split(k)
        return k, jeng.external_drive(k_ext, n_local, cfg)
    run = jax.jit(lambda k: jax.lax.scan(body, k, None, length=steps)[1])
    ty, tx = keys.shape[:2]
    return np.stack([np.stack([np.asarray(run(keys[y, x]))
                               for x in range(tx)], axis=1)
                     for y in range(ty)], axis=1)


built, drawn = {}, {}        # shared by the cases of one spec / tiling
for name, (law, ty, tx, kind) in cases.items():
    lw = getattr(connectivity, f"{law}_law")()
    kw = dict(use_kernels=False, cap_headroom=1.0, ext_rate_hz=20.0)
    if kind.endswith("gather_all"):
        kw["mode"] = "gather_all"
    if kind.startswith("plastic"):
        kw["stdp"] = STDPParams()
    e = jeng.EngineConfig(decomp=jgrid.TileDecomposition(
        jgrid.ColumnGrid(grid, grid, n_per_col), ty, tx, lw.radius),
        law=lw, **kw)
    cfg = de.DistConfig(engine=e)
    mesh = Mesh(np.array(jax.devices()[:ty * tx]).reshape(ty, tx),
                ("data", "model"))
    n_local = e.spec().n_local
    state = de.init_dist_state(cfg)
    if (law, ty, tx) not in drawn:
        drawn[law, ty, tx] = drives(e, state["rng"], n_local)  # (S,TY,TX,n)
    drive = drawn[law, ty, tx]
    plastic = kind.startswith("plastic")
    if (law, ty, tx, plastic) not in built:
        built[law, ty, tx, plastic] = de.build_dist_tables(cfg)[0]
    tables = built[law, ty, tx, plastic]
    inputs = de.SimInputs(tables=tables)
    save = {"drive": drive}
    for ti, tier in enumerate(tables.tiers()):
        for k, v in tier.items():
            save[f"table_{ti}_{k}"] = raw(v)
    recorder = None
    if plastic:
        host = jax.tree.map(np.asarray, tables)
        state["plastic"] = de.init_dist_plastic_state(cfg, host)
        slots, _ = de.build_dist_inverse_index(cfg, host)
        tables = de.fold_plastic_tables(tables)
        save["inv_slots"] = np.asarray(slots)
        inputs = de.SimInputs(tables=tables, inv_slots=jax.device_put(
            np.asarray(slots), NamedSharding(mesh, cfg.pspec(2))))
    if kind.startswith("recorded"):
        recorder = recorder_spec(
            e, steps, capacity=small if kind == "recorded_small" else None)
        gids = np.asarray(stacked_gid_maps(e.decomp))
        inputs = de.SimInputs(tables=tables, gids=jax.device_put(
            gids, NamedSharding(mesh, cfg.pspec(1))))
    ss, ts = de.dist_shardings(cfg, mesh, tables.storage)
    # placed from host copies: sharding a host array compiles nothing
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    state = jax.device_put(host(state), ss)
    inputs.tables = jax.device_put(host(tables), ts)
    sim = de.make_sim_fn(cfg, mesh, steps, recorder=recorder,
                         storage=tables.storage)
    out = sim(state, inputs)
    state, per = out[0], out[1]
    save["per_step"] = raw(per)
    for k in ("v", "c", "refrac"):
        save[f"neuron_{k}"] = raw(state["neuron"][k])
    save["i_ring"] = raw(state["i_ring"])
    save["t"] = np.asarray(state["t"])
    for k in ("spikes", "events", "dropped"):
        save[f"metrics_{k}"] = raw(state["metrics"][k])
    if plastic:
        pl = state["plastic"]
        for ti, w in enumerate(pl["w"]):
            save[f"plastic_w_{ti}"] = raw(w)
        save["plastic_x_pre"] = raw(pl["x_pre"][0])
        save["plastic_x_post"] = raw(pl["x_post"])
    if recorder is not None:
        for k, v in out[2].items():
            save[f"rec_{k}"] = np.asarray(v)
    np.savez(f"{out_dir}/{name}.npz", **save)
    print(name, float(np.asarray(per).sum()), flush=True)

# ensembles: each member's drive drawn from its own keys as the solo
# step draws it (the member axis after the tile axes)
ens = json.loads(sys.argv[7])
seeds = tuple(ens["seeds"])


def member_drives(cfg, keys, n_local):
    return np.stack([drives(cfg, keys[:, :, m], n_local)
                     for m in range(keys.shape[2])], axis=3)


def save_state(save, state):
    for k in ("v", "c", "refrac"):
        save[f"neuron_{k}"] = raw(state["neuron"][k])
    save["i_ring"] = raw(state["i_ring"])
    save["t"] = np.asarray(state["t"])
    for k in ("spikes", "events", "dropped"):
        save[f"metrics_{k}"] = raw(state["metrics"][k])


for name, (law, kind) in ens["single"].items():
    lw = getattr(connectivity, f"{law}_law")()
    kw = dict(use_kernels=False, cap_headroom=1.0, ext_rate_hz=20.0)
    if kind == "plastic":
        kw["stdp"] = STDPParams()
    e = jeng.EngineConfig(decomp=jgrid.TileDecomposition(
        jgrid.ColumnGrid(grid, grid, n_per_col), 1, 1, lw.radius),
        law=lw, **kw)
    n_local = e.spec().n_local
    tabs = jeng.build_shard_tables(e)
    state = jeng.init_ensemble_state(e, seeds)
    m = len(seeds)
    save = {"drive": member_drives(e, np.asarray(state["rng"])[None, None],
                                   n_local)[:, 0, 0]}
    if kind == "plastic":
        aux = jeng.init_plasticity(tabs, e)
        (st, tb, tr), per = jax.jit(lambda s: jeng.simulate(
            s, tabs, e, steps, plasticity=aux, ensemble=m))(state)
        save["plastic_w_0"] = raw(tb["local"]["w"])
        save["plastic_x_pre"] = raw(tr["x_pre"][0])
        save["plastic_x_post"] = raw(tr["x_post"])
    elif kind == "recorded":
        rspec = recorder_spec(e, steps)
        st, per, rec = jax.jit(lambda s: jeng.simulate(
            s, tabs, e, steps, recorder=rspec, ensemble=m))(state)
        for k, v in rec.items():
            save[f"rec_{k}"] = np.asarray(v)
    else:
        st, per = jax.jit(lambda s: jeng.simulate(
            s, tabs, e, steps, record_spikes=True, ensemble=m))(state)
    save["per_step"] = raw(per)
    save_state(save, st)
    np.savez(f"{out_dir}/{name}.npz", **save)
    print(name, float(np.asarray(per).sum()), flush=True)

for name, (law, kind) in ens["dist"].items():
    lw = getattr(connectivity, f"{law}_law")()
    kw = dict(use_kernels=False, cap_headroom=1.0, ext_rate_hz=20.0)
    if kind == "plastic":
        kw["stdp"] = STDPParams()
    e = jeng.EngineConfig(decomp=jgrid.TileDecomposition(
        jgrid.ColumnGrid(grid, grid, n_per_col), 2, 2, lw.radius),
        law=lw, **kw)
    cfg = de.DistConfig(engine=e, ensemble_seeds=seeds)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    n_local = e.spec().n_local
    state = de.init_dist_state(cfg)
    tables = de.build_dist_tables(cfg)[0]
    inputs = de.SimInputs(tables=tables)
    save = {"drive": member_drives(e, np.asarray(state["rng"]), n_local)}
    recorder = None
    if kind == "plastic":
        host = jax.tree.map(np.asarray, tables)
        state["plastic"] = de.init_dist_plastic_state(cfg, host)
        slots, _ = de.build_dist_inverse_index(cfg, host)
        tables = de.fold_plastic_tables(tables)
        inputs = de.SimInputs(tables=tables, inv_slots=jax.device_put(
            np.asarray(slots), NamedSharding(mesh, cfg.pspec(2))))
    if kind == "recorded":
        recorder = recorder_spec(e, steps)
        inputs = de.SimInputs(tables=tables, gids=jax.device_put(
            np.asarray(stacked_gid_maps(e.decomp)),
            NamedSharding(mesh, cfg.pspec(1))))
    ss, ts = de.dist_shardings(cfg, mesh, tables.storage)
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    state = jax.device_put(host(state), ss)
    inputs.tables = jax.device_put(host(tables), ts)
    sim = de.make_sim_fn(cfg, mesh, steps, recorder=recorder,
                         storage=tables.storage)
    out = sim(state, inputs)
    st, per = out[0], out[1]
    save["per_step"] = raw(per)
    save_state(save, st)
    if kind == "plastic":
        pl = st["plastic"]
        for ti, w in enumerate(pl["w"]):
            save[f"plastic_w_{ti}"] = raw(w)
        save["plastic_x_pre"] = raw(pl["x_pre"][0])
        save["plastic_x_post"] = raw(pl["x_post"])
    if recorder is not None:
        for k, v in out[2].items():
            save[f"rec_{k}"] = np.asarray(v)
    np.savez(f"{out_dir}/{name}.npz", **save)
    print(name, float(np.asarray(per).sum()), flush=True)

# the ensemble SimDriver: recorded, in segments, its spool on disk
from repro.parallel.compat import make_mesh
from repro.runtime import DriverConfig, SimDriver
drv_kw = ens["driver"]
lw = connectivity.gaussian_law()
ty, tx = drv_kw["tiles"]
e = jeng.EngineConfig(decomp=jgrid.TileDecomposition(
    jgrid.ColumnGrid(drv_kw["grid"], drv_kw["grid"], drv_kw["npc"]), ty, tx,
    lw.radius), law=lw, seed=drv_kw["seed"], use_kernels=False,
    cap_headroom=1.0, ext_rate_hz=20.0)
cfg = de.DistConfig(engine=e, ensemble_seeds=seeds)
drive = member_drives(e, np.asarray(de.init_dist_state(cfg)["rng"]),
                      e.spec().n_local)[:drv_kw["steps"]]
drv = SimDriver(DriverConfig(ckpt_dir=f"{out_dir}/ensemble_driver",
                             ckpt_every=1, keep=100, backoff_s=0.01,
                             handle_sigterm=False),
                cfg, make_mesh((ty, tx), ("data", "model")),
                segment_steps=drv_kw["seg"], record_events=True)
st = drv.run(drv_kw["steps"])["state"]
save = {"drive": drive,
        "counts": np.stack([drv.spike_counts(drv_kw["steps"], member=m)
                            for m in range(len(seeds))])}
save_state(save, st)
np.savez(f"{out_dir}/ensemble_driver.npz", **save)
print("ensemble_driver", float(save["counts"].sum()), flush=True)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's runs here are many small tensor ops, about as fast on
    one intra-op thread as on every core; one thread spares the cores
    when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_dir(tmp_path_factory):
    """Where ``reference_runs`` writes its files (``done`` last): the
    session's shared base directory (the parent of each xdist worker's)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return base / "dist_reference"


@pytest.fixture(scope="session")
def reference_runs(tmp_path_factory):
    """Every case's reference run, in one 4-device subprocess, once per
    test session: its files go to ``reference_dir``, and a lock lets one
    process run it while any other waits and then reads the files.  The
    ensembles' runs come with them (``ENSEMBLE``; ``"ensemble_driver"``
    also names the reference driver's checkpoint directory, its spool
    inside)."""
    out = reference_dir(tmp_path_factory)
    base = out.parent
    with open(base / "dist_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            env = dict(os.environ,
                       XLA_FLAGS="--xla_force_host_platform_device_count=4",
                       PYTHONPATH=os.path.join(REPO, "src"),
                       JAX_PLATFORMS="cpu")
            proc = subprocess.run(
                [sys.executable, "-c", REFERENCE, str(out), str(STEPS),
                 str(GRID), str(N_PER_COL), str(SMALL_CAPACITY),
                 json.dumps(CASES), json.dumps(ENSEMBLE)],
                env=env, capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, \
                proc.stdout + proc.stderr[-4000:]
            (out / "done").write_text("")
    names = list(CASES) + list(ENSEMBLE["single"]) + list(ENSEMBLE["dist"])
    runs = {name: dict(np.load(out / f"{name}.npz")) for name in names}
    runs["ensemble_driver"] = dict(np.load(out / "ensemble_driver.npz"),
                                   dir=out / "ensemble_driver")
    return runs


def port_config(law, ty, tx, kind, use_kernels=True):
    kw = dict(KW, use_kernels=use_kernels)
    if kind.endswith("gather_all"):
        kw["mode"] = "gather_all"
    if kind.startswith("plastic"):
        kw["stdp"] = STDPParams()
    lw = getattr(tconn, f"{law}_law")()
    return tde.DistConfig(engine=teng.EngineConfig(
        decomp=tgrid.TileDecomposition(
            tgrid.ColumnGrid(GRID, GRID, N_PER_COL), ty, tx, lw.radius),
        law=lw, **kw))


def port_run(name, ref, use_kernels=True):
    """The port's run of case ``name`` with the reference's drive."""
    law, ty, tx, kind = CASES[name]
    cfg = port_config(law, ty, tx, kind, use_kernels)
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state = tde.init_dist_state(cfg, device="cpu")
    inputs = tde.SimInputs(tables=tables,
                           drive=torch.from_numpy(ref["drive"]))
    recorder = None
    if kind.startswith("plastic"):
        state["plastic"] = tde.init_dist_plastic_state(cfg, tables)
        slots, aux = tde.build_dist_inverse_index(cfg, tables)
        assert aux["clipped"] == 0
        inputs.inv_slots = slots
        inputs.tables = tde.fold_plastic_tables(tables)
    if kind.startswith("recorded"):
        recorder = trec.recorder_spec(
            cfg.engine, STEPS,
            capacity=SMALL_CAPACITY if kind == "recorded_small" else None)
        inputs.gids = torch.from_numpy(
            trec.stacked_gid_maps(cfg.engine.decomp))
    sim = tde.make_sim_fn(cfg, STEPS, recorder=recorder,
                          storage=tables.storage, device="cpu")
    out = sim(state, inputs)
    return cfg, tables, inputs, out


def assert_same_run(ref, out, kind):
    state, per = out[0], out[1]
    assert_bits_equal(ref["per_step"], per, "per-step spikes")
    for k in ("v", "c", "refrac"):
        assert_bits_equal(ref[f"neuron_{k}"], state["neuron"][k], k)
    assert_bits_equal(ref["i_ring"], state["i_ring"], "i_ring")
    assert np.array_equal(ref["t"], state["t"]) and (state["t"] == STEPS
                                                       ).all()
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(ref[f"metrics_{k}"], state["metrics"][k], k)
    if kind.startswith("plastic"):
        pl = state["plastic"]
        for ti, w in enumerate(pl["w"]):
            assert_bits_equal(ref[f"plastic_w_{ti}"], w, f"w tier {ti}")
        assert_bits_equal(ref["plastic_x_pre"], pl["x_pre"][0], "x_pre")
        assert_bits_equal(ref["plastic_x_post"], pl["x_post"], "x_post")
    if kind.startswith("recorded"):
        for k in ("step", "gid", "count", "dropped"):
            assert_bits_equal(ref[f"rec_{k}"], out[2][k], f"recorder {k}")


STATIC = [n for n, c in CASES.items() if c[3] == "static"]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", STATIC)
def test_static_run_bit_identical(reference_runs, name, use_kernels):
    ref = reference_runs[name]
    _, tables, _, out = port_run(name, ref, use_kernels)
    assert_same_run(ref, out, "static")
    state = out[0]
    assert float(out[1].sum()) > 0
    # halo delivery carried spikes, and the drop rule was exercised
    assert len(tables.halo) > 0
    if name.endswith("2x2"):
        assert float(state["metrics"]["dropped"].sum()) > 0


def test_stacked_tables_match_reference(reference_runs):
    """Joint compression: the port's stacked tables are the reference's,
    array for array, caps included."""
    for name in ("gaussian_2x2", "exponential_1x2"):
        ref = reference_runs[name]
        law, ty, tx, kind = CASES[name]
        tables, stats = tde.build_dist_tables(
            port_config(law, ty, tx, kind), device="cpu")
        for ti, tier in enumerate(tables.tiers()):
            for k, v in tier.items():
                assert_bits_equal(ref[f"table_{ti}_{k}"], v,
                                  f"{name} tier {ti} {k}")
        assert stats["table_bytes_per_shard"] == \
            tsyn.materialized_table_bytes(tables, ty * tx)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_gather_all_run_bit_identical(reference_runs, use_kernels):
    name = "gaussian_2x2_gather_all"
    ref = reference_runs[name]
    assert_same_run(ref, port_run(name, ref, use_kernels)[3], "gather_all")


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", ["exponential_2x2_plastic",
                                  "gaussian_2x2_plastic_gather_all"])
def test_plastic_run_bit_identical(reference_runs, name, use_kernels):
    ref = reference_runs[name]
    _, tables, inputs, out = port_run(name, ref, use_kernels)
    assert_bits_equal(ref["inv_slots"], inputs.inv_slots, "inverse index")
    assert_same_run(ref, out, "plastic")
    # the local tier and halo tiers learned
    changed = [bool((w != tier["w"]).any())
               for w, tier in zip(out[0]["plastic"]["w"], tables.tiers())]
    assert changed[0] and any(changed[1:]), changed


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", ["exponential_2x2_recorded",
                                  "exponential_2x2_recorded_small"])
def test_recorded_run_bit_identical(reference_runs, name, use_kernels):
    ref = reference_runs[name]
    out = port_run(name, ref, use_kernels)[3]
    assert_same_run(ref, out, "recorded")
    rec = out[2]
    n_spikes = out[0]["metrics"]["spikes"].to(torch.int32)
    assert torch.equal(rec["dropped"], n_spikes - rec["count"])
    if name.endswith("small"):
        assert int(rec["dropped"].sum()) > 0
    # recording is a pure observer
    ref_static = reference_runs["exponential_2x2"]
    assert_bits_equal(ref_static["per_step"], out[1], "per-step spikes")


def test_returned_recorder_survives_a_later_call():
    """A 2x2 recorded ``make_sim_fn`` hands back a copy of its resident
    recorder: a later call of the same sim (an equal ``RecorderSpec``)
    from another ``state_seed`` leaves it unchanged.  With
    ``recorder_copy=False`` (the segmented driver, which drains at once)
    the call returns the resident buffers, which that later call
    refills."""
    cfg = port_config("exponential", 2, 2, "recorded")
    other = tde.DistConfig(engine=dataclasses.replace(
        cfg.engine, state_seed=cfg.engine.state_seed_value + 17))
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    recorder = trec.recorder_spec(cfg.engine, STEPS // 2)
    inputs = tde.SimInputs(tables=tables, gids=torch.from_numpy(
        trec.stacked_gid_maps(cfg.engine.decomp)))
    for copy in (True, False):
        sim = tde.make_sim_fn(cfg, STEPS // 2, recorder=recorder,
                              storage=tables.storage, device="cpu",
                              recorder_copy=copy)
        first = sim(tde.init_dist_state(cfg, device="cpu"), inputs)[2]
        kept = {k: x.clone() for k, x in first.items()}
        second = sim(tde.init_dist_state(other, device="cpu"), inputs)[2]
        assert int(kept["count"].sum()) > 0
        assert not torch.equal(kept["gid"], second["gid"])
        if copy:
            for k in kept:
                assert_bits_equal(kept[k], first[k], f"first call's {k}")
        else:
            assert all(first[k] is second[k] for k in first)


def test_drive_mismatch_and_missing_inputs_refused(reference_runs):
    ref = reference_runs["gaussian_2x2"]
    cfg = port_config("gaussian", 2, 2, "static")
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    sim = tde.make_sim_fn(cfg, STEPS - 1, storage=tables.storage,
                          device="cpu")
    with pytest.raises(ValueError, match="drive has shape"):
        sim(tde.init_dist_state(cfg, device="cpu"),
            tde.SimInputs(tables=tables,
                          drive=torch.from_numpy(ref["drive"])))
    pcfg = port_config("gaussian", 2, 2, "plastic")
    ptables, _ = tde.build_dist_tables(pcfg, device="cpu")
    psim = tde.make_sim_fn(pcfg, 2, storage=ptables.storage, device="cpu")
    pstate = tde.init_dist_state(pcfg, device="cpu")
    with pytest.raises(ValueError, match="plastic"):
        psim(pstate, tde.SimInputs(tables=ptables))
    pstate["plastic"] = tde.init_dist_plastic_state(pcfg, ptables)
    with pytest.raises(ValueError, match="inv_slots"):
        psim(pstate, tde.SimInputs(tables=tde.fold_plastic_tables(ptables)))
    with pytest.raises(ValueError, match="build-weight"):
        tde.init_dist_plastic_state(pcfg, tde.fold_plastic_tables(ptables))


def test_segments_continue_the_run(reference_runs):
    """Two calls of a 30-step sim equal one 60-step run: ``t`` rides in
    the state, which each call updates in place."""
    name = "exponential_2x2"
    ref = reference_runs[name]
    cfg = port_config("exponential", 2, 2, "static")
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state = tde.init_dist_state(cfg, device="cpu")
    sim = tde.make_sim_fn(cfg, STEPS // 2, storage=tables.storage,
                          device="cpu")
    drive = torch.from_numpy(ref["drive"])
    pers = []
    for k in range(2):
        half = drive[k * STEPS // 2:(k + 1) * STEPS // 2]
        out_state, per = sim(state, tde.SimInputs(tables=tables, drive=half))
        assert out_state is state
        pers.append(per)
    assert_same_run(ref, (state, torch.cat(pers, dim=2)), "static")


def test_derived_structures_built_once(reference_runs):
    """Float32 static tables take the fixed-order delivery through each
    tile's inverse index: built at the first step, found again at every
    later step and call (no growth of ``synapses.BUILD_COUNTS``)."""
    cfg = port_config("gaussian", 2, 2, "static")
    cfg = tde.DistConfig(engine=dataclasses.replace(
        cfg.engine, weight_dtype="float32"))
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state = tde.init_dist_state(cfg, device="cpu")
    inputs = tde.SimInputs(tables=tables)
    one = tde.make_sim_fn(cfg, 1, storage=tables.storage, device="cpu")
    before = dict(tsyn.BUILD_COUNTS)
    one(state, inputs)
    after_first = dict(tsyn.BUILD_COUNTS)
    assert after_first["inverse_index"] - before["inverse_index"] == 4
    tde.make_sim_fn(cfg, 5, storage=tables.storage, device="cpu")(
        state, inputs)
    one(state, inputs)
    assert tsyn.BUILD_COUNTS == after_first


@pytest.mark.parametrize("law", LAWS)
def test_one_by_one_equals_single_shard(law):
    """A 1x1 tiling is the single-shard engine: the same state, drive
    draws and tables, so the same run."""
    cfg = port_config(law, 1, 1, "static")
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state, per = tde.make_sim_fn(cfg, 40, storage=tables.storage,
                                 device="cpu")(
        tde.init_dist_state(cfg, device="cpu"), tde.SimInputs(tables=tables))
    e = cfg.engine
    fin, counts = teng.simulate(teng.init_sim_state(e, device="cpu"),
                                teng.build_shard_tables(e, device="cpu"), e,
                                40, device="cpu")
    assert float(counts.sum()) > 0
    assert torch.equal(per[0, 0], counts)
    for k in ("v", "c", "refrac"):
        assert torch.equal(state["neuron"][k][0, 0], fin["neuron"][k])
    assert torch.equal(state["i_ring"][0, 0], fin["i_ring"])
    for k in ("spikes", "events", "dropped"):
        assert torch.equal(state["metrics"][k][0, 0], fin["metrics"][k])


def single_shard_plastic(e, tables, n_steps, fused_post):
    """The single-shard plastic loop (``engine.simulate(plasticity=...)``)
    made of the engine's parts, with the post trace rounded as
    ``fused_post`` says."""
    aux = teng.init_plasticity(tables, e)
    spec = e.spec()
    plan = spec.delivery_plan(tables.storage)
    state = teng.init_sim_state(e, device="cpu")
    tiers = [dict(t, w=t["w"].clone()) for t in tsyn.tier_list(tables)]
    traces = aux["traces"]
    for _ in range(n_steps):
        slot = state["t"] % e.d_ring
        state, spikes, _ = teng._step(state, tables, e, deliver=False)
        ring, tiers, traces, ev, dr = teng.plastic_delivery_stdp(
            tiers, aux["masks"], aux["inv"], traces, [spikes], spec,
            state["i_ring"], slot, e, plan, fused_post=fused_post)
        m = state["metrics"]
        state = dict(state, i_ring=ring, metrics=dict(
            m, events=m["events"] + ev, dropped=m["dropped"] + dr))
    return state, tiers[0]["w"], traces


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_one_by_one_plastic_is_single_shard_with_sharded_post_trace(
        law, use_kernels):
    """A 1x1 plastic run differs from the single-shard plastic engine in
    one rounding only, as the reference's runs do: the sharded scan
    rounds the post trace once (``stdp.post_trace(fused=True)``), the
    single-shard scan twice.  The single-shard loop's parts with the
    sharded rounding give the 1x1 run bit for bit; with the single-shard
    rounding they give ``engine.simulate``'s plastic run."""
    n = 40
    cfg = port_config(law, 1, 1, "plastic", use_kernels)
    e = cfg.engine
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state = tde.init_dist_state(cfg, device="cpu")
    state["plastic"] = tde.init_dist_plastic_state(cfg, tables)
    slots, _ = tde.build_dist_inverse_index(cfg, tables)
    state, per = tde.make_sim_fn(cfg, n, storage=tables.storage,
                                 device="cpu")(
        state, tde.SimInputs(tables=tde.fold_plastic_tables(tables),
                             inv_slots=slots))
    assert len(tables.halo) == 0 and float(per.sum()) > 0
    tables = teng.build_shard_tables(e, device="cpu")
    (fin, ftabs, ftraces), counts = teng.simulate(
        teng.init_sim_state(e, device="cpu"), tables, e, n, device="cpu",
        plasticity=teng.init_plasticity(tables, e))
    assert torch.equal(per[0, 0], counts)
    pl = state["plastic"]
    tile = {"neuron": {k: x[0, 0] for k, x in state["neuron"].items()},
            "i_ring": state["i_ring"][0, 0],
            "metrics": {k: x[0, 0] for k, x in state["metrics"].items()}}
    tile_traces = {"x_pre": [pl["x_pre"][0][0, 0]],
                   "x_post": pl["x_post"][0, 0]}
    for fused, want, want_w, want_traces in (
            (True, tile, pl["w"][0][0, 0], tile_traces),
            (False, fin, ftabs["local"]["w"], ftraces)):
        got, w, traces = single_shard_plastic(e, tables, n, fused)
        for k in ("v", "c", "refrac"):
            assert torch.equal(got["neuron"][k], want["neuron"][k]), (fused, k)
        assert torch.equal(got["i_ring"], want["i_ring"]), fused
        for k in ("spikes", "events", "dropped"):
            assert torch.equal(got["metrics"][k], want["metrics"][k]), fused
        assert torch.equal(w, want_w), fused
        assert torch.equal(traces["x_pre"][0], want_traces["x_pre"][0])
        assert torch.equal(traces["x_post"], want_traces["x_post"]), fused
    # the rounding shows in this run
    assert not torch.equal(pl["x_post"][0, 0], ftraces["x_post"])


def test_simulate_reports_reference_keys():
    cfg = port_config("gaussian", 2, 2, "static")
    out = tde.simulate(cfg, 20, timed=True, device="cpu")
    for k in ("rate_hz", "events", "dropped", "stats", "elapsed_s",
              "events_timed"):
        assert k in out
    assert out["rate_hz"] > 0 and out["events_timed"] > 0
    assert out["per_step_spikes"].shape == (2, 2, 20)
    assert (out["state"]["t"] == 40).all()
    with pytest.raises(ValueError, match="static convenience"):
        tde.simulate(port_config("gaussian", 2, 2, "plastic"), 2,
                     device="cpu")


@pytest.mark.parametrize("plastic", [False, True])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 2)])
@pytest.mark.parametrize("law", LAWS)
def test_memory_metrics_match_reference(law, tiles, plastic):
    kind = "plastic" if plastic else "static"
    jcfg, _ = configs(law, grid=GRID, n_per_col=N_PER_COL, **KW)
    jcfg = dataclasses.replace(jcfg, decomp=dataclasses.replace(
        jcfg.decomp, tiles_y=tiles[0], tiles_x=tiles[1]))
    if plastic:
        from repro.core.stdp import STDPParams as JSTDP
        jcfg = dataclasses.replace(jcfg, stdp=JSTDP())
    tcfg = port_config(law, *tiles, kind).engine
    jspec, tspec = jcfg.spec(), tcfg.spec()
    for kw in ({}, {"plastic": plastic, "recorder_capacity": 123}):
        assert jmetrics.shard_memory_bytes(jspec, **kw) == \
            tmetrics.shard_memory_bytes(tspec, **kw)
        assert jmetrics.bytes_per_synapse(jspec, **kw) == \
            tmetrics.bytes_per_synapse(tspec, **kw)
    assert jspec.expected_synapses() == tspec.expected_synapses()
    tabs = jeng.build_shard_tables(jcfg)
    from repro.core.synapses import compress_tables as jcompress
    jst = jcompress(tabs).storage
    tst = tsyn.TableStorage.from_meta(jst.meta())
    assert jmetrics.shard_memory_bytes(jspec, jst, plastic=plastic) == \
        tmetrics.shard_memory_bytes(tspec, tst, plastic=plastic)


def test_cost_and_timing_helpers():
    assert tmetrics.cost_per_synaptic_event(2.0, 1.0, 1e6, 10.0) == \
        jmetrics.cost_per_synaptic_event(2.0, 1.0, 1e6, 10.0)
    assert tmetrics.speedup_efficiency(4.0, 1.0, 8) == \
        jmetrics.speedup_efficiency(4.0, 1.0, 8)
    calls = []
    assert tmetrics.time_fn(lambda: calls.append(1), iters=3, warmup=2,
                            device="cpu") >= 0.0
    assert len(calls) == 5
