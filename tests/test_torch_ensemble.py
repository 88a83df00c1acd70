"""Port parity: ensembles, a member axis through both engines and the
segmented driver.

Member m of an M-member ensemble is bit for bit the port's solo run with
``state_seed=seeds[m]`` (the contracts of the reference's
``tests/test_ensemble.py``, each held here in the port), and with each
member's reference drive injected the port's ensembles equal the
reference's: single-shard ``simulate(..., ensemble=3)``, the 2x2
``make_sim_fn`` with ``ensemble_seeds`` (static, recorded, plastic), and
the recorded ensemble ``SimDriver``'s spool files, byte for byte.  The
reference runs once per session, in ``tests/test_torch_dist.py``'s
4-device subprocess (``reference_runs``, cases ``ENSEMBLE``).
"""

import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core.stdp import STDPParams
from repro_torch.obs import record as trec
from repro_torch.obs.spool import member_name
from repro_torch.runtime import DriverConfig, SimDriver
from repro_torch.tree import tree_flatten

from _torch_parity import LAWS, assert_bits_equal, bits
from test_torch_dist import ENSEMBLE, KW, STEPS
from test_torch_dist import port_config as dist_port_config
from test_torch_dist import reference_runs  # noqa: F401  (fixture)

SEEDS = (0, 7, 13)
N = 40


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one intra-op thread is as fast here and
    spares the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(law, seed=3, state_seed=None, stdp=None, grid=4, npc=10,
         tiles=(1, 1), **kw):
    lw = getattr(tconn, f"{law}_law")()
    return teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(grid, grid, npc),
                                       *tiles, lw.radius),
        law=lw, seed=seed, state_seed=state_seed, stdp=stdp, **kw)


def _leaves(tree) -> list:
    """Every tensor and array of a state, tables or traces tree, as raw
    numpy bits (generators and ints left out)."""
    return [bits(x) for x in tree_flatten(tree)[0]
            if isinstance(x, (torch.Tensor, np.ndarray))]


def _tables_tree(tables) -> dict:
    return {"local": tables["local"], "halo": list(tables["halo"])}


# ---------------------------------------------------------------------------
# the reference's tests/test_ensemble.py contracts, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law", LAWS)
def test_ensemble_of_one_bit_identical_static(law):
    """A member axis of one is the identity: same spikes, same final
    state as the solo run."""
    cfg = _cfg(law)
    tabs = teng.build_shard_tables(cfg, device="cpu")
    solo_s, solo_steps = teng.simulate(teng.init_sim_state(cfg, device="cpu"),
                                       tabs, cfg, N, device="cpu")
    ens_cfg = dataclasses.replace(cfg, state_seed=None)
    ens_s, ens_steps = teng.simulate(
        teng.init_ensemble_state(ens_cfg, [cfg.state_seed_value],
                                 device="cpu"),
        tabs, ens_cfg, N, device="cpu", ensemble=1)
    assert float(solo_steps.sum()) > 0
    assert torch.equal(solo_steps, ens_steps[0])
    for a, b in zip(_leaves(solo_s), _leaves(ens_s)):
        np.testing.assert_array_equal(a, b[0])
    assert ens_s["t"] == solo_s["t"] == N


@pytest.mark.parametrize("law", LAWS)
def test_ensemble_of_one_bit_identical_plastic(law):
    cfg = _cfg(law, stdp=STDPParams())
    tabs = teng.build_shard_tables(cfg, device="cpu")
    aux = teng.init_plasticity(tabs, cfg)
    (solo_s, solo_w, solo_tr), solo_steps = teng.simulate(
        teng.init_sim_state(cfg, device="cpu"), tabs, cfg, N,
        plasticity=aux, device="cpu")
    (ens_s, ens_w, ens_tr), ens_steps = teng.simulate(
        teng.init_ensemble_state(cfg, [cfg.state_seed_value], device="cpu"),
        tabs, cfg, N, plasticity=aux, ensemble=1, device="cpu")
    assert torch.equal(solo_steps, ens_steps[0])
    for tree_a, tree_b in ((solo_s, ens_s),
                           (_tables_tree(solo_w), _tables_tree(ens_w)),
                           (solo_tr, ens_tr)):
        la, lb = _leaves(tree_a), _leaves(tree_b)
        assert len(la) == len(lb) > 0
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, b[0])
    assert not torch.equal(ens_w["local"]["w"][0], tabs["local"]["w"])


def test_ensemble_members_differ():
    """Different member seeds give different dynamics (guards against a
    broadcast that makes every member member 0)."""
    cfg = _cfg("gaussian")
    tabs = teng.build_shard_tables(cfg, device="cpu")
    _, steps = teng.simulate(teng.init_ensemble_state(cfg, SEEDS,
                                                      device="cpu"),
                             tabs, cfg, N, ensemble=len(SEEDS), device="cpu")
    assert steps.shape == (len(SEEDS), N)
    assert not torch.equal(steps[0], steps[1])


def _dist(seed=3, state_seed=None, seeds=None, stdp=None, tiles=(1, 1),
          **kw):
    return tde.DistConfig(engine=_cfg("gaussian", seed=seed,
                                      state_seed=state_seed, stdp=stdp,
                                      tiles=tiles, **kw),
                          ensemble_seeds=seeds)


def _driver(ckpt_dir, dist, seg=10, cache=None, **kw):
    cfg = DriverConfig(ckpt_dir=str(ckpt_dir), ckpt_every=1, keep=100,
                       backoff_s=0.01, handle_sigterm=False)
    return SimDriver(cfg, dist, "cpu", segment_steps=seg, sim_cache=cache,
                     **kw)


def _spool_files(spool_dir) -> dict:
    """Every file under a spool directory (member streams included), by
    relative path."""
    out = {}
    for root, _, files in os.walk(spool_dir):
        for fn in sorted(files):
            path = os.path.join(root, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, spool_dir)] = f.read()
    return out


def _spk_digests(spool_dir) -> dict:
    return {rel: hashlib.sha256(b).hexdigest()
            for rel, b in _spool_files(spool_dir).items()
            if rel.endswith(".spk")}


def test_member_spools_byte_identical_to_solo(tmp_path):
    """Each member's spool shards hash-equal the solo run with that state
    seed, and the ensemble ran through one sim function."""
    cache = {}
    ens = _driver(tmp_path / "ens", _dist(seeds=SEEDS), cache=cache,
                  record_events=True)
    ens.run(N)
    assert len(cache) == 1 and ens.n_members == len(SEEDS)
    ens_digests = _spk_digests(ens.spool.directory)
    for m, seed in enumerate(SEEDS):
        solo = _driver(tmp_path / f"solo{m}", _dist(state_seed=seed),
                       record_events=True)
        solo.run(N)
        want = {os.path.join(member_name(m), rel): h for rel, h in
                _spk_digests(solo.spool.directory).items()}
        got = {rel: h for rel, h in ens_digests.items()
               if rel.startswith(member_name(m) + os.sep)}
        assert got == want and got
        np.testing.assert_array_equal(solo.spike_counts(N),
                                      ens.spike_counts(N, member=m))
    with pytest.raises(ValueError, match="member"):
        ens.spike_counts(N)
    with pytest.raises(ValueError, match="member"):
        solo.spike_counts(N, member=0)


def test_ensemble_preempt_resume_exactly_once(tmp_path):
    """Preempt an ensemble mid-run and resume in a new driver: the
    per-member spools equal the unpreempted run's byte for byte, and so
    does every leaf of the state (each member's generators included)."""
    ref = _driver(tmp_path / "ref", _dist(seeds=SEEDS), record_events=True)
    ref_out = ref.run(N)
    first = _driver(tmp_path / "p", _dist(seeds=SEEDS), record_events=True,
                    preempt_after_segments=2)
    out1 = first.run(N)
    assert out1["preempted"] and out1["final_step"] == 20
    cache = {}
    second = _driver(tmp_path / "p", _dist(seeds=SEEDS), cache=cache,
                     record_events=True)
    out2 = second.run(N)
    assert not out2["preempted"] and out2["final_step"] == N
    assert _spool_files(second.spool.directory) \
        == _spool_files(ref.spool.directory)
    assert len(cache) == 1
    ta, tb = (tde.state_tree(o["state"]) for o in (out2, ref_out))
    la, lb = tree_flatten(ta)[0], tree_flatten(tb)[0]
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert_bits_equal(np.asarray(a), np.asarray(b))
    assert len(ta["rng"]) == len(SEEDS)
    assert ta["t"].shape == (1, 1, len(SEEDS))


def test_ensemble_plastic_member_checksum_matches_solo(tmp_path):
    """Member m's learned-weight checksum is the solo plastic run's with
    state_seed=seeds[m] (the realization is shared; only the dynamics
    seed varies); a member index is required exactly for ensembles."""
    stdp = STDPParams()
    ens = _driver(tmp_path / "ens", _dist(seeds=SEEDS[:2], stdp=stdp))
    out = ens.run(N)
    sums = []
    for m, seed in enumerate(SEEDS[:2]):
        solo = _driver(tmp_path / f"s{m}", _dist(state_seed=seed, stdp=stdp))
        sout = solo.run(N)
        want = solo.plastic_summary(sout["state"])
        got = ens.plastic_summary(out["state"], member=m)
        assert got == want
        sums.append(got["weight_checksum"])
    assert sums[0] != sums[1]
    with pytest.raises(ValueError, match="member"):
        ens.plastic_summary(out["state"])


def test_ensemble_refuses_retile(tmp_path):
    """A member-stacked checkpoint does not resume onto another tiling,
    even with allow_retile (the manifest's tiling rewritten, as a 2x1
    checkpoint would carry it)."""
    d = _driver(tmp_path, _dist(seeds=SEEDS))
    d.run(10)
    mpath = tmp_path / "step_00000010" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    assert manifest["meta"]["ensemble_seeds"] == list(SEEDS)
    manifest["meta"]["tiles_y"] = 2
    mpath.write_text(json.dumps(manifest))
    again = _driver(tmp_path, _dist(seeds=SEEDS), allow_retile=True)
    with pytest.raises(ValueError, match="member axis"):
        again.run(N)


def test_seed_split_solo_state_seed():
    """state_seed decouples the dynamics from the table realization: the
    same tables, different trajectories; state_seed=None follows seed."""
    a = _cfg("gaussian", seed=3, state_seed=None)
    b = _cfg("gaussian", seed=3, state_seed=99)
    ta = teng.build_shard_tables(a, device="cpu")
    tb = teng.build_shard_tables(b, device="cpu")
    for la, lb in zip(_leaves(_tables_tree(ta)), _leaves(_tables_tree(tb))):
        np.testing.assert_array_equal(la, lb)
    _, sa = teng.simulate(teng.init_sim_state(a, device="cpu"), ta, a, N,
                          device="cpu")
    _, sb = teng.simulate(teng.init_sim_state(b, device="cpu"), tb, b, N,
                          device="cpu")
    assert not torch.equal(sa, sb)
    assert a.state_seed_value == 3 and b.state_seed_value == 99


# ---------------------------------------------------------------------------
# member m is the port's own solo run, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["static", "recorded", "plastic"])
def test_single_shard_members_equal_solo_runs(kind):
    """``simulate(..., ensemble=3)``: each member's raster or counts,
    final state, recorder buffers and plastic weights and traces are the
    solo run's with its state seed."""
    stdp = STDPParams() if kind == "plastic" else None
    cfg = _cfg("exponential", stdp=stdp, npc=20, ext_rate_hz=20.0)
    tabs = teng.build_shard_tables(cfg, device="cpu")
    aux = teng.init_plasticity(tabs, cfg) if stdp else None
    rspec = trec.recorder_spec(cfg, N) if kind == "recorded" else None

    def run(state, c, ensemble=None):
        if aux is not None:
            (st, tb, tr), per = teng.simulate(state, tabs, c, N,
                                              plasticity=aux, device="cpu",
                                              ensemble=ensemble)
            return st, per, {"w": tb["local"]["w"], **tr}
        out = teng.simulate(state, tabs, c, N, record_spikes=True,
                            recorder=rspec, device="cpu", ensemble=ensemble)
        extra = {} if rspec is None else {k: v.clone()
                                          for k, v in out[2].items()}
        return out[0], out[1], extra

    ens = run(teng.init_ensemble_state(cfg, SEEDS, device="cpu"), cfg,
              ensemble=len(SEEDS))
    assert float(ens[1].sum()) > 0
    for m, seed in enumerate(SEEDS):
        c = dataclasses.replace(cfg, state_seed=seed)
        solo = run(teng.init_sim_state(c, device="cpu"), c)
        assert torch.equal(ens[1][m], solo[1])
        for a, b in zip(_leaves(ens[0]), _leaves(solo[0])):
            np.testing.assert_array_equal(a[m], b)
        for a, b in zip(_leaves(ens[2]), _leaves(solo[2])):
            np.testing.assert_array_equal(a[m], b)


@pytest.mark.parametrize("kind", ["static", "recorded", "plastic"])
def test_dist_members_equal_solo_runs(kind):
    """``make_sim_fn`` with ``ensemble_seeds`` at 2x2: each member's
    per-step counts, state, recorder buffers and plastic carry are the
    solo run's with its state seed (one band gather per band for all
    instances)."""
    stdp = STDPParams() if kind == "plastic" else None
    dist = _dist(seeds=SEEDS, stdp=stdp, tiles=(2, 2), npc=20,
                 ext_rate_hz=20.0)
    tables, _ = tde.build_dist_tables(dist, device="cpu")

    def run(cfg):
        st = tde.init_dist_state(cfg, device="cpu")
        inputs = tde.SimInputs(tables=tables)
        rs = None
        if stdp is not None:
            st["plastic"] = tde.init_dist_plastic_state(cfg, tables)
            inputs.inv_slots = tde.build_dist_inverse_index(cfg, tables)[0]
            inputs.tables = tde.fold_plastic_tables(tables)
        if kind == "recorded":
            rs = trec.recorder_spec(cfg.engine, N)
            inputs.gids = torch.from_numpy(
                trec.stacked_gid_maps(cfg.engine.decomp))
        out = tde.make_sim_fn(cfg, N, recorder=rs, storage=tables.storage,
                              device="cpu")(st, inputs)
        rec = {} if rs is None else {k: v.clone() for k, v in out[2].items()}
        return out[0], out[1], rec

    es, ep, er = run(dist)
    assert ep.shape == (2, 2, len(SEEDS), N) and float(ep.sum()) > 0
    assert es["t"].shape == (2, 2, len(SEEDS)) and len(es["rng"]) == 12
    for m, seed in enumerate(SEEDS):
        ss, sp, sr = run(tde.DistConfig(engine=dataclasses.replace(
            dist.engine, state_seed=seed)))
        assert torch.equal(ep[:, :, m], sp)
        for a, b in zip(_leaves(es), _leaves(ss)):
            np.testing.assert_array_equal(a[:, :, m], b)
        for k in sr:
            assert torch.equal(er[k][:, :, m], sr[k])


def test_ensemble_config_and_state_refusals():
    """``ensemble_seeds`` validates as the reference's does, and a state
    whose leading axes are not the ensemble's is refused."""
    with pytest.raises(ValueError, match="non-empty"):
        _dist(seeds=())
    d = _dist(seeds=[4, 5])
    assert d.ensemble_seeds == (4, 5) and d.n_members == 2
    assert _dist().n_members is None
    cfg = _cfg("gaussian")
    tabs = teng.build_shard_tables(cfg, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        teng.init_ensemble_state(cfg, [], device="cpu")
    state = teng.init_ensemble_state(cfg, SEEDS, device="cpu")
    with pytest.raises(ValueError, match="leading axes"):
        teng.simulate(state, tabs, cfg, 2, ensemble=2, device="cpu")
    with pytest.raises(ValueError, match="leading axes"):
        teng.simulate(teng.init_sim_state(cfg, device="cpu"), tabs, cfg, 2,
                      ensemble=1, device="cpu")
    with pytest.raises(ValueError, match="drive has shape"):
        teng.simulate(state, tabs, cfg, 2, ensemble=3, device="cpu",
                      drive=torch.zeros(2, cfg.spec().n_local))
    dt = tde.DistConfig(engine=_cfg("gaussian", tiles=(2, 1)),
                        ensemble_seeds=SEEDS)
    tables, _ = tde.build_dist_tables(dt, device="cpu")
    sim = tde.make_sim_fn(dt, 2, storage=tables.storage, device="cpu")
    solo = tde.init_dist_state(dataclasses.replace(dt, ensemble_seeds=None),
                               device="cpu")
    with pytest.raises(ValueError, match="members"):
        sim(solo, tde.SimInputs(tables=tables))


def test_record_step_device_t_into_resident_recorder():
    """``record_step`` with the step as a device tensor, appending into
    a resident recorder zeroed in place, writes what the host-int step
    writes into a fresh recorder, call after call."""
    cfg = _cfg("gaussian", npc=20)
    rspec = trec.recorder_spec(cfg, 6, capacity=150)
    n = rspec.n_rows
    gids = torch.from_numpy(trec.tile_gid_map(cfg.decomp, 0, 0))
    g = torch.Generator().manual_seed(2)
    cache = {}
    for call in range(2):
        resident = trec.resident_recorder(cache, rspec, "cpu")
        fresh = trec.init_recorder_state(rspec, device="cpu")
        t_dev = torch.tensor(10 * call, dtype=torch.int32)
        for k in range(6):
            spikes = (torch.rand(n + 1, generator=g) < 0.05 * (k + 1)).float()
            trec.record_step(resident, spikes, gids, t_dev, rspec)
            t_dev.add_(1)
            trec.record_step(fresh, spikes, gids, 10 * call + k, rspec)
        for key in ("step", "gid", "count", "dropped"):
            assert torch.equal(resident[key], fresh[key]), key
        assert int(fresh["dropped"]) > 0 and int(fresh["count"]) == 150
        assert int(resident["step"][0]) == 10 * call
    assert len(cache) == 1


# ---------------------------------------------------------------------------
# against the reference, each member's reference drive injected
# ---------------------------------------------------------------------------

def _assert_state(ref: dict, st: dict) -> None:
    for k in ("v", "c", "refrac"):
        assert_bits_equal(ref[f"neuron_{k}"], st["neuron"][k], k)
    assert_bits_equal(ref["i_ring"], st["i_ring"], "i_ring")
    assert np.array_equal(np.asarray(ref["t"]).reshape(-1),
                          np.broadcast_to(np.asarray(st["t"]),
                                          np.shape(ref["t"])).reshape(-1))
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(ref[f"metrics_{k}"], st["metrics"][k], k)


def _ensemble_engine(law, kind, use_kernels):
    lw = getattr(tconn, f"{law}_law")()
    d = dist_port_config(law, 1, 1, "static").engine.decomp
    return teng.EngineConfig(
        decomp=d, law=lw, use_kernels=use_kernels,
        stdp=STDPParams() if kind == "plastic" else None, **KW)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", sorted(ENSEMBLE["single"]))
def test_single_shard_ensemble_matches_reference(reference_runs, name,
                                                 use_kernels, monkeypatch):
    """``simulate(..., ensemble=3)`` at 6x6x30 against the reference's
    vmapped run: raster or counts, state, recorder buffers, plastic
    weights and traces, bit for bit.

    The plastic case: the reference's 60-step 6x6x30 single-shard
    program (vmapped or solo alike: its members equal its solo runs)
    fuses the post trace's decay and increment into one FMA, as its
    sharded scan does, where its 100-step 4x4x30 program
    (``tests/test_torch_plastic.py``) rounds twice, as the port's
    single-shard engine does.  Fusion follows XLA's compiled program
    (ROADMAP.md section 3), so this case holds the port with the fused
    rounding (``stdp.post_trace(..., fused=True)``) bit for bit, and
    checks that the port's own two roundings differ in the post trace
    only."""
    ref = reference_runs[name]
    law, kind = ENSEMBLE["single"][name]
    cfg = _ensemble_engine(law, kind, use_kernels)
    seeds = ENSEMBLE["seeds"]
    tabs = teng.build_shard_tables(cfg, device="cpu")
    state = teng.init_ensemble_state(cfg, seeds, device="cpu")
    drive = torch.from_numpy(ref["drive"])
    assert drive.shape == (STEPS, len(seeds), cfg.spec().n_local)
    if kind == "plastic":
        aux = teng.init_plasticity(tabs, cfg)
        (_, _, own), own_per = teng.simulate(
            teng.init_ensemble_state(cfg, seeds, device="cpu"), tabs, cfg,
            STEPS, plasticity=aux, drive=drive, device="cpu",
            ensemble=len(seeds))
        assert_bits_equal(ref["plastic_x_pre"], own["x_pre"][0], "x_pre")
        assert (bits(ref["plastic_x_post"]) != bits(own["x_post"])).any()
        monkeypatch.setattr(teng, "plastic_delivery_stdp", functools.partial(
            teng.plastic_delivery_stdp, fused_post=True))
        (st, tb, tr), per = teng.simulate(
            state, tabs, cfg, STEPS, plasticity=aux, drive=drive,
            device="cpu", ensemble=len(seeds))
        assert_bits_equal(ref["plastic_w_0"], tb["local"]["w"], "w")
        assert_bits_equal(ref["plastic_x_pre"], tr["x_pre"][0], "x_pre")
        assert_bits_equal(ref["plastic_x_post"], tr["x_post"], "x_post")
    elif kind == "recorded":
        st, per, rec = teng.simulate(
            state, tabs, cfg, STEPS, recorder=trec.recorder_spec(cfg, STEPS),
            drive=drive, device="cpu", ensemble=len(seeds))
        for k in ("step", "gid", "count", "dropped"):
            assert_bits_equal(ref[f"rec_{k}"], rec[k], f"recorder {k}")
    else:
        st, per = teng.simulate(state, tabs, cfg, STEPS, record_spikes=True,
                                drive=drive, device="cpu",
                                ensemble=len(seeds))
    assert float(per.sum()) > 0
    assert_bits_equal(ref["per_step"], per, "per-step spikes")
    _assert_state(ref, st)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", sorted(ENSEMBLE["dist"]))
def test_dist_ensemble_matches_reference(reference_runs, name, use_kernels):
    """The 2x2 ``make_sim_fn`` with ``ensemble_seeds`` at 6x6x30 against
    the reference's: per-step counts ``(TY, TX, M, S)``, state, recorder
    buffers and the plastic carry, bit for bit; drops included."""
    ref = reference_runs[name]
    law, kind = ENSEMBLE["dist"][name]
    base = dist_port_config(law, 2, 2, "plastic" if kind == "plastic"
                            else "static", use_kernels)
    cfg = dataclasses.replace(base, ensemble_seeds=ENSEMBLE["seeds"])
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    state = tde.init_dist_state(cfg, device="cpu")
    inputs = tde.SimInputs(tables=tables, drive=torch.from_numpy(ref["drive"]))
    recorder = None
    if kind == "plastic":
        state["plastic"] = tde.init_dist_plastic_state(cfg, tables)
        inputs.inv_slots = tde.build_dist_inverse_index(cfg, tables)[0]
        inputs.tables = tde.fold_plastic_tables(tables)
    if kind == "recorded":
        recorder = trec.recorder_spec(cfg.engine, STEPS)
        inputs.gids = torch.from_numpy(trec.stacked_gid_maps(
            cfg.engine.decomp))
    out = tde.make_sim_fn(cfg, STEPS, recorder=recorder,
                          storage=tables.storage, device="cpu")(state, inputs)
    st = out[0]
    assert_bits_equal(ref["per_step"], out[1], "per-step spikes")
    _assert_state(ref, st)
    assert float(st["metrics"]["dropped"].sum()) > 0
    if kind == "plastic":
        pl = st["plastic"]
        for ti, w in enumerate(pl["w"]):
            assert_bits_equal(ref[f"plastic_w_{ti}"], w, f"w tier {ti}")
        assert_bits_equal(ref["plastic_x_pre"], pl["x_pre"][0], "x_pre")
        assert_bits_equal(ref["plastic_x_post"], pl["x_post"], "x_post")
    if recorder is not None:
        for k in ("step", "gid", "count", "dropped"):
            assert_bits_equal(ref[f"rec_{k}"], out[2][k], f"recorder {k}")


def test_ensemble_driver_spool_matches_reference(reference_runs, tmp_path):
    """The recorded ensemble ``SimDriver`` (4x4x20 in 2x1 tiles, 40 steps
    in segments of 10) with the reference's member drives: every spool
    file (the member streams and headers) byte for byte, the final
    state bit for bit, and each member's per-step counts."""
    ref = reference_runs["ensemble_driver"]
    kw = ENSEMBLE["driver"]
    dist = _dist(seed=kw["seed"], seeds=ENSEMBLE["seeds"],
                 tiles=tuple(kw["tiles"]), grid=kw["grid"], npc=kw["npc"],
                 **KW)
    drv = _driver(tmp_path, dist, seg=kw["seg"], record_events=True,
                  drive=torch.from_numpy(ref["drive"]))
    out = drv.run(kw["steps"])
    files = _spool_files(drv.spool.directory)
    assert files == _spool_files(os.path.join(ref["dir"], "spool"))
    assert any(rel.startswith(member_name(2)) for rel in files)
    _assert_state(ref, out["state"])
    counts = np.stack([drv.spike_counts(kw["steps"], member=m)
                       for m in range(len(ENSEMBLE["seeds"]))])
    np.testing.assert_array_equal(counts, ref["counts"])
    assert counts.sum() > 0
