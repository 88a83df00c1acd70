"""Port parity: the segmented sim driver, its jobs and launchers, and the
generic fault-tolerant loop (``repro_torch.runtime``).

The reference's ``SimDriver`` runs once per module in a subprocess with
two fake host devices (``reference_drivers``): 4x4 columns of 20
neurons, ``cap_headroom=1.0`` and ``ext_rate_hz=20.0`` (spikes in bulk
and drops), 40 steps in segments of 10, recording on -- straight at
1x1 and 2x1, preempted after two segments and resumed at 1x1, and
preempted at 2x1 and resumed on 1x1 with a retile.  It saves each
run's spool, final state and analysis, and the drive each run drew
(after the retile: drawn from the keys ``retile_state`` derives).  The
port's driver runs the same cases on the CPU with that drive injected
(``SimDriver(drive=...)``) and must write byte-identical spool files
and ``header.json``, end in a bit-identical state (the generators
aside) and give equal analysis JSON and totals.  The rest holds each
contract of the reference's ``tests/test_sim_driver.py`` and
``tests/test_runtime.py`` inside the port, and its plastic resume to
the docstring contract of ``tests/test_plasticity.py``'s resume test
(bit-identical whatever the segment sizes), which the reference itself
fails.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import LeafSpec, checkpoint_meta, \
    latest_step
from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core.stdp import STDPParams
from repro_torch.obs.analysis import analyze_run, strip_private
from repro_torch.runtime import (DriverConfig, JobError, SimDriver,
                                 SimJobSpec, StragglerWatchdog,
                                 TrainDriver, build_sim_driver)

from _torch_parity import assert_bits_equal
from test_torch_dist import STEPS as DIST_STEPS
from test_torch_dist import port_config as dist_port_config
from test_torch_dist import reference_runs  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID, NPC, SEED = 4, 20, 3
N, SEG = 40, 10
KW = {"cap_headroom": 1.0, "ext_rate_hz": 20.0}   # the parity runs
CAP = 4000       # one recorder capacity for every tiling and segment size

REFERENCE = r"""
import json, os, shutil, sys
import jax, numpy as np
from repro.checkpoint.store import restore_checkpoint
from repro.core import connectivity, engine as jeng, grid as jgrid
from repro.core import dist_engine as de
from repro.core.retile import retile_state
from repro.obs.analysis import analyze_run, strip_private
from repro.parallel.compat import make_mesh
from repro.runtime import DriverConfig, SimDriver

out_dir, steps, seg, grid, npc, seed = sys.argv[1], *map(int, sys.argv[2:7])
kw = json.loads(sys.argv[7])
cache = {}


def cfg(ty, tx):
    law = connectivity.gaussian_law()
    return de.DistConfig(engine=jeng.EngineConfig(
        decomp=jgrid.TileDecomposition(jgrid.ColumnGrid(grid, grid, npc),
                                       ty, tx, law.radius),
        law=law, seed=seed, use_kernels=False, **kw))


def drives(e, keys):
    n_local = e.spec().n_local

    def body(k, _):
        k, k_ext = jax.random.split(k)
        return k, jeng.external_drive(k_ext, n_local, e)
    run = jax.jit(lambda k: jax.lax.scan(body, k, None, length=steps)[1])
    ty, tx = keys.shape[:2]
    return np.stack([np.stack([np.asarray(run(keys[y, x]))
                               for x in range(tx)], axis=1)
                     for y in range(ty)], axis=1)


def driver(name, ty, tx, **k):
    mesh = make_mesh((ty, tx), ("data", "model"))
    return SimDriver(DriverConfig(ckpt_dir=f"{out_dir}/{name}/run",
                                  ckpt_every=1, keep=100, backoff_s=0.01,
                                  handle_sigterm=False),
                     cfg(ty, tx), mesh, segment_steps=seg,
                     record_events=True, sim_cache=cache, **k)


def raw(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.dtype.kind == "f" \
        else a


def save(name, drv, out, drive):
    st = out["state"]
    arrays = {"drive": drive, "i_ring": raw(st["i_ring"]),
              "t": np.asarray(st["t"]), "active": np.asarray(st["active"])}
    for k in ("v", "c", "refrac"):
        arrays[f"neuron_{k}"] = raw(st["neuron"][k])
    for k in ("spikes", "events", "dropped"):
        arrays[f"metrics_{k}"] = raw(st["metrics"][k])
    np.savez(f"{out_dir}/{name}/state.npz", **arrays)
    rep = strip_private(analyze_run(drv.cfg.ckpt_dir))
    rep.pop("run_dir")
    with open(f"{out_dir}/{name}/result.json", "w") as f:
        json.dump({"analysis": rep, "totals": drv.metric_totals(st),
                   "recorder_dropped": drv.recorder_dropped,
                   "final_step": out["final_step"],
                   "steps_logged": [m["step"] for m in out["metrics"]]}, f)


init = {t: drives(cfg(*t).engine, np.asarray(de.init_dist_state(
    cfg(*t))["rng"])) for t in ((1, 1), (2, 1))}
for ty, tx in ((1, 1), (2, 1)):
    drv = driver(f"straight_{ty}x{tx}", ty, tx)
    save(f"straight_{ty}x{tx}", drv, drv.run(steps), init[ty, tx])
driver("resume_1x1", 1, 1, preempt_after_segments=2).run(steps)
drv = driver("resume_1x1", 1, 1)
save("resume_1x1", drv, drv.run(steps), init[1, 1])
# one recorder capacity on both tilings: the spool header holds it
cap = {"record_capacity": 64 * seg}
first = driver("retile_2x1_1x1", 2, 1, preempt_after_segments=2, **cap)
t0 = first.run(steps)["final_step"]
old = cfg(2, 1)
host = restore_checkpoint(first.cfg.ckpt_dir, t0, de.abstract_dist_inputs(
    old, first.storage)[0])
new = cfg(1, 1)
keys = np.asarray(retile_state(host, old.engine.decomp,
                               new.engine.decomp)["rng"])
drive = np.zeros_like(init[1, 1])
drive[t0:] = drives(new.engine, keys)[:steps - t0]
drv = driver("retile_2x1_1x1", 1, 1, allow_retile=True, **cap)
save("retile_2x1_1x1", drv, drv.run(steps), drive)
print("done", flush=True)
"""

CASES = ("straight_1x1", "straight_2x1", "resume_1x1", "retile_2x1_1x1")


@pytest.fixture(scope="module")
def reference_drivers(tmp_path_factory):
    out = tmp_path_factory.mktemp("driver_reference")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    for c in CASES:
        (out / c).mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out), str(N), str(SEG),
         str(GRID), str(NPC), str(SEED), json.dumps(KW)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    runs = {}
    for c in CASES:
        with open(out / c / "result.json") as f:
            res = json.load(f)
        runs[c] = {"dir": out / c / "run", "state": dict(np.load(
            out / c / "state.npz")), **res}
    return runs


def dist_cfg(ty=1, tx=1, law="gaussian", seed=SEED, grid=GRID, npc=NPC,
             **kw):
    """The port's config; by default without drops (the default
    ``cap_headroom``), so that the spool holds every spike."""
    lw = getattr(tconn, f"{law}_law")()
    return tde.DistConfig(engine=teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(grid, grid, npc),
                                       ty, tx, lw.radius),
        law=lw, seed=seed, **dict({"ext_rate_hz": 20.0}, **kw)))


def parity_cfg(ty, tx):
    return dist_cfg(ty, tx, **KW)


def driver(ckpt_dir, seg=SEG, tiles=(1, 1), dist=None, ckpt_every=1,
           keep=3, **kw):
    cfg = DriverConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                       keep=keep, backoff_s=0.01, handle_sigterm=False)
    return SimDriver(cfg, dist or dist_cfg(*tiles), "cpu",
                     segment_steps=seg, **kw)


def spool_files(run_dir) -> dict:
    d = os.path.join(run_dir, "spool")
    return {fn: open(os.path.join(d, fn), "rb").read()
            for fn in sorted(os.listdir(d))}


def assert_same_state(a: dict, b: dict, generators: bool = True):
    """Two port states bit for bit (every tensor, ``t`` and, unless told
    otherwise, every generator's state)."""
    ta, tb = tde.state_tree(a), tde.state_tree(b)
    if not generators:
        ta.pop("rng"), tb.pop("rng")
    from repro_torch.tree import tree_flatten
    la, da = tree_flatten(ta)
    lb, db = tree_flatten(tb)
    assert da == db
    for x, y in zip(la, lb):
        assert_bits_equal(np.asarray(x), np.asarray(y))


def assert_matches_reference(ref: dict, drv: SimDriver, out: dict):
    files = spool_files(drv.cfg.ckpt_dir)
    assert files == spool_files(ref["dir"])       # header.json included
    assert sum(len(v) for k, v in files.items() if k.endswith(".spk")) > 0
    st, rs = out["state"], ref["state"]
    for k in ("v", "c", "refrac"):
        assert_bits_equal(rs[f"neuron_{k}"], st["neuron"][k], k)
    assert_bits_equal(rs["i_ring"], st["i_ring"], "i_ring")
    assert np.array_equal(rs["t"], st["t"])
    assert np.array_equal(rs["active"], st["active"].numpy())
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(rs[f"metrics_{k}"], st["metrics"][k], k)
    rep = strip_private(analyze_run(drv.cfg.ckpt_dir))
    rep.pop("run_dir")
    assert json.loads(json.dumps(rep)) == ref["analysis"]
    assert drv.metric_totals(st) == ref["totals"]
    # above active_cap the recorder drops too, and counts it:
    # dropped = spikes - appended
    assert drv.recorder_dropped == ref["recorder_dropped"]
    assert drv.recorder_dropped == drv.metric_totals(st)["spikes"] \
        - drv.spike_counts(N).sum()
    assert out["final_step"] == ref["final_step"] == N


def assert_dist_run(ref: dict, st: dict):
    """A port state against a reference ``make_sim_fn`` run's arrays
    (``tests/test_torch_dist.py``'s files), plastic carry included."""
    for k in ("v", "c", "refrac"):
        assert_bits_equal(ref[f"neuron_{k}"], st["neuron"][k], k)
    assert_bits_equal(ref["i_ring"], st["i_ring"], "i_ring")
    assert np.array_equal(ref["t"], st["t"])
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(ref[f"metrics_{k}"], st["metrics"][k], k)
    pl = st["plastic"]
    for ti, w in enumerate(pl["w"]):
        assert_bits_equal(ref[f"plastic_w_{ti}"], w, f"w tier {ti}")
    assert_bits_equal(ref["plastic_x_pre"], pl["x_pre"][0], "x_pre")
    assert_bits_equal(ref["plastic_x_post"], pl["x_post"], "x_post")


def _drive(ref):
    return torch.from_numpy(ref["state"]["drive"])


# ---------------------------------------------------------------------------
# held against the reference's SimDriver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [(1, 1), (2, 1)])
def test_straight_run_matches_reference_driver(reference_drivers, tmp_path,
                                               tiles):
    ref = reference_drivers[f"straight_{tiles[0]}x{tiles[1]}"]
    drv = driver(tmp_path, dist=parity_cfg(*tiles), record_events=True,
                 drive=_drive(ref))
    out = drv.run(N)
    assert_matches_reference(ref, drv, out)
    assert [m["step"] for m in out["metrics"]] == ref["steps_logged"]
    assert ref["totals"]["dropped"] > 0           # the drop rule ran


def test_preempt_resume_matches_reference_driver(reference_drivers,
                                                 tmp_path):
    ref = reference_drivers["resume_1x1"]
    cfg = parity_cfg(1, 1)
    driver(tmp_path, dist=cfg, record_events=True, drive=_drive(ref),
           preempt_after_segments=2).run(N)
    drv = driver(tmp_path, dist=cfg, record_events=True, drive=_drive(ref))
    out = drv.run(N)
    assert_matches_reference(ref, drv, out)
    # and the reference's resumed run is its straight run
    assert spool_files(ref["dir"]) == spool_files(
        reference_drivers["straight_1x1"]["dir"])


def test_retile_resume_matches_reference_driver(reference_drivers,
                                                tmp_path):
    """2x1 -> preempt -> resume on 1x1 with a retile, the post-retile
    drive drawn from the reference's folded keys: spool, state and
    totals as the reference's (the relayout and the metric base are
    bit-exact; only the generators follow the port's own rule)."""
    ref = reference_drivers["retile_2x1_1x1"]
    first = reference_drivers["straight_2x1"]
    cap = {"record_capacity": 64 * SEG}   # the header holds it
    driver(tmp_path, dist=parity_cfg(2, 1), record_events=True,
           drive=_drive(first), preempt_after_segments=2, **cap).run(N)
    drv = driver(tmp_path, dist=parity_cfg(1, 1), record_events=True,
                 drive=_drive(ref), allow_retile=True, **cap)
    out = drv.run(N)
    assert_matches_reference(ref, drv, out)
    assert checkpoint_meta(str(tmp_path), N)["metric_base"] == \
        checkpoint_meta(str(ref["dir"]), N)["metric_base"]


# ---------------------------------------------------------------------------
# the reference's tests/test_sim_driver.py contracts, inside the port
# ---------------------------------------------------------------------------

def test_resume_bit_identity(tmp_path):
    """N steps straight == N/2 + save + kill + restore + N/2, exactly:
    per-step counts from the spool, the totals, and every leaf of the
    state, the generators' states included."""
    straight = driver(tmp_path / "a", seg=N, record_events=True)
    out_a = straight.run(N)
    first = driver(tmp_path / "b", seg=N // 2, record_events=True)
    first.run(N // 2)
    second = driver(tmp_path / "b", seg=N // 2, record_events=True)
    out_b = second.run(N)
    assert out_a["final_step"] == out_b["final_step"] == N
    spikes_a = straight.spike_counts(N)
    assert spikes_a.shape == (N,) and spikes_a.sum() > 0
    np.testing.assert_array_equal(spikes_a, second.spike_counts(N))
    assert straight.metric_totals(out_a["state"]) == \
        second.metric_totals(out_b["state"])
    assert_same_state(out_a["state"], out_b["state"])


def test_preemption_checkpoints_and_resumes(tmp_path):
    d1 = driver(tmp_path, preempt_after_segments=1)
    out1 = d1.run(N)
    assert out1["preempted"] and out1["final_step"] == SEG
    assert latest_step(str(tmp_path)) == SEG
    d2 = driver(tmp_path)
    out2 = d2.run(N)
    assert not out2["preempted"] and out2["final_step"] == N
    assert int(np.max(out2["state"]["t"])) == N
    rate = d2.firing_rate_hz(out2["state"])
    assert np.isfinite(rate) and rate > 0
    assert d2.captures() == 0                     # the CPU steps eagerly


def test_segment_failure_restores_and_replays(tmp_path):
    ref = driver(tmp_path / "ref", record_events=True)
    ref_out = ref.run(30)
    fired = []

    def hook(step):
        if step == 20 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    d = driver(tmp_path / "x", fault_hook=hook, record_events=True)
    out = d.run(30)
    assert fired == [20] and out["final_step"] == 30
    np.testing.assert_array_equal(ref.spike_counts(30), d.spike_counts(30))
    assert ref.metric_totals(ref_out["state"]) == \
        d.metric_totals(out["state"])
    assert_same_state(ref_out["state"], out["state"])


@pytest.mark.parametrize("fail_at,ckpt_every", [(30, 2), (20, 100)])
def test_replay_does_not_duplicate_logs(tmp_path, fail_at, ckpt_every):
    """A failure after an un-checkpointed segment (checkpoint at 20,
    failure at 30) or before any checkpoint (rewind to 0) prunes the
    abandoned timeline: metrics_log and the spool carry each segment
    exactly once."""
    fired = []

    def hook(step):
        if step == fail_at and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    d = driver(tmp_path, ckpt_every=ckpt_every, fault_hook=hook,
               record_events=True)
    out = d.run(N)
    assert fired == [fail_at] and out["final_step"] == N
    assert [m["step"] for m in d.metrics_log] == [0, 10, 20, 30]
    counts = d.spike_counts(N)
    assert counts.shape == (N,)
    assert counts.sum() == d.metric_totals(out["state"])["spikes"]


def test_resume_refuses_silent_retile(tmp_path):
    driver(tmp_path).run(SEG)
    d = driver(tmp_path, tiles=(1, 2))
    with pytest.raises(ValueError, match="retile"):
        d._restore_or_init()


def test_resume_refuses_grid_mismatch(tmp_path):
    driver(tmp_path).run(SEG)
    d = driver(tmp_path, dist=dist_cfg(grid=5), allow_retile=True)
    with pytest.raises(ValueError, match="grid"):
        d._restore_or_init()


@pytest.mark.parametrize("other,match", [
    ({"seed": 4}, "seed"), ({"law": "exponential"}, "law"),
    ({"stdp": STDPParams()}, "stdp")])
def test_resume_refuses_model_drift(tmp_path, other, match):
    """The relayout is only valid for the same model: another synapse
    seed, law or plasticity is refused, not silently continued."""
    driver(tmp_path).run(SEG)
    d = driver(tmp_path, dist=dist_cfg(**other))
    with pytest.raises(ValueError, match=match):
        d._restore_or_init()


def test_resume_refuses_table_realization_drift(tmp_path, monkeypatch):
    import repro_torch.core.synapses as syn
    driver(tmp_path).run(SEG)
    monkeypatch.setattr(syn, "TABLE_REALIZATION_VERSION",
                        syn.TABLE_REALIZATION_VERSION + 1)
    d = driver(tmp_path)
    with pytest.raises(ValueError, match="table_realization"):
        d._restore_or_init()


def test_checkpoint_meta_rides_inside_checkpoint(tmp_path):
    driver(tmp_path).run(SEG)
    assert not os.path.exists(tmp_path / "sim_meta.json")
    meta = checkpoint_meta(str(tmp_path), SEG)
    assert (meta["tiles_y"], meta["tiles_x"]) == (1, 1)
    assert meta["grid"] == [GRID, GRID, NPC]
    assert meta["law"] == "gaussian" and meta["seed"] == SEED
    assert meta["ensemble_seeds"] is None and meta["stdp"] is None


def test_rejects_nonpositive_segment_and_ensembles(tmp_path):
    with pytest.raises(ValueError, match="segment_steps"):
        driver(tmp_path, seg=0)
    # ensembles construct (an empty member list is refused)
    ens = dataclasses.replace(dist_cfg(), ensemble_seeds=(0, 1))
    assert ens.n_members == 2 and ens.lead == (1, 1, 2)
    with pytest.raises(ValueError, match="non-empty"):
        dataclasses.replace(dist_cfg(), ensemble_seeds=())


def test_retile_round_trip_carries_totals(tmp_path):
    """1x1 -> 2x1 -> 1x2: the per-tile metrics restart at zero on each
    retile, the manifest's base carries the history, and the totals
    and rate the driver reports equal the unretiled run's arithmetic."""
    d1 = driver(tmp_path, record_events=True, record_capacity=CAP)
    out1 = d1.run(20)
    totals1 = d1.metric_totals(out1["state"])
    assert totals1["spikes"] > 0
    meta = checkpoint_meta(str(tmp_path), 20)
    assert meta["metric_base"] == {"spikes": 0.0, "events": 0.0,
                                   "dropped": 0.0}
    assert meta["metric_totals"] == totals1
    d2 = driver(tmp_path, tiles=(2, 1), record_events=True,
                record_capacity=CAP, allow_retile=True)
    start, state = d2._restore_or_init()
    assert start == 20
    for k in ("spikes", "events", "dropped"):
        assert float(state["metrics"][k].sum()) == 0.0
    assert d2.metric_totals(state) == totals1
    n_active = GRID * GRID * NPC
    assert d2.firing_rate_hz(state) == pytest.approx(
        totals1["spikes"] / n_active / (20 * 1e-3))
    d2._save(20, state)
    d2.ckpt.wait()
    meta2 = checkpoint_meta(str(tmp_path), 20)
    assert meta2["metric_base"] == totals1 == meta2["metric_totals"]
    out2 = d2.run(30)
    d3 = driver(tmp_path, tiles=(1, 2), record_events=True,
                record_capacity=CAP, allow_retile=True)
    out3 = d3.run(N)
    assert out3["final_step"] == N
    totals = d3.metric_totals(out3["state"])
    assert totals["spikes"] > totals1["spikes"]
    assert d3.spike_counts(N).sum() == totals["spikes"]
    assert d2.metric_totals(out2["state"])["spikes"] <= totals["spikes"]


# ---------------------------------------------------------------------------
# plasticity: resume is bit-identical whatever the segment sizes
# ---------------------------------------------------------------------------

PLASTIC_STEPS = 30


@pytest.mark.parametrize("tiles", [(1, 1), (2, 1)])
def test_plastic_resume_bit_identical_across_segment_sizes(tmp_path,
                                                           tiles):
    """One plastic segment of 30 == 10 + preempt + resume in segments
    of 20: the learned weights, traces and state bit for bit (the
    docstring contract of the reference's plastic resume test, which
    the reference breaks: XLA fuses the post trace per program, the
    port states the fusion)."""
    cfg = dist_cfg(*tiles, stdp=STDPParams())
    rec = {"record_events": True, "record_capacity": CAP}
    a = driver(tmp_path / "a", seg=PLASTIC_STEPS, dist=cfg, **rec)
    out_a = a.run(PLASTIC_STEPS)
    driver(tmp_path / "b", seg=10, dist=cfg, preempt_after_segments=1,
           **rec).run(PLASTIC_STEPS)
    b = driver(tmp_path / "b", seg=20, dist=cfg, **rec)
    out_b = b.run(PLASTIC_STEPS)
    assert out_b["final_step"] == PLASTIC_STEPS
    assert_same_state(out_a["state"], out_b["state"])
    sa, sb = a.plastic_summary(out_a["state"]), b.plastic_summary(
        out_b["state"])
    assert sa == sb and sa["w_l1_delta"] > 0
    assert spool_files(tmp_path / "a") == spool_files(tmp_path / "b")


def test_plastic_retile_relays_weights_by_synapse(tmp_path):
    """A plastic run preempted on 2x1 and resumed on 1x2: the learned
    weights travel by global synapse id (the checksum right after the
    relay equals the one before), nothing is re-sampled."""
    cfg21 = dist_cfg(2, 1, stdp=STDPParams())
    d1 = driver(tmp_path, tiles=(2, 1), dist=cfg21,
                preempt_after_segments=2)
    out1 = d1.run(N)
    before = d1.plastic_summary(out1["state"])
    assert before["w_l1_delta"] > 0
    d2 = driver(tmp_path, dist=dist_cfg(1, 2, stdp=STDPParams()),
                allow_retile=True)
    start, state = d2._restore_or_init()
    assert start == 2 * SEG
    after = d2.plastic_summary(state)
    # the checksum is per global synapse; the float32 sum follows the
    # tiling's gather order
    assert after["weight_checksum"] == before["weight_checksum"]
    assert after["w_l1_delta"] == pytest.approx(before["w_l1_delta"])
    assert after["n_synapses"] == before["n_synapses"]
    meta = checkpoint_meta(str(tmp_path), 2 * SEG)
    assert meta["born_tiles"] == [2, 1]
    out2 = d2.run(N)
    assert out2["final_step"] == N


def test_plastic_driver_matches_reference_60_step_run(reference_runs,
                                                     tmp_path):
    """The reference's plastic program is held bitwise only as the
    program it compiles for one 60-step run: the port's driver with one
    60-step segment, on that run's drive, ends in its weights, traces
    and state (``tests/test_torch_dist.py``'s reference case
    ``exponential_2x2_plastic``, 6x6x30 in 2x2 tiles); and 30 + preempt
    + resume + 30 ends in the same bits."""
    ref = reference_runs["exponential_2x2_plastic"]
    cfg = dist_port_config("exponential", 2, 2, "plastic")
    drive = torch.from_numpy(ref["drive"])
    one = driver(tmp_path / "one", seg=DIST_STEPS, dist=cfg, drive=drive)
    out = one.run(DIST_STEPS)
    st = out["state"]
    assert_dist_run(ref, st)
    driver(tmp_path / "two", seg=DIST_STEPS // 2, dist=cfg, drive=drive,
           preempt_after_segments=1).run(DIST_STEPS)
    two = driver(tmp_path / "two", seg=DIST_STEPS // 2, dist=cfg,
                 drive=drive)
    assert_same_state(st, two.run(DIST_STEPS)["state"])


# ---------------------------------------------------------------------------
# jobs and launchers
# ---------------------------------------------------------------------------

def test_job_spec_round_trip_and_validation(tmp_path):
    spec = SimJobSpec(ckpt_dir=str(tmp_path), grid=4, n_per_column=20,
                      tiles=[2, 1], seeds=[0, 1], record=True)
    assert spec.tiles == (2, 1) and spec.seeds == (0, 1)
    assert SimJobSpec.from_json(spec.to_json()) == spec
    with pytest.raises(ValueError, match="law"):
        SimJobSpec(ckpt_dir="x", law="uniform")
    with pytest.raises(ValueError, match="segment_steps"):
        SimJobSpec(ckpt_dir="x", segment_steps=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        SimJobSpec(ckpt_dir="x", seeds=(1,), state_seed=2)
    with pytest.raises(ValueError, match="unknown job spec fields"):
        SimJobSpec.from_json(json.dumps({"ckpt_dir": "x", "mesh": 1}))
    # an ensemble spec builds: two members on 2x1 tiles, a member spool
    drv = build_sim_driver(spec, device="cpu")
    assert drv.n_members == 2 and drv.dist_cfg.ensemble_seeds == (0, 1)
    assert drv.dist_cfg.tiles == (2, 1) and drv.spool.members == (0, 1)


def test_build_sim_driver_refuses_bad_resume_targets(tmp_path):
    spec = SimJobSpec(ckpt_dir=str(tmp_path), grid=4, n_per_column=10,
                      t_steps=10, segment_steps=10)
    with pytest.raises(JobError, match="no checkpoint"):
        build_sim_driver(dataclasses.replace(spec, resume=True),
                         device="cpu")
    drv = build_sim_driver(spec, device="cpu")
    assert drv.dist_cfg.tiles == (1, 1) and drv.device.type == "cpu"
    drv.run(10)
    with pytest.raises(JobError, match="already holds"):
        build_sim_driver(spec, device="cpu")
    meta = checkpoint_meta(str(tmp_path), 10)
    assert SimJobSpec.from_json(json.dumps(meta["job"])) == spec


def test_sim_and_analyze_launchers(tmp_path, capsys):
    """The CLI: a recorded run preempted on 2x1, resumed on 1x2 with
    --retile, then analyzed; --seeds runs an ensemble."""
    from repro_torch.launch import analyze, sim
    from repro_torch.obs.telemetry import get_default, set_default
    run = str(tmp_path / "run")
    tracer = get_default()          # --telemetry-out installs its own
    args = ["--grid", "4", "--neurons-per-column", "20", "--steps", "30",
            "--segment-steps", "10", "--record", "--ckpt-dir", run,
            "--device", "cpu"]
    out = sim.main(args + ["--tiles", "2x1", "--preempt-after", "2",
                           "--metrics-out", str(tmp_path / "m.json")])
    assert out["preempted"] and out["final_step"] == 20
    with pytest.raises(ValueError, match="retile"):
        sim.main(args + ["--tiles", "1x2", "--resume"])
    try:
        out = sim.main(args + ["--tiles", "1x2", "--resume", "--retile",
                               "--telemetry-out", str(tmp_path / "t.jsonl"),
                               "--trace-out", str(tmp_path / "trace.json")])
    finally:
        set_default(tracer)
    assert out["final_step"] == 30 and not out["preempted"]
    with open(tmp_path / "m.json") as f:
        m = json.load(f)
    assert m["tiles"] == [2, 1] and m["captures"] == 0
    assert m["recording"]["recorder_dropped"] == 0
    rep = analyze.main(["--run", f"r={run}", "--telemetry",
                        f"r={tmp_path / 't.jsonl'}",
                        "--out", str(tmp_path / "a.json")])
    assert rep["runs"]["r"]["t_steps"] == 30
    assert rep["runs"]["r"]["n_events"] > 0
    assert rep["telemetry"]["r"]["segments"]["n"] == 1
    assert "final_step=30" in capsys.readouterr().out
    out = sim.main(args + ["--seeds", "0,1", "--ckpt-dir",
                           str(tmp_path / "ens"), "--metrics-out",
                           str(tmp_path / "e.json")])
    assert out["final_step"] == 30 and out["state"]["t"].shape == (1, 1, 2)
    with open(tmp_path / "e.json") as f:
        e = json.load(f)
    assert e["ensemble_seeds"] == [0, 1]
    assert e["recording"]["spooled_events"] > 0
    assert "members=2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the generic loop (the reference's tests/test_runtime.py contracts)
# ---------------------------------------------------------------------------

def _train_driver(tmp_path, fault_hook=None, ckpt_every=5, max_retries=3):
    def step_fn(state, batch):
        new = {"x": state["x"] + batch}
        return new, {"loss": new["x"]}

    return TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                     max_retries=max_retries, backoff_s=0.01,
                     handle_sigterm=False),
        step_fn=step_fn, batch_fn=lambda step: torch.tensor(1.0),
        init_state_fn=lambda: {"x": torch.tensor(0.0)},
        fault_hook=fault_hook, device="cpu")


def test_train_driver_runs_and_checkpoints(tmp_path):
    out = _train_driver(tmp_path).run(12)
    assert out["final_step"] == 12 and float(out["state"]["x"]) == 12.0
    assert latest_step(str(tmp_path)) == 12


def test_train_driver_recovers_from_injected_fault(tmp_path):
    fired = []

    def hook(step):
        if step == 7 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    out = _train_driver(tmp_path, fault_hook=hook).run(12)
    assert fired == [7] and out["final_step"] == 12
    assert float(out["state"]["x"]) == 12.0            # exact replay
    assert [m["step"] for m in out["metrics"]] == list(range(12))


def test_train_driver_gives_up_after_max_retries(tmp_path):
    def hook(step):
        if step >= 3:
            raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError):
        _train_driver(tmp_path, fault_hook=hook, max_retries=2).run(10)


def test_straggler_watchdog_flags_slow_step():
    wd = StragglerWatchdog(factor=3.0, window=10)
    for s in range(8):
        wd.observe(s, 0.01)
    assert wd.observe(8, 0.2) is True
    assert wd.flagged and wd.flagged[0][0] == 8
    assert wd.observe(9, 0.012) is False


def test_train_driver_preemption_checkpoints_and_exits(tmp_path):
    d = _train_driver(tmp_path, ckpt_every=100)
    orig = d.batch_fn

    def batch_fn(step):
        if step == 4:
            d.preempted = True            # simulated SIGTERM
        return orig(step)

    d.batch_fn = batch_fn
    out = d.run(50)
    assert out["preempted"] and out["final_step"] == 5
    assert latest_step(str(tmp_path)) == 5


def test_train_driver_restore_does_not_materialize_init_state(tmp_path):
    _train_driver(tmp_path).run(6)

    def boom():
        raise AssertionError("init_state_fn must not run on restore")

    d2 = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), backoff_s=0.01,
                     handle_sigterm=False),
        step_fn=lambda s, b: ({"x": s["x"] + b}, {"loss": s["x"]}),
        batch_fn=lambda step: torch.tensor(1.0), init_state_fn=boom,
        abstract_state={"x": LeafSpec((), torch.float32)}, device="cpu")
    start, state = d2._restore_or_init()
    assert start == 6 and float(state["x"]) == 6.0
    out = d2.run(9)
    assert out["final_step"] == 9 and float(out["state"]["x"]) == 9.0
