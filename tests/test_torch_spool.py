"""Port parity: the spike spool and the activity analysis
(``repro_torch.obs.spool``, ``repro_torch.obs.analysis``).

Each contract of the spool and analysis tests of the reference's
``tests/test_obs.py`` holds in the port's driver: valid empty logs,
exactly-once logs after preemption and after a failure replay,
recorder overflow counted (held to the contract of
``repro/obs/record.py``, ``dropped = spikes - appended``, which the
reference's own overflow test breaks), foreign headers refused,
tampered logs refused; the statistics on known spike trains.  The
same appends make byte-identical files in either package, and each
package's analysis of one spool is the other's.
"""

import json
import os

import numpy as np
import pytest

from repro.obs import analysis as janalysis
from repro.obs import spool as jspool
from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.obs.analysis import (analyze_run, compare_runs,
                                      ks_statistic, strip_private,
                                      updown_segmentation)
from repro_torch.obs.spool import (SpikeSpooler, load_events,
                                   read_header, read_new_events,
                                   shard_events)
from repro_torch.runtime import DriverConfig, SimDriver

N, SEG = 40, 10


def _dist_cfg(**kw):
    law = tconn.gaussian_law()
    return tde.DistConfig(engine=teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(4, 4, 20), 1, 1,
                                       law.radius),
        law=law, seed=3, **dict({"ext_rate_hz": 20.0}, **kw)))


def _driver(ckpt_dir, dist=None, ckpt_every=1, **kw):
    cfg = DriverConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                       backoff_s=0.01, handle_sigterm=False)
    return SimDriver(cfg, dist or _dist_cfg(), "cpu", segment_steps=SEG,
                     record_events=True, **kw)


def test_zero_spike_segments_produce_valid_empty_logs(tmp_path):
    d = _driver(tmp_path, dist=_dist_cfg(ext_rate_hz=0.0))
    out = d.run(20)
    d.spool.close()
    assert float(out["state"]["metrics"]["spikes"].sum()) == 0
    shards = shard_events(str(tmp_path))
    assert list(shards) == ["events_000_000.spk"]
    assert len(shards["events_000_000.spk"]) == 0
    assert read_header(str(tmp_path))["law"] == "gaussian"
    rep = analyze_run(str(tmp_path))
    assert rep["n_events"] == 0 and rep["t_steps"] == 20
    assert rep["rates"]["mean_hz"] == 0.0
    assert rep["population"]["updown"]["regime"] == "silent"


def test_spool_exactly_once_after_preemption(tmp_path):
    straight = _driver(tmp_path / "a")
    straight.run(N)
    straight.spool.close()
    d1 = _driver(tmp_path / "b", preempt_after_segments=2)
    assert d1.run(N)["preempted"]
    d1.spool.close()
    d2 = _driver(tmp_path / "b")
    assert d2.run(N)["final_step"] == N
    d2.spool.close()
    ev_a = load_events(str(tmp_path / "a"))
    assert len(ev_a) > 0
    np.testing.assert_array_equal(ev_a, load_events(str(tmp_path / "b")))
    assert json.dumps(strip_private(analyze_run(str(tmp_path / "a")))
                      ["rates"]) == json.dumps(strip_private(analyze_run(
                          str(tmp_path / "b")))["rates"])


def test_spool_exactly_once_after_failure_replay(tmp_path):
    straight = _driver(tmp_path / "ref")
    straight.run(N)
    straight.spool.close()
    fired = []

    def hook(step):
        if step == 30 and not fired:
            fired.append(step)
            raise RuntimeError("injected failure after unsaved segment")

    d = _driver(tmp_path / "x", ckpt_every=2, fault_hook=hook)
    out = d.run(N)
    assert fired == [30] and out["final_step"] == N
    d.spool.close()
    np.testing.assert_array_equal(load_events(str(tmp_path / "ref")),
                                  load_events(str(tmp_path / "x")))


def test_recorder_overflow_is_counted_not_silent(tmp_path):
    """An undersized event buffer keeps each segment's first events and
    counts the rest: dropped = spikes - appended, in the driver, in
    each checkpoint's manifest and after a resume.  Each segment starts
    from a freshly zeroed buffer."""
    full = _driver(tmp_path / "full")
    out = full.run(N)
    full.spool.close()
    n_total = len(load_events(str(tmp_path / "full")))
    assert n_total == full.metric_totals(out["state"])["spikes"] > 2
    tiny = _driver(tmp_path / "tiny", record_capacity=1)
    tiny.run(N)
    tiny.spool.close()
    ev = load_events(str(tmp_path / "tiny"))
    assert len(ev) == N // SEG              # one event a segment
    assert tiny.recorder_dropped == n_total - len(ev)
    # each segment's kept event is that segment's first spike
    steps = np.sort(load_events(str(tmp_path / "full"))["step"])
    first = [steps[steps >= s][0] for s in range(0, N, SEG)]
    assert list(ev["step"]) == first
    again = _driver(tmp_path / "tiny", record_capacity=1)
    start, _ = again._restore_or_init()
    assert start == N and again.recorder_dropped == tiny.recorder_dropped


def test_spooler_refuses_foreign_header(tmp_path):
    sp = SpikeSpooler(str(tmp_path), (1, 1),
                      header={"n_neurons": 160, "law": "gaussian"})
    sp.close()
    SpikeSpooler(str(tmp_path), (1, 1),
                 header={"n_neurons": 160, "law": "gaussian"}).close()
    with pytest.raises(ValueError, match="different model"):
        SpikeSpooler(str(tmp_path), (1, 1),
                     header={"n_neurons": 3840, "law": "gaussian"})


def test_spooler_truncate_rejects_tampered_logs(tmp_path):
    sp = SpikeSpooler(str(tmp_path), (1, 1), header={"n_neurons": 4})
    sp.append(0, 0, np.asarray([1, 2]), np.asarray([3, 0]))
    sp.wait()
    os.truncate(tmp_path / "events_000_000.spk", 0)
    with pytest.raises(IOError, match="truncated or deleted"):
        sp.truncate({"events_000_000.spk": 2})
    sp.close()


def test_spool_files_are_the_references_byte_for_byte(tmp_path):
    """The same appends through either spooler: identical files (header
    included), offsets, truncation and incremental reads."""
    header = {"grid": [2, 2, 3], "law": "exponential", "seed": 1,
              "dt_ms": 1.0, "n_neurons": 12}
    rng = np.random.default_rng(5)
    appends = [(y, x, np.sort(rng.integers(0, 50, n)).astype(np.int32),
                rng.integers(0, 12, n).astype(np.int32))
               for y, x, n in ((0, 0, 7), (1, 0, 0), (0, 1, 3),
                               (1, 1, 9), (0, 0, 4))]
    dirs = {}
    for name, mod in (("jax", jspool), ("torch", None)):
        d = str(tmp_path / name)
        sp = (mod.SpikeSpooler if mod else SpikeSpooler)(
            d, (2, 2), header=header)
        for a in appends:
            sp.append(*a)
        offs = sp.offsets()
        sp.truncate(dict(offs, **{"events_000_000.spk": 5}))
        sp.append(*appends[1])
        sp.close()
        dirs[name] = (d, offs)
    (dj, oj), (dt, ot) = dirs["jax"], dirs["torch"]
    assert oj == ot
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for fn in os.listdir(dj):
        assert open(os.path.join(dj, fn), "rb").read() == \
            open(os.path.join(dt, fn), "rb").read(), fn
    new, cur = read_new_events(dt)
    newj, curj = jspool.read_new_events(dj)
    assert cur == curj and set(new) == set(newj)
    for k in new:
        np.testing.assert_array_equal(new[k], newj[k])
    assert read_new_events(dt, cur)[0] == {}


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def _write_synthetic(directory, events, n_neurons=8, dt_ms=1.0):
    sp = SpikeSpooler(str(directory), (1, 1),
                      header={"grid": [2, 2, n_neurons // 4],
                              "law": "gaussian", "seed": 0,
                              "dt_ms": dt_ms, "n_neurons": n_neurons})
    sp.append(0, 0, np.asarray([e[0] for e in events], np.int32),
              np.asarray([e[1] for e in events], np.int32))
    sp.close()


def _same_report(a: dict, b: dict):
    a, b = strip_private(a), strip_private(b)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_analysis_statistics_on_synthetic_events(tmp_path):
    ev = [(t, 0) for t in range(0, 150, 10)]
    ev += [(5, 1), (25, 1)]
    ev += [(t, g) for t in list(range(0, 50, 2)) + list(range(100, 150, 2))
           for g in (2, 3, 4)]
    _write_synthetic(tmp_path, sorted(ev), n_neurons=8)
    rep = analyze_run(str(tmp_path), t_steps=150, bin_steps=5)
    assert rep["n_events"] == len(ev)
    rates = rep["_neuron_rates"]
    assert rates[0] == pytest.approx(100.0)
    assert rates[1] == pytest.approx(2 / 0.15)
    assert rep["isi"]["n_excluded"] >= 1
    assert rep["isi"]["n_neurons"] == 4
    assert rep["isi"]["p05"] < 0.5 < rep["isi"]["mean_cv"]
    ud = rep["population"]["updown"]
    assert ud["regime"] == "slow_wave_like"
    assert ud["n_down_periods"] >= 1 and ud["n_up_periods"] >= 2
    assert 0.3 < ud["up_fraction"] < 0.9
    _same_report(rep, janalysis.analyze_run(str(tmp_path), t_steps=150,
                                            bin_steps=5))


def test_ks_statistic_separates_distinct_distributions():
    rng = np.random.default_rng(0)
    a = rng.normal(8.0, 1.0, 400)
    same = rng.normal(8.0, 1.0, 400)
    b = rng.normal(35.0, 5.0, 400)
    assert ks_statistic(a, b) > 0.9
    assert ks_statistic(a, same) < 0.2
    assert ks_statistic(a, a) == 0.0
    assert ks_statistic(a, b) == janalysis.ks_statistic(a, b)


def test_updown_silent_and_awake_edges():
    assert updown_segmentation(np.zeros(50))["regime"] == "silent"
    steady = np.full(100, 10.0) + np.linspace(0, 0.1, 100)
    assert updown_segmentation(steady)["regime"] == "awake_like"


def test_driver_runs_analyze_as_the_reference_does(tmp_path):
    """Two laws' recorded runs: each package's report and comparison of
    the port's spools agree."""
    reports, jreports = {}, {}
    for name in ("gaussian", "exponential"):
        law = getattr(tconn, f"{name}_law")()
        cfg = tde.DistConfig(engine=teng.EngineConfig(
            decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(4, 4, 20), 1,
                                           1, law.radius),
            law=law, seed=3, ext_rate_hz=20.0))
        d = _driver(tmp_path / name, dist=cfg)
        d.run(N)
        d.spool.close()
        reports[name] = analyze_run(str(tmp_path / name))
        jreports[name] = janalysis.analyze_run(str(tmp_path / name))
        _same_report(reports[name], jreports[name])
    cmp = compare_runs(reports)
    assert json.dumps(cmp, sort_keys=True) == json.dumps(
        janalysis.compare_runs(jreports), sort_keys=True)
    pair = cmp["pairs"]["gaussian_vs_exponential"]
    assert pair["mean_rate_ratio"] > 0 and pair["rate_ks_statistic"] > 0
