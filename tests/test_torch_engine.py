"""Port parity: the whole single-shard static slice, bit for bit.

With the reference's drive injected (its key split each step as
``repro.core.engine.step`` splits it), the port's ``simulate`` must
reproduce the reference's spike raster, final neuron state, delay ring
and metrics exactly, for both laws and both delivery modes.  The torch
drive itself is held to the Poisson law statistically.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import engine as teng
from repro_torch.core.convert import state_from_arrays, tables_from_arrays

from _torch_parity import (LAWS, assert_bits_equal, configs,
                           reference_drive, tier_arrays)

STEPS = 120


@functools.lru_cache(maxsize=None)
def _reference_run(law, mode, grid, n_per_col, steps):
    """The reference's run (pure-XLA path) and the drive it drew."""
    jcfg, tcfg = configs(law, grid=grid, n_per_col=n_per_col, mode=mode)
    tabs = jeng.build_shard_tables(jcfg)
    state = jeng.init_sim_state(jcfg)
    drive = reference_drive(jcfg, state, steps)
    fin, raster = jax.jit(lambda s: jeng.simulate(
        s, tabs, jcfg, steps, record_spikes=True))(state)
    return jcfg, tcfg, drive, jax.tree_util.tree_map(np.asarray, fin), \
        np.asarray(raster)


def _assert_same_run(jfin, jraster, tfin, traster):
    assert_bits_equal(jraster, traster, "raster")
    for k in ("v", "c", "refrac"):
        assert_bits_equal(jfin["neuron"][k], tfin["neuron"][k], k)
    assert_bits_equal(jfin["i_ring"], tfin["i_ring"], "i_ring")
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(jfin["metrics"][k], tfin["metrics"][k], k)
    assert tfin["t"] == int(jfin["t"])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("mode", ["event", "gather_all"])
@pytest.mark.parametrize("law", LAWS)
def test_whole_slice_bit_identical(law, mode, use_kernels):
    jcfg, tcfg, drive, jfin, jraster = _reference_run(law, mode, 4, 30,
                                                      STEPS)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    state = teng.init_sim_state(tcfg, device="cpu")
    tfin, traster = teng.simulate(state, tabs, tcfg, STEPS,
                                  record_spikes=True,
                                  drive=torch.from_numpy(drive),
                                  device="cpu")
    assert traster.shape == (STEPS, tcfg.spec().n_local)
    assert float(traster.sum()) > 0
    _assert_same_run(jfin, jraster, tfin, traster)
    assert teng.firing_rate_hz(tfin, tcfg) == \
        jeng.firing_rate_hz(jfin, jcfg)


def test_wider_columns_bit_identical():
    """6x6 columns of 100 neurons (the widest tier-1 size)."""
    jcfg, tcfg, drive, jfin, jraster = _reference_run("gaussian", "event",
                                                      6, 100, 100)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    tfin, traster = teng.simulate(teng.init_sim_state(tcfg, device="cpu"),
                                  tabs, tcfg, 100, record_spikes=True,
                                  drive=torch.from_numpy(drive),
                                  device="cpu")
    _assert_same_run(jfin, jraster, tfin, traster)


def test_active_cap_overflow_run_bit_identical():
    """A strong drive against a tiny compaction list (rate_cap_hz) makes
    steps drop spikes: the port must drop the same ones."""
    law, steps = "exponential", 100
    jcfg, tcfg = configs(law, grid=4, n_per_col=30, rate_cap_hz=0.5,
                         cap_headroom=1.0, ext_rate_hz=20.0)
    assert tcfg.spec().active_cap_local < 40
    tabs_j = jeng.build_shard_tables(jcfg)
    js = jeng.init_sim_state(jcfg)
    drive = reference_drive(jcfg, js, steps)
    jfin, jraster = jax.jit(lambda s: jeng.simulate(
        s, tabs_j, jcfg, steps, record_spikes=True))(js)
    tfin, traster = teng.simulate(
        teng.init_sim_state(tcfg, device="cpu"),
        teng.build_shard_tables(tcfg, device="cpu"), tcfg, steps,
        record_spikes=True, drive=torch.from_numpy(drive), device="cpu")
    assert float(tfin["metrics"]["dropped"]) > 0
    _assert_same_run(jax.tree_util.tree_map(np.asarray, jfin),
                     np.asarray(jraster), tfin, traster)


@pytest.mark.parametrize("law", LAWS)
def test_resume_from_converted_reference_state(law):
    """The reference runs 60 steps; its state and tables, carried across
    with ``state_from_arrays`` / ``tables_from_arrays``, continue in the
    port for 60 more steps exactly as the reference continues."""
    jcfg, tcfg = configs(law, grid=4, n_per_col=30)
    tabs_j = jeng.build_shard_tables(jcfg)
    js = jeng.init_sim_state(jcfg)
    run = jax.jit(lambda s: jeng.simulate(s, tabs_j, jcfg, 60,
                                          record_spikes=True))
    js, _ = run(js)
    drive = reference_drive(jcfg, js, 60)
    jfin, jraster = run(js)
    arrays = jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in js.items() if k != "rng"})
    ts = state_from_arrays(arrays, tcfg, device="cpu")
    assert ts["t"] == 60
    tt = tables_from_arrays(tier_arrays(tabs_j)[0], tier_arrays(tabs_j)[1:],
                            tabs_j.storage.meta(), device="cpu")
    tfin, traster = teng.simulate(ts, tt, tcfg, 60, record_spikes=True,
                                  drive=torch.from_numpy(drive),
                                  device="cpu")
    _assert_same_run(jax.tree_util.tree_map(np.asarray, jfin),
                     np.asarray(jraster), tfin, traster)


def test_state_from_arrays_equals_port_init():
    jcfg, tcfg = configs("gaussian", grid=4, n_per_col=20)
    js = jax.tree_util.tree_map(
        np.asarray,
        {k: v for k, v in jeng.init_sim_state(jcfg).items() if k != "rng"})
    conv = state_from_arrays(js, tcfg, device="cpu")
    own = teng.init_sim_state(tcfg, device="cpu")
    for k in ("v", "c", "refrac"):
        assert torch.equal(conv["neuron"][k], own["neuron"][k])
    assert torch.equal(conv["active"], own["active"])
    assert torch.equal(conv["i_ring"], own["i_ring"])
    assert conv["metrics"]["spikes"].shape == ()
    # the same generator seed as init_sim_state: identical drives
    a = teng.external_drive(conv["rng"], 64, tcfg)
    b = teng.external_drive(own["rng"], 64, tcfg)
    assert torch.equal(a, b)


def test_torch_drive_is_poisson():
    """Mean and variance of the torch drive (in input events) match
    Poisson(lambda = 540 x 3 Hz x 1 ms) within 5 sigma."""
    _, tcfg = configs("gaussian", grid=4, n_per_col=20)
    lam = 540 * 3.0 * 1e-3
    gen = torch.Generator().manual_seed(0)
    n = 400_000
    x = (teng.external_drive(gen, n, tcfg) / tcfg.lif.j_ext_mv).double()
    assert torch.equal(x, x.round())
    mean, var = float(x.mean()), float(x.var())
    assert abs(mean - lam) < 5 * np.sqrt(lam / n)
    assert abs(var - lam) < 5 * np.sqrt((lam + 2 * lam ** 2) / n)


def test_drive_sources_agree():
    """Drawn, tensor-injected and callable-injected drives are the same
    run when they carry the same numbers."""
    _, tcfg = configs("exponential", grid=4, n_per_col=20)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    n = tcfg.spec().n_local
    gen = torch.Generator().manual_seed(tcfg.state_seed_value)
    drive = torch.stack([teng.external_drive(gen, n, tcfg)
                         for _ in range(40)])
    runs = [teng.simulate(teng.init_sim_state(tcfg, device="cpu"), tabs,
                          tcfg, 40, record_spikes=True, drive=d,
                          device="cpu")
            for d in (None, drive, lambda t: drive[t])]
    for fin, raster in runs[1:]:
        assert torch.equal(raster, runs[0][1])
        assert torch.equal(fin["neuron"]["v"], runs[0][0]["neuron"]["v"])
    fin, counts = teng.simulate(teng.init_sim_state(tcfg, device="cpu"),
                                tabs, tcfg, 40, drive=drive, device="cpu")
    assert torch.equal(counts, runs[0][1].sum(1))


def test_simulate_rejects_mismatched_inputs():
    _, tcfg = configs("gaussian", grid=4, n_per_col=20)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    state = teng.init_sim_state(tcfg, device="cpu")
    with pytest.raises(ValueError, match="drive"):
        teng.simulate(state, tabs, tcfg, 5, drive=torch.zeros(4, 3),
                      device="cpu")
    with pytest.raises(ValueError, match="mode"):
        teng.simulate(state, tabs, dataclasses.replace(tcfg, mode="dense"),
                      1, device="cpu")
