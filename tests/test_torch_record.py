"""Port parity: the device-side spike recorder, bit for bit.

A static run with the recorder gives the same ``step``/``gid`` buffers,
``count`` and ``dropped`` as the reference's, at the no-drop capacity
and at ``capacity=1``; recording leaves the raster unchanged; the
compaction wrapper equals the reference's compaction kernel (interpret
mode) and the global-id map equals the reference's on a padded grid.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import grid as jgrid
from repro.kernels import ops as jops
from repro.kernels.synaptic_accum import compact_events as jcompact
from repro.obs import record as jrec
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.kernels.ref import compact_events
from repro_torch.kernels.spike_compact import (TILE_ROWS, Plan, plan,
                                               spike_compact)
from repro_torch.obs import record as trec

from _torch_parity import LAWS, assert_bits_equal, configs, reference_drive

STEPS = 60


@functools.lru_cache(maxsize=None)
def _reference_recorded(law, capacity):
    jcfg, tcfg = configs(law, grid=4, n_per_col=30)
    tabs = jeng.build_shard_tables(jcfg)
    state = jeng.init_sim_state(jcfg)
    drive = reference_drive(jcfg, state, STEPS)
    rspec = jrec.recorder_spec(jcfg, STEPS, capacity=capacity)
    fin, raster, rec = jax.jit(lambda s: jeng.simulate(
        s, tabs, jcfg, STEPS, record_spikes=True, recorder=rspec))(state)
    return (tcfg, drive, np.asarray(raster),
            jax.tree_util.tree_map(np.asarray, rec),
            np.asarray(fin["metrics"]["spikes"]))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("capacity", [None, 1])
@pytest.mark.parametrize("law", LAWS)
def test_recorder_buffers_bit_identical(law, capacity, use_kernels):
    tcfg, drive, jraster, jrec_state, jspikes = _reference_recorded(
        law, capacity)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    rspec = trec.recorder_spec(tcfg, STEPS, capacity=capacity)
    assert rspec.use_kernels == use_kernels
    fin, raster, rec = teng.simulate(
        teng.init_sim_state(tcfg, device="cpu"), tabs, tcfg, STEPS,
        record_spikes=True, drive=torch.from_numpy(drive), device="cpu",
        recorder=rspec)
    for k in ("step", "gid", "count", "dropped"):
        assert_bits_equal(jrec_state[k], rec[k], k)
    assert_bits_equal(jraster, raster, "raster")
    n_spikes = int(raster.sum())
    assert n_spikes == int(jspikes) > 1
    assert int(rec["dropped"]) == n_spikes - int(rec["count"])
    if capacity is None:
        assert int(rec["dropped"]) == 0 and int(rec["count"]) == n_spikes
    else:
        assert int(rec["count"]) == 1
    # recording is a pure observer: the same run without it
    _, raster_off = teng.simulate(
        teng.init_sim_state(tcfg, device="cpu"), tabs, tcfg, STEPS,
        record_spikes=True, drive=torch.from_numpy(drive), device="cpu")
    assert torch.equal(raster, raster_off)


@pytest.mark.parametrize("ty,tx", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_tile_gid_map_padded_grid(ty, tx):
    """5x5 columns tiled 2x2 pad to 6x6: the padded slots are -1, as in
    the reference."""
    jd = jgrid.TileDecomposition(jgrid.ColumnGrid(5, 5, 4), 2, 2, 1)
    td = tgrid.TileDecomposition(tgrid.ColumnGrid(5, 5, 4), 2, 2, 1)
    a = jrec.tile_gid_map(jd, ty, tx)
    b = trec.tile_gid_map(td, ty, tx)
    assert_bits_equal(a, b, "gid map")
    assert b.shape == (td.n_local + 1,) and b[-1] == -1
    if (ty, tx) != (0, 0):
        assert (b[:-1] == -1).any()


def test_gid_maps_cover_grid_once():
    td = tgrid.TileDecomposition(tgrid.ColumnGrid(5, 5, 4), 2, 2, 1)
    allg = np.concatenate([trec.tile_gid_map(td, y, x)[:-1]
                           for y in range(2) for x in range(2)])
    real = np.sort(allg[allg >= 0])
    assert np.array_equal(real, np.arange(td.grid.n_neurons))


@pytest.mark.parametrize("n,cap,p", [(100, 40, 0.3), (1030, 64, 0.5),
                                     (2500, 3000, 0.1), (300, 16, 0.0)])
def test_spike_compact_matches_reference_kernel(n, cap, p):
    """The wrapper's CPU route against the reference's compaction kernel
    (interpret mode): indices and uncapped count."""
    rng = np.random.default_rng(n)
    spk = (rng.random(n) < p).astype(np.float32)
    jidx, jcnt = jops.spike_compact(jax.numpy.asarray(spk), n, cap)
    idx, cnt = spike_compact(torch.from_numpy(spk), n, cap)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    assert_bits_equal(np.asarray(jidx), idx, "idx")
    assert int(cnt) == int(jcnt) == int(spk.sum())
    cidx, ccnt = compact_events(torch.from_numpy(spk), n, cap)
    assert torch.equal(cidx, idx) and int(ccnt) == int(cnt)


def test_recorder_spec_sizing_and_refusals():
    _, tcfg = configs("gaussian", grid=4, n_per_col=30)
    r = trec.recorder_spec(tcfg, 10)
    spec = tcfg.spec()
    assert r.capacity == spec.active_cap_local * 10
    assert (r.active_cap, r.n_rows) == (spec.active_cap_local, spec.n_local)
    with pytest.raises(ValueError, match="capacity"):
        trec.recorder_spec(tcfg, 10, capacity=0)
    st = trec.init_recorder_state(r, device="cpu")
    assert st["step"].shape == (r.capacity,) and int(st["count"]) == 0
    with pytest.raises(ValueError, match="float32"):
        spike_compact(torch.zeros(4, dtype=torch.int32), 4, 2)


@pytest.mark.parametrize("n,tiles", [(0, 0), (1, 1), (3, 1), (4096, 1),
                                     (4097, 2), (3 * 4096, 3),
                                     (79_360, 20), (714_240, 175)])
def test_spike_compact_plan_edges(n, tiles):
    """Grid and scratch sizing of the compaction kernel: whole 4096-row
    tiles, a persistent grid of at most ``max_blocks`` (and at least one
    block, which writes the count and the sink tail), one status word per
    tile."""
    assert TILE_ROWS == 4096
    for max_blocks in (1, 7, 132 * 8):
        p = plan(n, max_blocks)
        assert isinstance(p, Plan) and p.tiles == tiles
        assert p.grid == max(1, min(tiles, max_blocks))
        assert p.status_words == max(tiles, 1)
    with pytest.raises(ValueError, match="plan"):
        plan(-1, 4)
    with pytest.raises(ValueError, match="plan"):
        plan(n, 0)


def _edge_case(case: str):
    rng = np.random.default_rng(17)
    if case == "cap0":
        n = 5000
        spk = (rng.random(n) < 0.3).astype(np.float32)
        return spk, n, 0
    if case == "cut_across_tile":
        n = 3 * TILE_ROWS + 77
        spk = (rng.random(n) < 0.5).astype(np.float32)
        cap = int(spk[:TILE_ROWS].sum()) + 3   # the cap-th spike: tile 1
        return spk, n, cap
    if case == "all_spike_cap_below":
        n = TILE_ROWS + 13
        return np.ones(n, np.float32), n, n - 100
    if case == "all_spike_cap_above":
        n = TILE_ROWS + 13
        return np.ones(n, np.float32), n, n + 5
    # n not a multiple of 4, a spiking row past n that must not count
    n = 1031
    spk = (rng.random(n + 3) < 0.4).astype(np.float32)
    spk[n:] = 1.0
    return spk, n, 300


@pytest.mark.parametrize("case", ["cap0", "cut_across_tile",
                                  "all_spike_cap_below",
                                  "all_spike_cap_above", "n_not_mult4"])
def test_spike_compact_edges_match_reference(case):
    """The plain version (the wrapper's CPU route) against the reference's
    ``compact_events`` at the compaction kernel's edge cases."""
    spk, n, cap = _edge_case(case)
    jidx, jcnt = jcompact(jax.numpy.asarray(spk), n, cap)
    idx, cnt = spike_compact(torch.from_numpy(spk), n, cap)
    assert idx.shape == (cap,) and idx.dtype == torch.int32
    assert_bits_equal(np.asarray(jidx).astype(np.int32), idx, "idx")
    assert int(cnt) == int(jcnt) == int((spk[:n] > 0).sum())
    live = np.flatnonzero(spk[:n] > 0)[:cap]
    assert np.array_equal(idx.numpy()[:live.size], live)
    assert (idx.numpy()[live.size:] == n).all()


@pytest.mark.parametrize("law", LAWS)
def test_returned_recorder_survives_a_later_call(law):
    """A recorder a call returned is that call's own, as the reference's
    fresh buffers are: a later call with an equal ``RecorderSpec`` from
    another ``state_seed`` leaves it unchanged (the engine's resident
    buffers are zeroed and refilled, the returned copy is not)."""
    _, tcfg = configs(law, grid=4, n_per_col=30)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    rspec = trec.recorder_spec(tcfg, STEPS)
    _, _, first = teng.simulate(teng.init_sim_state(tcfg, device="cpu"),
                                tabs, tcfg, STEPS, device="cpu",
                                recorder=rspec)
    kept = {k: x.clone() for k, x in first.items()}
    other = dataclasses.replace(tcfg, state_seed=tcfg.seed + 17)
    assert trec.recorder_spec(other, STEPS) == rspec
    _, _, second = teng.simulate(teng.init_sim_state(other, device="cpu"),
                                 tabs, other, STEPS, device="cpu",
                                 recorder=rspec)
    for k in kept:
        assert_bits_equal(kept[k], first[k], f"first call's {k}")
    assert int(first["count"]) > 0
    assert not torch.equal(first["gid"], second["gid"])
