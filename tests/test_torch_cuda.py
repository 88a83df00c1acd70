"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(every CPU run) and run on an H100 with
``pytest -m cuda tests/test_torch_cuda.py``.  Whether a card is present
is decided inside the fixture, never at import time.  The file imports
nothing of jax or the JAX package: the card tests need only the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import connectivity as tconn
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core.neuron import LIFParams
from repro_torch.core.synapses import deliver_events, with_local_tier
from repro_torch.kernels import _build, ref
from repro_torch.kernels.lif_step import lif_step_cuda
from repro_torch.kernels.synaptic_accum import event_delivery_banded

pytestmark = pytest.mark.cuda


def configs(law: str, grid: int = 4, n_per_col: int = 30, tiles: int = 1,
            **kw):
    """(None, port EngineConfig): the port's half of
    ``_torch_parity.configs``, so that this file needs no jax."""
    tl = getattr(tconn, f"{law}_law")()
    return None, teng.EngineConfig(
        decomp=tgrid.TileDecomposition(
            tgrid.ColumnGrid(grid, grid, n_per_col), tiles, tiles,
            tl.radius), law=tl, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_lif_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    n = 10_000
    v = torch.tensor(rng.uniform(-10, 25, n), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.uniform(0, 5, n), dtype=torch.float32, device=cuda)
    r = torch.tensor(rng.integers(0, 3, n), dtype=torch.int32, device=cuda)
    i = torch.tensor(rng.integers(-4000, 4000, n) * 2.0 ** -9,
                     dtype=torch.float32, device=cuda)
    a = torch.tensor(rng.random(n) < 0.9, device=cuda)
    kw = LIFParams().kernel_args()
    for x, y in zip(lif_step_cuda(v, c, r, i, a, **kw),
                    ref.lif_step_ref(v, c, r, i, a, **kw)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_delivery_kernel_matches_plain(cuda, law):
    _, tcfg = configs(law, grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    spec = tcfg.spec()
    g = torch.Generator(device=cuda).manual_seed(1)
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)[:1]
    for dens in (0.0, 0.05, 0.95):
        spk = (torch.rand(spec.n_local, device=cuda, generator=g)
               < dens).float()
        ring = torch.zeros((8, spec.n_local), device=cuda)
        rk, ek, dk = event_delivery_banded(
            [(tabs.local, spk, spec.active_cap_local)], ring.clone(), 2, 8,
            runs=runs)
        rp, ep, dp = deliver_events(tabs.local, spk, ring.clone(), 2, 8,
                                    spec.active_cap_local)
        assert torch.equal(rk, rp)
        assert int(ek) == int(ep) and int(dk) == int(dp)
    # the card has one route, through the tables' descriptors
    with pytest.raises(ValueError, match="run descriptors"):
        event_delivery_banded([(tabs.local, spk, spec.active_cap_local)],
                              ring, 2, 8)


@pytest.mark.parametrize("tgt32", [False, True])
@pytest.mark.parametrize("dens", [0.01, 0.05, 0.9])
@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_column_delivery_matches_plain(cuda, law, dens, tgt32):
    """The column kernel through the tables' run descriptors, every tier
    of a 2x2 tiling (local tier plus halo bands, random band spikes), at
    three densities with a small active_cap (drops), int16 and int32
    ids: ring, events and dropped equal to the plain path's."""
    from repro_torch.core.synapses import SynapseTables
    _, tcfg = configs(law, grid=4, n_per_col=100, tiles=2)
    spec = tcfg.spec()
    tabs = teng.build_shard_tables(tcfg, 1, 0, device=cuda)
    assert len(tabs.halo) >= 1 and tabs.local["tgt"].dtype == torch.int16
    if tgt32:
        tabs = SynapseTables(
            dict(tabs.local, tgt=tabs.local["tgt"].to(torch.int32)),
            [dict(t, tgt=t["tgt"].to(torch.int32)) for t in tabs.halo],
            tabs.storage, stats=tabs.stats)
    plan = spec.delivery_plan(tabs.storage)
    g = torch.Generator(device=cuda).manual_seed(int(dens * 100) + tgt32)
    spk = (torch.rand(spec.n_local, device=cuda, generator=g) < dens).float()
    bands = [(torch.rand(p.rows, device=cuda, generator=g) < dens).float()
             for p in plan[1:]]
    # a small active_cap for the local tier: only the first rows deliver
    small = [dataclasses.replace(plan[0], active_cap=max(
        int(spk.sum()) // 2, 1))] + plan[1:]
    ring = (torch.randint(-300, 300, (8, spec.n_local), device=cuda,
                          generator=g).float() * 2.0 ** -9)
    _build.reset_launch_counts()
    rk, ek, dk = teng.deliver_event_tiers(tabs, spk, bands, spec,
                                          ring.clone(), 5, 8, True,
                                          plan=small)
    assert _build.launch_counts() == {"event_delivery": len(plan)}
    rp, ep, dp = teng.deliver_event_tiers(tabs, spk, bands, spec,
                                          ring.clone(), 5, 8, False,
                                          plan=small)
    torch.cuda.synchronize()
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert float(ek) == float(ep) > 0 and float(dk) == float(dp) > 0
    assert all(r["perm"] is None
               for r in tabs.column_runs(spec.n_per_col, spec.n_exc_per_col,
                                         8))


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_column_delivery_float_window_matches_plain(cuda, law):
    """The column kernel's float32 window (tables whose weights are on
    no common grid take it; forced here on built tables) against the
    plain version: ring, events and dropped equal."""
    from repro_torch.kernels.ref import delivered_bits
    from repro_torch.kernels.synaptic_accum import deliver_columns_cuda
    _, tcfg = configs(law, grid=4, n_per_col=100)
    spec = tcfg.spec()
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)[0]
    assert runs["scale"] > 0
    g = torch.Generator(device=cuda).manual_seed(3)
    for dens in (0.05, 0.9):
        spk = (torch.rand(spec.n_local, device=cuda, generator=g)
               < dens).float()
        cap = int(spk.sum()) // 2 + 1
        ring = (torch.randint(-300, 300, (8, spec.n_local), device=cuda,
                              generator=g).float() * 2.0 ** -9)
        bits, _ = delivered_bits(spk, spec.n_local, cap)
        ek = torch.zeros(1, dtype=torch.int32, device=cuda)
        rk = deliver_columns_cuda(tabs.local, dict(runs, scale=0.0), bits,
                                  ring.clone(), 1, ek)
        rp, ep, _ = deliver_events(tabs.local, spk, ring.clone(), 1, 8, cap)
        torch.cuda.synchronize()
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
        assert int(ek) == int(ep) > 0


def test_kernel_path_run_matches_plain_path(cuda):
    _, tcfg = configs("exponential", grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    _build.reset_launch_counts()
    fk, rk = teng.simulate(teng.init_sim_state(tcfg, device=cuda), tabs,
                           tcfg, 50, record_spikes=True, device=cuda)
    # 8 eager steps, 5 replays of the captured 8-step graph, a 2-step tail
    assert _build.launch_counts() == {"neuron_step": 50,
                                      "event_delivery": 50, "step_graph": 5}
    plain = dataclasses.replace(tcfg, use_kernels=False)
    fp, rp = teng.simulate(teng.init_sim_state(plain, device=cuda), tabs,
                           plain, 50, record_spikes=True, device=cuda)
    assert torch.equal(rk, rp)
    assert torch.equal(fk["i_ring"], fp["i_ring"])


# ---------------------------------------------------------------------------
# the fused step head and the captured static step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5_003, 79_360, 714_240])
def test_neuron_step_kernel_matches_plain(cuda, n):
    """The step-head kernel against its plain version, every output
    exact: at spike densities 0, mid-run and above ``active_cap``, with
    neurons exactly at threshold, in place and not, and with no bitmap;
    one launch per call; n not a multiple of 32 too."""
    from repro_torch.kernels.neuron_step import neuron_step_cuda
    kw = LIFParams().kernel_args()
    g = torch.Generator(device=cuda).manual_seed(n)
    v0 = torch.rand(n, device=cuda, generator=g) * 25.0 - 5.0
    c = torch.rand(n, device=cuda, generator=g) * 5.0
    r = torch.randint(0, 3, (n,), device=cuda, generator=g,
                      dtype=torch.int32)
    a = torch.rand(n, device=cuda, generator=g) < 0.95
    drive = (torch.poisson(torch.full((n,), 1.62, device=cuda),
                           generator=g) * 0.5)
    # (ring offset, active_cap, neurons at threshold): no spike, mid-run
    # density, nothing delivered, and more spikes than active_cap
    for shift, cap, edge in ((-60.0, 1000, False), (0.0, n, True),
                             (0.0, 0, True), (15.0, n // 10, True)):
        ring = (torch.randint(-4000, 4000, (8, n), device=cuda,
                              generator=g).float() * 2.0 ** -9 + shift)
        v, drv = v0.clone(), drive.clone()
        if edge:     # v_int == theta exactly (v = c = 0, i = theta)
            ring[5, :64], v[:64], drv[:64] = kw["theta"], 0.0, 0.0
            c[:64], r[:64], a[:64] = 0.0, 0, True
        for inplace in (False, True):
            rk, rp = ring.clone(), ring.clone()
            st = (v.clone(), c.clone(), r.clone())
            _build.reset_launch_counts()
            got = neuron_step_cuda(rk, 5, drv, *st, a, active_cap=cap,
                                   out=st if inplace else None, **kw)
            assert _build.launch_counts() == {"neuron_step": 1}
            want = ref.neuron_step_ref(rp, 5, drv, v, c, r, a,
                                       active_cap=cap, **kw)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y)
            assert torch.equal(rk, rp) and not rk[5].any()
            assert bool(got[3][:64].all()) == edge
        if not edge:
            assert int(want[5]) == 0
        nobits = neuron_step_cuda(ring.clone(), 5, drv, v, c, r, a,
                                  active_cap=None, **kw)
        assert nobits[4] is None and int(nobits[5]) == int(want[5])
    assert int(want[5]) > n // 10   # the last density is above the cap


def _run_steps(state, tabs, cfg, n_steps, drive=None):
    """``n_steps`` eager ``engine.step`` calls (nothing captured)."""
    rows = []
    for k in range(n_steps):
        state, spk = teng.step(state, tabs, cfg,
                               drive=None if drive is None else drive[k])
        rows.append(spk)
    return state, torch.stack(rows)


@pytest.mark.parametrize("drawn", [False, True])
@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_captured_run_matches_eager_steps(cuda, law, drawn):
    """29 steps at 4x4x1240: 8 eager, two replays of the captured 8-step
    graph and a 5-step tail, then 19 more from step 29 (the graph starts
    mid-ring), against one eager ``step`` at a time from the same seed:
    raster, counts, state, ring, metrics and the drive generator's state
    are bit-equal, with the drive drawn inside the graph and injected."""
    _, tcfg = configs(law, grid=4, n_per_col=1240)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    n = tcfg.spec().n_local
    gen = torch.Generator(device=cuda).manual_seed(3)
    drive = (None if drawn else
             torch.stack([teng.external_drive(gen, n, tcfg)
                          for _ in range(48)]))
    sc, se = (teng.init_sim_state(tcfg, device=cuda) for _ in range(2))
    _build.reset_launch_counts()
    sc, raster = teng.simulate(sc, tabs, tcfg, 29, record_spikes=True,
                               drive=None if drawn else drive[:29],
                               device=cuda)
    sc, counts = teng.simulate(sc, tabs, tcfg, 19,
                               drive=None if drawn else drive[29:],
                               device=cuda)
    assert _build.launch_counts() == {"neuron_step": 48,
                                      "event_delivery": 48, "step_graph": 3}
    se, rows = _run_steps(se, tabs, tcfg, 48, drive)
    torch.cuda.synchronize()
    assert float(rows.sum()) > 0
    assert torch.equal(raster, rows[:29])
    assert torch.equal(counts, rows[29:].sum(1))
    assert sc["t"] == se["t"] == 48
    for k in ("v", "c", "refrac"):
        assert torch.equal(sc["neuron"][k], se["neuron"][k])
    assert torch.equal(sc["i_ring"], se["i_ring"])
    for k in ("spikes", "events", "dropped"):
        assert torch.equal(sc["metrics"][k], se["metrics"][k])
    assert torch.equal(teng.external_drive(sc["rng"], n, tcfg),
                       teng.external_drive(se["rng"], n, tcfg))


def test_captured_run_leaves_the_callers_state(cuda):
    """The captured loop works on copies of the neuron state and the
    metrics: the caller's tensors keep their values."""
    _, tcfg = configs("gaussian", grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    state = teng.init_sim_state(tcfg, device=cuda)
    before = {k: x.clone() for k, x in state["neuron"].items()}
    fin, _ = teng.simulate(state, tabs, tcfg, 24, device=cuda)
    for k, x in before.items():
        assert torch.equal(state["neuron"][k], x)
        assert not torch.equal(fin["neuron"][k], x) or k == "refrac"
    assert float(state["metrics"]["spikes"]) == 0.0
    assert float(fin["metrics"]["spikes"]) > 0


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_captured_run_follows_edited_weights(cuda, law):
    """Weights edited in place and replaced between captured runs:
    each run delivers the weights it is handed (its descriptors rebound,
    its graph captured anew), as the plain path does."""
    _, tcfg = configs(law, grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    plain = dataclasses.replace(tcfg, use_kernels=False)
    n = tcfg.spec().n_local
    gen = torch.Generator(device=cuda).manual_seed(8)
    drive = torch.stack([teng.external_drive(gen, n, tcfg)
                         for _ in range(24)])

    def both(tables):
        _build.reset_launch_counts()
        fk, rk = teng.simulate(teng.init_sim_state(tcfg, device=cuda),
                               tables, tcfg, 24, record_spikes=True,
                               drive=drive, device=cuda)
        assert _build.launch_counts()["step_graph"] == 2
        fp, rp = teng.simulate(teng.init_sim_state(plain, device=cuda),
                               tables, plain, 24, record_spikes=True,
                               drive=drive, device=cuda)
        torch.cuda.synchronize()
        assert torch.equal(rk, rp)
        assert torch.equal(fk["i_ring"].view(torch.int32),
                           fp["i_ring"].view(torch.int32))
        return fk["i_ring"].clone()

    base = both(tabs)
    tabs.local["w"].mul_(0.5)           # in place: exact in bf16
    halved = both(tabs)
    replaced = both(with_local_tier(
        tabs, dict(tabs.local, w=tabs.local["w"] * 4)))
    assert not torch.equal(base, halved)
    assert not torch.equal(halved, replaced)


def test_recorded_run_is_captured(cuda):
    """A recorded run replays the captured graph (the recorder's appends
    inside it) and equals the eager steps bit for bit: raster, state and
    recorder buffers; its raster is the unrecorded run's."""
    from repro_torch.obs.record import (init_recorder_state, record_step,
                                        recorder_spec, tile_gid_map)
    _, tcfg = configs("exponential", grid=4, n_per_col=1240)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    rspec = recorder_spec(tcfg, 40)
    _build.reset_launch_counts()
    fin, raster, rec = teng.simulate(
        teng.init_sim_state(tcfg, device=cuda), tabs, tcfg, 40,
        record_spikes=True, recorder=rspec, device=cuda)
    assert _build.launch_counts() == {"neuron_step": 40,
                                      "event_delivery": 40,
                                      "spike_compact": 40, "step_graph": 4}
    _, captured = teng.simulate(teng.init_sim_state(tcfg, device=cuda),
                                tabs, tcfg, 40, record_spikes=True,
                                device=cuda)
    assert torch.equal(raster, captured)
    assert int(rec["count"]) == int(raster.sum()) > 0
    # the eager steps, recorded into a fresh recorder with host steps
    gids = torch.from_numpy(tile_gid_map(tcfg.decomp, 0, 0)).to(cuda)
    eager_rec = init_recorder_state(rspec, device=cuda)
    st, rows = teng.init_sim_state(tcfg, device=cuda), []
    for k in range(40):
        st, spk = teng.step(st, tabs, tcfg)
        record_step(eager_rec, spk, gids, k, rspec)
        rows.append(spk)
    assert torch.equal(torch.stack(rows), raster)
    for k in ("v", "c", "refrac"):
        assert torch.equal(st["neuron"][k], fin["neuron"][k])
    assert torch.equal(st["i_ring"], fin["i_ring"])
    for k in rec:
        assert torch.equal(rec[k], eager_rec[k]), k


def test_compaction_graph_replayed_over_new_spikes(cuda):
    """One captured compaction, replayed twice over different spike
    vectors (and after eager calls between): every replay tags its
    status words with a fresh device epoch, so its look-back never takes
    a word of the previous replay, and each result is the plain
    version's bit for bit."""
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    g = torch.Generator(device=cuda).manual_seed(11)
    n, cap = 79_360, 30_000
    buf = torch.zeros(n, device=cuda)
    spike_compact_cuda(buf, n, cap)          # sizes the status scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        idx, cnt = spike_compact_cuda(buf, n, cap)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for dens in (0.3, 0.05, 0.6):
        buf.copy_((torch.rand(n, device=cuda, generator=g) < dens).float())
        graph.replay()
        want = ref.spike_compact_ref(buf, n, cap)
        assert torch.equal(idx, want[0]) and int(cnt) == int(want[1])
        e_idx, e_cnt = spike_compact_cuda(buf, n, cap)
        assert torch.equal(e_idx, idx) and int(e_cnt) == int(cnt)


def test_compaction_epoch_wraps_on_the_device(cuda):
    """At the last epoch the call's last block clears the tile words and
    restarts at epoch 1: the calls around the wrap stay exact."""
    from repro_torch.kernels import spike_compact as sc
    g = torch.Generator(device=cuda).manual_seed(12)
    n, cap = 200_000, 150_000
    spk = (torch.rand(n, device=cuda, generator=g) < 0.4).float()
    want = ref.spike_compact_ref(spk, n, cap)
    sc.spike_compact_cuda(spk, n, cap)
    scratch = sc._SCRATCH[spk.device if spk.device.index is not None
                          else torch.device("cuda", 0)]
    status = scratch.get(0)
    status[0] = sc.EPOCHS - 2
    for _ in range(4):
        idx, cnt = sc.spike_compact_cuda(spk, n, cap)
        assert torch.equal(idx, want[0]) and int(cnt) == int(want[1])
    assert int(status[0]) == 3 and int(status[1]) == 0


def _plastic_cfg(law, n_per_col=100, **kw):
    from repro_torch.core.stdp import STDPParams
    _, tcfg = configs(law, grid=4, n_per_col=n_per_col, **kw)
    return dataclasses.replace(tcfg, stdp=STDPParams())


@pytest.mark.parametrize("dens", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_plastic_kernel_matches_cpu_plain(cuda, law, dens):
    """Fixed-order delivery + LTD on the card against the plain version
    run on CPU copies of the same inputs: ring and weights exact."""
    from repro_torch.kernels.plastic_step import plastic_delivery_ltd
    tcfg = _plastic_cfg(law)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    aux = teng.init_plasticity(tabs, tcfg)
    spec = tcfg.spec()
    rng = np.random.default_rng(3)
    local = dict(tabs.local)
    m = aux["masks"][0] > 0
    w = local["w"].clone()
    w[m] = torch.tensor(rng.uniform(0, 0.6, int(m.sum())),
                        dtype=torch.float32)
    local["w"] = w
    spk = torch.tensor(rng.random(spec.n_local) < dens, dtype=torch.float32)
    x_post = torch.tensor(rng.uniform(0, 3, spec.n_local),
                          dtype=torch.float32)
    ring = torch.tensor(rng.normal(0, 4, (8, spec.n_local)),
                        dtype=torch.float32)

    def run(dev):
        tier = {k: v.clone().to(dev) for k, v in local.items()}
        inv = dict(aux["inv"], slots=aux["inv"]["slots"].to(dev),
                   n_in=aux["inv"]["n_in"].to(dev),
                   tm=aux["inv"]["tm"].to(dev))
        r, new_w, ev, dr = plastic_delivery_ltd(
            [(tier, spk.to(dev), spec.active_cap_local)],
            [aux["masks"][0].to(dev)], x_post.to(dev), ring.clone().to(dev),
            4, 8, -tcfg.stdp.a_minus, inv=inv)
        return r.cpu(), new_w[0].cpu(), int(ev), int(dr)

    rk, wk, ek, dk = run(cuda)
    rp, wp, ep, dp = run("cpu")
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert torch.equal(wk.view(torch.int32), wp.view(torch.int32))
    assert (ek, dk) == (ep, dp)


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_plastic_kernel_follows_the_masks_passed(cuda, law):
    """Masks other than those the index's plastic bits were built from
    -- half the plastic synapses made static, then edited again in
    place -- give the card the CPU plain path's weights and ring: the
    kernel's plastic bits follow the masks passed."""
    from repro_torch.kernels.plastic_step import plastic_delivery_ltd
    tcfg = _plastic_cfg(law)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    aux = teng.init_plasticity(tabs, tcfg)
    spec = tcfg.spec()
    rng = np.random.default_rng(5)
    spk = torch.tensor(rng.random(spec.n_local) < 0.5, dtype=torch.float32)
    x_post = torch.tensor(rng.uniform(0, 3, spec.n_local),
                          dtype=torch.float32)
    ring = torch.tensor(rng.normal(0, 4, (8, spec.n_local)),
                        dtype=torch.float32)
    mask = aux["masks"][0] * torch.tensor(
        rng.random(tuple(aux["masks"][0].shape)) < 0.5, dtype=torch.float32)
    inv_d = dict(aux["inv"], **{k: aux["inv"][k].to(cuda)
                                for k in ("slots", "n_in", "tm")})
    mask_d = mask.to(cuda)

    def run(dev, inv, m):
        tier = {k: v.clone().to(dev) for k, v in tabs.local.items()}
        r, new_w, ev, dr = plastic_delivery_ltd(
            [(tier, spk.to(dev), spec.active_cap_local)], [m],
            x_post.to(dev), ring.clone().to(dev), 3, 8, -tcfg.stdp.a_minus,
            inv=inv)
        return r.cpu(), new_w[0].cpu(), int(ev), int(dr)

    for edit in range(2):
        rk, wk, ek, dk = run(cuda, inv_d, mask_d)
        rp, wp, ep, dp = run("cpu", aux["inv"], mask)
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
        assert torch.equal(wk.view(torch.int32), wp.view(torch.int32))
        assert (ek, dk) == (ep, dp)
        assert int((wk != tabs.local["w"]).sum()) > 0
        # an in-place edit: every synapse of the first 20 rows static
        mask[:20] = 0.0
        mask_d[:20] = 0.0


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_fixed_order_delivery_without_ltd_matches_cpu_plain(cuda, law):
    """The fixed-order kernel with ``mask=None`` (static float32 tables):
    ring and counts equal to the plain version on CPU copies, weights
    untouched."""
    from repro_torch.kernels.plastic_step import plastic_delivery_ltd
    _, tcfg = configs(law, grid=4, n_per_col=100, weight_dtype="float32")
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    inv = tabs.inverse_index()
    spec = tcfg.spec()
    rng = np.random.default_rng(8)
    spk = torch.tensor(rng.random(spec.n_local) < 0.6, dtype=torch.float32)
    ring = torch.tensor(rng.normal(0, 4, (8, spec.n_local)),
                        dtype=torch.float32)
    cap = int(spk.sum()) - 50   # drops

    def run(dev):
        tier = {k: v.clone().to(dev) for k, v in tabs.local.items()}
        inv_d = dict(inv, **{k: inv[k].to(dev) for k in ("slots", "n_in",
                                                         "tm")})
        r, new_w, ev, dr = plastic_delivery_ltd(
            [(tier, spk.to(dev), cap)], None, None, ring.clone().to(dev), 6,
            8, 0.0, inv=inv_d)
        assert new_w is None
        return r.cpu(), tier["w"].cpu(), int(ev), int(dr)

    rk, wk, ek, dk = run(cuda)
    rp, wp, ep, dp = run("cpu")
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert torch.equal(wk, tabs.local["w"]) and torch.equal(wp, wk)
    assert (ek, dk) == (ep, dp) and dk == 50


@pytest.mark.parametrize("dens", [0.0, 0.01, 0.5, 1.0])
def test_spike_compact_kernel_matches_plain(cuda, dens):
    from repro_torch.kernels.ref import compact_events
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    g = torch.Generator(device=cuda).manual_seed(5)
    n = 79_360
    spk = (torch.rand(n + 1, device=cuda, generator=g) < dens).float()
    for cap in (1, 700, 6_400, n):
        idx, cnt = spike_compact_cuda(spk, n, cap)
        ridx, rcnt = compact_events(spk, n, cap)
        assert torch.equal(idx, ridx) and int(cnt) == int(rcnt)


@pytest.mark.parametrize("n", [79_360, 714_240])
@pytest.mark.parametrize("dens", [0.0, 0.01, 0.5, 1.0])
def test_spike_compact_kernel_one_launch_bit_equal(cuda, dens, n):
    """The multi-block kernel at the recorder's width and at one shard of
    the paper's smallest grid (24x24x1240): one launch per call, idx and
    count bit-equal to the plain version with cap above and below the
    count."""
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    g = torch.Generator(device=cuda).manual_seed(n + int(dens * 100))
    spk = (torch.rand(n, device=cuda, generator=g) < dens).float()
    count = int(spk.sum())
    for cap in (0, max(count // 2, 1), count, count + 1000, n + 1):
        _build.reset_launch_counts()
        idx, cnt = spike_compact_cuda(spk, n, cap)
        assert _build.launch_counts() == {"spike_compact": 1}
        ridx, rcnt = ref.spike_compact_ref(spk, n, cap)
        assert idx.dtype == cnt.dtype == torch.int32
        assert torch.equal(idx, ridx) and int(cnt) == int(rcnt) == count


def test_spike_compact_epoch_reuse(cuda):
    """The status scratch is reused across calls with a new epoch each:
    three calls in a row, then a call at another n, then the first input
    again, give identical results."""
    from repro_torch.kernels.spike_compact import spike_compact_cuda
    g = torch.Generator(device=cuda).manual_seed(9)
    a = (torch.rand(79_360, device=cuda, generator=g) < 0.2).float()
    b = (torch.rand(714_240, device=cuda, generator=g) < 0.7).float()
    want = ref.spike_compact_ref(a, 79_360, 20_000)
    runs = [spike_compact_cuda(a, 79_360, 20_000) for _ in range(3)]
    ib, cb = spike_compact_cuda(b, 714_240, 600_000)
    runs.append(spike_compact_cuda(a, 79_360, 20_000))
    rb = ref.spike_compact_ref(b, 714_240, 600_000)
    torch.cuda.synchronize()
    for idx, cnt in runs:
        assert torch.equal(idx, want[0]) and int(cnt) == int(want[1])
    assert torch.equal(ib, rb[0]) and int(cb) == int(rb[1])
    # unaligned and short: a view one float in, n not a multiple of 4
    c = torch.ones(5_003, device=cuda)[1:]
    idx, cnt = spike_compact_cuda(c, 5_001, 4_000)
    assert torch.equal(idx, ref.spike_compact_ref(c, 5_001, 4_000)[0])
    assert int(cnt) == 5_001


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_static_float32_run_is_fixed_order(cuda, law):
    """A static float32 run at 4x4x100 on the card goes through the
    fixed-order kernel, not the atomic one: the same ring and raster
    twice, and the same as the plain path on the CPU."""
    _, tcfg = configs(law, grid=4, n_per_col=100, weight_dtype="float32")
    cpu_tabs = teng.build_shard_tables(tcfg, device="cpu")
    tabs = cpu_tabs.to(cuda)
    n = tcfg.spec().n_local
    gen = torch.Generator().manual_seed(11)
    drive = torch.stack([teng.external_drive(gen, n, tcfg)
                         for _ in range(60)])
    runs = []
    for _ in range(2):
        _build.reset_launch_counts()
        fin, raster = teng.simulate(teng.init_sim_state(tcfg, device=cuda),
                                    tabs, tcfg, 60, record_spikes=True,
                                    drive=drive.to(cuda), device=cuda)
        counts = _build.launch_counts()
        assert counts.get("plastic_delivery_ltd") == 60
        assert counts.get("step_graph") == 6
        assert "event_delivery" not in counts
        runs.append((fin["i_ring"].cpu(), raster.cpu()))
    plain = dataclasses.replace(tcfg, use_kernels=False)
    fin_p, raster_p = teng.simulate(teng.init_sim_state(plain, device="cpu"),
                                    cpu_tabs, plain, 60, record_spikes=True,
                                    drive=drive, device="cpu")
    for ring, raster in runs:
        assert float(raster.sum()) > 0
        assert torch.equal(raster, raster_p)
        assert torch.equal(ring.view(torch.int32),
                           fin_p["i_ring"].view(torch.int32))


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_plastic_run_matches_cpu_plain_path(cuda, law):
    tcfg = _plastic_cfg(law)
    cpu_tabs = teng.build_shard_tables(tcfg, device="cpu")
    n = tcfg.spec().n_local
    gen = torch.Generator().manual_seed(2)
    drive = torch.stack([teng.external_drive(gen, n, tcfg)
                         for _ in range(40)])
    tabs = cpu_tabs.to(cuda)
    _build.reset_launch_counts()
    (sk, tk, rk), pk = teng.simulate(
        teng.init_sim_state(tcfg, device=cuda), tabs, tcfg, 40,
        drive=drive.to(cuda), device=cuda,
        plasticity=teng.init_plasticity(tabs, tcfg))
    assert _build.launch_counts() == {"neuron_step": 40,
                                      "plastic_delivery_ltd": 40}
    plain = dataclasses.replace(tcfg, use_kernels=False)
    (sp, tp, rp), pp = teng.simulate(
        teng.init_sim_state(plain, device="cpu"), cpu_tabs, plain, 40,
        drive=drive, device="cpu",
        plasticity=teng.init_plasticity(cpu_tabs, plain))
    assert torch.equal(pk.cpu(), pp)
    for a, b in ((tk["local"]["w"], tp["local"]["w"]),
                 (sk["i_ring"], sp["i_ring"]), (rk["x_post"], rp["x_post"]),
                 (rk["x_pre"][0], rp["x_pre"][0])):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# flash attention and the LM serving path
# ---------------------------------------------------------------------------

# the shapes of the reference's kernel test (tests/test_kernels.py), plus
# a fully masked case and a head_dim-256 window
FLASH_CASES = [
    (4, 2, 64, 64, 32, True, None, 0),
    (8, 2, 100, 100, 64, True, 48, 0),
    (2, 2, 37, 129, 16, False, None, 0),
    (2, 1, 1, 77, 32, True, None, 76),
    (3, 3, 48, 16, 8, True, None, 0),
    (6, 2, 200, 200, 128, True, None, 0),
    (2, 1, 130, 130, 256, True, 40, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win,qoff", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, bh, bhkv, sq, sk, d, causal, win,
                                    qoff, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
               for s in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    got = flash_attention_cuda(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_fully_masked_rows_are_zero(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn(2, 8, 8, device=cuda)
    out = flash_attention_cuda(q, q, q, causal=False, window=2,
                               q_offset=100)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_flash_wrapper_counts_launches_and_refuses(cuda):
    """Launches are counted per route: float32 at head_dim 64 and 32
    takes the 3xTF32 kernel (and its pre-pass), bf16 at head_dim 64 and
    32 the bf16 tensor-core one, never the CUDA-core kernel; head_dim 0
    and 512 raise."""
    from repro_torch.kernels import ops
    q = torch.randn(4, 32, 64, device=cuda)
    k = torch.randn(2, 32, 64, device=cuda)
    _build.reset_launch_counts()
    ops.attention(q, k, k)
    ops.attention(q, k, k, causal=False)
    assert _build.launch_counts() == {"flash_attention_tf32": 2,
                                      "tf32_split": 2}
    ops.attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    ops.attention(q[..., :32].bfloat16().contiguous(),
                  k[..., :32].bfloat16().contiguous(),
                  k[..., :32].bfloat16().contiguous())
    ops.attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                  k[..., :32].contiguous())
    want = {"flash_attention_tf32": 3, "tf32_split": 3,
            "flash_attention": 2}
    assert _build.launch_counts() == want
    for bad in (torch.randn(2, 8, 0, device=cuda),
                torch.randn(2, 8, 512, device=cuda)):
        with pytest.raises(ValueError, match="head_dim"):
            ops.attention(bad, bad, bad)
    with pytest.raises(ValueError, match="device"):
        ops.attention(q, k.cpu(), k)
    assert _build.launch_counts() == want


# the tensor-core kernel's cases (bf16, head_dim 64/128/256): Sq = 1,
# Sq and Sk off the 64/128 tiles, Sk below one tile, q_offset > 0, windows,
# GQA groups 1, 6 and 8, non-causal at D 64 over 1500 keys (whisper's
# encoder and cross-attention: 1500 = 11 x 128 + 92)
SM90_CASES = [
    (4, 2, 64, 64, 64, True, None, 0),
    (8, 2, 100, 100, 64, True, 48, 0),
    (3, 3, 48, 16, 64, True, None, 0),
    (2, 2, 37, 129, 128, False, None, 0),
    (2, 1, 1, 77, 128, True, None, 76),
    (12, 2, 1, 300, 128, False, None, 0),
    (6, 1, 200, 200, 128, True, None, 0),
    (4, 4, 129, 1000, 128, True, None, 871),
    (2, 1, 513, 513, 64, True, 200, 0),
    (8, 1, 130, 300, 256, True, 40, 0),
    (2, 2, 300, 257, 256, False, None, 0),
    (8, 1, 1, 40, 256, True, None, 39),
    (24, 24, 1500, 1500, 64, False, None, 0),
    (24, 24, 224, 1500, 64, False, None, 0),
]


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win,qoff", SM90_CASES)
def test_flash_sm90_kernel_matches_plain(cuda, bh, bhkv, sq, sk, d, causal,
                                         win, qoff):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + sk + d)
    q, k, v = (torch.randn(s, device=cuda, generator=g).bfloat16()
               for s in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    _build.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"flash_attention": 1}
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_sm90_fully_masked_rows_are_zero(cuda, d):
    """Rows that see no key are exactly 0: the whole CTA masked (window
    2 far behind), and rows masked while others of the CTA are live."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(2, 8, d, device=cuda, generator=g).bfloat16()
    out = flash_attention_cuda(q, q, q, causal=False, window=2,
                               q_offset=100)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    # keys 0..63, queries at 0..199 with window 100: rows 163+ see none
    q = torch.randn(2, 200, d, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, 64, d, device=cuda, generator=g).bfloat16()
    out = flash_attention_cuda(q, k, k, causal=True, window=100)
    want = ref.attention_ref(q, k, k, causal=True, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 163:], torch.zeros_like(out[:, 163:]))
    assert float(out[:, :163].float().abs().amax()) > 0
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# the narrow heads' kernel instances (D 16 and 32, bf16 on the sm90
# route, float32 on the TF32 one): Sq = 1, ragged Sq/Sk,
# Sk below one key tile, q_offset, windows, GQA groups 1, 6 and 8, and
# rows that see no key (window 5 at q_offset 18: rows 6+)
NARROW_CASES = [
    (2, 1, 1, 77, 32, True, None, 76),
    (12, 2, 1, 300, 16, False, None, 0),
    (3, 3, 48, 16, 32, True, None, 0),
    (2, 2, 37, 129, 16, False, None, 0),
    (6, 1, 200, 200, 32, True, None, 0),
    (4, 4, 129, 1000, 16, True, None, 871),
    (2, 1, 513, 513, 32, True, 200, 0),
    (8, 1, 130, 300, 16, True, 40, 0),
    (4, 4, 12, 20, 32, True, 5, 18),
    (48, 8, 300, 300, 32, True, None, 0),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win,qoff", NARROW_CASES)
def test_flash_narrow_kernel_matches_plain(cuda, bh, bhkv, sq, sk, d,
                                           causal, win, qoff, dtype):
    """One launch of the route's tensor-core kernel (and, in float32, of
    its pre-pass), no CUDA-core launch; output within 2e-2 (bf16) or
    2e-4 (float32) of the plain version, the row statistic within 2e-3 /
    1e-5 of |L| + 1, +1e30 exactly on rows that see no key."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(sq * 11 + sk + d)
    q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
               for s in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    route = fa._route(dtype, d)
    _build.reset_launch_counts()
    got, got_l = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want, want_l = ref.attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    names = {fa.ROUTE_KERNELS[route]: 1}
    if route == "tf32":
        names[fa.SPLIT_KERNEL] = 1
    assert _build.launch_counts() == names
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    ltol = 1e-5 if dtype == torch.float32 else 2e-3
    dead = want_l == 1e30
    assert torch.equal(got_l == 1e30, dead)
    assert bool(((got_l - want_l).abs()[~dead]
                 <= ltol * (1 + want_l[~dead].abs())).all())
    if qoff == 18:
        assert bool(dead.any())


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 16),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 16),
                                     (torch.float32, 32),
                                     (torch.float32, 8)])
def test_flash_narrow_fully_masked_rows_are_zero(cuda, dtype, d):
    """At the narrow widths, rows that see no key are exactly 0: the
    whole CTA masked (window 2 far behind), and rows masked while others
    of the CTA are live."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(2, 8, d, device=cuda, generator=g).to(dtype)
    out = flash_attention_cuda(q, q, q, causal=False, window=2,
                               q_offset=100)
    q = torch.randn(2, 200, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 64, d, device=cuda, generator=g).to(dtype)
    out2 = flash_attention_cuda(q, k, k, causal=True, window=100)
    want = ref.attention_ref(q, k, k, causal=True, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(out2[:, 163:], torch.zeros_like(out2[:, 163:]))
    assert float(out2[:, :163].float().abs().amax()) > 0
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out2.float(), want.float(), rtol=tol,
                               atol=tol)


# head widths no kernel is built for, padded to the route's next width:
# reduced qwen2.5-3b's 12 (-> 16 in bf16, 32 in float32) and kimi-k2's
# 112 (-> 128); (bh, bh_kv, sq, sk, causal, window, q_offset)
PAD_CASES = [(6, 2, 200, 200, True, None, 0), (4, 1, 129, 300, True, 40, 171),
             (2, 2, 37, 77, False, None, 0)]


@pytest.mark.parametrize("case", PAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 112])
def test_flash_padded_head_matches_plain(cuda, d, dtype, case):
    """One launch of the route's kernel on the padded inputs; output and
    row statistic against the plain version on the unpadded ones."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    bh, bhkv, sq, sk, causal, win, qoff = case
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
               for s in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    route = fa._route(dtype, d)
    _build.reset_launch_counts()
    got, got_l = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want, want_l = ref.attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    names = {fa.ROUTE_KERNELS[route]: 1}
    if route == "tf32":
        names[fa.SPLIT_KERNEL] = 1
    assert _build.launch_counts() == names
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    ltol = 1e-5 if dtype == torch.float32 else 2e-3
    dead = want_l == 1e30
    assert torch.equal(got_l == 1e30, dead)
    assert bool(((got_l - want_l).abs()[~dead]
                 <= ltol * (1 + want_l[~dead].abs())).all())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "qwen2.5-3b"])
def test_new_families_kernel_path_matches_plain(cuda, arch):
    """Reduced configs in float32: the kernel path's prefill and a decode
    step against the plain path's on the card, one launch of the 3xTF32
    flash kernel and one of its pre-pass per attention layer in the
    prefill (none for mamba) and none in decode; the padded heads
    (kimi-k2's 8, qwen2.5-3b's 12, padded to 16) included."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as tm
    from repro_torch.models import transformer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_reduced(arch)
    params = tt.init_model(base, seed=0, device=cuda)
    tok = torch.randint(0, base.vocab_size, (2, 40), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    n_attn = sum(k in ("attn", "moe") for k in base.layer_kinds)
    out = {}
    for impl in ("pallas", "naive"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        state = tt.init_decode_state(cfg, 2, 42, device=cuda)
        _build.reset_launch_counts()
        lg, state = tm.make_prefill(cfg)(params, {"tokens": tok[:, :39]},
                                         state)
        counts = _build.launch_counts()
        n_prefill = counts.get("flash_attention_tf32", 0)
        assert counts == ({"flash_attention_tf32": n_prefill,
                           "tf32_split": n_prefill} if n_prefill else {})
        lg2, state = tm.make_serve_step(cfg)(params, state, tok[:, 39:], 39)
        out[impl] = (lg, lg2, n_prefill, _build.launch_counts().get(
            "flash_attention_tf32", 0) - n_prefill)
    assert out["pallas"][2:] == (n_attn, 0)
    assert out["naive"][2:] == (0, 0)
    for a, b in zip(out["pallas"][:2], out["naive"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,n_flash", [("whisper-small", 2 + 3 + 3),
                                          ("internvl2-26b", 3)])
def test_encdec_families_kernel_path_matches_plain(cuda, arch, n_flash):
    """Reduced whisper (head_dim 12) and internvl (8) in float32 on the
    3xTF32 kernel (heads padded to 16): the kernel path's prefill and a
    decode step against the plain path's, with one launch (and one of
    its pre-pass) per encoder layer, self-attention layer and
    cross-attention in the prefill (whisper 2 + 3 + 3, internvl 3) and
    none in decode; internvl's patches prefix the prompt, so it decodes
    at n_patches + 39."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as tm
    from repro_torch.models import transformer as tt
    from repro_torch.models.frontends import STUB_WIDTH
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_reduced(arch)
    params = tt.init_model(base, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    tok = torch.randint(0, base.vocab_size, (2, 40), device=cuda,
                        generator=g)
    batch = {"tokens": tok[:, :39]}
    for key, n in (("frames", base.encoder_seq),
                   ("patch_embeds", base.n_patches)):
        if n:
            batch[key] = torch.randn((2, n, STUB_WIDTH), device=cuda,
                                     generator=g)
    start = base.n_patches + 39
    out = {}
    for impl in ("pallas", "naive"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        state = tt.init_decode_state(cfg, 2, start + 2, device=cuda)
        _build.reset_launch_counts()
        lg, state = tm.make_prefill(cfg)(params, batch, state)
        counts = _build.launch_counts()
        lg2, state = tm.make_serve_step(cfg)(params, state, tok[:, 39:],
                                             start)
        out[impl] = (lg, lg2, counts, _build.launch_counts())
    assert out["pallas"][2] == out["pallas"][3] == {
        "flash_attention_tf32": n_flash, "tf32_split": n_flash}
    assert out["naive"][2:] == ({}, {})
    for a, b in zip(out["pallas"][:2], out["naive"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_lm_prefill_goes_through_the_kernel(cuda):
    """Reduced qwen2 in float32: the kernel path's prefill and decode
    logits agree with the plain path's, with one kernel launch per layer
    in the prefill and none in decode."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as tm
    from repro_torch.models import transformer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_reduced("qwen2-1.5b")
    params = tt.init_model(base, seed=0, device=cuda)
    tok = torch.randint(0, base.vocab_size, (2, 70), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    out = {}
    for impl in ("pallas", "naive"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        state = tt.init_decode_state(cfg, 2, 72, device=cuda)
        _build.reset_launch_counts()
        lg, state = tm.make_prefill(cfg)(params, {"tokens": tok[:, :69]},
                                         state)
        # float32 takes the 3xTF32 kernel (its narrow head padded)
        n_prefill = _build.launch_counts().get("flash_attention_tf32", 0)
        lg2, state = tm.make_serve_step(cfg)(params, state, tok[:, 69:], 69)
        n_decode = _build.launch_counts().get("flash_attention_tf32", 0) \
            - n_prefill
        assert "flash_attention" not in _build.launch_counts()
        out[impl] = (lg, lg2, n_prefill, n_decode)
    assert out["pallas"][2:] == (base.n_layers, 0)
    assert out["naive"][2:] == (0, 0)
    for a, b in zip(out["pallas"][:2], out["naive"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_serve_batch_on_card(cuda):
    from repro_torch.launch.serve import serve_batch
    out = serve_batch("gemma-2b", batch=2, prompt_len=16, gen=4, seed=1,
                      device=cuda)
    again = serve_batch("gemma-2b", batch=2, prompt_len=16, gen=4, seed=1,
                        device=cuda)
    assert out["tokens"].shape == (2, 4) and out["prefill_s"] > 0
    np.testing.assert_array_equal(out["tokens"], again["tokens"])


# ---------------------------------------------------------------------------
# the 3xTF32 route (float32, head_dim 64/128/256)
# ---------------------------------------------------------------------------

def test_tf32_fragment_layout_is_what_the_kernel_assumes(cuda):
    """The probe's tf32 A fragment (a wgmma against the identity) puts
    each P value where the kernel's key order and register map say."""
    from repro_torch.kernels.flash_attention import (tf32_fragment_errors,
                                                     tf32_fragment_layout)
    layout = tf32_fragment_layout(cuda)
    torch.cuda.synchronize()
    assert sorted(layout.view(-1).tolist()) == list(range(512))
    assert tf32_fragment_errors(layout.cpu()) == 0


@pytest.mark.parametrize("sk,d", [(1, 64), (77, 64), (300, 128),
                                  (2048, 128), (130, 256), (77, 32),
                                  (2048, 32), (77, 16)])
def test_tf32_split_kernel_bit_exact(cuda, sk, d):
    from repro_torch.kernels.flash_attention import tf32_split_cuda
    g = torch.Generator(device=cuda).manual_seed(sk + d)
    k, v = (torch.randn((3, sk, d), device=cuda, generator=g) * 10
            for _ in range(2))
    _build.reset_launch_counts()
    got = tf32_split_cuda(k, v)
    want = ref.tf32_split_ref(k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"tf32_split": 1}
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win,qoff", SM90_CASES)
def test_flash_tf32_kernel_matches_plain(cuda, bh, bhkv, sq, sk, d, causal,
                                         win, qoff):
    """The 3xTF32 kernel at the bf16 kernel's edge cases, in float32,
    within the float32 tolerance of the plain version (f32 products, TF32
    off): one launch of it and one of its pre-pass each."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(sq * 5 + sk + d)
    q, k, v = (torch.randn(s, device=cuda, generator=g)
               for s in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    _build.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"flash_attention_tf32": 1,
                                      "tf32_split": 1}
    assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_tf32_fully_masked_rows_are_zero(cuda, d):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(2, 8, d, device=cuda, generator=g)
    out = flash_attention_cuda(q, q, q, causal=False, window=2,
                               q_offset=100)
    q = torch.randn(2, 200, d, device=cuda, generator=g)
    k = torch.randn(2, 64, d, device=cuda, generator=g)
    out2 = flash_attention_cuda(q, k, k, causal=True, window=100)
    want = ref.attention_ref(q, k, k, causal=True, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(out2[:, 163:], torch.zeros_like(out2[:, 163:]))
    torch.testing.assert_close(out2, want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# dict-form tables and weight binding on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_dict_form_delivery_on_the_card(cuda, law):
    """bf16 tables in dict form deliver through the column kernel exactly
    as the ``SynapseTables`` do, with the same run descriptors (found on
    the tier tensors, not rebuilt); every tier of a 2x2 tiling."""
    from repro_torch.core import synapses as tsyn
    _, tcfg = configs(law, grid=4, n_per_col=100, tiles=2)
    spec = tcfg.spec()
    tabs = teng.build_shard_tables(tcfg, 1, 0, compress=False, device=cuda)
    as_dict = {"local": tabs.local, "halo": list(tabs.halo)}
    plan = spec.delivery_plan()
    g = torch.Generator(device=cuda).manual_seed(11)
    spk = (torch.rand(spec.n_local, device=cuda, generator=g) < 0.1).float()
    bands = [(torch.rand(p.rows, device=cuda, generator=g) < 0.1).float()
             for p in plan[1:]]
    ring = torch.zeros((8, spec.n_local), device=cuda)
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)
    builds = tsyn.BUILD_COUNTS["column_runs"]
    out = []
    for t in (tabs, as_dict, tabs):
        _build.reset_launch_counts()
        out.append(teng.deliver_event_tiers(t, spk, bands, spec,
                                            ring.clone(), 3, 8, True))
        assert _build.launch_counts() == {"event_delivery": len(plan)}
    plain = teng.deliver_event_tiers(as_dict, spk, bands, spec,
                                     ring.clone(), 3, 8, False)
    torch.cuda.synchronize()
    assert tsyn.BUILD_COUNTS["column_runs"] == builds
    assert tsyn.column_runs(tsyn.tier_list(as_dict), spec.n_per_col,
                            spec.n_exc_per_col, 8) is runs
    for r, ev, dr in out:
        assert torch.equal(r.view(torch.int32), plain[0].view(torch.int32))
        assert float(ev) == float(plain[1]) > 0
        assert float(dr) == float(plain[2])


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_column_delivery_follows_new_weights(cuda, law):
    """A tier handed with replaced (``dict(tier, w=2 w)``) or in-place
    edited weights delivers them, as the plain version does, through the
    same descriptor; weights past the window limit raise."""
    _, tcfg = configs(law, grid=4, n_per_col=100)
    spec = tcfg.spec()
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    cap = spec.active_cap_local
    g = torch.Generator(device=cuda).manual_seed(5)
    spk = (torch.rand(spec.n_local, device=cuda, generator=g) < 0.2).float()
    runs = tabs.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)[:1]

    def both(tier):
        ring = torch.zeros((8, spec.n_local), device=cuda)
        rk, _, _ = event_delivery_banded([(tier, spk, cap)], ring.clone(), 4,
                                         8, runs=runs)
        rp, _, _ = deliver_events(tier, spk, ring.clone(), 4, 8, cap)
        torch.cuda.synchronize()
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
        return rk

    base = both(tabs.local)
    doubled = both(dict(tabs.local, w=tabs.local["w"] * 2))
    assert torch.equal(doubled, 2 * base) and float(base.abs().sum()) > 0
    tier = dict(tabs.local, w=tabs.local["w"].clone())
    tier["w"].neg_()
    assert torch.equal(both(tier), -base)
    tier["w"][0, 0] = 2.0 ** 15
    with pytest.raises(ValueError, match="2\\^24"):
        event_delivery_banded([(tier, spk, cap)],
                              torch.zeros((8, spec.n_local), device=cuda),
                              4, 8, runs=runs)


# ---------------------------------------------------------------------------
# the multi-shard engine (2x2 tiles on one card)
# ---------------------------------------------------------------------------

def _dist_config(law, use_kernels=True, **kw):
    from repro_torch.core import dist_engine as tde
    tl = getattr(tconn, f"{law}_law")()
    return tde.DistConfig(engine=teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(4, 4, 100), 2, 2,
                                       tl.radius),
        law=tl, cap_headroom=1.0, ext_rate_hz=20.0,
        use_kernels=use_kernels, **kw))


def _dist_same(a, b):
    for k in a["neuron"]:
        assert torch.equal(a["neuron"][k], b["neuron"][k]), k
    assert torch.equal(a["i_ring"], b["i_ring"])
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
    assert (a["t"] == b["t"]).all()


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_multishard_captured_equals_eager_and_plain(cuda, law):
    """4x4x100 in 2x2 tiles: one call of 40 steps (8 eager, 4 replays of
    the captured 8-step block of all tiles), 40 one-step calls and the
    plain path, from the same seed (each tile's drive drawn on its own
    generator, inside the graph on the first): identical, tile by tile;
    no derived structure is rebuilt after the first step."""
    from repro_torch.core import dist_engine as tde
    from repro_torch.core import synapses as tsyn
    cfg = _dist_config(law)
    tables, _ = tde.build_dist_tables(cfg, device=cuda)
    inputs = tde.SimInputs(tables=tables)
    n = 40
    _build.reset_launch_counts()
    sim = tde.make_sim_fn(cfg, n, storage=tables.storage, device=cuda)
    cap, cap_per = sim(tde.init_dist_state(cfg, device=cuda), inputs)
    counts = _build.launch_counts()
    assert counts["step_graph"] == (n - 8) // 8
    assert counts["neuron_step"] == 4 * n
    assert counts["event_delivery"] == 4 * n * (1 + len(tables.halo))
    assert float(cap["metrics"]["dropped"].sum()) > 0
    builds = dict(tsyn.BUILD_COUNTS)
    one = tde.make_sim_fn(cfg, 1, storage=tables.storage, device=cuda)
    eag = tde.init_dist_state(cfg, device=cuda)
    eag_per = torch.cat([one(eag, inputs)[1] for _ in range(n)], dim=2)
    assert one.graph_loop is None
    plain = tde.DistConfig(engine=dataclasses.replace(cfg.engine,
                                                      use_kernels=False))
    pl, pl_per = tde.make_sim_fn(plain, n, storage=tables.storage,
                                 device=cuda)(
        tde.init_dist_state(plain, device=cuda), inputs)
    assert dict(tsyn.BUILD_COUNTS) == builds
    assert float(cap_per.sum()) > 0
    for st, per in ((eag, eag_per), (pl, pl_per)):
        assert torch.equal(cap_per, per)
        _dist_same(cap, st)


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_multishard_plastic_card_equals_cpu_plain(cuda, law):
    """The plastic multi-shard kernel path on the card against the plain
    path on the CPU, the card's drive injected: every tier's weights,
    the traces and the state identical."""
    from repro_torch.core import dist_engine as tde
    from repro_torch.core.stdp import STDPParams
    cfg = _dist_config(law, stdp=STDPParams())
    plain = tde.DistConfig(engine=dataclasses.replace(cfg.engine,
                                                      use_kernels=False))
    cpu_tabs, _ = tde.build_dist_tables(cfg, device="cpu")
    slots, _ = tde.build_dist_inverse_index(cfg, cpu_tabs)
    n_local, steps = cfg.engine.spec().n_local, 20
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    drive = torch.stack([teng.external_drive(gen, n_local, cfg.engine)
                         for _ in range(steps * 4)]).view(steps, 2, 2,
                                                          n_local)
    runs = []
    for c, dev, tabs, sl, drv in (
            (cfg, cuda, cpu_tabs.to(cuda), slots.to(cuda), drive),
            (plain, "cpu", cpu_tabs, slots, drive.cpu())):
        state = tde.init_dist_state(c, device=dev)
        state["plastic"] = tde.init_dist_plastic_state(c, tabs)
        sim = tde.make_sim_fn(c, steps, storage=tabs.storage, device=dev)
        runs.append(sim(state, tde.SimInputs(
            tables=tde.fold_plastic_tables(tabs), inv_slots=sl,
            drive=drv)))
    (sk, pk), (sp, pp) = runs
    assert float(pp.sum()) > 0 and torch.equal(pk.cpu(), pp)
    for k in sp["neuron"]:
        assert torch.equal(sk["neuron"][k].cpu(), sp["neuron"][k]), k
    assert torch.equal(sk["i_ring"].cpu(), sp["i_ring"])
    for k in sp["metrics"]:
        assert torch.equal(sk["metrics"][k].cpu(), sp["metrics"][k]), k
    for a, b in zip(sk["plastic"]["w"] + sk["plastic"]["x_pre"]
                    + [sk["plastic"]["x_post"]],
                    sp["plastic"]["w"] + sp["plastic"]["x_pre"]
                    + [sp["plastic"]["x_post"]]):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    assert (sp["plastic"]["w"][0] != cpu_tabs.local["w"]).any()


# ---------------------------------------------------------------------------
# segmented runs: one captured graph per sim, resume on the card
# ---------------------------------------------------------------------------

def _gen_states(state):
    return [g.get_state() for g in state["rng"]]


def test_multishard_graph_kept_across_calls(cuda):
    """A sim called again on the same state replays the graph it
    captured: 8 segments of 50 steps (each a ring phase 2 slots on from
    the last, 50 mod 8) capture once and equal one 400-step call bit
    for bit, the generators' states included; two segments equal 100
    one-step eager calls."""
    from repro_torch.core import dist_engine as tde
    cfg = _dist_config("gaussian")
    tables, _ = tde.build_dist_tables(cfg, device=cuda)
    inputs = tde.SimInputs(tables=tables)
    seg = tde.make_sim_fn(cfg, 50, storage=tables.storage, device=cuda)
    st = tde.init_dist_state(cfg, device=cuda)
    _build.reset_launch_counts()
    pers = [seg(st, inputs)[1] for _ in range(8)]
    assert seg.captures == 1 and seg.graph_loop is not None
    # 8 eager steps, then 5 + 7 * 6 replays: the first segment's block
    # starts at step 8, every later one at its own first step
    assert _build.launch_counts()["step_graph"] == 5 + 7 * 6
    straight = tde.make_sim_fn(cfg, 400, storage=tables.storage,
                               device=cuda)
    st2 = tde.init_dist_state(cfg, device=cuda)
    per2 = straight(st2, inputs)[1]
    assert float(per2.sum()) > 0
    assert torch.equal(torch.cat(pers, dim=2), per2)
    _dist_same(st, st2)
    assert all(torch.equal(a, b) for a, b in zip(_gen_states(st),
                                                  _gen_states(st2)))
    one = tde.make_sim_fn(cfg, 1, storage=tables.storage, device=cuda)
    st3 = tde.init_dist_state(cfg, device=cuda)
    eager = torch.cat([one(st3, inputs)[1] for _ in range(100)], dim=2)
    assert torch.equal(torch.cat(pers[:2], dim=2), eager)
    # a new state is a new graph: the old one does not serve it
    seg(tde.init_dist_state(cfg, device=cuda), inputs)
    assert seg.captures == 2


def test_sim_driver_resume_bit_identical_on_card(cuda, tmp_path):
    """The segmented driver on the card: 4 segments of 50 straight, and
    2 + preempt + a fresh driver's 2: one capture per driver, the same
    state and generator states, the checkpoints' async copies taken on
    the writer's own stream."""
    from repro_torch.core import dist_engine as tde
    from repro_torch.runtime import DriverConfig, SimDriver
    cfg = _dist_config("exponential")

    def driver(d, **kw):
        return SimDriver(DriverConfig(ckpt_dir=str(d), backoff_s=0.01,
                                      handle_sigterm=False), cfg, cuda,
                         segment_steps=50, **kw)

    a = driver(tmp_path / "a")
    out_a = a.run(200)
    assert a.captures() == 1
    b1 = driver(tmp_path / "b", preempt_after_segments=2)
    assert b1.run(200)["final_step"] == 100 and b1.captures() == 1
    b2 = driver(tmp_path / "b")
    out_b = b2.run(200)
    assert b2.captures() == 1 and out_b["final_step"] == 200
    _dist_same(out_a["state"], out_b["state"])
    assert all(torch.equal(x, y) for x, y in zip(
        _gen_states(out_a["state"]), _gen_states(out_b["state"])))
    assert a.metric_totals(out_a["state"]) == \
        b2.metric_totals(out_b["state"])
    assert tde.state_tree(out_b["state"])["i_ring"].device.type == "cuda"


# ---------------------------------------------------------------------------
# ensembles and the job service: captured recorded runs on the card
# ---------------------------------------------------------------------------

def _events(rec, lead: int) -> list:
    """Each instance's recorded events as ``step << 32 | gid`` (int64),
    the instances flattened over the ``lead`` leading axes."""
    steps = rec["step"].flatten(0, lead - 1).long()
    gids = rec["gid"].flatten(0, lead - 1).long()
    counts = rec["count"].reshape(-1).tolist()
    return [(s[:c] << 32) | g[:c] for s, g, c in zip(steps, gids, counts)]


def test_multishard_recorded_captured_equals_eager(cuda):
    """4x4x100 in 2x2 tiles, recorded: one 40-step call (8 eager steps,
    4 replays with the recorder's appends inside the graph) against 40
    one-step eager calls, whose events concatenate, and the plain path:
    the same per-tile events, state and counts."""
    from repro_torch.core import dist_engine as tde
    from repro_torch.obs.record import recorder_spec, stacked_gid_maps
    cfg = _dist_config("exponential")
    tables, _ = tde.build_dist_tables(cfg, device=cuda)
    gids = torch.from_numpy(stacked_gid_maps(cfg.engine.decomp)).to(cuda)
    inputs = tde.SimInputs(tables=tables, gids=gids)
    n = 40
    _build.reset_launch_counts()
    sim = tde.make_sim_fn(cfg, n, recorder=recorder_spec(cfg.engine, n),
                          storage=tables.storage, device=cuda)
    cap, cap_per, rec = sim(tde.init_dist_state(cfg, device=cuda), inputs)
    assert _build.launch_counts()["step_graph"] == (n - 8) // 8
    assert sim.captures == 1
    cap_events = _events(rec, 2)
    one = tde.make_sim_fn(cfg, 1, recorder=recorder_spec(cfg.engine, 1),
                          storage=tables.storage, device=cuda)
    eag = tde.init_dist_state(cfg, device=cuda)
    parts = []
    for _ in range(n):
        parts.append(_events(one(eag, inputs)[2], 2))
    eag_events = [torch.cat(p) for p in zip(*parts)]
    plain = tde.DistConfig(engine=dataclasses.replace(cfg.engine,
                                                      use_kernels=False))
    pl, _, pl_rec = tde.make_sim_fn(
        plain, n, recorder=recorder_spec(plain.engine, n),
        storage=tables.storage, device=cuda)(
        tde.init_dist_state(plain, device=cuda), inputs)
    # above active_cap the recorder drops, and counts it
    assert sum(int(e.numel()) for e in cap_events) + int(
        rec["dropped"].sum()) == int(cap["metrics"]["spikes"].sum()) > 0
    for other in (eag_events, _events(pl_rec, 2)):
        assert all(torch.equal(a, b) for a, b in zip(cap_events, other))
    _dist_same(cap, eag)
    _dist_same(cap, pl)


def test_ensembles_captured_equal_solo_runs(cuda):
    """Captured ensembles on the card: single-shard (3 members at
    4x4x1240) and 2x2 ``make_sim_fn`` (2 members at 4x4x100, recorded),
    each member equal to its captured solo run bit for bit (drive drawn
    inside the graph on each member's generator)."""
    from repro_torch.core import dist_engine as tde
    from repro_torch.obs.record import recorder_spec, stacked_gid_maps
    seeds = (0, 5, 9)
    _, tcfg = configs("gaussian", grid=4, n_per_col=1240)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    _build.reset_launch_counts()
    ens, raster = teng.simulate(
        teng.init_ensemble_state(tcfg, seeds, device=cuda), tabs, tcfg, 24,
        record_spikes=True, ensemble=3, device=cuda)
    assert _build.launch_counts()["step_graph"] == 2
    for m, s in enumerate(seeds):
        c = dataclasses.replace(tcfg, state_seed=s)
        solo, rs = teng.simulate(teng.init_sim_state(c, device=cuda), tabs,
                                 c, 24, record_spikes=True, device=cuda)
        assert torch.equal(raster[m], rs)
        assert torch.equal(ens["neuron"]["v"][m], solo["neuron"]["v"])
    assert float(raster.sum()) > 0
    cfg = dataclasses.replace(_dist_config("gaussian"),
                              ensemble_seeds=seeds[:2])
    tables, _ = tde.build_dist_tables(cfg, device=cuda)
    inputs = tde.SimInputs(tables=tables, gids=torch.from_numpy(
        stacked_gid_maps(cfg.engine.decomp)).to(cuda))

    def run(c):
        sim = tde.make_sim_fn(c, 40, recorder=recorder_spec(c.engine, 40),
                              storage=tables.storage, device=cuda)
        st, per, rec = sim(tde.init_dist_state(c, device=cuda), inputs)
        assert sim.captures == 1
        return st, per, {k: v.clone() for k, v in rec.items()}

    es, ep, er = run(cfg)
    for m, s in enumerate(seeds[:2]):
        ss, sp, sr = run(tde.DistConfig(engine=dataclasses.replace(
            cfg.engine, state_seed=s)))
        assert torch.equal(ep[:, :, m], sp)
        assert torch.equal(es["i_ring"][:, :, m], ss["i_ring"])
        for k in sr:
            assert torch.equal(er[k][:, :, m], sr[k]), k


def test_job_server_captures_once_per_job(cuda, tmp_path):
    """The service on the card (the example at 4x4x100 in 2x2 tiles, 40
    steps in segments of 20): two 3-member jobs share one sim function,
    each captures its graph once, both streams see every event, and
    member 0's spool is the solo run's."""
    from repro_torch.examples import ensemble_service
    out = ensemble_service.run(str(tmp_path), device=cuda, grid=4, npc=100,
                               tiles=(2, 2), t_steps=40, seg=20,
                               report_path=str(tmp_path / "a.json"))
    assert [j["captures"] for j in out["jobs"]] == [1, 1]
    assert out["server_compiled_steps_after_2_jobs"] == 1
    assert out["member0_matches_solo"] and out["spooled_events"] > 0


def test_capture_holds_off_the_garbage_collector(cuda, monkeypatch):
    """A collection during a capture could destroy an unreachable graph
    (a sim and its kept loop form a cycle), which a capture does not
    permit: the collector is off while the graph's steps are captured,
    on while eager steps run, and on again after."""
    import gc
    _, tcfg = configs("gaussian", grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    seen = []
    one = teng._StepGraph._one

    def spy(self, drive, dst):
        seen.append(gc.isenabled())
        return one(self, drive, dst)

    monkeypatch.setattr(teng._StepGraph, "_one", spy)
    assert gc.isenabled()
    teng.simulate(teng.init_sim_state(tcfg, device=cuda), tabs, tcfg, 16,
                  device=cuda)
    assert seen == [True] * 8 + [False] * 8
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# LM training: the row statistic and the flash autograd Function
# ---------------------------------------------------------------------------

# (bh, bh_kv, sq, sk, d, causal, window, q_offset, dtype): each route,
# ragged edges, GQA, windows and fully masked rows (the q_offset-18
# window-5 case leaves rows 6+ without a key)
LSE_CASES = [
    (4, 2, 100, 100, 8, True, None, 0, torch.float32),       # tf32 (-> 16)
    (4, 2, 12, 20, 16, True, 5, 18, torch.bfloat16),         # sm90, dead
    (6, 2, 300, 300, 128, True, None, 0, torch.bfloat16),    # sm90
    (4, 4, 12, 20, 64, True, 5, 18, torch.bfloat16),         # sm90, dead
    (2, 1, 130, 300, 256, True, 40, 0, torch.bfloat16),      # sm90
    (6, 2, 300, 300, 128, True, None, 0, torch.float32),     # tf32
    (4, 4, 12, 20, 64, True, 5, 18, torch.float32),          # tf32, dead
    (2, 2, 37, 129, 256, False, None, 0, torch.float32),     # tf32
]


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win,qoff,dtype", LSE_CASES)
def test_flash_row_statistic_matches_plain(cuda, bh, bhkv, sq, sk, d,
                                           causal, win, qoff, dtype):
    """Each route's ``return_lse`` against the plain version's: within
    1e-5 of ``|L| + 1`` in float32 (the kernels' base-2 exponent and
    ``log`` against ``logsumexp``), 2e-3 in bf16 (the sm90 route's
    scores from bf16 operands in another order), +1e30 exactly on a
    fully masked row; the output is the one without the statistic."""
    from repro_torch.kernels.flash_attention import (_route,
                                                     flash_attention_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(sq * 3 + d)
    q, k, v = (torch.randn(s, device=cuda, generator=g).to(dtype)
               for s in ((bh, sq, d), (bhkv, sk, d), (bhkv, sk, d)))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    _build.reset_launch_counts()
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    plain = flash_attention_cuda(q, k, v, **kw)
    want_o, want_l = ref.attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    route = _route(dtype, d)
    assert _build.launch_counts()[
        {"sm90": "flash_attention", "tf32": "flash_attention_tf32"}[
            route]] == 2
    assert lse.dtype == torch.float32 and lse.shape == (bh, sq)
    assert torch.equal(out, plain)
    dead = want_l == 1e30
    assert torch.equal(lse == 1e30, dead)
    tol = 1e-5 if dtype == torch.float32 else 2e-3
    live = ~dead
    torch.testing.assert_close(lse[live], want_l[live], rtol=tol, atol=tol)
    if qoff:
        assert bool(dead.any())


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 16)])
def test_flash_function_on_kernel_matches_plain_route(cuda, dtype, d):
    """``_Flash`` with the kernel's forward on the card against the plain
    chunked route on CPU copies: output and dq, dk, dv (GQA, causal,
    Sq/Sk ragged against the chunks).  float32 within 1e-4 of each
    tensor's largest value; bf16 within 3e-2 (one bf16 step of the
    forward's P and output, carried through the backward).  One kernel
    launch per forward."""
    from repro_torch.models.attention import chunked_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(d)
    b, s, h, kv = 2, 300, 6, 2
    q, k, v, w = (torch.randn(shape, generator=g).to(dtype)
                  for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                                (b, s, h, d)))
    kw = dict(causal=True, window=None, scale=d ** -0.5, chunk_q=128,
              chunk_k=128)
    res = {}
    for dev, kernel in ((cuda, True), (torch.device("cpu"), False)):
        x = [t.to(dev).requires_grad_() for t in (q, k, v)]
        _build.reset_launch_counts()
        out = chunked_attention(*x, kernel=kernel, **kw)
        (out.float() * w.to(dev).float()).sum().backward()
        if kernel:
            torch.cuda.synchronize()
            assert sum(_build.launch_counts().values()) >= 1
        res[kernel] = [t.detach().float().cpu()
                       for t in [out] + [t.grad for t in x]]
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, got, want in zip(("out", "dq", "dk", "dv"), res[True],
                               res[False]):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= tol * scale, name
