"""Port parity: plastic (STDP) single-shard runs, bit for bit.

The reference runs on its pure-XLA path (``use_kernels=False``) and its
drive is injected into the port.  Weights are float32 here, so every
comparison is of bits: the inverse index, one plastic step from random
traces, whole 100-step runs (both laws, kernel and plain paths), the
converter, and the fixed-order delivery of a static float32 run.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import stdp as jstdp
from repro_torch.core import engine as teng
from repro_torch.core import stdp as tstdp
from repro_torch.core import synapses as tsyn
from repro_torch.core.convert import plasticity_from_arrays, tables_from_arrays
from repro_torch.kernels.plastic_step import (bind_plastic_bits, magic_div,
                                              magic_u31, plastic_delivery_ltd)
from repro_torch.kernels.synaptic_accum import deliver_rows_cuda

from _torch_parity import (LAWS, assert_bits_equal, configs,
                           reference_drive, tier_arrays)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # hermetic env
    from _hypothesis_fallback import given, settings, strategies as st

STEPS = 100


def plastic_configs(law, grid=4, n_per_col=30, tiles=1, **kw):
    jcfg, tcfg = configs(law, grid=grid, n_per_col=n_per_col, tiles=tiles,
                         **kw)
    return (dataclasses.replace(jcfg, stdp=jstdp.STDPParams()),
            dataclasses.replace(tcfg, stdp=tstdp.STDPParams()))


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _reference_plastic_run(law, steps=STEPS):
    jcfg, tcfg = plastic_configs(law)
    tabs = jeng.build_shard_tables(jcfg)
    aux = jeng.init_plasticity(tabs, jcfg)
    state = jeng.init_sim_state(jcfg)
    drive = reference_drive(jcfg, state, steps)
    (st, tb, tr), per = jax.jit(lambda s, t: jeng.simulate(
        s, t, jcfg, steps, plasticity=aux))(state, tabs)
    return (jcfg, tcfg, drive, _np(st), np.asarray(tb["local"]["w"]),
            _np(tr), np.asarray(per), np.asarray(tabs["local"]["w"]))


# ---------------------------------------------------------------------------
# inverse index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles,ty,tx", [(1, 0, 0), (2, 0, 0), (2, 0, 1),
                                         (2, 1, 0), (2, 1, 1)])
@pytest.mark.parametrize("law", LAWS)
def test_inverse_index_matches_reference(law, tiles, ty, tx):
    jcfg, tcfg = plastic_configs(law, tiles=tiles)
    jt = jeng.build_shard_tables(jcfg, ty, tx)
    tt = teng.build_shard_tables(tcfg, ty, tx, device="cpu")
    n_local = tcfg.spec().n_local
    ji = jstdp.build_inverse_index(list(jt.tiers()), n_local)
    ti = tstdp.build_inverse_index(tt.tiers(), n_local, device="cpu")
    if tiles == 2:
        assert len(tt.halo) > 0
    for k in ("slots", "n_in", "bases", "sizes"):
        assert_bits_equal(np.asarray(ji[k]), np.asarray(ti[k]), k)
    assert ti["total"] == ji["total"] and ti["clipped"] == ji["clipped"] == 0
    # the tables keep the same index for the fixed-order delivery
    assert torch.equal(tt.inverse_index()["slots"], ti["slots"])
    assert tt.inverse_index() is tt.inverse_index()


# ---------------------------------------------------------------------------
# one plastic step
# ---------------------------------------------------------------------------

def _step_inputs(law, case):
    """Reference tables/aux plus random live weights, traces, ring and a
    forced spike vector (numpy seed)."""
    kw = {"rate_cap_hz": 2.0, "cap_headroom": 1.0} if case == "overflow" \
        else {}
    jcfg, tcfg = plastic_configs(law, **kw)
    jt = jeng.build_shard_tables(jcfg)
    aux = jeng.init_plasticity(jt, jcfg)
    spec = tcfg.spec()
    n_local = spec.n_local
    rng = np.random.default_rng(7)
    w = np.asarray(jt["local"]["w"]).copy()
    mask = np.asarray(aux["masks"][0]) > 0
    w[mask] = rng.uniform(0.0, 0.6, mask.sum()).astype(np.float32)
    dens = {"random": 0.3, "overflow": 0.6, "zero": 0.0}[case]
    spikes = (rng.random(n_local) < dens).astype(np.float32)
    x_pre = rng.uniform(0, 3, w.shape[0]).astype(np.float32)
    x_post = rng.uniform(0, 3, n_local).astype(np.float32)
    ring = rng.normal(0, 4, (jcfg.d_ring, n_local)).astype(np.float32)
    if case == "overflow":
        assert spikes.sum() > spec.active_cap_local
    return jcfg, tcfg, jt, aux, w, spikes, x_pre, x_post, ring


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("case", ["random", "overflow", "zero"])
@pytest.mark.parametrize("law", LAWS)
def test_one_plastic_step_bit_identical(law, case, use_kernels):
    jcfg, tcfg, jt, aux, w, spikes, x_pre, x_post, ring = _step_inputs(
        law, case)
    jspec = jcfg.spec()
    plan = jspec.delivery_plan(jt.storage)[:1]
    slot = 5
    jtiers = [dict(jt["local"], w=jax.numpy.asarray(w))]
    jr, jtiers1, jtr, jev, jdr = jeng.plastic_delivery_stdp(
        jtiers, aux["masks"][:1], aux["inv"],
        {"x_pre": [jax.numpy.asarray(x_pre)],
         "x_post": jax.numpy.asarray(x_post)},
        [jax.numpy.asarray(spikes)], jspec, jax.numpy.asarray(ring), slot,
        jcfg, plan)

    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    tt = teng.build_shard_tables(tcfg, device="cpu")
    taux = teng.init_plasticity(tt, tcfg)
    tspec = tcfg.spec()
    ttiers = [dict(tt["local"], w=torch.from_numpy(w.copy()))]
    tr, ttiers1, ttr, tev, tdr = teng.plastic_delivery_stdp(
        ttiers, taux["masks"][:1], taux["inv"],
        {"x_pre": [torch.from_numpy(x_pre.copy())],
         "x_post": torch.from_numpy(x_post.copy())},
        [torch.from_numpy(spikes)], tspec, torch.from_numpy(ring.copy()),
        slot, tcfg, tspec.delivery_plan(tt.storage)[:1])

    assert_bits_equal(jr, tr, "ring")
    assert_bits_equal(jtiers1[0]["w"], ttiers1[0]["w"], "w")
    assert_bits_equal(jtr["x_post"], ttr["x_post"], "x_post")
    assert_bits_equal(jtr["x_pre"][0], ttr["x_pre"][0], "x_pre")
    assert float(jev) == float(tev) and float(jdr) == float(tdr)
    if case == "zero":
        assert float(tev) == 0 and np.array_equal(ring, tr.numpy())
    else:
        assert (ttiers1[0]["w"].numpy() != w).sum() > 0
    if case == "overflow":
        assert float(tdr) > 0


# ---------------------------------------------------------------------------
# whole plastic runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_whole_plastic_run_bit_identical(law, use_kernels):
    jcfg, tcfg, drive, jst, jw, jtr, jper, w_built = _reference_plastic_run(
        law)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    tt = teng.build_shard_tables(tcfg, device="cpu")
    assert_bits_equal(w_built, tt["local"]["w"], "built w")
    aux = teng.init_plasticity(tt, tcfg)
    (st, tb, tr), per = teng.simulate(
        teng.init_sim_state(tcfg, device="cpu"), tt, tcfg, STEPS,
        drive=torch.from_numpy(drive), device="cpu", plasticity=aux)
    assert float(per.sum()) > 0
    assert_bits_equal(jper, per, "per-step spikes")
    assert_bits_equal(jw, tb["local"]["w"], "learned w")
    assert (tb["local"]["w"].numpy() != w_built).sum() > 0
    assert_bits_equal(jtr["x_post"], tr["x_post"], "x_post")
    assert len(tr["x_pre"]) == 1
    assert_bits_equal(jtr["x_pre"][0], tr["x_pre"][0], "x_pre")
    for k in ("v", "c", "refrac"):
        assert_bits_equal(jst["neuron"][k], st["neuron"][k], k)
    assert_bits_equal(jst["i_ring"], st["i_ring"], "i_ring")
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(jst["metrics"][k], st["metrics"][k], k)
    assert st["t"] == int(jst["t"]) == STEPS
    # the caller's tables are not changed
    assert_bits_equal(w_built, tt["local"]["w"], "caller's w")


# ---------------------------------------------------------------------------
# refusals and invariants
# ---------------------------------------------------------------------------

def test_weight_invariant_refused_like_reference():
    jcfg, tcfg = plastic_configs("gaussian")
    jt = jeng.build_shard_tables(jcfg)
    tt = teng.build_shard_tables(tcfg, device="cpu")
    low = 0.1
    with pytest.raises(ValueError, match="exceeds STDP w_max"):
        jstdp.check_weight_invariant(list(jt.tiers()),
                                     jstdp.STDPParams(w_max=low))
    with pytest.raises(ValueError, match="exceeds STDP w_max"):
        tstdp.check_weight_invariant(tt.tiers(), tstdp.STDPParams(w_max=low))
    with pytest.raises(ValueError, match="exceeds STDP w_max"):
        teng.init_plasticity(tt, dataclasses.replace(
            tcfg, stdp=tstdp.STDPParams(w_max=low)))
    tstdp.check_weight_invariant(tt.tiers(), tcfg.stdp)


def test_plastic_run_refusals():
    _, tcfg = plastic_configs("gaussian", n_per_col=10)
    tt = teng.build_shard_tables(tcfg, device="cpu")
    aux = teng.init_plasticity(tt, tcfg)
    state = teng.init_sim_state(tcfg, device="cpu")
    with pytest.raises(ValueError, match="mode='event'"):
        teng.simulate(state, tt, dataclasses.replace(tcfg, mode="gather_all"),
                      2, device="cpu", plasticity=aux)
    from repro_torch.obs.record import recorder_spec
    with pytest.raises(ValueError, match="recorder"):
        teng.simulate(state, tt, tcfg, 2, device="cpu", plasticity=aux,
                      recorder=recorder_spec(tcfg, 2))
    with pytest.raises(ValueError, match="record_spikes"):
        teng.simulate(state, tt, tcfg, 2, device="cpu", plasticity=aux,
                      record_spikes=True)
    static = dataclasses.replace(tcfg, stdp=None)
    bf16 = teng.build_shard_tables(static, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        teng.simulate(state, bf16, tcfg, 2, device="cpu", plasticity=aux)
    w0 = tt["local"]["w"].clone()
    teng.simulate(state, tt, tcfg, 5, device="cpu", plasticity=aux)
    assert torch.equal(tt["local"]["w"], w0)


def test_plastic_spec_override_matches_reference():
    jcfg, tcfg = plastic_configs("exponential", tiles=2)
    js, ts = jcfg.spec(), tcfg.spec()
    assert ts.weight_dtype == js.weight_dtype == "float32"
    assert ts.halo_floor == js.halo_floor == 0.0
    assert [b["rows"] for b in ts.halo_bands()] == \
        [b["rows"] for b in js.halo_bands()]
    assert dataclasses.replace(tcfg, stdp=None).spec().weight_dtype == \
        "bfloat16"


def test_plastic_delivery_refuses_clipped_index_and_wrong_tier():
    _, tcfg = plastic_configs("gaussian", n_per_col=10)
    tt = teng.build_shard_tables(tcfg, device="cpu")
    spec = tcfg.spec()
    ring = torch.zeros((tcfg.d_ring, spec.n_local))
    spk = torch.ones(spec.n_local)
    tiers = [(tt["local"], spk, spec.active_cap_local)]
    clipped = dict(tt.inverse_index(), clipped=3)
    with pytest.raises(ValueError, match="clipped"):
        plastic_delivery_ltd(tiers, None, None, ring, 0, tcfg.d_ring, 0.0,
                             inv=clipped)
    wrong = dict(tt.inverse_index(), sizes=np.array([7]))
    with pytest.raises(ValueError, match="tier size"):
        plastic_delivery_ltd(tiers, None, None, ring, 0, tcfg.d_ring, 0.0,
                             inv=wrong)


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law", LAWS)
def test_plasticity_from_arrays_equals_port_init(law):
    jcfg, tcfg = plastic_configs(law, tiles=2)
    jt = jeng.build_shard_tables(jcfg, 1, 0)
    aux = _np(jeng.init_plasticity(jt, jcfg))
    conv = plasticity_from_arrays(aux, device="cpu")
    tt = tables_from_arrays(tier_arrays(jt)[0], tier_arrays(jt)[1:],
                            jt.storage.meta(), device="cpu")
    assert tt["local"]["w"].dtype == torch.float32
    own_t = teng.build_shard_tables(tcfg, 1, 0, device="cpu")
    for a, b in zip(tt.tiers(), own_t.tiers()):
        for k in a:
            assert_bits_equal(a[k], b[k], k)
    own = teng.init_plasticity(tt, tcfg)
    for k in ("slots", "n_in", "bases", "sizes"):
        assert_bits_equal(np.asarray(conv["inv"][k]),
                          np.asarray(own["inv"][k]), k)
    assert conv["inv"]["total"] == own["inv"]["total"]
    assert conv["inv"]["clipped"] == own["inv"]["clipped"] == 0
    assert len(conv["masks"]) == len(own["masks"]) == 1 + len(tt.halo)
    for a, b in zip(conv["masks"], own["masks"]):
        assert_bits_equal(a, b, "mask")
    for a, b in zip(conv["traces"]["x_pre"], own["traces"]["x_pre"]):
        assert_bits_equal(a, b, "x_pre")
    assert_bits_equal(conv["traces"]["x_post"], own["traces"]["x_post"],
                      "x_post")


def test_plasticity_from_arrays_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    jcfg, _ = plastic_configs("gaussian", n_per_col=10)
    jt = jeng.build_shard_tables(jcfg)
    aux = _np(jeng.init_plasticity(jt, jcfg))
    with pytest.raises(RuntimeError, match="cuda"):
        plasticity_from_arrays(aux)


# ---------------------------------------------------------------------------
# static runs with float32 weights: the fixed-order delivery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_static_float32_run_bit_identical(law, use_kernels):
    """A static run with float32 weights goes through the fixed-order
    delivery (kernel path) and matches the reference bit for bit."""
    steps = 100
    jcfg, tcfg = configs(law, grid=4, n_per_col=30, weight_dtype="float32")
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    jt = jeng.build_shard_tables(jcfg)
    js = jeng.init_sim_state(jcfg)
    drive = reference_drive(jcfg, js, steps)
    jfin, jraster = jax.jit(lambda s: jeng.simulate(
        s, jt, jcfg, steps, record_spikes=True))(js)
    tt = teng.build_shard_tables(tcfg, device="cpu")
    assert tt["local"]["w"].dtype == torch.float32
    builds = tsyn.BUILD_COUNTS["inverse_index"]
    tfin, traster = teng.simulate(
        teng.init_sim_state(tcfg, device="cpu"), tt, tcfg, steps,
        record_spikes=True, drive=torch.from_numpy(drive), device="cpu")
    assert float(traster.sum()) > 0
    assert_bits_equal(jraster, traster, "raster")
    assert_bits_equal(jfin["i_ring"], tfin["i_ring"], "i_ring")
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(jfin["metrics"][k], tfin["metrics"][k], k)
    # the kernel path builds the tables' inverse index once, the plain
    # path never
    assert tsyn.BUILD_COUNTS["inverse_index"] - builds == int(use_kernels)


def test_atomic_delivery_refuses_float32_weights():
    _, tcfg = configs("gaussian", grid=2, n_per_col=10,
                      weight_dtype="float32")
    tt = teng.build_shard_tables(tcfg, device="cpu")
    n = tcfg.spec().n_local
    with pytest.raises(ValueError, match="bfloat16"):
        deliver_rows_cuda(tt["local"], torch.zeros(4, dtype=torch.int32),
                          torch.zeros((8, n)), 0, None)


# ---------------------------------------------------------------------------
# the fixed-order kernel's static inputs: target-major delays and plastic
# bits, and the 32-bit magic-number division of a slot by the row cap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("law", LAWS)
def test_target_major_meta_is_the_gather_through_slots(law, tiles):
    _, tcfg = plastic_configs(law, tiles=tiles)
    tt = teng.build_shard_tables(tcfg, 0, tiles - 1, device="cpu")
    inv = tt.inverse_index()
    tiers = tt.tiers()
    masks = tstdp.plastic_masks(tiers)
    flat_d = torch.cat([t["dslot"].reshape(-1).long() for t in tiers])
    flat_m = torch.cat([m.reshape(-1) for m in masks])
    tm = inv["tm"]
    assert tm.dtype == torch.int8 and tm.shape == inv["slots"].shape
    valid = (torch.arange(tm.shape[1])[None, :] < inv["n_in"][:, None])
    s = inv["slots"].long()[valid]
    byte = tm.view(torch.uint8).long()
    assert torch.equal(byte[valid] & 127, flat_d[s])
    assert torch.equal(byte[valid] >> 7, (flat_m[s] > 0).long())
    assert int(byte[~valid].abs().sum()) == 0
    assert int((byte[valid] >> 7).sum()) > 0
    # the kernel's LTD is w + dw_unit where the bit is set: exact only for
    # masks of exactly 0 and 1
    half = [m * 0.5 for m in masks]
    with pytest.raises(ValueError, match="0 or 1"):
        tstdp.target_major_meta(tiers, inv, half)
    assert torch.equal(tstdp.target_major_meta(tiers, inv, masks), tm)


@pytest.mark.parametrize("law", LAWS)
def test_bind_plastic_bits_follows_the_masks_passed(law):
    """Binding other masks rewrites bit 7 of the bound tier's slots to
    them and leaves the delays and the other tiers' bits; the same
    mask again is free, an in-place edit is bound again; masks other
    than 0 or 1 are refused."""
    _, tcfg = plastic_configs(law, tiles=2)
    tt = teng.build_shard_tables(tcfg, 0, 1, device="cpu")
    inv = tt.inverse_index()
    tiers = tt.tiers()
    assert len(tiers) > 1
    masks = tstdp.plastic_masks(tiers)
    g = torch.Generator().manual_seed(4)
    mine = masks[0] * (torch.rand(masks[0].shape, generator=g) < 0.5)
    tm0 = inv["tm"].clone()
    bind_plastic_bits(inv, 0, mine)
    want = tstdp.target_major_meta(tiers, inv, [mine] + masks[1:])
    assert torch.equal(inv["tm"], want) and not torch.equal(want, tm0)
    assert torch.equal(inv["tm"] & 127, tm0 & 127)
    before = inv["tm"].clone()
    mine.add_(0.0)                       # a new version, the same values
    bind_plastic_bits(inv, 0, mine)
    assert torch.equal(inv["tm"], before)
    mine[: mine.shape[0] // 2] = 0.0
    bind_plastic_bits(inv, 0, mine)
    assert torch.equal(inv["tm"], tstdp.target_major_meta(
        tiers, inv, [mine] + masks[1:]))
    with pytest.raises(ValueError, match="0 or 1"):
        bind_plastic_bits(inv, 1, masks[1] * 0.5)


def _tier_caps():
    caps = set()
    for law in LAWS:
        for tiles in (1, 2):
            for kw in ({}, {"rate_cap_hz": 2.0}):
                _, tcfg = plastic_configs(law, tiles=tiles, **kw)
                spec = tcfg.spec()
                caps.update(p.cap for p in spec.delivery_plan())
            _, tcfg = configs(law, tiles=tiles)
            tt = teng.build_shard_tables(tcfg, device="cpu")
            caps.update(t["tgt"].shape[1] for t in tt.tiers())
    return sorted(caps)


def test_magic_division_over_the_tier_caps():
    """The kernel's row = umulhi(2v, m) >> l equals v // cap for every
    tier capacity of the test configurations, at the edges of each row
    and of the int32 range, and at random slots."""
    rng = np.random.default_rng(0)
    top = 2 ** 31 - 1
    for cap in _tier_caps() + [1, 2, 3, 7, 1240, 1391, 65535]:
        m, l = magic_u31(cap)
        assert m < 2 ** 32
        edges = [0, 1, cap - 1, cap, cap + 1, 2 * cap - 1, top, top - 1,
                 (top // cap) * cap, (top // cap) * cap - 1]
        v = np.array([e for e in edges if 0 <= e <= top]
                     + list(rng.integers(0, top, 2000)), dtype=np.uint64)
        assert np.array_equal(magic_div(v, m, l), v // np.uint64(cap)), cap


@settings(max_examples=300, deadline=None)
@given(d=st.integers(1, 2 ** 31 - 1), v=st.integers(0, 2 ** 31 - 1))
def test_magic_division_matches_floor_division(d, v):
    m, l = magic_u31(d)
    assert 0 < m < 2 ** 32 and 0 <= l <= 31
    assert magic_div(v, m, l) == v // d
    assert magic_div(2 ** 31 - 1, m, l) == (2 ** 31 - 1) // d
    with pytest.raises(ValueError):
        magic_u31(0)
