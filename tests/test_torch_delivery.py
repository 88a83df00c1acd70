"""Port parity: event delivery, bit for bit.

On the static bfloat16 path every ring value is a multiple of 2^-9 far
below 2^15, so float32 sums are exact in any order: the port's ring
must equal the reference's ``deliver_events`` ring exactly, with equal
``n_events`` / ``n_dropped``, whatever order its scatter adds in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import synapses as jsyn
from repro.kernels import ref as jref
from repro_torch.core import engine as teng
from repro_torch.core import synapses as tsyn
from repro_torch.core.convert import tables_from_arrays
from repro_torch.kernels.synaptic_accum import (compact_events,
                                                event_delivery,
                                                event_delivery_banded,
                                                synaptic_accum)

from _torch_parity import LAWS, assert_bits_equal, configs, tier_arrays

# the reference's functions, jitted (one compile instead of one per op)
j_deliver_events = jax.jit(jsyn.deliver_events, static_argnums=(4, 5))
j_gather_all = jax.jit(jsyn.deliver_gather_all, static_argnums=(4,))
j_accum_ref = jax.jit(jref.synaptic_accum_ref)


def _built(law, tiles=1, ty=0, tx=0, grid=4, n_per_col=30, **kw):
    jcfg, tcfg = configs(law, grid=grid, n_per_col=n_per_col, tiles=tiles,
                         **kw)
    jt = jeng.build_shard_tables(jcfg, ty, tx)
    tt = teng.build_shard_tables(tcfg, ty, tx, device="cpu")
    return jcfg, tcfg, jt, tt


def _ring(rng, d_ring, n):
    return (rng.integers(-300, 300, (d_ring, n)) * 2.0 ** -9).astype(
        np.float32)


def _as_int32(tab: dict) -> dict:
    return dict(tab, tgt=tab["tgt"].to(torch.int32))


# (spike density, active_cap): zero spikes, sparse, and overflow of a
# small active_cap (only the first active_cap rows, ascending, deliver)
DENSITIES = [(0.0, None), (0.05, None), (0.3, None), (0.6, 40)]


@pytest.mark.parametrize("tgt32", [False, True])
@pytest.mark.parametrize("density,cap", DENSITIES)
@pytest.mark.parametrize("law", LAWS)
def test_deliver_events_bit_identical(law, density, cap, tgt32):
    jcfg, tcfg, jt, tt = _built(law)
    spec = tcfg.spec()
    cap = cap or spec.active_cap_local
    rng = np.random.default_rng(int(density * 100) + 7 * tgt32)
    n = spec.n_local
    spk = (rng.random(n) < density).astype(np.float32)
    ring = _ring(rng, 8, n)
    jtab = dict(jt["local"])
    ttab = tt["local"]
    if tgt32:
        jtab["tgt"] = jtab["tgt"].astype(jnp.int32)
        ttab = _as_int32(ttab)
    rj, ej, dj = j_deliver_events(jtab, jnp.asarray(spk),
                                  jnp.asarray(ring), 5, 8, cap)
    for route in ("core", "wrapper"):
        r0 = torch.from_numpy(ring.copy())
        if route == "core":
            rt, et, dt = tsyn.deliver_events(ttab, torch.from_numpy(spk),
                                             r0, 5, 8, cap)
        else:
            rt, et, dt = event_delivery_banded(
                [(ttab, torch.from_numpy(spk), cap)], r0, 5, 8)
        assert_bits_equal(rj, rt, f"ring via {route}")
        assert int(et) == int(ej) and int(dt) == int(dj), route
    n_spk = int(spk.sum())
    assert int(dj) == max(n_spk - cap, 0)
    if density == 0.0:
        assert int(ej) == 0 and np.array_equal(np.asarray(rj), ring)


@pytest.mark.parametrize("ty,tx", [(0, 0), (1, 1)])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_multi_tier_halo_delivery(law, use_kernels, ty, tx):
    """Local tier plus every halo fan-out band, with random band spikes,
    through the engine's ``deliver_event_tiers``."""
    jcfg, tcfg, jt, tt = _built(law, tiles=2, ty=ty, tx=tx)
    assert len(tt.halo) >= 2
    jspec, tspec = jcfg.spec(), tcfg.spec()
    jplan = jspec.delivery_plan(jt.storage)
    tplan = tspec.delivery_plan(tt.storage)
    rng = np.random.default_rng(11 + ty)
    n = tspec.n_local
    spk = (rng.random(n) < 0.2).astype(np.float32)
    bands = [(rng.random(p.rows) < 0.3).astype(np.float32)
             for p in tplan[1:]]
    ring = _ring(rng, 8, n)
    rj, ej, dj = jax.jit(lambda s, b, r: jeng.deliver_event_tiers(
        jt, s, b, jspec, r, 6, 8, False, plan=jplan))(
        jnp.asarray(spk), [jnp.asarray(b) for b in bands], jnp.asarray(ring))
    rt, et, dt = teng.deliver_event_tiers(
        tt, torch.from_numpy(spk), [torch.from_numpy(b) for b in bands],
        tspec, torch.from_numpy(ring.copy()), 6, 8, use_kernels, plan=tplan)
    assert_bits_equal(rj, rt, "ring")
    assert_bits_equal(ej, et, "events")
    assert_bits_equal(dj, dt, "dropped")
    assert float(et) > 0


@pytest.mark.parametrize("law", LAWS)
def test_gather_all_bit_identical(law):
    jcfg, tcfg, jt, tt = _built(law, tiles=2, ty=0, tx=1)
    rng = np.random.default_rng(2)
    n = tcfg.spec().n_local
    spk = (rng.random(n) < 0.3).astype(np.float32)
    ring = _ring(rng, 8, n)
    rj = j_gather_all(jt["local"], jnp.asarray(spk), jnp.asarray(ring), 2,
                      8)
    rt = tsyn.deliver_gather_all(tt["local"], torch.from_numpy(spk),
                                 torch.from_numpy(ring.copy()), 2, 8)
    assert_bits_equal(rj, rt, "local")
    band = tt.halo[0]
    bspk = (rng.random(band["tgt"].shape[0] - 1) < 0.5).astype(np.float32)
    rj = j_gather_all(jt["halo"][0], jnp.asarray(bspk), rj, 2, 8)
    rt = tsyn.deliver_gather_all(band, torch.from_numpy(bspk), rt, 2, 8)
    assert_bits_equal(rj, rt, "halo band")


def test_float32_weights_delivery():
    jcfg, tcfg, jt, tt = _built("gaussian", weight_dtype="float32")
    assert tt.local["w"].dtype == torch.float32
    spec = tcfg.spec()
    rng = np.random.default_rng(4)
    spk = (rng.random(spec.n_local) < 0.2).astype(np.float32)
    ring = np.zeros((8, spec.n_local), np.float32)
    rj, ej, _ = j_deliver_events(jt["local"], jnp.asarray(spk),
                                 jnp.asarray(ring), 0, 8,
                                 spec.active_cap_local)
    rt, et, _ = event_delivery(tt["local"], torch.from_numpy(spk),
                               torch.from_numpy(ring), 0, 8,
                               spec.active_cap_local)
    # float32 weights are not on the 2^-9 grid: sums are exact only up to
    # order; the CPU scatter adds in the reference's order here
    np.testing.assert_allclose(np.asarray(rj), rt.numpy(), rtol=0,
                               atol=1e-5)
    assert int(et) == int(ej)


@pytest.mark.parametrize("n_rows,cap,density", [(50, 64, 0.3),
                                                (200, 16, 0.5),
                                                (100, 10, 0.0),
                                                (80, 80, 1.0)])
def test_compact_events_matches_nonzero(n_rows, cap, density):
    rng = np.random.default_rng(n_rows)
    spk = (rng.random(n_rows + 3) < density).astype(np.float32)
    want = np.flatnonzero(spk[:n_rows] > 0)[:cap]
    want = np.concatenate([want, np.full(cap - len(want), n_rows)])
    idx, n_spk = compact_events(torch.from_numpy(spk), n_rows, cap)
    assert idx.dtype == torch.int32 and idx.shape == (cap,)
    assert np.array_equal(np.asarray(want), idx.numpy())
    assert int(n_spk) == int((spk[:n_rows] > 0).sum())


def test_legacy_synaptic_accum_matches_reference():
    jcfg, tcfg, jt, tt = _built("exponential")
    rng = np.random.default_rng(9)
    n_rows = tt.local["tgt"].shape[0] - 1
    idx = rng.integers(0, n_rows + 1, 37).astype(np.int32)  # unsorted, sink
    ring = _ring(rng, 8, tcfg.spec().n_local)
    loc = jt["local"]
    rj = j_accum_ref(jnp.asarray(idx), 3, loc["tgt"], loc["w"], loc["dslot"],
                     jnp.asarray(ring))
    t = tt.local
    rt = synaptic_accum(torch.from_numpy(idx), 3, t["tgt"], t["w"],
                        t["dslot"], torch.from_numpy(ring.copy()))
    assert_bits_equal(rj, rt, "ring")


def test_plan_mismatch_and_bad_tables_raise():
    _, tcfg, _, tt = _built("gaussian", tiles=2)
    plan = tcfg.spec().delivery_plan(tt.storage)
    n = tcfg.spec().n_local
    ring = torch.zeros((8, n))
    spk = torch.zeros(n)
    with pytest.raises(ValueError, match="plan"):
        event_delivery_banded([(tt.local, spk, plan[0].active_cap)], ring,
                              0, 8, plan=plan)
    with pytest.raises(ValueError, match="plan"):
        event_delivery_banded([(tt.local, spk, plan[0].active_cap + 1)],
                              ring, 0, 8, plan=plan[:1])
    bad = dict(tt.local, dslot=tt.local["dslot"].to(torch.int32))
    with pytest.raises(ValueError):
        event_delivery_banded([(bad, spk, 4)], ring, 0, 8)
    with pytest.raises(ValueError):
        event_delivery_banded([(tt.local, spk, 4)], ring, 0, 4)


@pytest.mark.parametrize("law", LAWS)
def test_converted_tables_equal_port_build(law):
    """``tables_from_arrays`` of the reference's tables (numpy, bf16 as
    ml_dtypes) equals the port's own build."""
    jcfg, tcfg, jt, tt = _built(law, tiles=2, ty=1, tx=0)
    conv = tables_from_arrays(tier_arrays(jt)[0], tier_arrays(jt)[1:],
                              jt.storage.meta(), device="cpu")
    assert conv.storage == tt.storage
    for a, b in zip(conv.tiers(), tt.tiers()):
        for k in ("tgt", "w", "dslot", "nnz"):
            assert a[k].dtype == b[k].dtype
            assert torch.equal(a[k], b[k]), k
    f32 = {**tier_arrays(jt)[0]}
    f32["w"] = f32["w"].astype(np.float32)
    conv32 = tables_from_arrays(f32, tier_arrays(jt)[1:],
                                jt.storage.meta(), device="cpu")
    assert torch.equal(conv32.local["w"], tt.local["w"])
    with pytest.raises(ValueError):
        tables_from_arrays(tier_arrays(jt)[0], [], jt.storage.meta(),
                           device="cpu")
