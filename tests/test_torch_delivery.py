"""Port parity: event delivery, bit for bit.

On the static bfloat16 path every ring value is a multiple of 2^-9 far
below 2^15, so float32 sums are exact in any order: the port's ring
must equal the reference's ``deliver_events`` ring exactly, with equal
``n_events`` / ``n_dropped``, whatever order its scatter adds in.
"""

import re
from pathlib import Path

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
from repro_torch.core import connectivity as tconn
from repro_torch.core import grid as tgrid
from repro_torch import kernels as kernels_pkg
from repro_torch.core.convert import tables_from_arrays
from repro_torch.kernels.ref import (deliver_rows_ref, deliver_runs_ref,
                                     delivered_bits, delivered_flags,
                                     run_fields)
from repro_torch.kernels.synaptic_accum import (build_column_runs,
                                                compact_events,
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


# ---------------------------------------------------------------------------
# the column kernel's run descriptor and delivered-row bitmap
# ---------------------------------------------------------------------------

def _port_tables(law, tiles_y, tiles_x, ty, tx, grid=4, n_per_col=30):
    tl = getattr(tconn, f"{law}_law")()
    cfg = teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(grid, grid,
                                                        n_per_col),
                                       tiles_y, tiles_x, tl.radius), law=tl)
    return cfg.spec(), teng.build_shard_tables(cfg, ty, tx, device="cpu")


def _run_entries(desc):
    """Every (pair, row, position) a descriptor names: the pair's target
    column and delay, the row, and the position in the tier's own
    arrays (through ``perm`` where the descriptor permuted them)."""
    g = desc["row_group"]
    start, length = run_fields(desc["runs"])
    p_i, g_i = (length > 0).nonzero(as_tuple=True)
    lens = length[p_i, g_i]
    rep = torch.repeat_interleave(torch.arange(lens.numel()), lens)
    k = (start[p_i, g_i][rep] + torch.arange(rep.numel())
         - (torch.cumsum(lens, 0) - lens)[rep])
    p = p_i[rep]
    row = desc["pair_src"].long()[p] * g + g_i[rep]
    if desc["perm"] is not None:
        k = desc["perm"].long()[row, k]
    n_tcols = desc["n_tcols"]
    tcol = torch.repeat_interleave(torch.arange(n_tcols),
                                   desc["pair_ptr"].diff().long())
    return tcol[p], desc["pair_dslot"].long()[p], row, k


def _assert_covers(tier, desc):
    n_rows, cap = tier["tgt"].shape[0] - 1, tier["tgt"].shape[1]
    tcol, d, row, k = _run_entries(desc)
    assert bool((row < n_rows).all())
    hits = torch.zeros((n_rows + 1) * cap, dtype=torch.int64)
    hits.index_add_(0, row * cap + k, torch.ones_like(row))
    valid = torch.arange(cap)[None, :] < tier["nnz"][:, None]
    assert torch.equal(hits.view(n_rows + 1, cap), valid.long())
    assert torch.equal(tier["tgt"][row, k].long() // desc["col_width"],
                       tcol)
    assert torch.equal(tier["dslot"][row, k].long(), d)
    # the descriptor's own entry arrays hold the same values
    if desc["perm"] is None:
        assert desc["tgt"] is tier["tgt"] and desc["w"] is tier["w"]


def _shuffled(tier, seed):
    """A hand-made tier: each row's valid entries in random order with
    random delay slots, so one (row, target column) is split into many
    runs."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.arange(tier["tgt"].shape[1])[None, :] < tier["nnz"][:, None]
    keys = torch.where(valid, torch.rand(valid.shape, generator=g),
                       torch.full(valid.shape, 2.0))
    order = keys.argsort(1)
    out = {k: torch.gather(v, 1, order) if v.dim() == 2 else v
           for k, v in tier.items()}
    d = torch.randint(0, 8, valid.shape, generator=g, dtype=torch.int8)
    out["dslot"] = torch.where(valid, d, torch.zeros_like(d))
    return out


@pytest.mark.parametrize("tiling", [(1, 1, 0, 0), (1, 2, 0, 1),
                                    (2, 2, 1, 0)])
@pytest.mark.parametrize("law", LAWS)
def test_column_runs_cover_every_entry_once(law, tiling):
    """build_tables output: one run per (row, target column) in every
    tier, halo bands included; every valid entry named exactly once,
    with its target column and delay; delivery through the descriptor
    equals the row delivery, tier by tier."""
    spec, tt = _port_tables(law, *tiling)
    if tiling[:2] != (1, 1):
        assert len(tt.halo) > 0
    runs = tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)
    assert runs is tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)
    rng = np.random.default_rng(sum(tiling))
    for tier, desc in zip(tt.tiers(), runs):
        assert desc["perm"] is None
        _assert_covers(tier, desc)
        n_rows = tier["tgt"].shape[0] - 1
        spk = torch.from_numpy((rng.random(n_rows) < 0.3).astype(np.float32))
        cap = max(n_rows // 4, 1)
        ring = torch.from_numpy(_ring(rng, 8, spec.n_local))
        ev_a = torch.zeros(1, dtype=torch.int32)
        ev_b = torch.zeros(1, dtype=torch.int32)
        idx, _ = compact_events(spk, n_rows, cap)
        ra = deliver_rows_ref(tier, idx, ring.clone(), 2, ev_a)
        rb = deliver_runs_ref(desc, delivered_flags(spk, n_rows, cap)[0],
                              ring.clone(), 2, ev_b)
        assert_bits_equal(ra, rb, "ring")
        assert int(ev_a) == int(ev_b)


@pytest.mark.parametrize("col_width", [30, 64, 7])
def test_column_runs_of_split_rows(col_width):
    """Hand-made tables whose (row, target column) entries are not one
    run, and column widths that cut the network's columns: the
    descriptor delivers from a row-sorted copy and still covers every
    entry once."""
    spec, tt = _port_tables("exponential", 1, 1, 0, 0)
    tier = _shuffled(tt.local, col_width)
    desc = build_column_runs(tier, spec.n_per_col, col_width, spec.n_local)
    assert desc["perm"] is not None
    _assert_covers(tier, desc)


@pytest.mark.parametrize("hand_made", [False, True])
@pytest.mark.parametrize("density,cap", DENSITIES)
@pytest.mark.parametrize("law", LAWS)
def test_delivery_through_runs_bit_identical(law, density, cap, hand_made):
    """The descriptor's plain delivery against the reference's
    ``deliver_events`` and the port's row delivery: ring, events and
    the dropped count, on built and on hand-made (split-run) tables."""
    jcfg, tcfg, jt, tt = _built(law)
    spec = tcfg.spec()
    cap = cap or spec.active_cap_local
    rng = np.random.default_rng(int(density * 100) + 3 * hand_made)
    n = spec.n_local
    spk = (rng.random(n) < density).astype(np.float32)
    ring = _ring(rng, 8, n)
    tier = _shuffled(tt.local, 5) if hand_made else tt.local
    jtab = {k: jnp.asarray(v.numpy()) for k, v in tier.items()
            if k != "w"}
    jtab["w"] = jnp.asarray(tier["w"].float().numpy()).astype(jnp.bfloat16)
    rj, ej, dj = j_deliver_events(jtab, jnp.asarray(spk), jnp.asarray(ring),
                                  5, 8, cap)
    desc = build_column_runs(tier, spec.n_per_col, spec.n_per_col, n)
    assert (desc["perm"] is not None) == hand_made
    flag, n_spk = delivered_flags(torch.from_numpy(spk), n, cap)
    ev = torch.zeros(1, dtype=torch.int32)
    rt = deliver_runs_ref(desc, flag, torch.from_numpy(ring.copy()), 5, ev)
    assert_bits_equal(rj, rt, "ring")
    assert int(ev) == int(ej)
    assert int(torch.clamp(n_spk - cap, min=0)) == int(dj)
    idx, _ = compact_events(torch.from_numpy(spk), n, cap)
    ev_rows = torch.zeros(1, dtype=torch.int32)
    rr = deliver_rows_ref(tier, idx, torch.from_numpy(ring.copy()), 5,
                          ev_rows)
    assert_bits_equal(rr, rt, "ring vs row delivery")


@pytest.mark.parametrize("n_rows,cap,density", [(50, 64, 0.3),
                                                (200, 16, 0.5),
                                                (100, 10, 0.0),
                                                (95, 95, 1.0)])
def test_delivered_bits_are_the_compacted_rows(n_rows, cap, density):
    """Bit r % 32 of word r // 32 is set exactly for the rows
    ``compact_events`` delivers; the sink row's and padding bits are
    0."""
    rng = np.random.default_rng(n_rows + 1)
    spk = torch.from_numpy((rng.random(n_rows + 3) < density)
                           .astype(np.float32))
    bits, n_spk = delivered_bits(spk, n_rows, cap)
    assert bits.dtype == torch.int32 and bits.shape == ((n_rows + 32) // 32,)
    shift = torch.arange(32, dtype=torch.int32)
    got = ((bits[:, None] >> shift) & 1).view(-1)
    idx, n_c = compact_events(spk, n_rows, cap)
    want = torch.zeros_like(got)
    want[idx[idx < n_rows].long()] = 1
    assert torch.equal(got, want)
    assert int(n_spk) == int(n_c)
    assert torch.equal(delivered_flags(spk, n_rows, cap)[0].long(),
                       want[:n_rows + 1].long())


def test_window_scale_of_built_and_off_grid_weights():
    """Built bf16 tables: every weight is a multiple of 2^-9 and the
    summed fan-in stays far below 2^24 / 2^9, so the column kernel's
    window is int32 at scale 2^9.  Weights on no common grid within
    range get scale 0.0: the float32 window."""
    spec, tt = _port_tables("exponential", 1, 1, 0, 0)
    desc = tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)[0]
    assert desc["scale"] == 512.0
    w = tt.local["w"].clone()
    w[0, 0] = 2.0 ** -40
    w[1, 0] = 3.0e4
    off = dict(tt.local, w=w)
    assert build_column_runs(off, spec.n_per_col, spec.n_per_col,
                             spec.n_local)["scale"] == 0.0


def test_column_runs_beyond_16_bit_positions():
    """A hand-made tier whose rows hold more than 65535 entries: the
    descriptor keeps run starts past 2^16 (no refusal) and delivers
    like the row delivery, with and without the permuted copy."""
    rng = np.random.default_rng(9)
    n_local, col_width, cap = 64, 16, 70_000
    nnz = torch.tensor([cap, 65_600, 3, 0], dtype=torch.int32)
    tgt = torch.from_numpy(rng.integers(0, n_local, (4, cap))
                           .astype(np.int32))
    dslot = torch.from_numpy(rng.integers(0, 8, (4, cap)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-64, 64, (4, cap)) * 2.0 ** -9).to(
        torch.bfloat16)
    valid = torch.arange(cap)[None, :] < nnz[:, None]
    # each row's entries for one (target column, delay) made one run
    key = torch.where(valid, (tgt // col_width) * 8 + dslot.long(),
                      torch.full_like(tgt, 10 ** 6).long())
    order = key.argsort(dim=1, stable=True)
    tier = {"tgt": torch.where(valid, torch.gather(tgt, 1, order), 0),
            "dslot": torch.where(valid, torch.gather(dslot, 1, order),
                                 torch.zeros_like(dslot)),
            "w": torch.where(valid, torch.gather(w, 1, order),
                             torch.zeros_like(w)),
            "nnz": nnz}
    spk = torch.tensor([1.0, 1.0, 1.0])
    for t, permuted in ((tier, False), (_shuffled(tier, 2), True)):
        desc = build_column_runs(t, 2, col_width, n_local)
        assert (desc["perm"] is not None) == permuted
        assert int(run_fields(desc["runs"])[0].max()) > 0xFFFF
        _assert_covers(t, desc)
        ring = torch.zeros((8, n_local))
        ev_a = torch.zeros(1, dtype=torch.int32)
        ev_b = torch.zeros(1, dtype=torch.int32)
        idx, _ = compact_events(spk, 3, 3)
        ra = deliver_rows_ref(t, idx, ring.clone(), 4, ev_a)
        rb = deliver_runs_ref(desc, delivered_flags(spk, 3, 3)[0],
                              ring.clone(), 4, ev_b)
        assert_bits_equal(ra, rb, "ring")
        assert int(ev_a) == int(ev_b) == int(nnz.sum())


def _cu_constant(source: str, name: str) -> int:
    text = (Path(kernels_pkg.__file__).parent / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_static_shared_memory_reserves_match_the_sources():
    """The wrappers size the dynamic shared memory (ring window, row
    bitmap) to what a block has beside each kernel's static arrays: the
    reserves they assume are the ones the CUDA sources declare."""
    from repro_torch.kernels import plastic_step, synaptic_accum
    assert (_cu_constant("event_delivery.cu", "kColStaticSmem")
            == synaptic_accum.COLUMN_STATIC_SMEM)
    assert (_cu_constant("event_delivery.cu", "kColThreads") // 32
            == synaptic_accum.COLUMN_WARPS)
    assert (_cu_constant("plastic_delivery.cu", "kStaticSmem")
            == plastic_step.STATIC_SMEM)


@pytest.mark.parametrize("n_per_col,d_ring", [(1240, 8), (1240, 64),
                                              (1162, 50), (30, 32)])
def test_column_width_leaves_room_for_static_arrays(n_per_col, d_ring):
    """The window, d_ring x width float32, fits a block's shared memory
    less the kernel's static arrays; a column that fits is kept whole,
    one that does not is cut to a multiple of 4."""
    from repro_torch.kernels import _build, synaptic_accum
    room = _build.SMEM_BYTES - synaptic_accum.COLUMN_STATIC_SMEM
    width = synaptic_accum.column_width(n_per_col, d_ring)
    assert 4 * d_ring * width <= room
    if 4 * d_ring * n_per_col <= room:
        assert width == n_per_col
    else:
        assert width % 4 == 0 and 4 * d_ring * (width + 4) > room
