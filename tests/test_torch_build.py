"""Port parity: the host-side network build.

The PyTorch port must realize the reference's network array for array:
the same numpy draws, the same packing, the same bfloat16 weight bits
(rounded through torch, where the reference rounds through ml_dtypes),
the same storage descriptor and the same initial membrane state.
"""

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.synapses import np_dtype
from repro_torch.configs import snn as tsnn
from repro_torch.core import engine as teng
from repro_torch.core.synapses import TableStorage, quantize_weights

from _torch_parity import LAWS, assert_bits_equal, configs, tier_arrays

# (tiles per side, tile_y, tile_x): the single shard and every tile of a
# 2x2 tiling (the latter carries halo fan-out bands)
TILES = [(1, 0, 0), (2, 0, 0), (2, 0, 1), (2, 1, 0), (2, 1, 1)]


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("tiles,ty,tx", TILES)
@pytest.mark.parametrize("law", LAWS)
def test_tables_bit_identical(law, tiles, ty, tx, compress):
    jcfg, tcfg = configs(law, grid=4, n_per_col=30, tiles=tiles)
    ref = jeng.build_shard_tables(jcfg, ty, tx, compress=compress)
    port = teng.build_shard_tables(tcfg, ty, tx, compress=compress,
                                   device="cpu")
    assert port.storage.meta() == ref.storage.meta()
    assert len(port.tiers()) == len(ref.tiers())
    if tiles > 1:
        assert len(port.halo) > 0
    for ti, (ra, pt) in enumerate(zip(tier_arrays(ref), port.tiers())):
        for k in ("tgt", "w", "dslot", "nnz"):
            assert pt[k].dtype == {
                "tgt": getattr(torch, ref.storage.tgt_dtype),
                "w": torch.bfloat16, "dslot": torch.int8,
                "nnz": torch.int32}[k]
            assert_bits_equal(ra[k], pt[k], f"tier {ti} {k}")
    for k in ("n_synapses", "clipped", "table_bytes", "bytes_per_synapse"):
        assert port.stats[k] == ref.stats[k], k


@pytest.mark.parametrize("tiles,ty,tx", [(1, 0, 0), (2, 1, 1)])
@pytest.mark.parametrize("law", LAWS)
def test_spec_and_plan_match(law, tiles, ty, tx):
    jcfg, tcfg = configs(law, grid=4, n_per_col=30, tiles=tiles)
    js, ts = jcfg.spec(), tcfg.spec()
    assert ts.n_local == js.n_local and ts.cap_local == js.cap_local
    assert ts.storage().meta() == js.storage().meta()
    assert ts.table_bytes() == js.table_bytes()
    jb, tb = js.halo_bands(), ts.halo_bands()
    assert [(b["cap"], b["rows"]) for b in tb] == \
        [(b["cap"], b["rows"]) for b in jb]
    for a, b in zip(jb, tb):
        assert np.array_equal(a["cols"], b["cols"])
    st = jeng.build_shard_tables(jcfg, ty, tx).storage
    jp = js.delivery_plan(st)
    tp = ts.delivery_plan(TableStorage.from_meta(st.meta()))
    assert [(p.cap, p.active_cap, p.rows, p.entries) for p in tp] == \
        [(p.cap, p.active_cap, p.rows, p.entries) for p in jp]


@pytest.mark.parametrize("grid,tiles,ty,tx", [(4, 1, 0, 0), (5, 2, 1, 1),
                                               (5, 2, 0, 1)])
def test_init_state_matches(grid, tiles, ty, tx):
    # a 5x5 grid on a 2x2 tiling pads inactive columns into the last tiles
    jcfg, tcfg = configs("gaussian", grid=grid, n_per_col=20, tiles=tiles,
                         state_seed=5)
    js = jeng.init_sim_state(jcfg, ty, tx, seed_offset=1)
    ts = teng.init_sim_state(tcfg, ty, tx, seed_offset=1, device="cpu")
    for k in ("v", "c", "refrac"):
        assert_bits_equal(js["neuron"][k], ts["neuron"][k], k)
    assert_bits_equal(js["active"], ts["active"], "active")
    assert_bits_equal(js["i_ring"], ts["i_ring"], "i_ring")
    assert ts["t"] == int(js["t"]) == 0
    if tiles > 1 and ty == 1:
        assert not bool(ts["active"].all())


def test_bf16_rounding_matches_ml_dtypes():
    """torch's bfloat16 rounding of float64 weights gives the bits the
    reference's ml_dtypes cast gives (``synapses.py`` ``np_dtype``)."""
    rng = np.random.default_rng(3)
    ws = np.concatenate([rng.uniform(0.26, 0.44, 200_000),
                         rng.uniform(-2.0, -1.2, 200_000),
                         rng.normal(0.0, 3.0, 100_000)])
    ref = ws.astype(np_dtype("bfloat16")).astype(np.float32)
    assert_bits_equal(ref, quantize_weights(ws, "bfloat16"), "bf16")
    assert_bits_equal(ws.astype(np.float32),
                      quantize_weights(ws, "float32"), "f32")


def test_float32_weight_tables_match():
    jcfg, tcfg = configs("exponential", grid=4, n_per_col=20, tiles=2,
                         weight_dtype="float32")
    ref = jeng.build_shard_tables(jcfg, 0, 1)
    port = teng.build_shard_tables(tcfg, 0, 1, device="cpu")
    assert port.storage.meta() == ref.storage.meta()
    for ra, pt in zip(tier_arrays(ref), port.tiers()):
        assert pt["w"].dtype == torch.float32
        for k in ra:
            assert_bits_equal(ra[k], pt[k], k)


def test_snn_configs_match_reference():
    from repro.configs import snn as jsnn
    assert sorted(tsnn.CASES) == sorted(jsnn.CASES)
    for name, case in tsnn.CASES.items():
        ref = jsnn.CASES[name]
        assert (case.grid, case.law, case.n_per_column) == \
            (ref.grid, ref.law, ref.n_per_column)
        ts = case.engine_config(4, 4).spec()
        js = ref.engine_config(4, 4).spec()
        assert (ts.n_local, ts.cap_local) == (js.n_local, js.cap_local)
        assert ts.storage().meta() == js.storage().meta()
    r = tsnn.reduced_case("exponential", grid=6, n_per_column=40)
    jr = jsnn.reduced_case("exponential", grid=6, n_per_column=40)
    assert r.name == jr.name
    assert r.engine_config(1, 1).spec().storage().meta() == \
        jr.engine_config(1, 1).spec().storage().meta()
