"""Port parity: elastic re-tiling (``repro_torch.core.retile``).

The port's functions are held bit for bit to the reference's on the
same numpy inputs: the column and neuron maps, the state relayout (its
generators aside: a ``torch.Generator`` cannot fold a key, so the port
seeds each new tile's generator by its own rule, ``retile_seed``), the
gid maps, the synapse stream, its packing, the table relay and the
plastic relay.  The contracts of the reference's
``tests/test_retile.py`` hold in the port.
"""

import numpy as np
import pytest
import torch

from repro.core import connectivity as jconn
from repro.core import dist_engine as jde
from repro.core import engine as jeng
from repro.core import grid as jgrid
from repro.core import retile as jrt
from repro.core.stdp import STDPParams as JSTDP
from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core import retile as trt
from repro_torch.core.stdp import STDPParams
from repro_torch.core.synapses import compress_tables

from _torch_parity import assert_bits_equal

# grid 3x3 does not divide either 2-tile tiling evenly -> both layouts
# carry padded columns, exercising the -1 (no source neuron) paths
H, W, NPC = 3, 3, 4


def _cfgs(ty, tx, law="gaussian", grid=(H, W, NPC), plastic=False):
    """(reference DistConfig, port DistConfig) of one model."""
    jl, tl = (getattr(m, f"{law}_law")() for m in (jconn, tconn))
    kw = {"seed": 2}
    jcfg = jde.DistConfig(engine=jeng.EngineConfig(
        decomp=jgrid.TileDecomposition(jgrid.ColumnGrid(*grid), ty, tx,
                                       jl.radius), law=jl,
        stdp=JSTDP() if plastic else None, use_kernels=False, **kw))
    tcfg = tde.DistConfig(engine=teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(*grid), ty, tx,
                                       tl.radius), law=tl,
        stdp=STDPParams() if plastic else None, **kw))
    return jcfg, tcfg


def _global_neuron_ids(dec):
    gid = trt.global_column_ids(dec)
    gnid = gid[..., None] * NPC + np.arange(NPC)
    return np.where(gid[..., None] >= 0, gnid, -1).reshape(
        dec.tiles_y, dec.tiles_x, dec.n_local)


def _patterned_state(cfg, t=5):
    """A port state tree whose every leaf encodes its global neuron id."""
    st = tde.state_tree(tde.init_dist_state(cfg, device="cpu"))
    dec = cfg.engine.decomp
    gnid = _global_neuron_ids(dec)
    valid = gnid >= 0
    st["neuron"] = {
        "v": torch.from_numpy(np.where(valid, gnid, 0).astype(np.float32)),
        "c": torch.from_numpy(np.where(valid, gnid + 0.25, 0).astype(
            np.float32)),
        "refrac": torch.from_numpy(np.where(valid, gnid % 5, 0).astype(
            np.int32))}
    d_ring = st["i_ring"].shape[2]
    slots = np.arange(d_ring)[None, None, :, None]
    st["i_ring"] = torch.from_numpy(np.where(
        valid[:, :, None, :], 1000.0 * slots + gnid[:, :, None, :],
        0.0).astype(np.float32))
    st["t"] = np.full(st["t"].shape, t, np.int32)
    shape = valid.shape[:2]
    st["metrics"] = {
        "spikes": torch.arange(1, shape[0] * shape[1] + 1,
                               dtype=torch.float32).view(shape),
        "events": torch.full(shape, 2.5),
        "dropped": torch.zeros(shape)}
    return st


def _reference_view(st, jcfg):
    """The same state as the reference's host tree (its own keys)."""
    host = {"neuron": {k: v.numpy() for k, v in st["neuron"].items()},
            "i_ring": st["i_ring"].numpy(), "t": st["t"],
            "active": st["active"].numpy(),
            "metrics": {k: v.numpy() for k, v in st["metrics"].items()},
            "rng": np.asarray(jde.init_dist_state(jcfg)["rng"])}
    return host


@pytest.mark.parametrize("old_tiles,new_tiles", [((1, 2), (2, 1)),
                                                 ((2, 1), (1, 2)),
                                                 ((2, 2), (1, 1))])
def test_retile_state_matches_reference(old_tiles, new_tiles):
    jold, told = _cfgs(*old_tiles)
    jnew, tnew = _cfgs(*new_tiles)
    old_d, new_d = told.engine.decomp, tnew.engine.decomp
    np.testing.assert_array_equal(
        trt.neuron_gather_map(old_d, new_d),
        jrt.neuron_gather_map(jold.engine.decomp, jnew.engine.decomp))
    st = _patterned_state(told, t=5)
    out = trt.retile_state(st, old_d, new_d, state_seed=2)
    ref = jrt.retile_state(_reference_view(st, jold), jold.engine.decomp,
                           jnew.engine.decomp)
    for k in ("v", "c", "refrac"):
        assert_bits_equal(ref["neuron"][k], out["neuron"][k], k)
    for k in ("i_ring", "t", "active"):
        assert_bits_equal(ref[k], out[k], k)
    for k in ref["metrics"]:
        assert_bits_equal(ref["metrics"][k], out["metrics"][k], k)
    n_new = new_tiles[0] * new_tiles[1]
    assert out["rng"] == [trt.retile_seed(2, 5, i) for i in range(n_new)]


def test_retile_seeds_the_new_generators_by_the_ports_rule():
    """New tile i's generator is seeded with ``retile_seed(state_seed, t,
    i)``: distinct per tile and per step, the same on every resume, and
    ``load_state`` seeds the live generators with it."""
    _, told = _cfgs(1, 2)
    _, tnew = _cfgs(2, 1)
    st = _patterned_state(told, t=7)
    out = trt.retile_state(st, told.engine.decomp, tnew.engine.decomp,
                           state_seed=2)
    seeds = out["rng"]
    assert len(set(seeds)) == 2
    assert seeds == trt.retile_state(st, told.engine.decomp,
                                     tnew.engine.decomp, 2)["rng"]
    assert trt.retile_seed(2, 8, 0) != seeds[0]
    assert trt.retile_seed(3, 7, 0) != seeds[0]
    live = tde.state_like(tnew, device="cpu")
    tde.load_state(live, out)
    for g, s in zip(live["rng"], seeds):
        want = torch.Generator().manual_seed(s)
        assert torch.equal(torch.rand(4, generator=g),
                           torch.rand(4, generator=want))
    assert (live["t"] == 7).all()


@pytest.mark.parametrize("old_tiles,new_tiles", [((1, 2), (2, 1)),
                                                 ((2, 1), (1, 2))])
def test_retile_places_state_by_global_column_id(old_tiles, new_tiles):
    _, old_cfg = _cfgs(*old_tiles)
    _, new_cfg = _cfgs(*new_tiles)
    old_d, new_d = old_cfg.engine.decomp, new_cfg.engine.decomp
    st = _patterned_state(old_cfg, t=5)
    out = trt.retile_state(st, old_d, new_d)
    gnid = _global_neuron_ids(new_d)
    valid = gnid >= 0
    np.testing.assert_array_equal(out["neuron"]["v"],
                                  np.where(valid, gnid, 0).astype(
                                      np.float32))
    np.testing.assert_array_equal(out["neuron"]["refrac"],
                                  np.where(valid, gnid % 5, 0).astype(
                                      np.int32))
    slots = np.arange(out["i_ring"].shape[2])[None, None, :, None]
    np.testing.assert_array_equal(
        out["i_ring"], np.where(valid[:, :, None, :], 1000.0 * slots
                                + gnid[:, :, None, :], 0.0).astype(
                                    np.float32))
    assert out["t"].shape == (new_d.tiles_y, new_d.tiles_x)
    assert (out["t"] == 5).all()
    want_active = np.stack([
        np.stack([np.repeat(new_d.active_mask(y, x).ravel(), NPC)
                  for x in range(new_d.tiles_x)])
        for y in range(new_d.tiles_y)])
    np.testing.assert_array_equal(out["active"], want_active)
    for k in ("spikes", "events", "dropped"):
        assert not out["metrics"][k].any()
        assert out["metrics"][k].dtype == np.float32
    assert out["neuron"]["v"].dtype == np.float32
    assert out["neuron"]["refrac"].dtype == np.int32
    assert out["t"].dtype == np.int32


def test_retile_identity_roundtrip():
    _, a = _cfgs(1, 2)
    _, b = _cfgs(2, 1)
    st = _patterned_state(a, t=7)
    back = trt.retile_state(
        trt.retile_state(st, a.engine.decomp, b.engine.decomp),
        b.engine.decomp, a.engine.decomp)
    for k in ("v", "c", "refrac"):
        np.testing.assert_array_equal(back["neuron"][k],
                                      st["neuron"][k].numpy())
    np.testing.assert_array_equal(back["i_ring"], st["i_ring"].numpy())
    np.testing.assert_array_equal(back["active"], st["active"].numpy())


def test_retile_config_keeps_everything_but_tiles():
    _, cfg = _cfgs(1, 2)
    new = trt.retile_config(cfg, 2, 1)
    assert new.tiles == (2, 1)
    assert new.engine.decomp.grid == cfg.engine.decomp.grid
    assert new.engine.seed == cfg.engine.seed
    assert new.engine.law == cfg.engine.law


def test_gather_map_rejects_grid_mismatch():
    law = tconn.gaussian_law()
    a = tgrid.TileDecomposition(grid=tgrid.ColumnGrid(3, 3, 4), tiles_y=1,
                                tiles_x=2, radius=law.radius)
    b = tgrid.TileDecomposition(grid=tgrid.ColumnGrid(4, 3, 4), tiles_y=2,
                                tiles_x=1, radius=law.radius)
    with pytest.raises(ValueError, match="grid"):
        trt.neuron_gather_map(a, b)


def test_gather_map_is_bijection_on_logical_neurons():
    _, a = _cfgs(1, 2)
    _, b = _cfgs(2, 1)
    src = trt.neuron_gather_map(a.engine.decomp, b.engine.decomp)
    gnid_old = _global_neuron_ids(a.engine.decomp).reshape(-1)
    np.testing.assert_array_equal(np.sort(src[src >= 0]),
                                  np.sort(np.where(gnid_old >= 0)[0]))


# ---------------------------------------------------------------------------
# synapse relay (the plastic path)
# ---------------------------------------------------------------------------

TGRID = (4, 4, 10)     # divides every tiling here: no padded rows


def _tables(ty, tx, law, plastic):
    jcfg, tcfg = _cfgs(ty, tx, law, grid=TGRID, plastic=plastic)
    jtabs = jde.build_dist_tables(jcfg)[0]
    ttabs = tde.build_dist_tables(tcfg, device="cpu")[0]
    return jcfg, tcfg, jtabs, ttabs


def _assert_tables_equal(jtabs, ttabs):
    for jt, tt in zip(jtabs.tiers(), ttabs.tiers()):
        for k in ("tgt", "w", "dslot", "nnz"):
            assert_bits_equal(np.asarray(jt[k]), tt[k], k)
    assert jtabs.storage.meta() == ttabs.storage.meta()


@pytest.mark.parametrize("law,plastic", [("exponential", False),
                                         ("gaussian", True)])
def test_synapse_stream_and_relay_match_reference(law, plastic):
    """gather_synapse_stream, the gid maps, pack_synapse_stream and
    retile_tables (1x2 -> 2x1 at the analytic caps, and 2x1 -> 1x1 into
    the compressed caps of that relay, as the driver packs), bfloat16
    and float32 weights."""
    jcfg, tcfg, jtabs, ttabs = _tables(1, 2, law, plastic)
    jd, td = jcfg.engine.decomp, tcfg.engine.decomp
    jspec, tspec = jcfg.engine.spec(), tcfg.engine.spec()
    np.testing.assert_array_equal(trt.local_gid_map(td, 0, 1),
                                  jrt.local_gid_map(jd, 0, 1))
    for jb, tb in zip(jspec.halo_bands(), tspec.halo_bands()):
        np.testing.assert_array_equal(
            trt.band_gid_map(td, tb["cols"], 0, 1, tspec.n_exc_per_col),
            jrt.band_gid_map(jd, jb["cols"], 0, 1, jspec.n_exc_per_col))
    ts = trt.gather_synapse_stream(ttabs, td, tspec)
    js = jrt.gather_synapse_stream(jtabs, jd, jspec)
    for k in ("pre", "post", "w", "dslot"):
        assert_bits_equal(js[k], ts[k], k)
    assert len(ts["pre"]) > 0
    j2, t2 = _cfgs(2, 1, law, grid=TGRID, plastic=plastic)
    _assert_tables_equal(
        jrt.retile_tables(jtabs, jd, jspec, j2.engine.decomp,
                          j2.engine.spec()),
        trt.retile_tables(ttabs, td, tspec, t2.engine.decomp,
                          t2.engine.spec()))
    born2 = tde.build_dist_tables(t2, device="cpu")[0]
    j1, t1 = _cfgs(1, 1, law, grid=TGRID, plastic=plastic)
    relay = compress_tables(trt.retile_tables(
        born2, t2.engine.decomp, t2.engine.spec(), t1.engine.decomp,
        t1.engine.spec()))
    _assert_tables_equal(
        jrt.retile_tables(jde.build_dist_tables(j2)[0], j2.engine.decomp,
                          j2.engine.spec(), j1.engine.decomp,
                          j1.engine.spec(), storage=relay.storage),
        trt.retile_tables(born2, t2.engine.decomp, t2.engine.spec(),
                          t1.engine.decomp, t1.engine.spec(),
                          storage=relay.storage))


def test_retile_plastic_matches_reference():
    """The plastic carry (every tier's learned weights, the local
    pre-trace, the post-trace) relaid 1x2 -> 2x1 as the reference
    relays it, bit for bit."""
    jcfg, tcfg, jtabs, ttabs = _tables(1, 2, "gaussian", True)
    rng = np.random.default_rng(3)
    carry = tde.init_dist_plastic_state(tcfg, ttabs)
    for w in carry["w"]:
        w.add_(torch.from_numpy(rng.normal(0, 1e-3, w.shape).astype(
            np.float32)) * (w != 0))
    carry["x_pre"][0].copy_(torch.from_numpy(rng.random(
        carry["x_pre"][0].shape).astype(np.float32)))
    carry["x_post"].copy_(torch.from_numpy(rng.random(
        carry["x_post"].shape).astype(np.float32)))
    jcarry = {"w": [w.numpy() for w in carry["w"]],
              "x_pre": [carry["x_pre"][0].numpy()],
              "x_post": carry["x_post"].numpy()}
    j2, t2 = _cfgs(2, 1, "gaussian", grid=TGRID, plastic=True)
    ref = jrt.retile_plastic(jcarry, jtabs, jcfg.engine.decomp,
                             jcfg.engine.spec(), j2.engine.decomp,
                             j2.engine.spec())
    out = trt.retile_plastic(carry, ttabs, tcfg.engine.decomp,
                             tcfg.engine.spec(), t2.engine.decomp,
                             t2.engine.spec())
    assert len(ref["w"]) == len(out["w"])
    for a, b in zip(ref["w"], out["w"]):
        assert_bits_equal(a, b, "w")
    assert_bits_equal(ref["x_pre"][0], out["x_pre"][0], "x_pre")
    assert_bits_equal(ref["x_post"], out["x_post"], "x_post")


def test_pack_refuses_to_drop_learned_weights():
    _, tcfg, _, ttabs = _tables(1, 2, "gaussian", True)
    td, tspec = tcfg.engine.decomp, tcfg.engine.spec()
    stream = trt.gather_synapse_stream(ttabs, td, tspec)
    small = tspec.storage()
    import dataclasses
    small = dataclasses.replace(small, cap_local=1)
    with pytest.raises(ValueError, match="row capacity"):
        trt.pack_synapse_stream(stream, td, tspec, small)
