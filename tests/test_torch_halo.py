"""Port parity: the halo exchange of stacked tiles and the band geometry
of the multi-shard tables.

The reference's exchange runs one tile per device under ``shard_map``;
its contract (``tests/test_multidevice.py``) is that every tile's region
is the window of the zero-padded global slab around it.  The port's
stacked exchange is held to that contract directly, for radii below,
equal to and above the tile size, in both modes; the bit-packing, the
band index maps and the analytic import volume are held to the
reference's own functions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import halo as jhalo
from repro_torch.core import dist_engine as tde
from repro_torch.core import halo as thalo

from _torch_parity import LAWS, configs

# (TY, TX, tile_h, tile_w, F, radii)
GEOMETRIES = [
    (4, 2, 3, 3, 5, (1, 3, 4, 7)),
    (1, 3, 2, 4, 2, (1, 2, 5)),
    (2, 2, 3, 3, 1, (3,)),
    (3, 1, 2, 2, 3, (2, 4)),
]
CASES = [(g[:5], r) for g in GEOMETRIES for r in g[5]]


def _slab(ty, tx, th, tw, f, seed=0):
    rng = np.random.default_rng(seed)
    glob = rng.integers(0, 2, size=(ty * th, tx * tw, f)).astype(np.float32)
    tiles = glob.reshape(ty, th, tx, tw, f).transpose(0, 2, 1, 3, 4)
    return glob, np.ascontiguousarray(tiles)


@pytest.mark.parametrize("mode", ["strip", "block"])
@pytest.mark.parametrize("geom,radius", CASES)
def test_exchange_is_the_padded_slab_window(geom, radius, mode):
    ty, tx, th, tw, f = geom
    glob, tiles = _slab(ty, tx, th, tw, f)
    reg = thalo.exchange_halo_2d(torch.from_numpy(tiles), radius=radius,
                                 mode=mode)
    assert reg.shape == (ty, tx, th + 2 * radius, tw + 2 * radius, f)
    pad = np.pad(glob, ((radius, radius), (radius, radius), (0, 0)))
    for y in range(ty):
        for x in range(tx):
            want = pad[y * th:y * th + th + 2 * radius,
                       x * tw:x * tw + tw + 2 * radius]
            assert np.array_equal(want, reg[y, x].numpy()), (y, x)


@pytest.mark.parametrize("geom,radius", CASES[:4])
def test_packed_exchange_gives_the_same_regions(geom, radius):
    ty, tx, th, tw, f = geom
    _, tiles = _slab(ty, tx, th, tw, f, seed=1)
    x = torch.from_numpy(tiles)
    plain = thalo.exchange_halo_2d(x, radius=radius)
    packed = thalo.unpack_bits(thalo.exchange_halo_2d(
        thalo.pack_bits(x), radius=radius, mode="block"), f)
    assert torch.equal(plain, packed)


def test_shift_zero_fills_outside_the_slab():
    x = torch.arange(1, 13, dtype=torch.float32).view(3, 4)
    assert torch.equal(thalo.shift(x, 0, 1)[0], torch.zeros(4))
    assert torch.equal(thalo.shift(x, 0, 1)[1:], x[:2])
    assert torch.equal(thalo.shift(x, 1, -2)[:, :2], x[:, 2:])
    assert torch.equal(thalo.shift(x, 1, -2)[:, 2:], torch.zeros(3, 2))
    assert torch.equal(thalo.shift(x, 0, 3), torch.zeros(3, 4))
    assert thalo.shift(x, 1, 0) is x


@pytest.mark.parametrize("f", [1, 7, 8, 9, 24, 30])
def test_pack_bits_match_reference(f):
    rng = np.random.default_rng(f)
    spk = (rng.random((3, 2, f)) < 0.4).astype(np.float32)
    jp = np.asarray(jhalo.pack_bits(jnp.asarray(spk)))
    tp = thalo.pack_bits(torch.from_numpy(spk))
    assert tp.dtype == torch.uint8 and np.array_equal(jp, tp.numpy())
    assert thalo.packed_width(f) == jhalo.packed_width(f) == jp.shape[-1]
    ju = np.asarray(jhalo.unpack_bits(jnp.asarray(jp), f))
    tu = thalo.unpack_bits(tp, f)
    assert tu.dtype == torch.float32
    assert np.array_equal(ju, tu.numpy()) and np.array_equal(spk, ju)


@pytest.mark.parametrize("mode", ["strip", "block"])
@pytest.mark.parametrize("th,tw,r,payload", [(3, 3, 1, 4), (4, 2, 3, 1),
                                             (2, 5, 10, 155), (8, 8, 3, 124)])
def test_halo_import_bytes_match_reference(th, tw, r, payload, mode):
    assert thalo.halo_import_bytes(th, tw, r, payload, mode) == \
        jhalo.halo_import_bytes(th, tw, r, payload, mode)


def _dist_cfg(law, ty, tx, **kw):
    jcfg, tcfg = configs(law, grid=6, n_per_col=30)
    jd = dataclasses.replace(jcfg.decomp, tiles_y=ty, tiles_x=tx)
    td = dataclasses.replace(tcfg.decomp, tiles_y=ty, tiles_x=tx)
    return (dataclasses.replace(jcfg, decomp=jd),
            tde.DistConfig(engine=dataclasses.replace(tcfg, decomp=td),
                           **kw))


TILINGS = [(1, 2), (2, 1), (2, 2)]


@pytest.mark.parametrize("tiles", TILINGS)
@pytest.mark.parametrize("law", LAWS)
def test_band_geometry_matches_reference(law, tiles):
    jcfg, tcfg = _dist_cfg(law, *tiles)
    js, ts = jcfg.spec(), tcfg.engine.spec()
    jb, tb = js.halo_bands(), ts.halo_bands()
    assert len(tb) == len(jb) > 0
    assert ts.band_caps() == js.band_caps()
    assert np.array_equal(ts.local_positions_in_region(),
                          js.local_positions_in_region())
    for a, b in zip(jb, tb):
        assert np.array_equal(js.band_positions_exc(a),
                              ts.band_positions_exc(b))
        assert np.array_equal(js.band_positions_in_region(a),
                              ts.band_positions_in_region(b))
    assert ts.expected_synapses() == js.expected_synapses()


@pytest.mark.parametrize("mode", ["strip", "block"])
@pytest.mark.parametrize("tiles", TILINGS)
@pytest.mark.parametrize("law", LAWS)
def test_band_maps_are_exchange_then_gather(law, tiles, mode):
    """Gathering through ``band_gather_maps`` equals the reference's two
    stages: the exchange of the excitatory spike blocks, then each
    band's ``band_positions_exc`` gather (and with a pre-trace's extra
    sink column)."""
    _, cfg = _dist_cfg(law, *tiles, halo_mode=mode)
    spec = cfg.engine.spec()
    d = cfg.engine.decomp
    ty, tx = tiles
    n_local, n_per, n_exc = spec.n_local, spec.n_per_col, spec.n_exc_per_col
    rng = np.random.default_rng(3)
    spikes = torch.from_numpy(rng.uniform(0.5, 2.0, (ty, tx, n_local))
                              .astype(np.float32))
    blk = spikes.view(ty, tx, d.tile_h, d.tile_w, n_per)[..., :n_exc]
    region = thalo.exchange_halo_2d(blk, radius=d.radius, mode=mode)
    region = region.reshape(ty * tx, -1)
    src = torch.cat([spikes.reshape(-1), torch.zeros(1)])
    maps = tde.band_gather_maps(cfg, n_local, device="cpu")
    for band, m in zip(spec.halo_bands(), maps):
        want = region[:, torch.from_numpy(spec.band_positions_exc(band))]
        assert m.shape == (ty * tx, band["rows"])
        assert torch.equal(src[m], want)
        # out-of-slab sources read the zero sink
        assert bool((want == 0).any()) == bool((m == src.numel() - 1).any())
    # the pre-trace's layout: one more slot per tile, a sink column
    stride = n_local + 1
    xpre = torch.cat([spikes, torch.zeros(ty, tx, 1)], dim=2)
    src = torch.cat([xpre.reshape(-1), torch.zeros(1)])
    for band, m in zip(spec.halo_bands(), tde.band_gather_maps(
            cfg, stride, sink_column=True, device="cpu")):
        want = region[:, torch.from_numpy(spec.band_positions_exc(band))]
        got = src[m]
        assert torch.equal(got[:, :-1], want)
        assert torch.equal(got[:, -1], torch.zeros(ty * tx))


@pytest.mark.parametrize("mode", ["strip", "block"])
@pytest.mark.parametrize("tiles", TILINGS)
@pytest.mark.parametrize("law", LAWS)
def test_packed_band_maps_equal_unpacked(law, tiles, mode):
    """``DistConfig.pack_spikes`` moves the exchange's payload as packed
    bitmaps (``pack_bits`` -> exchange -> ``unpack_bits``): the maps are
    the unpacked exchange's, value for value."""
    for stride, sink in ((None, False), (1, True)):
        got = []
        for pack in (True, False):
            _, cfg = _dist_cfg(law, *tiles, halo_mode=mode, pack_spikes=pack)
            n = cfg.engine.spec().n_local + (stride or 0)
            got.append(tde.band_gather_maps(cfg, n, sink_column=sink,
                                            device="cpu"))
        assert len(got[0]) == len(got[1]) > 0
        for a, b in zip(*got):
            assert a.dtype == b.dtype == torch.int64
            assert torch.equal(a, b)


@pytest.mark.parametrize("tiles,n_rows,cap,density",
                         [(4, 1000, 40, 0.1), (4, 1000, 2000, 0.5),
                          (3, 33, 5, 0.6), (1, 64, 64, 0.9), (4, 7, 1, 0.0)])
def test_band_bitmaps_for_all_tiles_equal_per_tile(tiles, n_rows, cap,
                                                   density):
    """The halo bands' delivered-row bitmaps, packed for every tile in
    one call, equal one call per tile (drop rule above ``cap`` included)."""
    from repro_torch.kernels.ref import delivered_bits
    rng = np.random.default_rng(n_rows)
    spk = torch.from_numpy((rng.random((tiles, n_rows)) < density)
                           .astype(np.float32))
    bits, counts = delivered_bits(spk, n_rows, cap)
    for i in range(tiles):
        b, c = delivered_bits(spk[i], n_rows, cap)
        assert torch.equal(bits[i], b) and int(counts[i]) == int(c)
