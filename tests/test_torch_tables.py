"""Dict-form tables and the structures derived from the tiers.

The reference accepts a shard's tables as a ``{"local": ..., "halo":
[...]}`` dict in every mode (its distributed step builds one each
plastic step).  The port's inverse index and run descriptors are cached
on the tier tensors (``core.synapses.inverse_index`` / ``column_runs``),
so the dict form delivers like ``SynapseTables`` and a tier with new
weights (``dict(tier, w=...)``) finds them again.  A run descriptor
follows the weights it is handed (``bind_column_weights``).  The card's
halves of these checks are in ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import engine as teng
from repro_torch.core import stdp as tstdp
from repro_torch.core import synapses as tsyn
from repro_torch.kernels.ref import (compact_events, deliver_rows_ref,
                                     deliver_runs_ref, delivered_flags)
from repro_torch.kernels.synaptic_accum import (bind_column_weights,
                                                build_column_runs)

from _torch_parity import LAWS, assert_bits_equal, configs, reference_drive

STEPS = 60


def _dict_form(tables) -> dict:
    return {"local": tables["local"], "halo": list(tables["halo"])}


@pytest.mark.parametrize("law", LAWS)
def test_dict_form_float32_run_bit_identical(law):
    """Dict-form float32 tables (uncompressed: the plan of a dict comes
    from the spec, as in the reference) through the kernel path's
    fixed-order delivery: rasters, ring and counters equal the
    reference's dict-form run bit for bit."""
    jcfg, tcfg = configs(law, grid=4, n_per_col=30, weight_dtype="float32")
    assert tcfg.use_kernels
    jt = jeng.build_shard_tables(jcfg, compress=False)
    js = jeng.init_sim_state(jcfg)
    drive = reference_drive(jcfg, js, STEPS)
    jdict = _dict_form(jt)
    jfin, jraster = jax.jit(lambda s: jeng.simulate(
        s, jdict, jcfg, STEPS, record_spikes=True))(js)
    tt = teng.build_shard_tables(tcfg, compress=False, device="cpu")
    assert tt["local"]["w"].dtype == torch.float32
    tfin, traster = teng.simulate(
        teng.init_sim_state(tcfg, device="cpu"), _dict_form(tt), tcfg,
        STEPS, record_spikes=True, drive=torch.from_numpy(drive),
        device="cpu")
    assert float(traster.sum()) > 0
    assert_bits_equal(jraster, traster, "raster")
    assert_bits_equal(jfin["i_ring"], tfin["i_ring"], "i_ring")
    for k in ("spikes", "events", "dropped"):
        assert_bits_equal(jfin["metrics"][k], tfin["metrics"][k], k)


@pytest.mark.parametrize("law", LAWS)
def test_dict_tiers_with_new_weights_share_the_index(law):
    """The inverse index is built once for a set of tier tensors: the
    dict form, ``dict(tier, w=...)`` and the ``SynapseTables`` all reach
    the same one.  A plastic run builds it once in ``init_plasticity``,
    and the tables it returns (``with_local_tier``, new weights) find it
    again, with no host rebuild."""
    _, tcfg = configs(law, grid=4, n_per_col=30, weight_dtype="float32")
    tt = teng.build_shard_tables(tcfg, device="cpu")
    builds = tsyn.BUILD_COUNTS["inverse_index"]
    inv = tsyn.inverse_index(tsyn.tier_list(_dict_form(tt)))
    assert tsyn.BUILD_COUNTS["inverse_index"] == builds + 1
    local2 = dict(tt.local, w=tt.local["w"] * 0.5)
    assert tsyn.inverse_index([local2, *tt.halo]) is inv
    assert tt.inverse_index() is inv
    assert tsyn.with_local_tier(tt, local2).inverse_index() is inv
    assert tsyn.inverse_index(tsyn.tier_list(
        tsyn.with_local_tier(_dict_form(tt), local2))) is inv
    assert tsyn.BUILD_COUNTS["inverse_index"] == builds + 1

    pcfg = dataclasses.replace(tcfg, stdp=tstdp.STDPParams())
    pt = teng.build_shard_tables(pcfg, device="cpu")
    builds = tsyn.BUILD_COUNTS["inverse_index"]
    aux = teng.init_plasticity(pt, pcfg)
    (_, pt2, _), _ = teng.simulate(
        teng.init_sim_state(pcfg, device="cpu"), pt, pcfg, 40,
        plasticity=aux, device="cpu")
    assert not torch.equal(pt2["local"]["w"], pt["local"]["w"])
    assert pt2.inverse_index() is aux["inv"]
    assert teng.init_plasticity(pt2, pcfg)["inv"] is aux["inv"]
    assert tsyn.BUILD_COUNTS["inverse_index"] == builds + 1


def test_derived_structures_follow_edits_of_the_structure():
    """An in-place edit of a tier's tgt, dslot or nnz makes a new inverse
    index and new run descriptors (matched by identity and version
    counter), for the tables and for a dict of the same tiers; halo
    tiers count as much as the local one."""
    _, tcfg = configs("exponential", grid=4, n_per_col=30, tiles=2)
    spec = tcfg.spec()
    tt = teng.build_shard_tables(tcfg, 1, 1, device="cpu")
    assert len(tt.halo) >= 1
    runs = tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)
    inv = tt.inverse_index()
    assert tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8) is runs
    builds = dict(tsyn.BUILD_COUNTS)
    tt.halo[0]["dslot"][0, 0] = tt.halo[0]["dslot"][0, 0]   # in place
    runs2 = tsyn.column_runs(tsyn.tier_list(_dict_form(tt)), spec.n_per_col,
                             spec.n_exc_per_col, 8)
    assert runs2 is not runs and runs2[0] is not runs[0]
    assert tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8) is runs2
    assert tt.inverse_index() is not inv
    assert tsyn.BUILD_COUNTS["column_runs"] == builds["column_runs"] + 1
    assert tsyn.BUILD_COUNTS["inverse_index"] == \
        builds["inverse_index"] + 1


def _shuffled(tier, seed):
    """A tier whose rows' valid entries are permuted, so that the
    descriptor delivers from a row-sorted copy (``perm``)."""
    g = torch.Generator().manual_seed(seed)
    cap = tier["tgt"].shape[1]
    valid = torch.arange(cap)[None, :] < tier["nnz"][:, None]
    keys = torch.where(valid, torch.rand(valid.shape, generator=g),
                       torch.full(valid.shape, 2.0))
    order = keys.argsort(1)
    return {k: torch.gather(v, 1, order) if v.dim() == 2 else v
            for k, v in tier.items()}


def _delivery_equal(tier, desc, seed):
    """The descriptor's plain delivery against the row delivery of
    ``tier``'s own weights."""
    rng = np.random.default_rng(seed)
    n_rows = tier["tgt"].shape[0] - 1
    n_local = desc["n_local"]
    spk = torch.from_numpy((rng.random(n_rows) < 0.4).astype(np.float32))
    ring = torch.from_numpy(rng.integers(-300, 300, (8, n_local))
                            * 2.0 ** -9).to(torch.float32)
    ev_a, ev_b = (torch.zeros(1, dtype=torch.int32) for _ in range(2))
    idx, _ = compact_events(spk, n_rows, n_rows)
    ra = deliver_rows_ref(tier, idx, ring.clone(), 3, ev_a)
    rb = deliver_runs_ref(desc, delivered_flags(spk, n_rows, n_rows)[0],
                          ring.clone(), 3, ev_b)
    assert_bits_equal(ra, rb, "ring")
    assert int(ev_a) == int(ev_b)


@pytest.mark.parametrize("permuted", [False, True])
def test_bind_column_weights_refreshes_edited_and_replaced_weights(permuted):
    """A descriptor bound to one weight tensor: an in-place edit and a
    replaced tensor both refresh its ``w`` (the tier's, or the row-sorted
    copy) and ``scale``; binding again unchanged is free (nothing is
    recomputed); the structure is never rebuilt."""
    _, tcfg = configs("gaussian", grid=4, n_per_col=30)
    spec = tcfg.spec()
    tt = teng.build_shard_tables(tcfg, device="cpu")
    tier = _shuffled(tt.local, 4) if permuted else dict(tt.local)
    desc = build_column_runs(tier, spec.n_per_col, spec.n_per_col,
                             spec.n_local)
    assert (desc["perm"] is not None) == permuted
    assert desc["scale"] == 512.0
    structure = {k: desc[k] for k in ("pair_ptr", "runs", "tgt", "perm")}

    def expect_w(w):
        return w if not permuted else torch.gather(w, 1,
                                                   desc["perm"].long())

    assert bind_column_weights(desc, tier) is desc
    w_before = desc["w"]
    assert bind_column_weights(desc, tier)["w"] is w_before   # free

    # in place: doubled (still on the 2^-9 grid, now every weight on 2^-8)
    tier["w"].mul_(2)
    bind_column_weights(desc, tier)
    assert torch.equal(desc["w"], expect_w(tier["w"]))
    assert desc["scale"] == 256.0
    _delivery_equal(tier, desc, 1)

    # replaced: a new tensor, halved (back on the 2^-9 grid)
    w3 = tier["w"] / 2
    tier3 = dict(tier, w=w3)
    bind_column_weights(desc, tier3)
    assert torch.equal(desc["w"], expect_w(w3))
    assert desc["scale"] == 512.0
    _delivery_equal(tier3, desc, 2)
    for k, v in structure.items():
        assert desc[k] is v


def test_bind_column_weights_refuses_weights_past_the_window():
    """Weights whose summed |w| per target times 2^s reaches 2^24 raise,
    at build and on rebinding an edited tier; the descriptor keeps its
    last good binding."""
    _, tcfg = configs("gaussian", grid=4, n_per_col=30)
    spec = tcfg.spec()
    tt = teng.build_shard_tables(tcfg, device="cpu")
    tier = dict(tt.local)
    desc = build_column_runs(tier, spec.n_per_col, spec.n_per_col,
                             spec.n_local)
    w_good = desc["w"]
    big = tier["w"].clone()
    big[0, 0] = 2.0 ** 15          # x 2^9 = 2^24 at its target
    with pytest.raises(ValueError, match="2\\^24"):
        bind_column_weights(desc, dict(tier, w=big))
    assert desc["w"] is w_good and desc["scale"] == 512.0
    with pytest.raises(ValueError, match="2\\^24"):
        build_column_runs(dict(tier, w=big), spec.n_per_col, spec.n_per_col,
                          spec.n_local)
    tier["w"][0, 0] = 2.0 ** 15    # in place
    with pytest.raises(ValueError, match="2\\^24"):
        bind_column_weights(desc, tier)


def test_descriptor_holds_no_reference_to_its_cache_key():
    """Descriptors and index are cached on the tier's nnz tensor and must
    not keep it alive: dropping the tables frees the cache entry."""
    import gc
    _, tcfg = configs("gaussian", grid=4, n_per_col=30)
    spec = tcfg.spec()
    tt = teng.build_shard_tables(tcfg, device="cpu")
    tt.column_runs(spec.n_per_col, spec.n_exc_per_col, 8)
    tt.inverse_index()
    key = id(tt.local["nnz"])
    assert key in tsyn._DERIVED
    del tt
    gc.collect()
    assert key not in tsyn._DERIVED
