"""Port parity: the step's head in one kernel, bit for bit.

The port's step head (``ref.neuron_step_ref``, the plain version of the
``neuron_step`` kernel) reads the ring slot and the drive, runs the
LIF+SFA update, zeroes the slot and packs the delivered rows into a
bitmap.  The reference does the same in its step
(``repro.core.engine.step``: ``i_ring[slot] + drive``, ``lif_sfa_step``,
``i_ring.at[slot].set(0)``) and its compaction
(``repro.kernels.synaptic_accum.compact_events``): on the same state,
slot and drive every output must match exactly, also when more rows
spike than ``active_cap`` lets through.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.neuron import lif_sfa_step as j_lif
from repro.kernels.synaptic_accum import compact_events as j_compact
from repro_torch.core import engine as teng
from repro_torch.kernels import ops, ref
from repro_torch.kernels.neuron_step import n_words, neuron_step

from _torch_parity import (LAWS, assert_bits_equal, configs,
                           reference_drive)


def _inputs(seed: int, n: int, d_ring: int = 8):
    """A mid-run-like state: ring words and drive on the reference's
    grids (multiples of 2^-9 and of 0.5 mV), refractory and inactive
    neurons, and neurons exactly at threshold."""
    rng = np.random.default_rng(seed)
    ring = (rng.integers(-6000, 9000, (d_ring, n)) * 2.0 ** -9
            ).astype(np.float32)
    drive = (rng.poisson(1.62, n) * 0.5).astype(np.float32)
    v = rng.uniform(-5.0, 20.0, n).astype(np.float32)
    c = rng.uniform(0.0, 6.0, n).astype(np.float32)
    refrac = rng.integers(0, 3, n).astype(np.int32)
    active = rng.random(n) < 0.9
    # v_int == theta exactly (v = c = 0, i = theta): must spike
    v[:8], c[:8], refrac[:8], active[:8] = 0.0, 0.0, 0, True
    ring[:, :8], drive[:8] = 20.0, 0.0
    return ring, drive, v, c, refrac, active


def _reference_head(jcfg, ring, drive, v, c, refrac, active, slot, cap):
    """The reference's step head under jit: the LIF update on
    ``i_ring[slot] + drive``, the zeroed slot, and the compaction's
    delivered rows and count."""
    n = v.shape[0]

    @jax.jit
    def head(ring, drive, v, c, refrac, active):
        i_now = ring[slot] + drive
        neuron, spikes = j_lif({"v": v, "c": c, "refrac": refrac}, i_now,
                               jcfg.lif, active)
        idx, n_spk = j_compact(spikes, n, cap)
        return neuron, spikes, ring.at[slot].set(0.0), idx, n_spk

    out = head(*(jnp.asarray(x) for x in (ring, drive, v, c, refrac,
                                          active)))
    return jax.tree_util.tree_map(np.asarray, out)


def _unpack(bits: torch.Tensor, n: int) -> np.ndarray:
    """The rows whose bit is set, ascending."""
    words = bits.numpy().view(np.uint32)
    flags = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    rows = np.nonzero(flags.reshape(-1))[0]
    assert (rows < n).all(), "a bit past the last row is set"
    return rows


@pytest.mark.parametrize("cap_frac", [None, 0.5, 0.0])
@pytest.mark.parametrize("grid,n_per_col,slot,seed", [(4, 30, 3, 0),
                                                      (6, 100, 7, 1)])
def test_step_head_bit_identical_to_reference(grid, n_per_col, slot, seed,
                                              cap_frac):
    """``cap_frac``: None takes the config's ``active_cap``; a fraction
    sets it below this step's spike count (0.0: nothing delivered)."""
    jcfg, tcfg = configs("gaussian", grid=grid, n_per_col=n_per_col)
    n = tcfg.spec().n_local
    ring, drive, v, c, refrac, active = _inputs(seed, n)
    ring_t = torch.from_numpy(ring.copy())
    out = ref.neuron_step_ref(
        ring_t, slot, torch.from_numpy(drive), torch.from_numpy(v),
        torch.from_numpy(c), torch.from_numpy(refrac),
        torch.from_numpy(active),
        active_cap=n, **tcfg.lif.kernel_args())
    n_spk = int(out[5])
    assert 8 <= n_spk < n
    cap = (tcfg.spec().active_cap_local if cap_frac is None
           else int(cap_frac * n_spk))
    ring_t = torch.from_numpy(ring.copy())
    v_t, c_t, r_t, spk_t, bits, count = ref.neuron_step_ref(
        ring_t, slot, torch.from_numpy(drive), torch.from_numpy(v),
        torch.from_numpy(c), torch.from_numpy(refrac),
        torch.from_numpy(active), active_cap=cap,
        **tcfg.lif.kernel_args())
    neuron_j, spk_j, ring_j, idx_j, n_j = _reference_head(
        jcfg, ring, drive, v, c, refrac, active, slot, cap)
    for k, x in (("v", v_t), ("c", c_t), ("refrac", r_t)):
        assert_bits_equal(neuron_j[k], x, k)
    assert_bits_equal(spk_j, spk_t, "spk")
    assert_bits_equal(ring_j, ring_t, "ring")
    assert bits.dtype == torch.int32 and bits.shape == (n_words(n),)
    assert count.dtype == torch.int32 and count.shape == ()
    assert int(count) == int(n_j) == n_spk
    delivered = idx_j[:min(int(n_j), cap)]
    assert np.array_equal(_unpack(bits, n), delivered)
    assert len(delivered) == min(n_spk, cap)


def test_step_head_without_bitmap_counts_spikes():
    _, tcfg = configs("exponential", grid=4, n_per_col=30)
    n = tcfg.spec().n_local
    args = [torch.from_numpy(x) for x in _inputs(2, n)]
    kw = tcfg.lif.kernel_args()
    with_bits = ref.neuron_step_ref(args[0].clone(), 5, *args[1:],
                                    active_cap=10, **kw)
    without = ref.neuron_step_ref(args[0].clone(), 5, *args[1:], **kw)
    assert without[4] is None
    assert without[5].dtype == torch.int32
    for a, b in zip(with_bits[:4] + with_bits[5:], without[:4] + without[5:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_and_ops_route_cpu_to_plain(inplace):
    """On CPU tensors the wrapper and ``ops.neuron_step`` are the plain
    version; ``out=`` / ``inplace`` write the new state into the given
    tensors and leave the values unchanged."""
    _, tcfg = configs("gaussian", grid=4, n_per_col=30)
    n = tcfg.spec().n_local
    ring, drive, v, c, refrac, active = (torch.from_numpy(x)
                                         for x in _inputs(3, n))
    kw = tcfg.lif.kernel_args()
    want = ref.neuron_step_ref(ring.clone(), 2, drive, v, c, refrac, active,
                               active_cap=100, **kw)
    ring_w = ring.clone()
    state = {"v": v.clone(), "c": c.clone(), "refrac": refrac.clone()}
    got_state, spk, bits, count = ops.neuron_step(
        state, ring_w, 2, drive, tcfg.lif, active, active_cap=100,
        inplace=inplace)
    assert (got_state["v"] is state["v"]) == inplace
    for k, x in zip(("v", "c", "refrac"), want[:3]):
        assert torch.equal(got_state[k], x)
    assert torch.equal(spk, want[3]) and torch.equal(bits, want[4])
    assert int(count) == int(want[5])
    assert not ring_w[2].any() and torch.equal(ring_w[3], ring[3])
    got = neuron_step(ring.clone(), 2, drive, v, c, refrac, active,
                      active_cap=100, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    _, tcfg = configs("gaussian", grid=2, n_per_col=16)
    n = tcfg.spec().n_local
    ring, drive, v, c, refrac, active = (torch.from_numpy(x)
                                         for x in _inputs(4, n))
    kw = tcfg.lif.kernel_args()
    bad = [
        (ring, 0, drive, v, c, refrac.to(torch.int64), active),
        (ring, 0, drive[:-1], v, c, refrac, active),
        (ring, 0, drive, v[::2], c[::2], refrac[::2], active[::2]),
        (ring.double(), 0, drive, v, c, refrac, active),
        (ring[:, :-1], 0, drive, v, c, refrac, active),
        (ring, 8, drive, v, c, refrac, active),
        (ring, 0, drive, v, c, refrac, active.to(torch.uint8)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            neuron_step(*args, active_cap=10, **kw)
    with pytest.raises(ValueError):
        neuron_step(ring, 0, drive, v, c, refrac, active, active_cap=-1,
                    **kw)
    with pytest.raises(ValueError):
        neuron_step(ring, 0, drive, v, c, refrac, active, active_cap=3,
                    out=(v, c, refrac.float()), **kw)


@pytest.mark.parametrize("law", LAWS)
def test_run_of_partial_blocks_bit_identical(law):
    """29 steps: three blocks of ``d_ring`` and a tail of five, from
    step 0 and again from step 3 (blocks that start mid-ring): the
    port's raster, state and ring are the reference's."""
    jcfg, tcfg = configs(law, grid=4, n_per_col=30)
    tabs_j = jeng.build_shard_tables(jcfg)
    tabs_t = teng.build_shard_tables(tcfg, device="cpu")
    js = jeng.init_sim_state(jcfg)
    ts = teng.init_sim_state(tcfg, device="cpu")
    for steps in (3, 29):
        drive = reference_drive(jcfg, js, steps)
        js, jraster = jax.jit(lambda s, k=steps: jeng.simulate(
            s, tabs_j, jcfg, k, record_spikes=True))(js)
        ts, traster = teng.simulate(ts, tabs_t, tcfg, steps,
                                    record_spikes=True,
                                    drive=torch.from_numpy(drive),
                                    device="cpu")
        assert_bits_equal(jraster, traster, "raster")
        for k in ("v", "c", "refrac"):
            assert_bits_equal(js["neuron"][k], ts["neuron"][k], k)
        assert_bits_equal(js["i_ring"], ts["i_ring"], "i_ring")
        for k in ("spikes", "events", "dropped"):
            assert_bits_equal(js["metrics"][k], ts["metrics"][k], k)
    assert ts["t"] == 32


def test_plain_and_kernel_paths_agree_above_cap():
    """Both routes of the port's step (fused head + delivery with the
    head's bitmap, and the plain pieces) drop the same spikes."""
    _, tcfg = configs("exponential", grid=4, n_per_col=30, rate_cap_hz=0.5,
                      cap_headroom=1.0, ext_rate_hz=20.0)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    runs = []
    for use_kernels in (True, False):
        cfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
        runs.append(teng.simulate(teng.init_sim_state(cfg, device="cpu"),
                                  tabs, cfg, 30, record_spikes=True,
                                  device="cpu"))
    (fk, rk), (fp, rp) = runs
    assert float(fk["metrics"]["dropped"]) > 0
    assert torch.equal(rk, rp) and torch.equal(fk["i_ring"], fp["i_ring"])
    for k in ("spikes", "events", "dropped"):
        assert torch.equal(fk["metrics"][k], fp["metrics"][k])


def test_capture_tally_counts_replays():
    """Launches counted while a graph is captured go to its tally, not
    to the counts; each replay counts once and adds the tally."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    _build.count_launch("neuron_step")
    with _build.capture_tally() as tally:
        for _ in range(8):
            _build.count_launch("neuron_step")
            _build.count_launch("event_delivery")
    assert tally == {"neuron_step": 8, "event_delivery": 8}
    assert _build.launch_counts() == {"neuron_step": 1}
    for _ in range(3):
        _build.count_replay("step_graph", tally)
    assert _build.launch_counts() == {"neuron_step": 25,
                                      "event_delivery": 24, "step_graph": 3}
    with pytest.raises(RuntimeError):
        with _build.capture_tally():
            raise RuntimeError("capture failed")
    _build.count_launch("lif_step")
    assert _build.launch_counts()["lif_step"] == 1
    _build.reset_launch_counts()
