"""Port parity: the LIF+SFA update, bit for bit.

The reference's jitted ``lif_sfa_step`` is compiled by XLA, which
contracts its multiply-adds into fused multiply-adds; the port's plain
version (float64-evaluated FMAs rounded once to float32) and its CUDA
kernel (``__fmaf_rn``) compute the same, so v, c, refrac and the spike
vector must match exactly -- including refractory, inactive and
``v == theta`` neurons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.neuron import LIFParams as JLIF
from repro.core.neuron import lif_sfa_step as j_lif
from repro_torch.core.neuron import LIFParams, lif_sfa_step
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lif_step import lif_step

from _torch_parity import assert_bits_equal


def _inputs(seed: int, n: int = 8192):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-15.0, 25.0, n).astype(np.float32)
    c = rng.uniform(0.0, 6.0, n).astype(np.float32)
    refrac = rng.integers(0, 4, n).astype(np.int32)
    # ring + drive currents are whole multiples of 2^-9 (bf16 weights)
    i = (rng.integers(-6000, 6000, n) * 2.0 ** -9).astype(np.float32)
    active = rng.random(n) < 0.9
    # edges: v_int == theta exactly (v = c = 0, i = theta), the same but
    # refractory, the same but inactive, and a huge input while refractory
    theta = np.float32(LIFParams().theta_mv)
    v[:12], c[:12], i[:12] = 0.0, 0.0, theta
    refrac[:4], refrac[4:8], active[8:12] = 0, 2, False
    active[:8] = True
    refrac[12:16], i[12:16] = 3, 1e3
    return v, c, refrac, i, active


def _reference(v, c, refrac, i, active, params=JLIF()):
    fn = jax.jit(lambda s, x, a: j_lif(s, x, params, a))
    st = {"v": jnp.asarray(v), "c": jnp.asarray(c),
          "refrac": jnp.asarray(refrac)}
    out, spk = fn(st, jnp.asarray(i), jnp.asarray(active))
    return out, spk


def _port_state(v, c, refrac):
    return {"v": torch.from_numpy(v), "c": torch.from_numpy(c),
            "refrac": torch.from_numpy(refrac)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lif_bit_identical_to_jitted_reference(seed):
    v, c, refrac, i, active = _inputs(seed)
    out_j, spk_j = _reference(v, c, refrac, i, active)
    out_t, spk_t = lif_sfa_step(_port_state(v, c, refrac),
                                torch.from_numpy(i), LIFParams(),
                                torch.from_numpy(active))
    for k in ("v", "c", "refrac"):
        assert out_t[k].dtype == {"v": torch.float32, "c": torch.float32,
                                  "refrac": torch.int32}[k]
        assert_bits_equal(out_j[k], out_t[k], k)
    assert_bits_equal(spk_j, spk_t, "spk")
    s = spk_t.numpy()
    assert s[:4].all() and not s[4:12].any() and not s[12:16].any()


def test_lif_without_active_mask_matches():
    v, c, refrac, i, _ = _inputs(5)
    out_j, spk_j = _reference(v, c, refrac, i, np.ones_like(v, bool))
    out_t, spk_t = lif_sfa_step(_port_state(v, c, refrac),
                                torch.from_numpy(i), LIFParams())
    assert_bits_equal(out_j["v"], out_t["v"], "v")
    assert_bits_equal(spk_j, spk_t, "spk")


def test_eager_unfused_formula_would_differ():
    """Guards the premise: evaluating the formula without fused
    multiply-adds does not give the reference's bits."""
    v, c, refrac, i, active = _inputs(7)
    out_j, _ = _reference(v, c, refrac, i, active)
    p = LIFParams()
    eager = (torch.from_numpy(v) * np.float32(p.leak_decay)
             + torch.from_numpy(i)
             - np.float32(p.g_sfa) * torch.from_numpy(c))
    free = (refrac == 0) & ~((eager.numpy() >= 20.0) & active)
    assert (np.asarray(out_j["v"])[free] != eager.numpy()[free]).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_wrapper_and_ops_route_cpu_to_plain(seed):
    v, c, refrac, i, active = _inputs(seed, 2048)
    args = (torch.from_numpy(v), torch.from_numpy(c),
            torch.from_numpy(refrac), torch.from_numpy(i),
            torch.from_numpy(active))
    kw = LIFParams().kernel_args()
    want = ref.lif_step_ref(*args, **kw)
    got = lif_step(*args, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    st, spk = ops.lif_step(_port_state(v, c, refrac), args[3], LIFParams(),
                           args[4])
    assert torch.equal(st["v"], want[0]) and torch.equal(spk, want[3])


def test_wrapper_rejects_bad_inputs():
    v, c, refrac, i, active = (torch.from_numpy(x) for x in _inputs(0, 64))
    kw = LIFParams().kernel_args()
    with pytest.raises(ValueError):
        lif_step(v, c, refrac.to(torch.int64), i, active, **kw)
    with pytest.raises(ValueError):
        lif_step(v, c, refrac, i[:32], active, **kw)
    with pytest.raises(ValueError):
        lif_step(v[::2], c[::2], refrac[::2], i[::2], active[::2], **kw)


def test_kernel_args_are_float32_constants():
    kw = LIFParams().kernel_args()
    for k in ("leak_decay", "sfa_decay", "neg_g_dt", "theta"):
        assert kw[k] == float(np.float32(kw[k]))
    assert kw["neg_g_dt"] == -float(np.float32(0.025))
    assert kw["refrac_steps"] == 2
