"""The port's attention against the JAX reference: the flash kernel's
plain version (``ops.attention`` on CPU tensors) against the reference's
flash kernel in interpret mode and its ``attention_ref``, and the
attention module (``apply_attention``) in its three modes and three
``attn_impl`` routes.  Inputs come from numpy seeds; weights cross
through ``model_params_from_arrays``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jatt
from repro.parallel.sharding import MeshRules
from repro_torch.configs import get_reduced
from repro_torch.core.convert import model_params_from_arrays
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt

from _torch_parity import lm_params

# the shapes of the reference's own kernel test (tests/test_kernels.py)
CASES = [
    (4, 2, 64, 64, 32, True, None, 0),
    (8, 2, 100, 100, 64, True, 48, 0),
    (2, 2, 37, 129, 16, False, None, 0),
    (2, 1, 1, 77, 32, True, None, 76),
    (3, 3, 48, 16, 8, True, None, 0),
]
RULES = MeshRules(batch=None, fsdp=None, heads=None, mlp=None,
                  experts=None, vocab=None, kv_seq=None, d_inner=None)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _qkv(rng, bh, bhkv, sq, sk, d):
    return (rng.normal(size=(bh, sq, d)).astype(np.float32),
            rng.normal(size=(bhkv, sk, d)).astype(np.float32),
            rng.normal(size=(bhkv, sk, d)).astype(np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win,qoff", CASES)
def test_plain_attention_matches_reference_kernel(bh, bhkv, sq, sk, d,
                                                  causal, win, qoff):
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = _qkv(rng, bh, bhkv, sq, sk, d)
    kw = dict(causal=causal, window=win, q_offset=qoff)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
    j_kernel = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      block_q=32, block_k=32, interpret=True, **kw)
    j_ref = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    for want in (j_kernel, j_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_dtypes(dtype):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 2, 64, 64, 16)
    jq, jk, jv = (jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(_f32(x)).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    got = ops.attention(tq, tk, tv, causal=True)
    assert got.dtype == getattr(torch, dtype)
    want = jflash(jq, jk, jv, causal=True, block_q=32, block_k=32,
                  interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_fully_masked_rows_are_zero():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 1, 8, 8, 8)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False, window=2,
                        q_offset=100)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, window=2, q_offset=100, block_q=8,
                  block_k=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(want), 0.0)


@pytest.mark.parametrize("window", [None, 5])
def test_unrepeated_kv_equals_repeated_kv(window):
    """The port hands the kernel un-repeated KV (GQA by ``bh // group``);
    the reference repeats KV first.  Each query head sees the same keys
    and values, so the results are equal."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 6, 2, 20, 20, 16))
    got = ops.attention(q, k, v, causal=True, window=window)
    rep = ops.attention(q, k.repeat_interleave(3, 0).contiguous(),
                        v.repeat_interleave(3, 0).contiguous(),
                        causal=True, window=window)
    assert torch.equal(got, rep)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(torch.zeros(2, 4, 12), torch.zeros(1, 4, 12),
                      torch.zeros(1, 4, 12))
    with pytest.raises(ValueError, match="dtype"):
        ops.attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="dtype"):
        ops.attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="BH % BH_kv"):
        ops.attention(torch.zeros(3, 4, 16), torch.zeros(2, 4, 16),
                      torch.zeros(2, 4, 16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(torch.zeros(4, 2, 16).transpose(0, 1), k, k)
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q, k, k, q_offset=-1)


def test_cpu_attention_launches_no_kernel():
    _build.reset_launch_counts()
    q = torch.zeros(2, 4, 16)
    ops.attention(q, q, q)
    tref.attention_ref(q, q, q)
    assert _build.launch_counts() == {}
    assert "flash_attention" in _build.SOURCES


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route(dtype, d):
    """bf16 at head_dim 64/128/256 takes the tensor-core kernel, every
    other accepted case the CUDA-core kernel (float32 keeps f32)."""
    from repro_torch.kernels.flash_attention import (ROUTE_KERNELS,
                                                     SM90_HEAD_DIMS, _route)
    want = "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS \
        else "simt"
    assert _route(dtype, d) == want
    assert ROUTE_KERNELS[want] in ("flash_attention", "flash_attention_simt")


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.float64, 128),
                                     (torch.bfloat16, 12),
                                     (torch.bfloat16, 512),
                                     (torch.float32, 0)])
def test_flash_route_refuses(dtype, d):
    from repro_torch.kernels.flash_attention import _route
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        _route(dtype, d)
    assert "flash_attention_sm90" in _build.SOURCES


@pytest.mark.parametrize("d,sq,sk,causal,win,qoff", [
    (64, 40, 40, True, None, 0), (128, 1, 33, True, None, 32),
    (256, 37, 50, False, 9, 0)])
def test_plain_attention_matches_reference_at_sm90_head_dims(d, sq, sk,
                                                             causal, win,
                                                             qoff):
    """The tensor-core route's cases (bf16, head_dim 64/128/256): on the
    CPU the wrapper's plain version against the reference's kernel in
    interpret mode, GQA group 3."""
    rng = np.random.default_rng(d + sq)
    q, k, v = _qkv(rng, 3, 1, sq, sk, d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(_f32(x)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    kw = dict(causal=causal, window=win, q_offset=qoff)
    _build.reset_launch_counts()
    got = ops.attention(tq, tk, tv, **kw)
    assert _build.launch_counts() == {}
    assert got.dtype == torch.bfloat16 and got.shape == (3, sq, d)
    want = jflash(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# module level: apply_attention, reduced configs, float32
# ---------------------------------------------------------------------------

def _layer0(arch: str, impl: str):
    jcfg = dataclasses.replace(jget_reduced(arch), attn_impl=impl)
    tcfg = dataclasses.replace(get_reduced(arch), attn_impl=impl)
    jp, arrays = lm_params(jcfg)
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    jl0 = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    return jcfg, tcfg, jl0, tp["layers"][0]["attn"]


def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=tol, atol=tol)


# "pallas" runs the reference's kernel in interpret mode: one config
@pytest.mark.parametrize("arch,impl", [
    ("qwen2-1.5b", "pallas"), ("qwen2-1.5b", "naive"),
    ("qwen2-1.5b", "chunked"), ("gemma-2b", "naive"),
    ("gemma-2b", "chunked")])
def test_apply_attention_three_modes(arch, impl):
    jcfg, tcfg, jp, tp = _layer0(arch, impl)
    rng = np.random.default_rng(4)
    b, s, total = 2, 40, 48
    x = rng.normal(size=(b, s + 1, tcfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)

    # no cache (train / prefill without state)
    jo, _ = jatt.apply_attention(jp, jcfg, RULES, jnp.asarray(x[:, :s]),
                                 jnp.asarray(pos))
    to, _ = tatt.apply_attention(tp, tcfg, torch.from_numpy(x[:, :s]),
                                 torch.from_numpy(pos))
    _close(to, jo)

    # prefill into a cache, then one decode step
    jc = jatt.init_cache(jcfg, b, total, jnp.float32)
    tc = tatt.init_cache(tcfg, b, total, torch.float32, device="cpu")
    jo, jc = jatt.apply_attention(jp, jcfg, RULES, jnp.asarray(x[:, :s]),
                                  jnp.asarray(pos), cache=jc,
                                  cache_pos=jnp.int32(0))
    to, tc = tatt.apply_attention(tp, tcfg, torch.from_numpy(x[:, :s]),
                                  torch.from_numpy(pos), cache=tc,
                                  cache_pos=0)
    _close(to, jo)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    one = np.array([s], np.int32)
    jo, jc = jatt.apply_attention(jp, jcfg, RULES, jnp.asarray(x[:, s:]),
                                  jnp.asarray(one), cache=jc,
                                  cache_pos=jnp.int32(s))
    to, tc = tatt.apply_attention(tp, tcfg, torch.from_numpy(x[:, s:]),
                                  torch.from_numpy(one), cache=tc,
                                  cache_pos=s)
    _close(to, jo)
    _close(tc.k, jc.k)


@pytest.mark.parametrize("window", [3, 8])
def test_ring_cache_prefill_and_decode(window):
    """Sliding-window attention with a ring-buffered cache (window shorter
    than the sequence): the ring writes and the windowed decode."""
    jcfg, tcfg, jp, tp = _layer0("qwen2-1.5b", "naive")
    rng = np.random.default_rng(5)
    b, s, total = 2, 10, 14
    x = rng.normal(size=(b, s + 2, tcfg.d_model)).astype(np.float32)
    jc = jatt.init_cache(jcfg, b, total, jnp.float32, window=window)
    tc = tatt.init_cache(tcfg, b, total, torch.float32, window=window,
                         device="cpu")
    assert tc.ring and jc.ring and tc.k.shape == jc.k.shape
    pos = np.arange(s, dtype=np.int32)
    jo, jc = jatt.apply_attention(jp, jcfg, RULES, jnp.asarray(x[:, :s]),
                                  jnp.asarray(pos), window=window,
                                  cache=jc, cache_pos=jnp.int32(0))
    to, tc = tatt.apply_attention(tp, tcfg, torch.from_numpy(x[:, :s]),
                                  torch.from_numpy(pos), window=window,
                                  cache=tc, cache_pos=0)
    _close(to, jo)
    _close(tc.k, jc.k)
    for t in range(s, s + 2):
        one = np.array([t], np.int32)
        jo, jc = jatt.apply_attention(
            jp, jcfg, RULES, jnp.asarray(x[:, t:t + 1]), jnp.asarray(one),
            window=window, cache=jc, cache_pos=jnp.int32(t))
        to, tc = tatt.apply_attention(
            tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(one), window=window, cache=tc, cache_pos=t)
        _close(to, jo)
        _close(tc.v, jc.v)


@pytest.mark.parametrize("causal,window,k_valid", [
    (True, None, None), (False, None, 30), (True, 7, None)])
def test_chunked_attention_matches_reference(causal, window, k_valid):
    """The plain chunked forward against the reference's, with ragged
    chunks, a key limit and a window."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 37, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 45, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 45, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, scale=0.3, q_offset=4,
              chunk_q=16, chunk_k=16, k_valid=k_valid)
    got = tatt.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw)
    kk = np.repeat(k, 3, axis=2)
    vv = np.repeat(v, 3, axis=2)
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(kk),
                                  jnp.asarray(vv), **kw)
    _close(got, want)


def test_cross_attention_is_refused():
    _, tcfg, _, tp = _layer0("qwen2-1.5b", "naive")
    x = torch.zeros(1, 4, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tatt.apply_attention(tp, tcfg, x, torch.arange(4), kv_x=x)
