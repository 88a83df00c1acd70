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
    for d in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            ops.attention(torch.zeros(2, 4, d), torch.zeros(1, 4, d),
                          torch.zeros(1, 4, d))
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
    assert {"flash_attention_sm90", "flash_attention_tf32"} <= set(
        _build.SOURCES)


@pytest.mark.parametrize("d", [8, 12, 16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route(dtype, d):
    """At every head_dim bf16 takes the bf16 tensor-core kernel and
    float32 the 3xTF32 tensor-core kernel; no width takes the CUDA-core
    kernel.  A width the route's kernel is not built for is padded to the
    next one it is (8, 12 -> 16; 112 -> 128)."""
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     ROUTE_HEAD_DIMS,
                                                     ROUTE_KERNELS, _route,
                                                     padded_head_dim)
    want = "sm90" if dtype == torch.bfloat16 else "tf32"
    assert _route(dtype, d) == want
    assert ROUTE_KERNELS[want] in ("flash_attention", "flash_attention_tf32")
    assert padded_head_dim(want, d) == {8: 16, 12: 16, 112: 128}.get(d, d)
    assert padded_head_dim(want, d) in ROUTE_HEAD_DIMS[want]
    assert padded_head_dim(want, d) in HEAD_DIMS


# head widths the routes pad: 1, 8 (reduced kimi-k2, internvl), 12
# (reduced qwen2.5-3b, whisper), 20 and 112 (kimi-k2); (bh, bh_kv, sq,
# sk, causal, window, q_offset)
PAD_CASES = [(6, 2, 40, 40, True, None, 0), (4, 1, 33, 50, True, 9, 17),
             (2, 2, 19, 27, False, None, 0)]
# padded against unpadded plain version: the same sums with zero terms
# added, in another blocking of the CPU's float32 dot products
PAD_TOL = {"float32": 1e-6, "bfloat16": 1e-6}


# each width padded on each route (both build 16, 32, 128)
PAD_WIDTHS = {"bfloat16": {1: 16, 8: 16, 12: 16, 20: 32, 112: 128},
              "float32": {1: 16, 8: 16, 12: 16, 20: 32, 112: 128}}


@pytest.mark.parametrize("case", PAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 8, 12, 20, 112])
def test_padded_head_equals_plain_version(d, dtype, case):
    """``with_padded_head`` (the CUDA route's zero padding to the route's
    width, the true width's scale, the output sliced back) around the
    plain version equals the plain version on the unpadded inputs:
    outputs and the row statistic, within ``PAD_TOL`` of |value| + 1."""
    from repro_torch.kernels.flash_attention import (_route,
                                                     padded_head_dim,
                                                     with_padded_head)
    bh, bhkv, sq, sk, causal, win, qoff = case
    rng = np.random.default_rng(d + sq)
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _qkv(rng, bh, bhkv, sq, sk, d))
    route = _route(q.dtype, d)
    assert padded_head_dim(route, d) == PAD_WIDTHS[dtype][d]
    kw = dict(causal=causal, window=win, q_offset=qoff, return_lse=True)
    got, got_l = with_padded_head(tref.attention_ref, route, q, k, v, **kw)
    want, want_l = tref.attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    tol = PAD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got_l, want_l, rtol=tol, atol=tol)
    # the caller's scale is kept
    got2 = with_padded_head(tref.attention_ref, route, q, k, v, scale=0.3,
                            causal=causal, window=win, q_offset=qoff)
    torch.testing.assert_close(got2.float(), tref.attention_ref(
        q, k, v, scale=0.3, causal=causal, window=win,
        q_offset=qoff).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [1, 8, 12, 20, 112])
def test_wrapper_takes_any_head_dim_on_cpu(d):
    """The wrapper takes D 1-256 and on CPU tensors is the plain version,
    unpadded, launching nothing; against the reference's kernel in
    interpret mode, which takes any D too."""
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, 4, 2, 24, 24, d)
    _build.reset_launch_counts()
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=10)
    assert _build.launch_counts() == {}
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=10, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["float32"],
                               atol=TOL["float32"])


# ---------------------------------------------------------------------------
# the TF32 route's arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

def _emulate_tf32(q, k, v, *, products, causal=True, window=None,
                  q_offset=0, scale=None):
    """The TF32 kernel's arithmetic: K and V^T from the pre-pass's plain
    version (``tref.tf32_split_ref``, V^T in its key order), Q and P
    split by ``tref.tf32_split``, ``products`` TF32 products per matmul
    (3: hi hi + hi lo + lo hi; 1: hi hi) summed exactly (float64) and
    rounded to float32, P V over the permuted keys; softmax in float32;
    scores scaled by ``scale`` (``1/sqrt(D)`` when None)."""
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    group = bh // bhkv
    k_split, vt_split = tref.tf32_split_ref(k, v)
    sk_pad = k_split.shape[2]
    perm = ((torch.arange(sk_pad) // 8 * 8).view(-1, 8)
            + torch.tensor(tref.TF32_KEY_ORDER)).view(-1)
    pairs = [(0, 0), (0, 1), (1, 0)][:products]

    def mm(eq, a, b):
        return sum(torch.einsum(eq, a[i].double(), b[j].double())
                   for i, j in pairs).to(torch.float32)

    kp = [x.repeat_interleave(group, 0) for x in k_split]
    vp = [x.repeat_interleave(group, 0) for x in vt_split]
    s = mm("bqd,bkd->bqk", tref.tf32_split(q), kp) * (
        scale if scale is not None else 1.0 / np.sqrt(d))
    q_pos = q_offset + torch.arange(sq)[:, None]
    k_pos = torch.arange(sk_pad)[None, :]
    live = (k_pos < sk) & (q_pos >= 0)
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= (q_pos - k_pos) < window
    s = s.masked_fill(~live[None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    o = mm("bqk,bdk->bqd", tref.tf32_split(p[..., perm].contiguous()), vp)
    return torch.where(l > 0, o / l, torch.zeros_like(o))


TF32_CASES = [                     # (bh, bh_kv, sq, sk, d, causal, window)
    (4, 2, 96, 96, 64, True, None),
    (4, 2, 96, 96, 64, True, 40),
    (6, 2, 80, 100, 128, True, None),
    (6, 2, 80, 100, 128, False, 33),
    # the narrow heads: D 32 and 16, and D 8 and 20 padded to 16 and 32
    (4, 2, 96, 96, 32, True, None),
    (6, 2, 80, 100, 32, False, 33),
    (4, 2, 96, 96, 16, True, 40),
    (6, 3, 80, 100, 8, True, None),
    (4, 4, 70, 90, 20, True, 25),
]


@pytest.mark.parametrize("bh,bhkv,sq,sk,d,causal,win", TF32_CASES)
def test_3xtf32_emulation_holds_float32_tolerance(bh, bhkv, sq, sk, d,
                                                  causal, win):
    """Three TF32 products per matmul (the TF32 kernel's design) hold the
    float32 tolerance against the reference's flash kernel, causal and
    windowed, GQA; a head of a width the route is not built for goes
    through its zero padding (``with_padded_head``) first, as on the
    card."""
    from repro_torch.kernels.flash_attention import (padded_head_dim,
                                                     with_padded_head)
    rng = np.random.default_rng(bh * 100 + d + (win or 0))
    q, k, v = _qkv(rng, bh, bhkv, sq, sk, d)
    kw = dict(causal=causal, window=win)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=32, block_k=32, interpret=True, **kw)

    def emulate(q, k, v, **kw):
        return _emulate_tf32(q, k, v, products=3, **kw)
    assert padded_head_dim("tf32", d) == {8: 16, 20: 32}.get(d, d)
    got = with_padded_head(emulate, "tf32", torch.from_numpy(q),
                           torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["float32"],
                               atol=TOL["float32"])


def test_one_tf32_product_misses_float32_tolerance():
    """One TF32 product per matmul does not hold the float32 tolerance
    (the reason the kernel takes three)."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 4, 2, 128, 128, 128)
    want = _f32(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_q=32, block_k=32, interpret=True, causal=True))
    one = _f32(_emulate_tf32(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), products=1))
    three = _f32(_emulate_tf32(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), products=3))
    tol = TOL["float32"]
    assert not np.allclose(one, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(three, want, rtol=tol, atol=tol)
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()


@pytest.mark.parametrize("sk", [1, 64, 77, 130])
def test_tf32_split_plain_version(sk):
    """The pre-pass's plain version: hi and lo are TF32 values (low 13
    bits 0) that sum to x within 2^-21 of it, rounded to nearest with
    ties away from zero; V^T holds each group of 8 keys in
    ``TF32_KEY_ORDER``; keys past Sk are 0; Sk_pad is a multiple of
    ``TF32_KEY_PAD``."""
    rng = np.random.default_rng(sk)
    k = torch.from_numpy(rng.normal(size=(3, sk, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, sk, 64)).astype(np.float32))
    ks, vts = tref.tf32_split_ref(k, v)
    pad = max(-(-sk // tref.TF32_KEY_PAD), 1) * tref.TF32_KEY_PAD
    assert ks.shape == (2, 3, pad, 64) and vts.shape == (2, 3, 64, pad)
    for x in (ks, vts):
        assert not bool((x.view(torch.int32) & 0x1FFF).any())
    err = (ks[0, :, :sk] + ks[1, :, :sk] - k).abs()
    assert bool((err <= k.abs() * 2.0 ** -21).all())
    assert not ks[:, :, sk:].any()
    for j in range(pad):
        key = j // 8 * 8 + tref.TF32_KEY_ORDER[j % 8]
        want = tref.tf32_split(v[:, key]) if key < sk else (0, 0)
        for part in range(2):
            assert torch.equal(vts[part, :, :, j],
                               torch.as_tensor(want[part]).expand(3, 64))
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert tref.tf32_round(ties).tolist() == [1 + 2.0 ** -10,
                                              -(1 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.float64, 128),
                                     (torch.bfloat16, 257),
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
    """Cross-attention where it is undefined: a cross cache that does not
    hold every encoder position (or is a ring), and a static read
    (``update_cache=False``) with no cache."""
    _, tcfg, _, tp = _layer0("qwen2-1.5b", "naive")
    x = torch.zeros(1, 4, tcfg.d_model)
    short = tatt.init_cache(tcfg, 1, 3, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="encoder positions"):
        tatt.apply_attention(tp, tcfg, x, torch.arange(4), kv_x=x,
                             cache=short, cache_pos=0)
    ring = tatt.init_cache(tcfg, 1, 8, torch.float32, window=4,
                           device="cpu")
    with pytest.raises(ValueError, match="encoder positions"):
        tatt.apply_attention(tp, tcfg, x, torch.arange(4), kv_x=x,
                             cache=ring, cache_pos=0)
    with pytest.raises(ValueError, match="static cross cache"):
        tatt.apply_attention(tp, tcfg, x, torch.arange(4),
                             update_cache=False)
