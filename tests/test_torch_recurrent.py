"""The port's recurrent families against the JAX reference on the CPU: the
causal conv (with and without its decode carry), the chunk scan, the
mamba and RG-LRU blocks in training, prefill-from-state and one-token
decode, their init distributions, the parameter trees against the
reference's, prefill + 8 decode steps of reduced falcon-mamba-7b and
recurrentgemma-9b (the window and the ring cache), and a prefill split in
two against the one-shot prefill.  Inputs come from numpy seeds; weights
cross through ``model_params_from_arrays``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import layers as jl
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.parallel.sharding import MeshRules
from repro_torch import configs as tconfigs
from repro_torch.core.convert import model_params_from_arrays
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt

from _torch_parity import (assert_states_close, lm_params,
                           port_layer_states, serve_both)

MAMBA, GRIFFIN = "falcon-mamba-7b", "recurrentgemma-9b"
RULES = MeshRules()
F32_TOL = 1e-5               # modules and states in float32
LOGIT_TOL = 1e-4             # whole-model logits in float32
# a prefill split in two against the one-shot prefill (the port alone):
# the same float32 sums, the attention's over another key blocking
SPLIT_TOL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().copy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, tol=F32_TOL, msg=""):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def serve_runs():
    """The reference's and the port's prefill + 8 decode steps, built
    once per (arch, impl) for this file's tests."""
    cache = {}

    def get(arch, impl):
        if (arch, impl) not in cache:
            cache[arch, impl] = serve_both(arch, impl)
        return cache[arch, impl]
    return get


# ---------------------------------------------------------------------------
# the conv and the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 7])
@pytest.mark.parametrize("carry", [False, True])
def test_conv1d_matches_reference(carry, seq):
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq, 24)).astype(np.float32)
    p = {"w": rng.normal(size=(4, 24)).astype(np.float32),
         "b": rng.normal(size=(24,)).astype(np.float32)}
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if carry else None
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    if carry:
        yj, sj = jl.apply_conv1d(pj, jnp.asarray(x), jnp.asarray(st))
        yt, s_t = tl.apply_conv1d(pt, _t(x), _t(st))
        _close(s_t, sj, 0.0, "carry")
    else:
        yj = jl.apply_conv1d(pj, jnp.asarray(x))
        yt = tl.apply_conv1d(pt, _t(x))
    _close(yt, yj)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 17])
def test_diag_scan_chunk_matches_reference(n):
    """The log-depth chunk scan against ``lax.associative_scan``'s: the
    same combine in the same association order."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, size=(2, n, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, n, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jlast, jall = jssm.diag_scan_chunk(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(h0))
    tlast, tall = tssm.diag_scan_chunk(_t(a), _t(b), _t(h0))
    _close(tall, jall)
    _close(tlast, jlast)


def test_associative_scan_equals_the_recurrence():
    """In float64, the scan is the recurrence h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(3)
    for n in (1, 3, 8, 13, 128):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, n, 5)))
        b = torch.from_numpy(rng.normal(size=(2, n, 5)))
        h0 = torch.from_numpy(rng.normal(size=(2, 5)))
        last, h_all = tssm.diag_scan_chunk(a, b, h0)
        h, want = h0, []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(h_all, torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(last, h, rtol=1e-12, atol=1e-12)
        # the carry is a copy: a state holds no chunk's h_all alive
        assert last.untyped_storage().data_ptr() != \
            h_all.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block_params(arch: str, name: str):
    cfg = jget_reduced(arch)
    jp, arrays = lm_params(cfg)
    tree = jp["blocks"][0] if jp["blocks"] else jp["rest"][0]
    stacked = bool(jp["blocks"])
    pj = jax.tree.map(lambda a: a[0] if stacked else a, tree[name])
    pt = jax.tree.map(lambda a: _t(np.asarray(a)), pj)
    return cfg, tconfigs.get_reduced(arch), pj, pt


def _random_state(rng, ref_state):
    return jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.5,
        ref_state)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,name", [(MAMBA, "mamba"), (GRIFFIN, "rglru")])
def test_recurrent_block_matches_reference(arch, name, mode):
    """The mamba and RG-LRU mixers: training (no state; 37 positions, a
    padded tail after two 16-position chunks), a prefill continuing a
    random state (output and new state) and one-token decode."""
    jcfg, tcfg, pj, pt = _block_params(arch, name)
    japply = {"mamba": jssm.apply_mamba, "rglru": jrg.apply_rglru}[name]
    tapply = {"mamba": tssm.apply_mamba, "rglru": trg.apply_rglru}[name]
    jinit = {"mamba": jssm.init_mamba_state,
             "rglru": jrg.init_rglru_state}[name]
    rng = np.random.default_rng(11)
    seq = {"train": 37, "prefill": 21, "decode": 1}[mode]
    x = rng.normal(size=(2, seq, jcfg.d_model)).astype(np.float32)
    st = None
    if mode != "train":
        st = _random_state(rng, jax.tree.map(np.asarray,
                                             jinit(jcfg, 2, jnp.float32)))
    yj, sj = jax.jit(lambda p, x, s: japply(p, jcfg, RULES, x, state=s))(
        pj, jnp.asarray(x), None if st is None else jax.tree.map(
            jnp.asarray, st))
    yt, s_t = tapply(pt, tcfg, _t(x), state=None if st is None else {
        k: _t(v) for k, v in st.items()})
    _close(yt, yj)
    if st is None:
        assert s_t is None and sj is None
    else:
        assert set(s_t) == set(sj)
        for k in sj:
            _close(s_t[k], sj[k], msg=k)
            assert s_t[k].dtype == torch.float32


def test_recurrent_init_distributions():
    """The reference's distributions (not its numbers): mamba's
    ``a_log = log(1..N)`` per channel, ``softplus(dt_bias)`` in [1e-3,
    1e-1], ``d_skip`` ones; RG-LRU's decay at r = 1, ``exp(-8
    softplus(lam))``, in [0.9, 0.999], zero gate biases; those leaves in
    float32 whatever the model's dtype; conv weights of std 1/sqrt(k)."""
    gen = torch.Generator().manual_seed(0)
    mcfg = dataclasses.replace(tconfigs.get_reduced(MAMBA), d_model=256,
                               dtype="bfloat16")
    m = tssm.init_mamba(gen, mcfg, torch.bfloat16)
    n, di = mcfg.ssm_state, mcfg.d_inner
    assert m["a_log"].dtype == m["dt_bias"].dtype == m["d_skip"].dtype \
        == torch.float32
    torch.testing.assert_close(torch.exp(m["a_log"]), torch.arange(
        1, n + 1, dtype=torch.float32).expand(di, n))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.max()) > 0.03 and float(dt.min()) < 3e-3
    assert torch.equal(m["d_skip"], torch.ones(di))
    assert m["in_proj"].dtype == torch.bfloat16
    assert abs(float(m["conv"]["w"].float().std()) * 2 - 1) < 0.05
    assert not m["conv"]["b"].float().any()
    rcfg = dataclasses.replace(tconfigs.get_reduced(GRIFFIN), d_model=1024,
                               dtype="bfloat16")
    r = trg.init_rglru(gen, rcfg, torch.bfloat16)
    decay = torch.exp(-8.0 * torch.nn.functional.softplus(r["lam"]))
    assert r["lam"].dtype == r["b_a"].dtype == r["b_x"].dtype \
        == torch.float32
    assert float(decay.min()) >= 0.9 - 1e-5
    assert float(decay.max()) <= 0.999 + 1e-5
    assert not r["b_a"].any() and not r["b_x"].any()
    assert abs(float(r["w_a"].float().std()) * 32 - 1) < 0.02


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  MAMBA, GRIFFIN])
def test_parameter_tree_is_the_references(arch):
    """Layer by layer, the port's ``init_model`` makes the reference's
    leaves (names, shapes, dtypes at bf16), and its count is
    ``param_count() + param_count_gap()``: the reference's formula is
    off for the recurrent blocks (its own tree holds the same surplus)."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), dtype="bfloat16")
    jp, _ = jt.init_model(jax.random.PRNGKey(0), jcfg)
    ref = model_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    port = tt.init_model(tcfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ref)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), port) == shapes
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    n_port = sum(t.numel() for t in jax.tree.leaves(port))
    assert n_port == n_ref == tcfg.param_count() + tt.param_count_gap(tcfg)
    assert tt.param_count_gap(tcfg) != 0 or arch not in (MAMBA, GRIFFIN)
    # the leaves the reference keeps in float32 cross as float32
    for lp in ref["layers"]:
        for grp in ("moe", "mamba", "rglru"):
            for name in ("router", "dt_bias", "a_log", "d_skip", "b_a",
                         "b_x", "lam"):
                if name in lp.get(grp, {}):
                    assert lp[grp][name].dtype == torch.float32, name


# ---------------------------------------------------------------------------
# the slice: prefill, then teacher-forced decode
# ---------------------------------------------------------------------------

# the reference's "pallas" runs its kernel in interpret mode: one config
RUNS = [(MAMBA, "chunked"), (GRIFFIN, "chunked"), (GRIFFIN, "pallas")]


@pytest.mark.parametrize("arch,impl", RUNS)
def test_recurrent_prefill_and_decode_match_reference(serve_runs, arch,
                                                      impl):
    """20-token prompts (recurrentgemma: past its 16-token window, so the
    ring cache wraps in decode), 8 teacher-forced steps."""
    jl_all, tl_all, _ = serve_runs(arch, impl)
    assert len(jl_all) == 9
    for step, (jlg, tlg) in enumerate(zip(jl_all, tl_all)):
        assert tuple(tlg.shape) == tuple(jlg.shape), step
        np.testing.assert_allclose(_np(tlg), _np(jlg), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")


@pytest.mark.parametrize("when", ["prefill", "final"])
@pytest.mark.parametrize("arch,impl", RUNS)
def test_recurrent_decode_states_match_reference(serve_runs, arch, impl,
                                                 when):
    """Every layer's recurrent state (conv carry, ssm / h) and ring KV
    cache after the prefill and after 8 steps."""
    assert_states_close(*serve_runs(arch, impl)[2][when], F32_TOL)


@pytest.mark.parametrize("arch,impl,first", [
    (MAMBA, "chunked", 13), (GRIFFIN, "chunked", 13),
    (GRIFFIN, "pallas", 21), ("qwen2-1.5b", "pallas", 13),
    ("granite-moe-1b-a400m", "chunked", 13)])
def test_prefill_in_two_parts_equals_one_shot(arch, impl, first):
    """A prefill of the first ``first`` tokens, then one of the rest from
    that state (``cache_pos=first``), gives the one-shot prefill's last
    logits and states: the recurrent layers carry conv and scan state,
    attention attends over the cached keys too (recurrentgemma's ring
    of 16 crossed; qwen2's full cache).  MoE routing depends on the
    tokens routed together; its capacity (256) drops none here."""
    cfg = dataclasses.replace(tconfigs.get_reduced(arch), attn_impl=impl)
    params = tt.init_model(cfg, seed=2, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32))
    prefill = tm.make_prefill(cfg)
    one, st1 = prefill(params, {"tokens": tok},
                       tt.init_decode_state(cfg, 2, 40, device="cpu"))
    st = tt.init_decode_state(cfg, 2, 40, device="cpu")
    _, st = prefill(params, {"tokens": tok[:, :first]}, st)
    x, st2, _ = tt.forward(params, cfg, {"tokens": tok[:, first:]},
                           state=st, cache_pos=first)
    two = tt.logits(params, x[:, -1:])
    _close(two, one, SPLIT_TOL)
    assert_states_close(port_layer_states(st1), port_layer_states(st2),
                        SPLIT_TOL)
    # and decode continues alike from either state
    nxt = torch.argmax(one[:, -1:], dim=-1).to(torch.int32)
    step = tm.make_serve_step(cfg)
    _close(step(params, st2, nxt, 37)[0], step(params, st1, nxt, 37)[0],
           SPLIT_TOL)
