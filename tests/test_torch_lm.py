"""The port's LM serving path against the JAX reference: the layers, the
configurations, the weight converter, prefill + teacher-forced decode
of reduced qwen2-1.5b and gemma-2b, and ``serve_batch``.  Inputs come
from numpy seeds; weights cross through ``model_params_from_arrays``."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as jl
from repro_torch import configs as tconfigs
from repro_torch.core.convert import model_params_from_arrays
from repro_torch.kernels import _build
from repro_torch.launch.serve import serve_batch
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt

from _torch_parity import (assert_bits_equal, assert_states_close,
                           lm_params, serve_both)

ARCHS = ("qwen2-1.5b", "gemma-2b")
F32_TOL = 1e-5       # modules in float32
LOGIT_TOL = 1e-4     # whole-model logits in float32
BF16_TOL = 2e-2      # bfloat16, as the reference's own kernel tests


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().copy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=tol, atol=tol)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.dtype(dtype))
    return j, torch.from_numpy(_f32(j)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_reduced, jget_reduced)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    full = tconfigs.get_config(arch)
    assert full.param_count() == jget_config(arch).param_count()


def test_qwen2_full_width():
    cfg = tconfigs.get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == \
        (28, 1536, 12, 2, 128, 8960, 152064)
    assert cfg.param_count() == 1_543_910_912


def test_unported_architectures_are_refused():
    """All ten architectures resolve; a name outside them is refused by
    the registry, and a block kind the stack does not have by the model
    code."""
    assert set(tconfigs.ARCH_NAMES) == set(J_ARCH_NAMES)
    for get in (tconfigs.get_config, tconfigs.get_reduced,
                tconfigs.shape_cells):
        with pytest.raises(KeyError, match="unknown architecture"):
            get("gpt-2")
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen2-1.5b"),
                              pattern=("conv",))
    with pytest.raises(ValueError, match="unknown block kind"):
        tt.init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown block kind"):
        tt.init_decode_state(cfg, 1, 4, device="cpu")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "falcon-mamba-7b", "recurrentgemma-9b"])
def test_new_families_resolve(arch):
    """The MoE, mamba and RG-LRU families resolve by name, at full width
    and reduced, and their reduced models initialise."""
    full, red = tconfigs.get_config(arch), tconfigs.get_reduced(arch)
    assert full.name == arch
    assert dataclasses.asdict(red) == dataclasses.asdict(jget_reduced(arch))
    assert arch in tconfigs.ARCH_NAMES
    p = tt.init_model(red, device="cpu")
    assert len(p["layers"]) == red.n_layers


# ---------------------------------------------------------------------------
# layers, float32 (and the bfloat16 rounding of the embedding scale)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [True, False])
def test_rmsnorm(offset):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w = rng.normal(size=(48,)).astype(np.float32)
    want = jl.apply_rmsnorm({"scale": jnp.asarray(w)}, jnp.asarray(x),
                            offset=offset)
    got = tl.apply_rmsnorm({"scale": torch.from_numpy(w)},
                           torch.from_numpy(x), offset=offset)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("pos_dims", [1, 2])
def test_rope(theta, pos_dims):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(30, 37, dtype=np.int32)
    if pos_dims == 2:
        pos = np.stack([pos, pos + 100])
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) / math.sqrt(s[0])
         for k, s in (("gate", (48, 96)), ("up", (48, 96)),
                      ("down", (96, 48)))}
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    got = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [False, True])
def test_embedding_and_tied_logits(scale, dtype):
    """The bfloat16 case checks that sqrt(d) is rounded to the working
    dtype before the multiply (as the reference does): bit-equal."""
    rng = np.random.default_rng(3)
    jtab, ttab = _pair(rng.normal(size=(64, 48)), dtype)
    tok = rng.integers(0, 64, (2, 9)).astype(np.int32)
    want = jl.apply_embedding({"table": jtab}, jnp.asarray(tok),
                              scale=scale)
    got = tl.apply_embedding({"table": ttab}, torch.from_numpy(tok),
                             scale=scale)
    assert_bits_equal(want, got, "embedding")
    x = rng.normal(size=(2, 9, 48)).astype(np.float32)
    _close(tl.logits_from_embedding({"table": ttab},
                                    torch.from_numpy(x).to(ttab.dtype)),
           jl.logits_from_embedding({"table": jtab},
                                    jnp.asarray(x, jtab.dtype)),
           F32_TOL if dtype == "float32" else BF16_TOL * 10)


def test_dense():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 48)).astype(np.float32)
    w = rng.normal(size=(48, 20)).astype(np.float32)
    b = rng.normal(size=(20,)).astype(np.float32)
    want = jl.apply_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x))
    got = tl.apply_dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                         torch.from_numpy(x))
    _close(got, want, F32_TOL)


def test_init_distributions():
    """The port draws the reference's distributions (not its numbers):
    zero norm scales and biases, projections with std 1/sqrt(fan-in)."""
    cfg = tconfigs.get_reduced("qwen2-1.5b")
    p = tt.init_model(cfg, seed=3, device="cpu")
    q = tt.init_model(cfg, seed=3, device="cpu")
    assert torch.equal(p["layers"][2]["mlp"]["up"], q["layers"][2]["mlp"]["up"])
    assert len(p["layers"]) == cfg.n_layers
    assert p["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    a = p["layers"][0]["attn"]
    assert not a["bq"].any() and not p["layers"][1]["ln2"]["scale"].any()
    assert abs(float(p["embed"]["table"].std()) - 1.0) < 0.02
    assert abs(float(a["wq"].std()) * math.sqrt(cfg.d_model) - 1.0) < 0.1


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_model_params_keep_bf16_bits():
    jcfg = dataclasses.replace(jget_reduced("qwen2-1.5b"), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen2-1.5b"),
                               dtype="bfloat16")
    jp, arrays = lm_params(jcfg)
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    assert tp["embed"]["table"].dtype == torch.bfloat16
    assert_bits_equal(jp["embed"]["table"], tp["embed"]["table"], "embed")
    for i in range(jcfg.n_layers):
        jb = jax.tree.map(lambda a: a[i], jp["blocks"][0])
        for grp in ("attn", "mlp", "ln1", "ln2"):
            for name, leaf in jb[grp].items():
                assert_bits_equal(leaf, tp["layers"][i][grp][name],
                                  f"layer {i} {grp}.{name}")


def test_model_params_unstack_pattern_positions():
    """Period i of ``blocks[pos]`` is layer ``i * len(pattern) + pos``;
    ``rest`` follows."""
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen2-1.5b"),
                              n_layers=5, pattern=("attn", "attn"))
    mark = lambda v: {"ln1": {"scale": np.full((48,), v, np.float32)}}
    tree = {"embed": {"table": np.zeros((512, 48), np.float32)},
            "ln_f": {"scale": np.zeros((48,), np.float32)},
            "blocks": [{"ln1": {"scale": np.stack([np.full((48,), v,
                                                           np.float32)
                                                   for v in vals])}}
                       for vals in ((0, 2), (1, 3))],
            "rest": [mark(4)]}
    tp = model_params_from_arrays(cfg, tree, device="cpu")
    assert [float(lp["ln1"]["scale"][0]) for lp in tp["layers"]] == \
        [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="layers"):
        model_params_from_arrays(dataclasses.replace(cfg, n_layers=6),
                                 tree, device="cpu")


# ---------------------------------------------------------------------------
# the slice: prefill, then teacher-forced decode
# ---------------------------------------------------------------------------

# the reference's "pallas" runs its kernel in interpret mode: one config
@pytest.mark.parametrize("arch,impl", [
    ("qwen2-1.5b", "pallas"), ("qwen2-1.5b", "chunked"),
    ("gemma-2b", "chunked"), ("gemma-2b", "naive")])
def test_prefill_and_decode_match_reference(arch, impl):
    jl_all, tl_all, states = serve_both(arch, impl)
    assert len(jl_all) == 9
    for step, (jlg, tlg) in enumerate(zip(jl_all, tl_all)):
        assert tuple(tlg.shape) == tuple(jlg.shape), step
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
    assert_states_close(*states["prefill"], F32_TOL)


def test_prefill_and_decode_bf16():
    """bfloat16 logits reach |x| ~ 30, where one bf16 step is 0.125-0.25,
    and the two frameworks round at different places: the tolerance is
    2e-2 of the largest logit (measured: under 1.2e-2 of it)."""
    jl_all, tl_all, _ = serve_both("qwen2-1.5b", "chunked", "bfloat16",
                                   prompt=8, steps=2)
    for step, (jlg, tlg) in enumerate(zip(jl_all, tl_all)):
        assert tlg.dtype == torch.bfloat16
        ref = _f32(jlg)
        err = float(np.abs(_f32(tlg) - ref).max())
        assert err <= BF16_TOL * float(np.abs(ref).max()), (step, err)


def test_pallas_and_naive_paths_agree_on_cpu():
    """On CPU tensors the kernel route is the plain version: the two
    prefill routes give the same logits and launch nothing."""
    cfg = tconfigs.get_reduced("qwen2-1.5b")
    p = tt.init_model(cfg, seed=1, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    _build.reset_launch_counts()
    out = {}
    for impl in ("pallas", "naive"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        out[impl], _ = tm.make_prefill(c)(
            p, {"tokens": tok}, tt.init_decode_state(c, 2, 20, device="cpu"))
    assert torch.equal(out["pallas"], out["naive"])
    assert _build.launch_counts() == {}


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + (
    "granite-moe-1b-a400m", "kimi-k2-1t-a32b", "falcon-mamba-7b",
    "recurrentgemma-9b"))
def test_serve_batch_on_cpu(arch):
    a = serve_batch(arch, batch=2, prompt_len=10, gen=4, seed=5,
                    device="cpu")
    b = serve_batch(arch, batch=2, prompt_len=10, gen=4, seed=5,
                    device="cpu")
    assert set(a) == {"tokens", "prefill_s", "decode_s_per_token", "config"}
    assert a["config"] == jget_reduced(arch).name
    assert a["tokens"].shape == (2, 4) and a["tokens"].dtype == np.int32
    assert ((a["tokens"] >= 0)
            & (a["tokens"] < tconfigs.get_reduced(arch).padded_vocab)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["prefill_s"] > 0 and a["decode_s_per_token"] > 0
    with pytest.raises(NotImplementedError):
        serve_batch(arch, 1, 4, 1, greedy=False, device="cpu")


def test_serve_batch_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_batch("qwen2-1.5b", 1, 4, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.init_model(tconfigs.get_reduced("qwen2-1.5b"))
