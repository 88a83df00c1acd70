"""The port's encoder-decoder (whisper-small) and VLM (internvl2-26b)
families against the JAX reference, at their reduced configs in float32:
``sinusoidal_positions``, the stub frontends, cross-attention, the
stateless forward (the loss's path), prefill + teacher-forced decode;
and the port's own contracts: the two-part prefill, the parameter
counts, the converter's new leaves and ``serve_batch``.  Inputs come
from numpy seeds; weights cross through ``model_params_from_arrays``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import attention as jatt
from repro.models import frontends as jfe
from repro.models import layers as jl
from repro.models import model as jm
from repro.models import transformer as jt
from repro.parallel.sharding import MeshRules
from repro_torch import configs as tconfigs
from repro_torch.core.convert import model_params_from_arrays
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tatt
from repro_torch.models import frontends as tfe
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt

from _torch_parity import (assert_bits_equal, assert_states_close,
                           frontend_inputs, lm_params, port_cross_states,
                           port_layer_states, serve_both)

ARCHS = ("whisper-small", "internvl2-26b")
SIN_TOL = 1e-6       # sinusoidal positions, float32
F32_TOL = 1e-5       # modules and caches in float32
LOGIT_TOL = 1e-4     # whole-model logits in float32
# parameters of the reference's trees (``abstract_model``), and the
# formula's count, at the published widths
FULL_PARAMS = {"whisper-small": (294_959_616, 294_762_240),
               "internvl2-26b": (19_294_918_656, 19_293_345_792)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().copy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_f32(port), _f32(ref), rtol=tol, atol=tol)


def _models(arch: str, impl: str = "chunked"):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced ``arch``, the port's weights the reference's."""
    jcfg = dataclasses.replace(jget_reduced(arch), attn_impl=impl)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), attn_impl=impl)
    jp, arrays = lm_params(jcfg)
    return jcfg, tcfg, jp, model_params_from_arrays(tcfg, arrays,
                                                    device="cpu")


def _inputs(cfg, batch: int, prompt: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(
        np.int32)
    return {"tokens": tokens, **frontend_inputs(cfg, rng, batch)}


def _both(arrays: dict):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# configurations and parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_resolve_and_equal_the_reference(arch):
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_reduced, jget_reduced)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    assert arch in tconfigs.ARCH_NAMES
    assert len(tconfigs.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_gaps(arch):
    """The port's trees hold what the reference's hold: the formula plus
    ``param_count_gap`` (the frontend's adapter and the encoder's final
    norm), at the published widths (the reference's ``abstract_model``)
    and at the reduced ones (both packages' initialised trees)."""
    full = tconfigs.get_config(arch)
    held, formula = FULL_PARAMS[arch]
    shapes, _ = jt.abstract_model(jget_config(arch))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == held
    assert full.param_count() == formula
    assert full.param_count() + tt.param_count_gap(full) == held
    red = tconfigs.get_reduced(arch)
    jp, _ = jt.init_model(jax.random.PRNGKey(0), jget_reduced(arch))
    tp = tt.init_model(red, device="cpu")
    n_port = sum(t.numel() for t in _leaves(tp))
    assert n_port == sum(a.size for a in jax.tree.leaves(jp))
    assert n_port == red.param_count() + tt.param_count_gap(red)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_carries_the_new_leaves(arch):
    """``enc_blocks`` unstacks into ``enc_layers``; ``enc_ln_f``,
    ``frontend.adapter`` and each decoder layer's ``cross`` / ``ln_x``
    cross bit for bit; the converted tree has ``init_model``'s
    structure and shapes."""
    jcfg, tcfg, jp, tp = _models(arch)
    assert _shapes(tp) == _shapes(tt.init_model(tcfg, device="cpu"))
    assert_bits_equal(jp["frontend"]["adapter"],
                      tp["frontend"]["adapter"], "adapter")
    if jcfg.encoder_layers:
        assert len(tp["enc_layers"]) == jcfg.encoder_layers
        assert_bits_equal(jp["enc_ln_f"]["scale"], tp["enc_ln_f"]["scale"],
                          "enc_ln_f")
        for i in range(jcfg.encoder_layers):
            for grp in ("attn", "mlp", "ln1", "ln2"):
                for name, leaf in jp["enc_blocks"][grp].items():
                    assert_bits_equal(leaf[i], tp["enc_layers"][i][grp][name],
                                      f"encoder {i} {grp}.{name}")
        with pytest.raises(ValueError, match="encoder layers"):
            model_params_from_arrays(
                dataclasses.replace(tcfg, encoder_layers=5),
                jax.tree.map(np.asarray, jp), device="cpu")
    else:
        assert "enc_layers" not in tp and "enc_ln_f" not in tp
    for i in range(jcfg.n_layers):
        jb = jax.tree.map(lambda a: a[i], jp["blocks"][0])
        grps = ("cross", "ln_x") if jcfg.cross_attn else ()
        assert ("cross" in tp["layers"][i]) == bool(jcfg.cross_attn)
        for grp in grps:
            assert set(jb[grp]) == set(tp["layers"][i][grp])
            for name, leaf in jb[grp].items():
                assert_bits_equal(leaf, tp["layers"][i][grp][name],
                                  f"layer {i} {grp}.{name}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("offset", [None, 0, 93])
def test_sinusoidal_positions(d, offset):
    if offset is None:
        want = jl.sinusoidal_positions(128, d)
        got = tl.sinusoidal_positions(128, d, device="cpu")
    else:
        pos = offset + np.arange(35, dtype=np.int32)
        want = jl.sinusoidal_positions(jnp.asarray(pos), d)
        got = tl.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, SIN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontends(arch):
    assert tfe.STUB_WIDTH == jfe.STUB_WIDTH
    jcfg, _, jp, tp = _models(arch)
    x = np.random.default_rng(4).standard_normal(
        (2, 12, tfe.STUB_WIDTH)).astype(np.float32)
    _close(tfe.apply_audio_frontend(tp["frontend"], torch.from_numpy(x)),
           jfe.apply_audio_frontend(jp["frontend"], jnp.asarray(x)),
           F32_TOL)
    _close(tfe.apply_patch_frontend(tp["frontend"], torch.from_numpy(x)),
           jfe.apply_patch_frontend(jp["frontend"], jnp.asarray(x)),
           F32_TOL)


def _cross_case(impl: str):
    jcfg, tcfg, jp, tp = _models("whisper-small", impl)
    jpa, tpa = jp["blocks"][0]["cross"], tp["layers"][1]["cross"]
    jpa = jax.tree.map(lambda a: a[1], jpa)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jcfg.encoder_seq,
                               jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jpa, tpa, x, enc


@pytest.mark.parametrize("impl", ["chunked", "naive", "pallas"])
@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_cross_attention_matches_reference(mode, impl):
    """Cross-attention over the encoder's output (no cache; prefill,
    which writes the cross cache) and decode over the static cache,
    against the reference's ``apply_attention(kv_x=...)`` (its "pallas"
    is the chunked route here: the kernel is covered by the model tests
    and the card)."""
    jcfg, tcfg, jpa, tpa, x, enc = _cross_case(impl)
    jcfg = dataclasses.replace(jcfg, attn_impl="chunked"
                               if impl == "pallas" else impl)
    rules = MeshRules()
    pos = np.arange(20, dtype=np.int32)
    shape = (2, jcfg.encoder_seq, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    jcache = jatt.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    tcache = tatt.KVCache(torch.zeros(shape), torch.zeros(shape))
    if mode == "no_cache":
        want, _ = jatt.apply_attention(jpa, jcfg, rules, jnp.asarray(x),
                                       jnp.asarray(pos),
                                       kv_x=jnp.asarray(enc))
        got, _ = tatt.apply_attention(tpa, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos),
                                      kv_x=torch.from_numpy(enc))
    else:
        want, jcache = jatt.apply_attention(
            jpa, jcfg, rules, jnp.asarray(x), jnp.asarray(pos),
            kv_x=jnp.asarray(enc), cache=jcache,
            cache_pos=jnp.zeros((), jnp.int32))
        got, tcache = tatt.apply_attention(
            tpa, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
            kv_x=torch.from_numpy(enc), cache=tcache, cache_pos=0)
        _close(tcache.k, jcache.k, F32_TOL)
        _close(tcache.v, jcache.v, F32_TOL)
        if mode == "decode":
            x1, p1 = x[:, :1], np.array([20], np.int32)
            want, _ = jatt.apply_attention(jpa, jcfg, rules,
                                           jnp.asarray(x1), jnp.asarray(p1),
                                           cache=jcache, update_cache=False)
            got, _ = tatt.apply_attention(tpa, tcfg, torch.from_numpy(x1),
                                          torch.from_numpy(p1),
                                          cache=tcache, update_cache=False)
    assert tuple(got.shape) == want.shape
    _close(got, want, F32_TOL)


def test_continued_cross_attention_reads_the_whole_cache():
    """A chunk continued without the encoder's input (S > 1, static
    cache) attends over every cached key, non-causally: the same values
    as the chunk's queries over the encoder's output itself."""
    _, tcfg, _, tpa, x, enc = _cross_case("chunked")
    shape = (2, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    cache = tatt.KVCache(torch.zeros(shape), torch.zeros(shape))
    xt, et = torch.from_numpy(x), torch.from_numpy(enc)
    pos = torch.arange(20)
    whole, _ = tatt.apply_attention(tpa, tcfg, xt, pos, kv_x=et,
                                    cache=cache, cache_pos=0)
    part, _ = tatt.apply_attention(tpa, tcfg, xt[:, 5:], pos[5:] + 40,
                                   cache=cache, update_cache=False)
    torch.testing.assert_close(part, whole[:, 5:], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the slice: the stateless forward, prefill + teacher-forced decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_state_matches_reference(arch):
    """The loss's path: no state, the VLM's prefix rows sliced off, the
    encoder run on the frames; hidden states and ``loss_fn``."""
    jcfg, tcfg, jp, tp = _models(arch)
    arrays = _inputs(jcfg, 2, 24)
    arrays["labels"] = np.roll(arrays["tokens"], -1, axis=1)
    arrays["labels"][:, -3:] = -1
    jb, tb = _both(arrays)
    rules = MeshRules()
    want, _, _ = jt.forward(jp, jcfg, rules, jb)
    with torch.no_grad():
        got, state, _ = tt.forward(tp, tcfg, tb)
    assert tuple(got.shape) == (2, 24, jcfg.d_model) == want.shape
    assert state == {"layers": [None] * jcfg.n_layers}
    _close(got, want, LOGIT_TOL)
    jloss, jmet = jm.loss_fn(jp, jcfg, rules, jb)
    with torch.no_grad():
        tloss, tmet = tm.loss_fn(tp, tcfg, tb)
    _close(tloss, jloss, F32_TOL)
    assert int(tmet["tokens"]) == int(jmet["tokens"])


# the reference's "pallas" runs its kernel in interpret mode: one config
@pytest.mark.parametrize("arch,impl", [
    ("whisper-small", "pallas"), ("whisper-small", "chunked"),
    ("whisper-small", "naive"), ("internvl2-26b", "chunked"),
    ("internvl2-26b", "naive")])
def test_prefill_and_decode_match_reference(arch, impl):
    """Prefill and 8 teacher-forced decode steps: logits within 1e-4,
    the self-attention caches and (whisper) the cross caches within 1e-5
    after the prefill and after the last step.  A VLM prefills
    ``n_patches + prompt`` positions and decodes from there."""
    jl_all, tl_all, states = serve_both(arch, impl)
    assert len(jl_all) == 9
    for step, (jlg, tlg) in enumerate(zip(jl_all, tl_all)):
        assert tuple(tlg.shape) == tuple(jlg.shape), step
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")
    want = {"prefill", "final"}
    if arch == "whisper-small":
        want |= {"cross_prefill", "cross_final"}
    assert set(states) == want
    for key in want:
        assert_states_close(*states[key], F32_TOL)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_part_prefill_equals_one_shot(arch, impl):
    """Whisper: frames with the first part only, the second part's
    cross-attention over the cross caches; internvl: the patches with the
    first half of the prompt, then the rest at ``n_patches + half``.
    Last logits and every cache equal the one-shot prefill's."""
    _, tcfg, _, tp = _models(arch, impl)
    arrays = _inputs(tcfg, 2, 24, seed=9)
    _, tb = _both(arrays)
    n_pre, half = tcfg.n_patches, 10
    max_len = n_pre + 24 + 2
    prefill = tm.make_prefill(tcfg)
    one_lg, one = prefill(tp, tb, tt.init_decode_state(tcfg, 2, max_len,
                                                       device="cpu"))
    first = {k: v for k, v in tb.items() if k != "tokens"}
    first["tokens"] = tb["tokens"][:, :half]
    _, two = prefill(tp, first, tt.init_decode_state(tcfg, 2, max_len,
                                                     device="cpu"))
    x, two, _ = tt.forward(tp, tcfg, {"tokens": tb["tokens"][:, half:]},
                           state=two, cache_pos=n_pre + half)
    two_lg = tt.logits(tp, x[:, -1:])
    torch.testing.assert_close(two_lg, one_lg, rtol=F32_TOL, atol=F32_TOL)
    assert_states_close(port_layer_states(one), port_layer_states(two),
                        F32_TOL)
    if tcfg.cross_attn:
        assert_states_close(port_cross_states(one), port_cross_states(two),
                            0.0)


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,gen", [("whisper-small", 4),
                                      ("internvl2-26b", 4)])
def test_serve_batch_on_cpu(arch, gen, monkeypatch):
    """Deterministic greedy tokens; a VLM's decode at ``n_patches +
    prompt_len + i`` with ``gen < n_patches`` (where the reference's
    ``serve_batch`` sizes its state without the prefix and raises)."""
    seen = []
    real = tserve.make_serve_step

    def recording(cfg, rules=None):
        step = real(cfg, rules)

        def wrapped(params, state, token, pos):
            seen.append(pos)
            return step(params, state, token, pos)
        return wrapped

    monkeypatch.setattr(tserve, "make_serve_step", recording)
    red = tconfigs.get_reduced(arch)
    assert gen < red.n_patches or not red.n_patches
    a = tserve.serve_batch(arch, batch=2, prompt_len=16, gen=gen, seed=5,
                           device="cpu")
    b = tserve.serve_batch(arch, batch=2, prompt_len=16, gen=gen, seed=5,
                           device="cpu")
    assert a["config"] == jget_reduced(arch).name
    assert a["tokens"].shape == (2, gen) and a["tokens"].dtype == np.int32
    assert ((a["tokens"] >= 0) & (a["tokens"] < red.padded_vocab)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    start = red.n_patches + 16
    assert seen == [start + i for i in range(gen)] * 2
    if red.n_patches:
        from repro.launch.serve import serve_batch as jserve_batch
        with pytest.raises(TypeError, match="dynamic_update_slice"):
            jserve_batch(arch, 2, 16, gen)
