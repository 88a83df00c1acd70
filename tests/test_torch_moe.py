"""The port's MoE family against the JAX reference on the CPU: the
capacity rule, the routing (top-k, stable sort, capacity-ranked slots),
the MoE layer (``apply_moe`` against the reference's meshless dispatch
``_apply_moe_dense``, with and without capacity drops), the loss with
the router terms and its gradients, the init distributions, and prefill
+ 8 decode steps of reduced granite-moe-1b and kimi-k2.  Inputs come
from numpy seeds; weights cross through ``model_params_from_arrays``."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import LMBatchPipeline as JPipeline
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models.config import ShapeConfig as JShape
from repro.parallel.sharding import MeshRules
from repro_torch import configs as tconfigs
from repro_torch.core.convert import model_params_from_arrays
from repro_torch.kernels.flash_attention import _route, padded_head_dim
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.tree import tree_flatten

from _torch_parity import assert_states_close, lm_params, serve_both

GRANITE, KIMI = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
RULES = MeshRules()          # no mesh: the reference's meshless dispatch
F32_TOL = 1e-5               # modules and states in float32
LOGIT_TOL = 1e-4             # whole-model logits in float32
# the loss's router terms and each leaf's gradient (error norm over
# norm), as tests/test_torch_train.py holds the dense models
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().copy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def serve_runs():
    """The reference's and the port's prefill + 8 decode steps, built
    once per (arch, impl) for this file's tests."""
    cache = {}

    def get(arch, impl):
        if (arch, impl) not in cache:
            cache[arch, impl] = serve_both(arch, impl, meshless=True)
        return cache[arch, impl]
    return get


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def test_full_width_configs():
    g, k = tconfigs.get_config(GRANITE), tconfigs.get_config(KIMI)
    assert (g.n_layers, g.d_model, g.n_experts, g.moe_top_k,
            g.resolved_head_dim) == (24, 1024, 32, 8, 64)
    assert g.param_count() == jget_config(GRANITE).param_count() \
        == 1_334_887_424
    assert (k.n_layers, k.n_experts, k.resolved_head_dim) == (61, 384, 112)
    # kimi's head takes the tensor-core routes padded to 128
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "tf32")):
        assert _route(dtype, 112) == route
        assert padded_head_dim(route, 112) == 128


@pytest.mark.parametrize("arch,n", [(GRANITE, 40), (GRANITE, 8192),
                                    (KIMI, 1), (KIMI, 3000)])
def test_moe_capacity_equals_reference(arch, n):
    for get_t, get_j in ((tconfigs.get_reduced, jget_reduced),
                         (tconfigs.get_config, jget_config)):
        assert tmoe.moe_capacity(get_t(arch), n) == \
            jmoe.moe_capacity(get_j(arch), n)


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 3, 7, 256])
def test_routing_slots_equal_reference(cap):
    """On the same router probabilities: the experts, the slots and the
    kept mask equal the reference's exactly (stable order within an
    expert, the dump slot past capacity), the renormalised weights
    within float32 rounding."""
    rng = np.random.default_rng(cap)
    logits = rng.normal(size=(40, 8)).astype(np.float32) * 2
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jw, je, js, jk = jmoe._topk_capacity_slots(jnp.asarray(probs), 2, 8,
                                               cap)
    tw, te, ts, tk = tmoe._topk_capacity_slots(torch.from_numpy(probs), 2,
                                               8, cap)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert ts.dtype == torch.int32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=F32_TOL,
                               atol=F32_TOL)
    if cap < 10:               # 80 assignments over 8 experts
        assert int((~tk).sum()) > 0


def _moe_case(arch: str, drops: bool):
    cfg_j, cfg_t = jget_reduced(arch), tconfigs.get_reduced(arch)
    b, s = 2, 20
    if drops:   # 1024 tokens, capacity 256 for ~512 assignments an expert
        cfg_j = dataclasses.replace(cfg_j, capacity_factor=0.25)
        cfg_t = dataclasses.replace(cfg_t, capacity_factor=0.25)
        b, s = 4, 256
    jp, _ = lm_params(cfg_j)
    arrays = jax.tree.map(np.asarray, jp["blocks"][0]["moe"])
    p_j = {k: jnp.asarray(v[0]) for k, v in arrays.items()}
    p_t = {k: torch.from_numpy(np.array(v[0])) for k, v in arrays.items()}
    x = np.random.default_rng(5).normal(
        size=(b, s, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, p_j, p_t, x


@pytest.mark.parametrize("arch,drops", [(GRANITE, False), (KIMI, False),
                                        (GRANITE, True)])
def test_apply_moe_matches_reference(arch, drops):
    """``apply_moe`` against the reference's ``_apply_moe_dense``: the
    routing slots and kept mask exactly (each package routing its own
    float32 probabilities), y and the three aux values within float32
    tolerance; with ``drops`` the capacity drops about half the
    assignments."""
    cfg_j, cfg_t, p_j, p_t, x = _moe_case(arch, drops)
    y_j, aux_j = jax.jit(lambda p, x: jmoe._apply_moe_dense(
        p, cfg_j, RULES, x))(p_j, jnp.asarray(x))
    y_t, aux_t = tmoe.apply_moe(p_t, cfg_t, torch.from_numpy(x))
    t = x.shape[0] * x.shape[1]
    cap = tmoe.moe_capacity(cfg_t, t)
    assert cap == jmoe.moe_capacity(cfg_j, t)
    xt = x.reshape(t, -1)
    probs_j = jax.nn.softmax(jnp.asarray(xt) @ p_j["router"], axis=-1)
    probs_t = torch.softmax(torch.from_numpy(xt) @ p_t["router"], dim=-1)
    k, e = cfg_t.moe_top_k, cfg_t.n_experts
    _, je, js, jk = jmoe._topk_capacity_slots(probs_j, k, e, cap)
    _, te, ts, tk = tmoe._topk_capacity_slots(probs_t, k, e, cap)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=F32_TOL,
                               atol=F32_TOL)
    assert set(aux_t) == set(aux_j)
    for name in aux_j:
        np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]),
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
    dropped = float(aux_t["frac_dropped"])
    assert (dropped > 0.3) if drops else dropped == 0.0
    assert dropped == pytest.approx(float((~tk).float().mean()))


def test_moe_init_distributions():
    """The reference's distributions (not its numbers): a float32 router
    and expert projections of std 1/sqrt(fan-in), in the model's dtype."""
    cfg = dataclasses.replace(tconfigs.get_reduced(GRANITE), d_model=256,
                              d_ff=128, n_experts=8, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (256, 8)
    shapes = {"gate": (8, 256, 128), "up": (8, 256, 128),
              "down": (8, 128, 256)}
    for name, shape in shapes.items():
        assert p[name].shape == shape and p[name].dtype == torch.bfloat16
        std = float(p[name].float().std()) * math.sqrt(shape[1])
        assert abs(std - 1.0) < 0.03, (name, std)
    assert abs(float(p["router"].std()) * 16 - 1.0) < 0.1


# ---------------------------------------------------------------------------
# the loss with the router terms
# ---------------------------------------------------------------------------

def test_loss_fn_router_terms_match_reference():
    """Reduced granite: ``loss_fn``'s loss (the mean nll plus
    ``router_aux_coef * load_balance + 1e-4 * router_z``, summed over the
    layers), nll, token count, the aux values and every leaf's gradient
    against ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg = jget_reduced(GRANITE)
    tcfg = tconfigs.get_reduced(GRANITE)
    jp, arrays = lm_params(jcfg)
    pipe = JPipeline(cfg=jcfg, shape=JShape("t", 48, 2, "train"), seed=0)
    batch = pipe.batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, jcfg, RULES, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    loss, met, grads = tm._grads_of(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(met) == set(jmet) == {"nll", "tokens", "load_balance",
                                     "router_z", "frac_dropped"}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    for name in ("nll", "load_balance", "router_z", "frac_dropped"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=name)
    mean_nll = float(met["nll"]) / int(met["tokens"])
    router = (tcfg.router_aux_coef * float(met["load_balance"])
              + 1e-4 * float(met["router_z"]))
    assert router > 0
    np.testing.assert_allclose(float(loss), mean_nll + router, rtol=1e-6)
    ref_grads = model_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    errs = []
    for a, b in zip(tree_flatten(grads)[0], tree_flatten(ref_grads)[0]):
        a, b = _np(a), _np(b)
        errs.append(float(np.linalg.norm(a - b))
                    / max(float(np.linalg.norm(b)), 1e-30))
    assert max(errs) <= LEAF_TOL, errs
    # a dense config's loss carries no router terms
    dense = tconfigs.get_reduced("qwen2-1.5b")
    dp = tt.init_model(dense, seed=0, device="cpu")
    dl, dm = tm.loss_fn(dp, dense, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert float(dl) == float(dm["nll"]) / int(dm["tokens"])
    assert float(dm["load_balance"]) == 0.0


# ---------------------------------------------------------------------------
# the slice: prefill, then teacher-forced decode
# ---------------------------------------------------------------------------

# the reference's "pallas" runs its kernel in interpret mode: granite only
RUNS = [(GRANITE, "chunked"), (KIMI, "chunked"), (GRANITE, "pallas")]


@pytest.mark.parametrize("arch,impl", RUNS)
def test_moe_prefill_and_decode_match_reference(serve_runs, arch, impl):
    jl_all, tl_all, _ = serve_runs(arch, impl)
    assert len(jl_all) == 9
    for step, (jlg, tlg) in enumerate(zip(jl_all, tl_all)):
        assert tuple(tlg.shape) == tuple(jlg.shape), step
        np.testing.assert_allclose(_np(tlg), _np(jlg), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {step}")


@pytest.mark.parametrize("when", ["prefill", "final"])
@pytest.mark.parametrize("arch,impl", RUNS)
def test_moe_decode_states_match_reference(serve_runs, arch, impl, when):
    """Every layer's KV cache after the prefill and after 8 steps."""
    assert_states_close(*serve_runs(arch, impl)[2][when], F32_TOL)
