"""The port's LM training path against the JAX reference on the CPU:
the flash autograd Function (``_Flash``) against ``jax.grad`` of the
reference's ``chunked_attention`` (its ``custom_vjp``), the chunked loss
and its gradients against ``jax.value_and_grad(loss_fn)``, three train
steps against the reference's jitted step, the configurations and shape
cells of the ported architectures, and the train driver's resume.
Inputs come from numpy seeds; weights, gradients and AdamW moments cross
through ``core.convert``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as jall_cells
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import shape_cells as jshape_cells
from repro.data.pipeline import LMBatchPipeline as JPipeline
from repro.launch.mesh import make_host_mesh
from repro.models import attention as ja
from repro.models import model as jm
from repro.models.config import ShapeConfig as JShape
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.parallel.sharding import rules_for_mesh
from repro_torch import configs as tconfigs
from repro_torch.core.convert import (adamw_state_from_arrays,
                                      model_params_from_arrays)
from repro_torch.data.pipeline import LMBatchPipeline
from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch.train import build_trainer
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import init_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.tree import tree_flatten

from _torch_parity import assert_bits_equal, lm_params

ARCHS = ("qwen2-1.5b", "qwen2.5-3b", "qwen3-8b")
PORTED = ("qwen2-1.5b", "qwen3-8b", "gemma-2b", "qwen2.5-3b",
          "granite-moe-1b-a400m", "kimi-k2-1t-a32b", "falcon-mamba-7b",
          "recurrentgemma-9b", "whisper-small", "internvl2-26b")
# float32 throughout.  Attention gradients against the reference's
# chunked_attention: both sides run the same chunk-pair arithmetic in
# another einsum order: 1e-5 of the largest gradient.
GRAD_TOL = 1e-5
# whole-model loss and per-leaf gradients (3 layers, float32): each
# leaf's |port - reference| norm over the reference's norm.  The
# reference's model repeats KV to the query heads before its flash
# custom_vjp and sums dk, dv over each group in the repeat's transpose;
# the port never repeats and sums the group inside each chunk pair's
# product: another order (measured 1.6e-6)
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
# three AdamW steps.  The reference's jitted global norm differs from
# its own eager one by up to 2.5e-5 (XLA:CPU's float32 dot reduction;
# the gradients agree to 1.6e-6), and clipping carries that into the
# moments (v squares it) and the parameters: loss, nll and parameters to
# 2e-5 (measured up to 9e-6), grad norm and m to 5e-5 (measured 3.3e-5),
# v to 1e-4 (measured 6.2e-5), each leaf's error norm over its norm
STEP_TOL, GNORM_TOL, V_TOL = 2e-5, 5e-5, 1e-4
BATCH, SEQ = 2, 48       # ragged against the 32-wide attention and loss


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().copy()
    return np.asarray(x, np.float32)


def _rules(cfg):
    """The sharding rules the reference's ``build_trainer`` builds."""
    mesh = make_host_mesh()
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    ov = {}
    if cfg.n_heads % axes.get("model", 1):
        ov["heads"] = None
    if cfg.d_ff % axes.get("model", 1) or not cfg.d_ff:
        ov["mlp"] = None
    return rules_for_mesh(mesh, **ov)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_and_cells_equal_the_reference(arch):
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_reduced, jget_reduced)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    assert tconfigs.get_config(arch).param_count() == \
        jget_config(arch).param_count()
    assert [dataclasses.asdict(s) for s in tconfigs.shape_cells(arch)] == \
        [dataclasses.asdict(s) for s in jshape_cells(arch)]


def test_all_cells_are_the_references_over_the_ported_archs():
    want = [(a, dataclasses.asdict(s)) for a, s in jall_cells()
            if a in PORTED]
    got = [(a, dataclasses.asdict(s)) for a, s in tconfigs.all_cells()]
    assert sorted(got, key=str) == sorted(want, key=str)
    assert set(tconfigs.ARCH_NAMES) == set(PORTED)


# ---------------------------------------------------------------------------
# _Flash: the flash custom VJP
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, d, causal, window, q_offset, chunk)
FLASH_CASES = {
    "causal_gqa_padded": (2, 40, 40, 4, 2, 16, True, None, 0, 16),
    "window": (1, 33, 33, 2, 1, 8, True, 7, 0, 8),
    "dead_rows": (1, 12, 20, 2, 2, 8, True, 5, 18, 8),
    "bidirectional_ragged": (1, 19, 27, 3, 1, 16, False, None, 0, 8),
}


def _flash_inputs(case):
    b, sq, sk, h, kv, d, *_ = case
    rng = np.random.default_rng(sq * 7 + sk)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, w


def _reference_flash(case, q, k, v, w):
    _, _, _, _, _, d, causal, window, q_offset, chunk = case

    def f(q, k, v):
        out = ja.chunked_attention(q, k, v, causal=causal, window=window,
                                   scale=1.0 / np.sqrt(d),
                                   q_offset=q_offset, chunk_q=chunk,
                                   chunk_k=chunk)
        return jnp.sum(out * w), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kernel", [False, True],
                         ids=["chunked", "kernel_route"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_grads_match_reference_custom_vjp(name, kernel):
    """``_Flash`` forward and backward against the reference's
    ``chunked_attention`` (forward and ``jax.grad`` through its
    ``custom_vjp``).  ``kernel``: the forward is the flash kernel's
    wrapper, which on CPU tensors takes the plain version with the row
    statistic."""
    case = FLASH_CASES[name]
    q, k, v, w = _flash_inputs(case)
    jout, jgrads = _reference_flash(case, q, k, v, w)
    _, _, _, _, _, d, causal, window, q_offset, chunk = case
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                  scale=1.0 / np.sqrt(d), q_offset=q_offset,
                                  chunk_q=chunk, chunk_k=chunk,
                                  kernel=kernel)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), jout, rtol=GRAD_TOL, atol=GRAD_TOL)
    for name_g, t, j in zip("qkv", (tq, tk, tv), jgrads):
        scale = max(float(np.abs(j).max()), 1.0)
        np.testing.assert_allclose(_np(t.grad), j, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale,
                                   err_msg=f"d{name_g}")
    if name == "dead_rows":
        assert np.all(jout[:, 6:] == 0) and np.all(_np(out)[:, 6:] == 0)
        assert np.all(_np(tq.grad)[:, 6:] == 0)


@pytest.mark.parametrize("name", ["dead_rows", "causal_gqa_padded"])
def test_row_statistic_matches_reference(name):
    """The plain version's row statistic ``L`` (what the kernels write
    with ``return_lse``) against the reference's ``_flash_fwd_impl``
    residual, dead rows (+1e30) included."""
    case = FLASH_CASES[name]
    b, sq, sk, h, kv, d, causal, window, q_offset, _ = case
    q, k, v, _ = _flash_inputs(case)
    qg = ja._grouped(jnp.asarray(q), kv)
    kg = jnp.asarray(k).transpose(0, 2, 1, 3)
    vg = jnp.asarray(v).transpose(0, 2, 1, 3)
    cfgt = (causal, window, 1.0 / np.sqrt(d), q_offset, sq, sk, sk, None,
            None)
    _, jl = ja._flash_fwd_impl(qg, kg, vg, cfgt)
    flat = [torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3)).reshape(-1, x.shape[1], d))
        for x in (q, k, v)]
    _, lse = attention_ref(*flat, causal=causal, window=window,
                           q_offset=q_offset, return_lse=True)
    jl = np.asarray(jl).reshape(b * h, sq)
    np.testing.assert_allclose(lse.numpy(), jl, rtol=1e-6, atol=1e-5)
    assert (lse.numpy() == 1e30).any() == (name == "dead_rows")


def test_flash_gradcheck_float64():
    """``torch.autograd.gradcheck`` of ``_Flash`` on the plain route in
    float64 (GQA, causal, a window, padded chunks)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 7, 4, 4)))
    k = torch.from_numpy(rng.standard_normal((1, 7, 2, 4)))
    v = torch.from_numpy(rng.standard_normal((1, 7, 2, 4)))
    for x in (q, k, v):
        x.requires_grad_()

    def f(q, k, v):
        return tattn.chunked_attention(q, k, v, causal=True, window=5,
                                       scale=0.5, chunk_q=3, chunk_k=4)
    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-7)


def test_pallas_training_route_raises_where_no_kernel_takes_the_head():
    """qwen2.5-3b reduced has head_dim 12, which the flash wrapper pads to
    its route's width (32 in float32, the 3xTF32 kernel): ``"pallas"``
    trains there and equals the plain chunked route.  A head wider than any kernel (260) still
    raises."""
    base = tconfigs.get_reduced("qwen2.5-3b")
    assert base.resolved_head_dim == 12
    params = init_model(base, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(
        0, base.vocab_size, (1, 8)).astype(np.int32))
        for k in ("tokens", "labels")}
    out = {impl: tm._grads_of(params, dataclasses.replace(
        base, attn_impl=impl), batch) for impl in ("pallas", "chunked")}
    np.testing.assert_allclose(float(out["pallas"][0]),
                               float(out["chunked"][0]), rtol=LOSS_TOL)
    assert max(_leaf_errors(out["pallas"][2], out["chunked"][2])) \
        <= LEAF_TOL
    wide = dataclasses.replace(base, head_dim=260, attn_impl="pallas")
    params = init_model(wide, seed=0, device="cpu")
    opt = adamw(warmup_cosine(1e-3, 2, 5))
    with pytest.raises(ValueError, match="head_dim"):
        tm.make_train_step(wide, opt)(params, opt.init(params), batch)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, step=0, mask=True):
    pipe = JPipeline(cfg=cfg, shape=JShape("t", SEQ, BATCH, "train"),
                     seed=seed)
    b = pipe.batch(step)
    if mask:                     # masked labels (-1) at a few positions
        b["labels"] = b["labels"].copy()
        b["labels"][0, 5:9] = -1
        b["labels"][1, -3:] = -1
    return b


def _leaf_errors(port_tree, ref_tree) -> list:
    out = []
    for p, r in zip(tree_flatten(port_tree)[0], tree_flatten(ref_tree)[0]):
        p, r = _np(p), _np(r)
        out.append(float(np.linalg.norm(p - r))
                   / max(float(np.linalg.norm(r)), 1e-30))
    return out


@pytest.mark.parametrize("arch,impl", [
    ("qwen2-1.5b", "chunked"), ("qwen2-1.5b", "pallas"),
    ("qwen2.5-3b", "chunked"), ("qwen3-8b", "chunked"),
    ("qwen3-8b", "pallas")])
def test_loss_and_grads_match_reference(arch, impl):
    """``loss_fn``'s loss, nll, token count and per-leaf gradients against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` (its flash
    ``custom_vjp``, chunked loss, ``jax.checkpoint``).  The port's
    ``"pallas"`` goes through the flash wrapper's forward (the plain
    version on the CPU) and the same backward."""
    jcfg = jget_reduced(arch)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), attn_impl=impl)
    jp, arrays = lm_params(jcfg)
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, jcfg, _rules(jcfg), b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met, grads = tm._grads_of(tp, tcfg, tb)
    assert int(met["tokens"]) == int(jmet["tokens"]) == BATCH * SEQ - 7
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]),
                               rtol=LOSS_TOL)
    ref_grads = model_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jgrads), device="cpu")
    errs = _leaf_errors(grads, ref_grads)
    assert max(errs) <= LEAF_TOL, errs
    assert all(not t.requires_grad for t in tree_flatten(tp)[0])
    # the eval step is the loss without gradients
    eloss, emet = tm.make_eval_step(tcfg)(tp, tb)
    assert float(eloss) == float(loss) and not eloss.requires_grad


def test_remat_changes_no_value():
    """Per-layer checkpointing (``cfg.remat``) recomputes the layers in
    the backward: the same loss and gradients bit for bit."""
    tcfg = tconfigs.get_reduced("qwen3-8b")
    _, arrays = lm_params(jget_reduced("qwen3-8b"))
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(jget_reduced("qwen3-8b")).items()}
    outs = []
    for remat in (True, False):
        c = dataclasses.replace(tcfg, remat=remat)
        tp = model_params_from_arrays(c, arrays, device="cpu")
        outs.append(tm._grads_of(tp, c, tb))
    assert_bits_equal(outs[0][0], outs[1][0], "loss")
    for a, b in zip(tree_flatten(outs[0][2])[0], tree_flatten(outs[1][2])[0]):
        assert_bits_equal(a, b, "grad")


# ---------------------------------------------------------------------------
# three train steps against the reference's jitted step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-8b"])
def test_train_steps_match_reference(arch, microbatches):
    """Three steps of ``make_train_step`` with AdamW under warmup-cosine:
    losses, grad norms, token counts, final parameters and AdamW state
    against the reference's jitted step."""
    jcfg = jget_reduced(arch)
    tcfg = tconfigs.get_reduced(arch)
    jp, arrays = lm_params(jcfg)
    jopt = jadamw(jwarmup_cosine(1e-2, 2, 5))
    topt = adamw(warmup_cosine(1e-2, 2, 5))
    jstep = jax.jit(jm.make_train_step(jcfg, _rules(jcfg), jopt,
                                       microbatches=microbatches))
    tstep = tm.make_train_step(tcfg, topt, microbatches=microbatches)
    jstate = jopt.init(jp)
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    tstate = topt.init(tp)
    for i in range(3):
        batch = _batch(jcfg, step=i, mask=i == 1)
        jp, jstate, jout = jstep(jp, jstate, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        tp, tstate, tout = tstep(tp, tstate, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        for key, tol in (("loss", STEP_TOL), ("nll", STEP_TOL),
                         ("grad_norm", GNORM_TOL)):
            np.testing.assert_allclose(float(tout[key]), float(jout[key]),
                                       rtol=tol, err_msg=f"{key} {i}")
        assert int(tout["tokens"]) == int(jout["tokens"])
    ref_p = model_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    errs = _leaf_errors(tp, ref_p)
    assert max(errs) <= STEP_TOL, errs
    ref_s = adamw_state_from_arrays(tcfg, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    assert int(tstate["step"]) == int(ref_s["step"]) == 3
    for key, tol in (("m", GNORM_TOL), ("v", V_TOL)):
        errs = _leaf_errors(tstate[key], ref_s[key])
        assert max(errs) <= tol, (key, errs)


def test_train_step_launches_no_kernel_on_cpu():
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen3-8b"),
                              attn_impl="pallas")
    params = init_model(cfg, seed=0, device="cpu")
    opt = adamw(warmup_cosine(1e-3, 2, 5))
    b = LMBatchPipeline(cfg, ShapeConfig("t", 16, 2, "train")).batch(0)
    _build.reset_launch_counts()
    _, _, out = tm.make_train_step(cfg, opt)(
        params, opt.init(params), {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    assert _build.launch_counts() == {}
    assert np.isfinite(float(out["loss"]))


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

def _train(ckpt_dir, steps=12, fault_hook=None):
    driver, _ = build_trainer("qwen2-1.5b", batch=2, seq=16, steps=steps,
                              ckpt_dir=str(ckpt_dir), ckpt_every=4,
                              fault_hook=fault_hook, device="cpu")
    return driver


@pytest.fixture(scope="module")
def straight_run(tmp_path_factory):
    out = _train(tmp_path_factory.mktemp("straight")).run(12)
    return out


def _assert_same_training(a, b_state, losses):
    assert [m["loss"] for m in a["metrics"]] == losses
    for x, y in zip(tree_flatten(a["state"])[0], tree_flatten(b_state)[0]):
        assert_bits_equal(x, y, "state leaf")


def test_train_driver_resume_is_bit_identical(straight_run, tmp_path):
    """Preempted after step 6 (checkpoint at the boundary) and resumed by
    a fresh driver: the final parameters, AdamW state and every step's
    loss equal the straight run's bit for bit."""
    holder = {}

    def preempt(step):
        if step == 6:
            holder["driver"].preempted = True
    first = holder["driver"] = _train(tmp_path, fault_hook=preempt)
    a = first.run(12)
    assert a["preempted"] and a["final_step"] == 7
    b = _train(tmp_path).run(12)
    assert b["final_step"] == 12
    _assert_same_training(straight_run, b["state"],
                          [m["loss"] for m in a["metrics"] + b["metrics"]])
    losses = [m["loss"] for m in straight_run["metrics"]]
    assert losses[-1] < losses[0]


def test_train_driver_retry_before_first_checkpoint(straight_run, tmp_path):
    """A failure before the first checkpoint rebuilds the state from the
    seed (the step updates it in place) and replays to the same run."""
    failed = []

    def fail_once(step):
        if step == 2 and not failed:
            failed.append(step)
            raise RuntimeError("injected worker loss")
    driver = _train(tmp_path, fault_hook=fail_once)
    driver.cfg.backoff_s = 0.0
    out = driver.run(12)
    assert failed == [2]
    _assert_same_training(straight_run, out["state"],
                          [m["loss"] for m in out["metrics"]])


def test_examples_train_and_recover_on_cpu(tmp_path):
    """``repro_torch.examples.train_lm`` (its loss falls) and
    ``fault_tolerance_demo`` (a crash at step 30 replayed from the
    checkpoint, each step logged once) on the CPU."""
    from repro_torch.examples import fault_tolerance_demo, train_lm
    losses = train_lm.run("qwen3-8b", 20, 4, 32, str(tmp_path / "lm"),
                          device="cpu")
    assert len(losses) == 20 and losses[-1] < losses[0]
    out = fault_tolerance_demo.run(str(tmp_path / "ft"), device="cpu")
    assert out["final_step"] == 50
