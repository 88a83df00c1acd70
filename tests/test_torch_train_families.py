"""Training the mamba, RG-LRU, encoder-decoder and VLM families: the
port against the JAX reference on the CPU.

Reduced falcon-mamba-7b, recurrentgemma-9b, whisper-small (its frames)
and internvl2-26b (its patches): ``loss_fn``'s loss, nll, token count and
per-leaf gradients against ``jax.value_and_grad`` of the reference's
``loss_fn`` on the plain ``"chunked"`` route and the kernel route
(``"pallas"``: the flash wrapper's forward, which on CPU tensors is the
plain version with the row statistic), and three AdamW steps against the
reference's train step (``_Reference`` says how it is run).  Adafactor
over the reference's stack groups (``transformer.stack_groups``): three
steps against the reference's, parameters and state, on reduced qwen2 (one
group of 3 layers), reduced whisper (its encoder's group and its
decoder's) and recurrentgemma cut to 8 layers (two periods and a 2-layer
remainder).  The recurrent scans' per-chunk checkpoint: the same values
with and without grad, and the bytes saved for the backward of one
mamba layer free of the chunks' discretised tensors.  Each reference
function is jitted once for the module (``reference`` fixture); inputs
come from numpy seeds, weights cross through ``core.convert``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import LMBatchPipeline as JPipeline
from repro.launch.mesh import make_host_mesh
from repro.models import model as jm
from repro.models.config import ShapeConfig as JShape
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.optim.optimizers import _clipped as jclipped
from repro.parallel.sharding import rules_for_mesh
from repro_torch import configs as tconfigs
from repro_torch.core.convert import (adafactor_state_from_arrays,
                                      adamw_state_from_arrays,
                                      model_params_from_arrays)
from repro_torch.launch.train import build_trainer
from repro_torch.models import model as tm
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import stack_groups
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.tree import tree_flatten

from _torch_parity import lm_params

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-small",
         "internvl2-26b")
# as tests/test_torch_train.py: the loss and each leaf's gradient error
# norm over its norm (float32; the flash backward sums GQA groups and
# chunk pairs in another order than the reference's custom_vjp)
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
# three optimizer steps: XLA:CPU's jitted global norm differs from an
# eager one by up to 2.5e-5, which clipping carries into the moments
# (second moments square it) and the parameters
STEP_TOL, GNORM_TOL, V_TOL = 2e-5, 5e-5, 1e-4
BATCH, SEQ = 2, 48      # tokens; a VLM's patches come on top
# the Adafactor configs: (name, arch, config overrides)
ADAFACTOR = {"qwen2": ("qwen2-1.5b", {}),
             "whisper": ("whisper-small", {}),
             "recurrentgemma_8": ("recurrentgemma-9b", {"n_layers": 8})}


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


def _configs(arch: str, **overrides):
    return (dataclasses.replace(jget_reduced(arch), **overrides),
            dataclasses.replace(tconfigs.get_reduced(arch), **overrides))


def _batch(cfg, step=0, mask=True) -> dict:
    """``BATCH`` x ``SEQ`` tokens of the reference's pipeline (with the
    family's frames or patches), a few labels masked."""
    pipe = JPipeline(cfg=cfg, shape=JShape("t", SEQ + cfg.n_patches, BATCH,
                                           "train"), seed=0)
    b = pipe.batch(step)
    assert b["tokens"].shape == (BATCH, SEQ)
    if mask:
        b["labels"] = b["labels"].copy()
        b["labels"][0, 5:9] = -1
        b["labels"][1, -3:] = -1
    return b


def _leaf_errors(port_tree, ref_tree) -> list:
    port, ref = tree_flatten(port_tree)[0], tree_flatten(ref_tree)[0]
    assert len(port) == len(ref)
    out = []
    for p, r in zip(port, ref):
        p, r = _np(p), _np(r)
        assert p.shape == r.shape
        out.append(float(np.linalg.norm(p - r))
                   / max(float(np.linalg.norm(r)), 1e-30))
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class _Reference:
    """The reference's runs, each made once when first asked for, one
    jitted loss gradient per config.

    Its train step at one microbatch is ``value_and_grad(loss_fn)``, then
    ``optimizer.update`` (``repro.models.model.make_train_step``), which
    clips the gradients to a global norm of 1 first (``_clipped``).
    Jitted, XLA:CPU fuses that norm's per-leaf dot products into one
    sequential float32 sum of each leaf's squares: on reduced
    recurrentgemma's 8192-element leaves it lies 3e-4 off the exact
    norm (the reference's own eager ``global_norm``: 1e-7), and the
    clipping carries the error into the moments.  So here the gradient
    is jitted, ``_clipped`` runs op by op, and the update (jitted) is the
    same optimizer's with ``clip_norm=inf`` on the clipped gradients:
    the reference's step with its norm computed exactly."""

    def __init__(self):
        self.memo = {}

    def get(self, key, fn):
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]

    def grads_of(self, arch, **ov):
        def make():
            jcfg, _ = _configs(arch, **ov)
            return jax.jit(jax.value_and_grad(
                lambda p, b: jm.loss_fn(p, jcfg, _rules(jcfg), b),
                has_aux=True))
        return self.get(("grads_of", arch, tuple(sorted(ov.items()))), make)

    def grads(self, arch):
        def run():
            jcfg, _ = _configs(arch)
            jp, arrays = lm_params(jcfg)
            batch = _batch(jcfg)
            (loss, met), grads = self.grads_of(arch)(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            return {"arrays": arrays, "batch": batch, "loss": float(loss),
                    "nll": float(met["nll"]), "tokens": int(met["tokens"]),
                    "grads": _np_tree(grads)}
        return self.get(("grads", arch), run)

    def steps(self, arch, make_opt, n=3, **ov):
        """``n`` train steps with the optimizer ``make_opt(clip_norm)``
        builds: the initial parameters, per-step outs, the final
        parameters and optimizer state (numpy)."""
        jcfg, _ = _configs(arch, **ov)
        jp, arrays = lm_params(jcfg)
        grads_of = self.grads_of(arch, **ov)
        jopt = make_opt(float("inf"))
        update = jax.jit(jopt.update)
        jstate = jopt.init(jp)
        outs = []
        for i in range(n):
            batch = _batch(jcfg, step=i, mask=i == 1)
            (loss, met), grads = grads_of(jp, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
            grads, gnorm = jclipped(grads, 1.0)
            jp, jstate, _ = update(jp, grads, jstate)
            outs.append({"loss": float(loss), "grad_norm": float(gnorm),
                         **{k: float(v) for k, v in met.items()}})
        return arrays, outs, _np_tree(jp), _np_tree(jstate)

    def adamw_steps(self, arch):
        return self.get(("adamw", arch), lambda: self.steps(
            arch, lambda c: jadamw(jwarmup_cosine(1e-2, 2, 5),
                                   clip_norm=c)))

    def adafactor_steps(self, name):
        arch, ov = ADAFACTOR[name]
        return self.get(("adafactor", name), lambda: self.steps(
            arch, lambda c: jadafactor(jwarmup_cosine(1e-2, 2, 5),
                                       clip_norm=c), **ov))


@pytest.fixture(scope="module")
def reference():
    return _Reference()


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch, impl):
    """``loss_fn``'s loss, nll, token count and per-leaf gradients against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` (its chunked
    flash ``custom_vjp``, its per-chunk ``jax.checkpoint`` scans, the
    encoder over the frames, the patch prefix).  Every leaf's gradient
    is nonzero."""
    ref = reference.grads(arch)
    _, tcfg = _configs(arch)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    tp = model_params_from_arrays(tcfg, ref["arrays"], device="cpu")
    loss, met, grads = tm._grads_of(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in ref["batch"].items()})
    assert int(met["tokens"]) == ref["tokens"] == BATCH * SEQ - 7
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(float(met["nll"]), ref["nll"], rtol=LOSS_TOL)
    ref_grads = model_params_from_arrays(tcfg, ref["grads"], device="cpu",
                                         dtype="float32")
    errs = _leaf_errors(grads, ref_grads)
    assert max(errs) <= LEAF_TOL, errs
    assert all(float(g.abs().max()) > 0 for g in tree_flatten(grads)[0])


# ---------------------------------------------------------------------------
# three train steps: AdamW, then Adafactor over the stack groups
# ---------------------------------------------------------------------------

def _check_steps(tcfg, topt, ref, state_from_arrays):
    arrays, jouts, jp, jstate = ref
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    tstate = topt.init(tp)
    step = tm.make_train_step(tcfg, topt)
    for i, jout in enumerate(jouts):
        batch = _batch(tcfg, step=i, mask=i == 1)
        tp, tstate, tout = step(tp, tstate, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        for key, tol in (("loss", STEP_TOL), ("nll", STEP_TOL),
                         ("grad_norm", GNORM_TOL)):
            np.testing.assert_allclose(float(tout[key]), jout[key],
                                       rtol=tol, err_msg=f"{key} {i}")
        assert int(tout["tokens"]) == int(jout["tokens"])
    errs = _leaf_errors(tp, model_params_from_arrays(tcfg, jp,
                                                     device="cpu"))
    assert max(errs) <= STEP_TOL, errs
    ref_state = state_from_arrays(tcfg, jstate, device="cpu")
    assert int(tstate["step"]) == int(ref_state["step"]) == 3
    return tstate, ref_state


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_reference(reference, arch):
    """Three steps of ``make_train_step`` with AdamW under warmup-cosine:
    losses, grad norms, token counts, the parameters and AdamW's moments
    against the reference's."""
    _, tcfg = _configs(arch)
    tstate, ref_state = _check_steps(
        tcfg, adamw(warmup_cosine(1e-2, 2, 5)), reference.adamw_steps(arch),
        adamw_state_from_arrays)
    for key, tol in (("m", GNORM_TOL), ("v", V_TOL)):
        errs = _leaf_errors(tstate[key], ref_state[key])
        assert max(errs) <= tol, (key, errs)


@pytest.mark.parametrize("name", sorted(ADAFACTOR))
def test_adafactor_steps_match_reference(reference, name):
    """Three steps with Adafactor over ``stack_groups(cfg)`` against the
    reference's (its layers stacked): losses, grad norms, the
    parameters and every moment leaf of the state (the reference's
    layout: a stacked 1-D leaf's ``row`` over the layers and ``col``
    over its width; each group's update clipped as one leaf)."""
    arch, ov = ADAFACTOR[name]
    _, tcfg = _configs(arch, **ov)
    groups = stack_groups(tcfg)
    stacked = [g for g in groups["blocks"][1]] + (
        [groups["enc_blocks"][1]] if "enc_blocks" in groups else [])
    assert stacked and all(len(g) > 1 for g in stacked)
    tstate, ref_state = _check_steps(
        tcfg, adafactor(warmup_cosine(1e-2, 2, 5), stacks=groups),
        reference.adafactor_steps(name), adafactor_state_from_arrays)
    errs = _leaf_errors(tstate["v"], ref_state["v"])
    assert max(errs) <= V_TOL, errs
    # the 1-D leaves of a group are factored across its layers
    row = ref_state["v"]["blocks"][0]["ln1"]["scale"]["row"]
    assert tuple(row.shape) == (len(groups["blocks"][1][0]),)


def test_stack_groups_follow_the_reference_layout():
    """The groups the reference stacks: one per pattern position over the
    whole periods, the remainder single, the encoder always stacked,
    nothing grouped with one period."""
    qwen = tconfigs.get_reduced("qwen2-1.5b")
    assert stack_groups(qwen) == {"blocks": ("layers", [(0, 1, 2)]),
                                  "rest": ("layers", [])}
    griffin = tconfigs.get_reduced("recurrentgemma-9b")
    assert griffin.pattern_periods == (1, 2)
    assert stack_groups(griffin) == {"blocks": ("layers", []),
                                     "rest": ("layers", [0, 1, 2, 3, 4])}
    eight = dataclasses.replace(griffin, n_layers=8)
    assert stack_groups(eight) == {
        "blocks": ("layers", [(0, 3), (1, 4), (2, 5)]),
        "rest": ("layers", [6, 7])}
    whisper = tconfigs.get_reduced("whisper-small")
    assert stack_groups(whisper)["enc_blocks"] == ("enc_layers", (0, 1))
    flat = dataclasses.replace(qwen, scan_layers=False)
    assert stack_groups(flat)["blocks"] == ("layers", [])


# ---------------------------------------------------------------------------
# the launcher takes every family's reduced config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("granite-moe-1b-a400m",))
def test_build_trainer_takes_the_family(arch, tmp_path):
    """``launch.train.build_trainer`` on the reduced config, frames and
    patches from its pipeline: three steps, finite losses."""
    driver, cfg = build_trainer(arch, batch=2, seq=16 + (
        tconfigs.get_reduced(arch).n_patches), steps=3,
        ckpt_dir=str(tmp_path), ckpt_every=10, device="cpu")
    out = driver.run(3)
    assert out["final_step"] == 3
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])


# ---------------------------------------------------------------------------
# the recurrent scans' per-chunk checkpoint
# ---------------------------------------------------------------------------

def _mixer(name: str, ssm_state: int = 16):
    arch = "falcon-mamba-7b" if name == "mamba" else "recurrentgemma-9b"
    cfg = dataclasses.replace(tconfigs.get_reduced(arch),
                              ssm_state=ssm_state)
    gen = torch.Generator().manual_seed(0)
    init = tssm.init_mamba if name == "mamba" else trg.init_rglru
    apply = tssm.apply_mamba if name == "mamba" else trg.apply_rglru
    return cfg, init(gen, cfg, torch.float32), apply


@pytest.mark.parametrize("name", ["mamba", "rglru"])
def test_chunk_checkpoint_changes_no_value(name):
    """The training loop's output (37 positions: two whole chunks and a
    padded tail) is the same bit for bit with grad enabled, where each
    chunk runs under ``torch.utils.checkpoint``, and without; so are
    the gradients of two backward passes."""
    cfg, p, apply = _mixer(name)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        plain, _ = apply(p, cfg, x)
    leaves = tree_flatten(p)[0]
    grads = []
    for _ in range(2):
        for t in leaves:
            t.requires_grad_(True)
        out, _ = apply(p, cfg, x)
        assert torch.equal(out.detach(), plain)
        grads.append(torch.autograd.grad(out.square().sum(), leaves))
        for t in leaves:
            t.requires_grad_(False)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_mamba_saved_bytes_hold_no_chunk_tensor():
    """One mamba layer in training: the bytes that
    ``saved_tensors_hooks`` sees for its backward grow from 2 to 4
    chunks by the layer's own (B, C, width) activations only, less than
    one (B, C, d_inner, N) float32 tensor a chunk, and no saved tensor
    has the chunks' discretised shape (the scan's tensors are recomputed
    chunk by chunk).  Without the checkpoint each chunk keeps about a
    dozen of them."""
    cfg, p, apply = _mixer("mamba")
    for t in tree_flatten(p)[0]:
        t.requires_grad_(True)
    b, c, di, n = 2, cfg.mamba_chunk, cfg.d_inner, cfg.ssm_state
    saved = {}
    for n_chunks in (2, 4):
        x = torch.randn(b, n_chunks * c, cfg.d_model, requires_grad=True)
        shapes, nbytes = [], []

        def pack(t):
            shapes.append(tuple(t.shape))
            nbytes.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            apply(p, cfg, x)
        assert (b, c, di, n) not in shapes
        saved[n_chunks] = sum(nbytes)
    per_chunk = (saved[4] - saved[2]) / 2
    assert 0 < per_chunk < b * c * di * n * 4, saved
