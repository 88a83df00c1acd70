"""The port's optimizers and schedules against the JAX reference's
(``repro.optim``): one AdamW and one Adafactor update from the same
parameters, gradients and state (float32 and bfloat16 parameters), the
global norm and clipping, and the learning-rate schedules at several
steps.  Trees are in the port's layout on both sides (the reference's
optimizers take any pytree)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.optim import warmup_rsqrt as jwarmup_rsqrt
from repro.optim.optimizers import global_norm as jglobal_norm
from repro_torch.optim import (adafactor, adamw, constant, global_norm,
                               warmup_cosine, warmup_rsqrt)
from repro_torch.tree import tree_flatten, tree_unflatten

# float32: the reference's jitted update contracts multiply-adds into
# FMAs (XLA:CPU) and reduces in another order: 2e-6 relative to each
# leaf's largest value.  bfloat16 parameters: both round a float32
# update to bf16; a value that lands on a rounding boundary moves by one
# bf16 step (2^-8 relative), so at most 1 % of the values may differ,
# each by at most one step.  Their float32 moments: XLA:CPU keeps some of
# the reference's bf16 intermediates (the clipped gradient, its scaled
# copies) in float32 inside its fusions where eager PyTorch rounds them,
# so the moments are held to one bf16 step (2^-8) of each leaf's largest
# value.
F32_TOL, BF16_STEP = 2e-6, 2.0 ** -8
# the port's tree: dict keys, a list of layers, leaves of rank 1 to 3
SHAPES = {"embed": {"table": (11, 6)},
          "layers": [{"w": (6, 3, 4), "b": (3, 4), "scale": (6,)},
                     {"w": (6, 3, 4), "b": (3, 4), "scale": (6,)}],
          "ln_f": {"scale": (6,)}}


def _map_shapes(fn, node=SHAPES):
    """SHAPES with each shape tuple replaced by ``fn(shape)``."""
    if isinstance(node, dict):
        return {k: _map_shapes(fn, node[k]) for k in sorted(node)}
    if isinstance(node, list):
        return [_map_shapes(fn, x) for x in node]
    return fn(node)


def _tree(rng, scale=1.0):
    return _map_shapes(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32))


def _to_torch(tree, dtype=torch.float32):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [torch.from_numpy(np.array(x)).to(dtype)
                                    for x in leaves])


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _close(port, ref, dtype, tol=F32_TOL):
    for p, r in zip(tree_flatten(port)[0], jax.tree.leaves(ref)):
        p = p.to(torch.float32).numpy()
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert p.shape == r.shape
        if dtype == torch.float32:
            scale = max(float(np.abs(r).max()), 1e-30)
            np.testing.assert_allclose(p, r, rtol=tol, atol=tol * scale)
        else:
            diff = p != r
            assert diff.mean() <= 0.01, diff.mean()
            np.testing.assert_allclose(p[diff], r[diff], rtol=2 ** -7)


def _state_pair(rng, kind):
    """A mid-run state (step 4, non-zero moments) in both packages."""
    if kind == "adamw":
        m, v = _tree(rng, 0.1), _tree(rng, 0.1)
        v = jax.tree.map(np.abs, v)
        j = {"m": _to_jax(m), "v": _to_jax(v), "step": jnp.int32(4)}
        t = {"m": _to_torch(m), "v": _to_torch(v),
             "step": torch.tensor(4, dtype=torch.int32)}
        return j, t
    def moments(s):
        if len(s) >= 2:
            m = {"row": rng.standard_normal(s[:-1]),
                 "col": rng.standard_normal(s[:-2] + s[-1:])}
        else:
            m = {"full": rng.standard_normal(s)}
        return {k: np.abs(x).astype(np.float32) for k, x in m.items()}
    tree = _map_shapes(moments)
    j = {"v": _to_jax(tree), "step": jnp.int32(4)}
    t = {"v": _to_torch(tree), "step": torch.tensor(4, dtype=torch.int32)}
    return j, t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("grad_scale", [0.05, 5.0], ids=["unclipped",
                                                          "clipped"])
def test_update_matches_reference(kind, dtype, grad_scale):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if kind == "adamw":
        jopt = jadamw(jwarmup_cosine(1e-2, 2, 10))
        topt = adamw(warmup_cosine(1e-2, 2, 10))
    else:
        jopt = jadafactor(jwarmup_rsqrt(1e-2, 3), weight_decay=0.1)
        topt = adafactor(warmup_rsqrt(1e-2, 3), stacks={},
                         weight_decay=0.1)
    jstate, tstate = _state_pair(rng, kind)
    jp, jst, jgn = jax.jit(jopt.update)(_to_jax(params, jdt),
                                        _to_jax(grads, jdt), jstate)
    tp = _to_torch(params, dtype)
    leaves = tree_flatten(tp)[0]
    tp2, tst, tgn = topt.update(tp, _to_torch(grads, dtype), tstate)
    assert tp2 is tp and all(a is b for a, b in zip(leaves,
                                                     tree_flatten(tp)[0]))
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 5
    _close(tp, jp, dtype)
    moments = ("m", "v") if kind == "adamw" else ("v",)
    for key in moments:
        _close(tst[key], jst[key], torch.float32,
               F32_TOL if dtype == torch.float32 else BF16_STEP)


def test_init_state_layout():
    tp = _to_torch(_tree(np.random.default_rng(1)), torch.bfloat16)
    st = adamw(constant(1e-3)).init(tp)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in tree_flatten(st["m"])[0] + tree_flatten(st["v"])[0])
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    fac = adafactor(constant(1e-3), stacks={}).init(tp)
    assert fac["v"]["layers"][0]["w"]["row"].shape == (6, 3)
    assert fac["v"]["layers"][0]["w"]["col"].shape == (6, 4)
    assert fac["v"]["ln_f"]["scale"]["full"].shape == (6,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_global_norm_matches_reference(dtype):
    tree = _tree(np.random.default_rng(2), 3.0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    np.testing.assert_allclose(float(global_norm(_to_torch(tree, dtype))),
                               float(jglobal_norm(_to_jax(tree, jdt))),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["constant", "warmup_cosine",
                                  "warmup_rsqrt"])
def test_schedules_match_reference(name):
    pairs = {"constant": (jconstant(3e-4), constant(3e-4)),
             "warmup_cosine": (jwarmup_cosine(3e-4, 5, 40),
                               warmup_cosine(3e-4, 5, 40)),
             "warmup_rsqrt": (jwarmup_rsqrt(1e-3, 7),
                              warmup_rsqrt(1e-3, 7))}
    jfn, tfn = pairs[name]
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 41, 1000):
        want = np.float32(jfn(jnp.int32(step)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tfn(arg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{name} step {step}")
