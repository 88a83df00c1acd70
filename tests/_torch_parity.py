"""Shared helpers of the ``test_torch_*`` parity tests: the same
configuration built in the JAX reference (``repro``) and in the PyTorch
port (``repro_torch``), the reference's drive, and bitwise comparisons.
Data crosses between the two packages as numpy arrays."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.core import connectivity as jconn
from repro.core import engine as jeng
from repro.core import grid as jgrid
from repro_torch.core import connectivity as tconn
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid

LAWS = ("gaussian", "exponential")


def configs(law: str, grid: int = 4, n_per_col: int = 30, tiles: int = 1,
            **kw):
    """(reference EngineConfig on its pure-XLA path, port EngineConfig)."""
    jl = getattr(jconn, f"{law}_law")()
    tl = getattr(tconn, f"{law}_law")()
    jcfg = jeng.EngineConfig(
        decomp=jgrid.TileDecomposition(
            jgrid.ColumnGrid(grid, grid, n_per_col), tiles, tiles,
            jl.radius), law=jl, use_kernels=False, **kw)
    tcfg = teng.EngineConfig(
        decomp=tgrid.TileDecomposition(
            tgrid.ColumnGrid(grid, grid, n_per_col), tiles, tiles,
            tl.radius), law=tl, **kw)
    return jcfg, tcfg


def reference_drive(jcfg, jstate, n_steps: int) -> np.ndarray:
    """The (n_steps, n_local) drive the reference draws, splitting the
    state's key each step exactly as ``repro.core.engine.step`` does."""
    key = jstate["rng"]
    n_local = jcfg.spec().n_local
    out = []
    for _ in range(n_steps):
        key, k_ext = jax.random.split(key)
        out.append(np.asarray(jeng.external_drive(k_ext, n_local, jcfg)))
    return np.stack(out)


def bits(x) -> np.ndarray:
    """The raw bits of a numpy/JAX array or a torch tensor, for bitwise
    equality (bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "f" or x.dtype.name == "bfloat16":
        return x.view(np.dtype(f"u{x.dtype.itemsize}"))
    return x


def assert_bits_equal(ref, port, what: str = "") -> None:
    a, b = bits(ref), bits(port)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    n_diff = int((a != b).sum())
    assert n_diff == 0, f"{what}: {n_diff} of {a.size} values differ"


def tier_arrays(tables) -> list:
    """Every tier of reference tables as a dict of numpy arrays."""
    return [{k: np.asarray(v) for k, v in t.items()} for t in tables.tiers()]


def lm_params(jcfg, seed: int = 0):
    """The reference's parameters of ``jcfg`` (``init_model``), with every
    zero-initialised leaf (norm scales, QKV biases, the conv and RG-LRU
    gate biases) set to small random values so that the ``(1 + w)``
    scales and the biases are exercised.
    Returns the JAX tree and the same tree as numpy arrays."""
    from repro.models.transformer import init_model
    params, _ = init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in ("scale", "bq", "bk", "bv", "q_norm", "k_norm", "b",
                    "b_a", "b_x"):
            noise = rng.normal(scale=0.3, size=leaf.shape)
            return jax.numpy.asarray(noise, leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# LM serving in both packages
# ---------------------------------------------------------------------------

def serve_rules(cfg, batch: int, max_len: int):
    """The sharding rules the reference's ``serve_batch`` builds."""
    from repro.launch.mesh import make_host_mesh
    from repro.parallel.sharding import rules_for_mesh
    mesh = make_host_mesh()
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model = axes.get("model", 1)
    ov = {}
    if cfg.n_heads % model:
        ov["heads"] = None
    if cfg.d_ff % model or not cfg.d_ff:
        ov["mlp"] = None
    if max_len % model:
        ov["kv_seq"] = None
    if batch % (axes.get("data", 1) * axes.get("pod", 1)):
        ov["batch"] = None
    return rules_for_mesh(mesh, **ov)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy().copy()
    return np.asarray(x, np.float32)


def _leaf_dict(st) -> dict:
    """One layer's decode state as a dict of float32 numpy arrays (a KV
    cache as ``{"k", "v"}``)."""
    if hasattr(st, "k"):
        return {"k": _f32(st.k), "v": _f32(st.v)}
    return {k: _leaf_dict(v) if isinstance(v, dict) else _f32(v)
            for k, v in st.items()}


def reference_layer_states(jcfg, jstate) -> list:
    """The reference's decode state per layer, in layer order: period
    ``i`` of ``blocks[pos]`` is layer ``i * len(pattern) + pos``, then
    ``rest``."""
    per = len(jcfg.pattern)
    layers = {}
    for pos, stacked in enumerate(jstate.get("blocks") or []):
        leaves = _leaf_dict(stacked)
        n = jax.tree.leaves(leaves)[0].shape[0]
        for i in range(n):
            layers[i * per + pos] = jax.tree.map(lambda a: a[i], leaves)
    base = len(layers)
    for j, st in enumerate(jstate.get("rest") or []):
        layers[base + j] = _leaf_dict(st)
    return [layers[i] for i in range(jcfg.n_layers)]


def port_layer_states(tstate) -> list:
    return [_leaf_dict(st) for st in tstate["layers"]]


def reference_cross_states(jcfg, jstate) -> list:
    """The reference's cross caches per decoder layer, in layer order:
    ``cross`` (stacked per pattern position, as ``blocks``), then
    ``cross_rest``."""
    return reference_layer_states(jcfg, {"blocks": jstate.get("cross"),
                                         "rest": jstate.get("cross_rest")})


def port_cross_states(tstate) -> list:
    return [_leaf_dict(st) for st in tstate["cross"]]


def frontend_inputs(cfg, rng, batch: int) -> dict:
    """Whisper's frames, then a VLM's patch embeddings, drawn from
    ``rng`` as the reference's ``serve_batch`` draws them (float32)."""
    from repro.models.frontends import STUB_WIDTH
    out = {}
    for key, n in (("frames", cfg.encoder_seq),
                   ("patch_embeds", cfg.n_patches)):
        if n:
            out[key] = rng.standard_normal(
                (batch, n, STUB_WIDTH)).astype(np.float32)
    return out


def serve_both(arch: str, impl: str, dtype: str = "float32",
               batch: int = 2, prompt: int = 20, steps: int = 8,
               meshless: bool = False, **overrides):
    """Prefill and ``steps`` decode steps of the reduced ``arch`` in both
    packages (``overrides`` replace config fields in both), the port
    teacher-forced on the reference's greedy tokens, the weights the
    reference's (``lm_params``).  The reference runs under the rules of
    its ``serve_batch`` (a host mesh), or without a mesh (``meshless``:
    its MoE layers then take the dispatch the port ports,
    ``_apply_moe_dense``, not the expert-parallel one).  Whisper's frames
    and a VLM's patches are drawn after the tokens
    (``frontend_inputs``); a VLM decodes from ``n_patches + prompt``.
    Returns the two lists of logits and
    ``{"prefill": (ref, port), "final": (ref, port)}``: each package's
    decode state per layer (``reference_layer_states``) after the prefill
    and after the last step, and with cross-attention
    ``"cross_prefill"`` / ``"cross_final"``, the cross caches per layer
    (``reference_cross_states``)."""
    import dataclasses

    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.models import model as jm
    from repro.models import transformer as jt
    from repro_torch import configs as tconfigs
    from repro_torch.core.convert import model_params_from_arrays
    from repro_torch.models import model as tm
    from repro_torch.models import transformer as tt
    jcfg = dataclasses.replace(jget_reduced(arch), attn_impl=impl,
                               dtype=dtype, **overrides)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), attn_impl=impl,
                               dtype=dtype, **overrides)
    jp, arrays = lm_params(jcfg)
    tp = model_params_from_arrays(tcfg, arrays, device="cpu")
    start = jcfg.n_patches + prompt
    max_len = start + steps
    if meshless:
        from repro.parallel.sharding import MeshRules
        rules = MeshRules()
    else:
        rules = serve_rules(jcfg, batch, max_len)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, prompt)).astype(
        np.int32)
    extra = frontend_inputs(jcfg, rng, batch)

    jstate = jt.init_decode_state(jcfg, batch, max_len)
    tstate = tt.init_decode_state(tcfg, batch, max_len, device="cpu")
    jbatch = {k: jnp.asarray(v) for k, v in extra.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in extra.items()}
    jlg, jstate = jax.jit(jm.make_prefill(jcfg, rules))(
        jp, {"tokens": jnp.asarray(tokens), **jbatch}, jstate)
    tlg, tstate = tm.make_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(tokens), **tbatch}, tstate)
    cross = jcfg.cross_attn and jcfg.encoder_seq

    def snapshot(when):
        states[when] = (reference_layer_states(jcfg, jstate),
                        port_layer_states(tstate))
        if cross:
            states["cross_" + when] = (reference_cross_states(jcfg, jstate),
                                       port_cross_states(tstate))

    states = {}
    snapshot("prefill")
    jl_all, tl_all = [jlg], [tlg]
    jstep = jax.jit(jm.make_serve_step(jcfg, rules))
    tstep = tm.make_serve_step(tcfg)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jlg[:, -1:], axis=-1)).astype(np.int32)
        jlg, jstate = jstep(jp, jstate, jnp.asarray(tok),
                            jnp.int32(start + i))
        tlg, tstate = tstep(tp, tstate, torch.from_numpy(tok), start + i)
        jl_all.append(jlg)
        tl_all.append(tlg)
    snapshot("final")
    return jl_all, tl_all, states


def assert_states_close(ref_layers: list, port_layers: list, tol: float):
    """Every layer's decode state leaf within ``tol`` (rtol and atol)."""
    assert len(ref_layers) == len(port_layers)
    for i, (r, p) in enumerate(zip(ref_layers, port_layers)):
        r_leaves = jax.tree_util.tree_flatten_with_path(r)[0]
        p_leaves = jax.tree_util.tree_flatten_with_path(p)[0]
        assert [k for k, _ in r_leaves] == [k for k, _ in p_leaves], i
        for (path, a), (_, b) in zip(r_leaves, p_leaves):
            np.testing.assert_allclose(
                b, a, rtol=tol, atol=tol,
                err_msg=f"layer {i} {jax.tree_util.keystr(path)}")


class ShapeMesh:
    """What the reference's ``launch.dryrun._rules_for`` reads of a mesh
    (its axis names, iterable as ``rules_for_mesh`` takes a tuple, and
    its device array's shape): no device is needed."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=np.int8)

    def __iter__(self):
        return iter(self.axis_names)


def reference_dryrun():
    """The reference's dry-run module, imported after jax has its
    devices (its import sets XLA_FLAGS for a later first init, which is
    put back)."""
    import os
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun
