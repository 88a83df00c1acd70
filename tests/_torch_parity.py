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
    zero-initialised leaf (norm scales, QKV biases) set to small random
    values so that the ``(1 + w)`` scales and the biases are exercised.
    Returns the JAX tree and the same tree as numpy arrays."""
    from repro.models.transformer import init_model
    params, _ = init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in ("scale", "bq", "bk", "bv", "q_norm", "k_norm"):
            noise = rng.normal(scale=0.3, size=leaf.shape)
            return jax.numpy.asarray(noise, leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    return params, jax.tree.map(np.asarray, params)
