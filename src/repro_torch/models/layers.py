"""Primitive layers of the LM stack: parameters as plain dicts of
tensors, functional applies (the port of ``repro.models.layers``).

The reference's quirks are carried across as they are:

* ``apply_rmsnorm`` always uses the ``(1 + w)`` scale (the reference
  never reads ``cfg.rms_offset``), computed in float32 with eps 1e-6;
* ``apply_mlp``'s GeGLU is the tanh approximation of GELU (the default
  of ``jax.nn.gelu``);
* ``apply_embedding`` rounds ``sqrt(d)`` to the working dtype before it
  multiplies;
* ``apply_rope`` rotates split halves (not interleaved pairs), with its
  angles in float32;
* ``logits_from_embedding`` returns padded-vocabulary logits.

The reference's ``init_*`` functions also return logical sharding
names; the port's return the parameters only, and ``logical_names``
names a leaf by its place in the tree (the reference's names, which no
placement reads on one card).  Every ``init_*`` draws through
``random_normal`` / ``random_uniform``: given ``META_GEN`` in place of
a ``torch.Generator`` they return uninitialised ``"meta"`` tensors, so
the abstract (shape-and-dtype) trees come from the same code as the
real ones.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import gather_dim, index_along, psum_over
from ..parallel.sharding import Halves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported model dtype {name!r}") from None


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``"meta"`` device,
    which has none: the draws below return uninitialised meta tensors
    for it, and ``gen.device`` places the zeros and ones beside them."""

    device = torch.device("meta")


META_GEN = MetaGenerator()


def random_normal(gen, shape) -> torch.Tensor:
    """Standard normal float32 draws on ``gen`` (a meta tensor for
    ``META_GEN``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def random_uniform(gen, shape) -> torch.Tensor:
    """Uniform [0, 1) float32 draws on ``gen`` (a meta tensor for
    ``META_GEN``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)


def _normal(gen: torch.Generator, shape, scale: float, dtype):
    """N(0, scale^2) drawn in float32 on ``gen``'s device, then cast: the
    distribution of the reference's ``_normal`` (not its numbers)."""
    return (random_normal(gen, shape) * scale).to(dtype)


# the reference's logical axis names of every parameter leaf, by the
# leaf's key and, where a key means two things, its parent's key
_MLP_NAMES = {"gate": ("fsdp", "mlp"), "up": ("fsdp", "mlp"),
              "down": ("mlp", "fsdp")}
_PARENT_NAMES = {
    "mlp": _MLP_NAMES,
    "moe": {"router": ("fsdp", "experts"),
            "gate": ("experts", "fsdp", None),
            "up": ("experts", "fsdp", None),
            "down": ("experts", None, "fsdp")},
    "conv": {"w": (None, "d_inner"), "b": ("d_inner",)},
}
_LEAF_NAMES = {
    "table": ("vocab", "fsdp"), "scale": (None,),
    "wq": ("fsdp", "heads", None), "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None), "wo": ("heads", None, "fsdp"),
    "bq": ("heads", None), "bk": ("kv_heads", None),
    "bv": ("kv_heads", None), "q_norm": (None,), "k_norm": (None,),
    # [x | z] side by side: each rank holds its channels of both halves
    "in_proj": ("fsdp", Halves("d_inner")), "out_proj": ("d_inner", "fsdp"),
    "x_proj": ("d_inner", None), "dt_proj": (None, "d_inner"),
    "dt_bias": ("d_inner",), "a_log": ("d_inner", None),
    "d_skip": ("d_inner",), "w_a": (None, "d_inner"), "b_a": ("d_inner",),
    "w_x": (None, "d_inner"), "b_x": ("d_inner",), "lam": ("d_inner",),
    "adapter": (None, "fsdp"),
}


def logical_names(parent: str, key: str) -> tuple:
    """The logical axis names of the parameter leaf ``key`` of the dict
    held under ``parent`` (``"mlp"``'s ``"gate"``, ``"attn"``'s
    ``"wq"``); raises on a leaf it does not know."""
    names = _PARENT_NAMES.get(parent, {}).get(key) or _LEAF_NAMES.get(key)
    if names is None:
        raise KeyError(f"no logical names for parameter {parent}/{key}")
    return names


def init_dense(gen, d_in: int, d_out: int, dtype, bias: bool = False,
               scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def apply_dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_rmsnorm(p, x, *, offset: bool = True, eps: float = 1e-6):
    """RMSNorm in float32; ``offset=True`` is the ``(1 + w)`` scale."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = p["scale"].to(torch.float32)
    return (x * (1.0 + w if offset else w)).to(dt)


def init_embedding(gen, vocab: int, d: int, dtype) -> dict:
    return {"table": _normal(gen, (vocab, d), 1.0, dtype)}


def apply_embedding(p, tokens, *, scale: bool = False, rules=None):
    """The rows of ``tokens``.  On ranks (``rules`` with a mesh) the
    table is this rank's block, ``("vocab", "fsdp")``: the FSDP dim is
    gathered, each rank looks up the tokens in its vocabulary range
    (zeros for the others) and the rows are summed over the vocab axes
    (exact: one row is not zero)."""
    table = gather_dim(p["table"], rules, "fsdp", 1)
    part, parts = index_along(rules, "vocab")
    if parts > 1:
        local = tokens.long() - part * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(inside, local, torch.zeros_like(local))]
        x = psum_over(torch.where(inside[..., None], rows,
                                  torch.zeros_like(rows)),
                      rules, "vocab", "tp")
    else:
        x = table[tokens.long()]
    if scale:
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype,
                             device=x.device)
    return x


def logits_from_embedding(p, x):
    """Tied LM head: ``x @ table^T`` (padded-vocab logits)."""
    return x @ p["table"].T


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, d_ff: int, dtype) -> dict:
    return {
        "gate": _normal(gen, (d, d_ff), 1.0 / math.sqrt(d), dtype),
        "up": _normal(gen, (d, d_ff), 1.0 / math.sqrt(d), dtype),
        "down": _normal(gen, (d_ff, d), 1.0 / math.sqrt(d_ff), dtype),
    }


def apply_mlp(p, x, act: str = "silu", rules=None):
    """The gated MLP.  On ranks, ``gate``/``up`` are this rank's columns
    (``("fsdp", "mlp")``) and ``down`` its rows (``("mlp", "fsdp")``):
    the FSDP dims are gathered and the output is summed over the mlp
    axes."""
    gate = gather_dim(p["gate"], rules, "fsdp", 0)
    up = gather_dim(p["up"], rules, "fsdp", 0)
    down = gather_dim(p["down"], rules, "fsdp", 1)
    a = x @ gate
    a = F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")
    return psum_over((a * (x @ up)) @ down, rules, "mlp", "tp")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) or (S,) integer."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)            # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d: int, device="cuda") -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (no parameters), float32
    (S, d): ``[sin, cos]`` of ``pos / 10000 ** (dim / d)``.

    ``positions``: an int ``n`` (``arange(n)`` on ``device``), or an
    (S,) position tensor (decode computes the embedding at the current
    offset directly, no table; ``device`` is then the tensor's).  The
    caller casts to its working dtype, as the reference's does."""
    if isinstance(positions, int):
        positions = torch.arange(positions, dtype=torch.int32,
                                 device=device)
    pos = positions.to(torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=pos.device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Causal temporal conv (the mamba and RG-LRU blocks' front)
# ---------------------------------------------------------------------------

def init_conv1d(gen, channels: int, k: int, dtype) -> dict:
    return {"w": _normal(gen, (k, channels), 1.0 / math.sqrt(k), dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=gen.device)}


def apply_conv1d(p, x, state=None):
    """Depthwise causal conv along the sequence.  x: (B, S, C).

    ``state``: the (B, k-1, C) carry of the trailing inputs (decode and
    continued prefill); returns ``(y, new_state)`` when given, else y.
    The k taps are summed in the reference's order (tap 0 first, then
    the bias), in the parameters' dtype."""
    k = p["w"].shape[0]
    s = x.shape[1]
    if state is not None:
        window = torch.cat([state, x], dim=1)              # (B, k-1+S, C)
        new_state = window[:, window.shape[1] - (k - 1):, :]
    else:
        window = F.pad(x, (0, 0, k - 1, 0))
        new_state = None
    y = window[:, 0:s, :] * p["w"][0]
    for i in range(1, k):
        y = y + window[:, i:i + s, :] * p["w"][i]
    y = y + p["b"]
    return (y, new_state) if state is not None else y
