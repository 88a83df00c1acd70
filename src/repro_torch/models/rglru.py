"""RG-LRU recurrent block (recurrentgemma / Griffin): the port of
``repro.models.rglru``.

Real-Gated Linear Recurrent Unit::

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  per-channel decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped Griffin-style: in-proj to (x, gate) branches, the temporal conv
on the x branch, the RG-LRU, then ``h * gelu(gate)`` (the tanh form of
GELU, as ``jax.nn.gelu`` computes it) and the out-proj.  The recurrence
is diagonal, so it shares the mamba block's chunked log-depth scan
(``ssm.diag_scan_chunk``).  The state is ``{"conv": (B, k-1, w), "h":
(B, w) float32}``.

On ranks (``rules`` with a mesh) every rank holds its ``w / M``
channels: ``in_proj``'s slice of both halves
(``parallel.sharding.Halves``), the conv, ``b_a``, ``b_x``, ``lam``,
the scan and the state.  ``w_a`` and ``w_x`` are ``(None, "d_inner")``:
the rank's output channels over *every* input channel, so the conv's
output is gathered over the ``d_inner`` axes (once for the whole
sequence; its backward reduce-scatters) before the gates, and
``out_proj``'s product is summed over them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import gather_dim, psum_over
from .config import ModelConfig
from .layers import _normal, apply_conv1d, init_conv1d, random_uniform
from .ssm import diag_scan_chunk

_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's distributions: ``lam`` the inverse softplus of
    ``-log(u) / (2 c)`` with u uniform in [0.9^2, 0.999^2] (so the decay
    ``a^c`` at r = 1 lies in [0.9, 0.999]); ``lam`` and the gate biases
    in float32."""
    d, w, k = cfg.d_model, cfg.resolved_rglru_width, cfg.conv_k
    dev = gen.device
    u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * random_uniform(gen, (w,))
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * _C)))
    return {
        "in_proj": _normal(gen, (d, 2 * w), 1 / math.sqrt(d), dtype),
        "conv": init_conv1d(gen, w, k, dtype),
        "w_a": _normal(gen, (w, w), 1 / math.sqrt(w), dtype),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_x": _normal(gen, (w, w), 1 / math.sqrt(w), dtype),
        "b_x": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lam": lam,
        "out_proj": _normal(gen, (w, d), 1 / math.sqrt(w), dtype),
    }


def _gates(p, x_c, x_all):
    """The decay and the gated input of a chunk.  x_c: (B, C, w) (on
    ranks the rank's channels); x_all: every channel of it (``x_c``
    itself on one card)."""
    xf = x_c.to(torch.float32)
    r = torch.sigmoid((x_all @ p["w_a"]).to(torch.float32) + p["b_a"])
    i = torch.sigmoid((x_all @ p["w_x"]).to(torch.float32) + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2), stably through expm1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (i * xf)


def _chunk_step(p, h, x_chunk, x_all_chunk, chunk: int):
    """One chunk of the scan (``x_chunk`` its valid positions, up to
    ``chunk``; ``x_all_chunk`` the same positions of every channel):
    (h_last, h over the valid positions, float32).  The padded tail
    (a = 1, b = 0) does not advance the state."""
    n_valid = x_chunk.shape[1]
    a, bx = _gates(p, x_chunk, x_all_chunk)
    if n_valid < chunk:
        a = F.pad(a, (0, 0, 0, chunk - n_valid), value=1.0)
        bx = F.pad(bx, (0, 0, 0, chunk - n_valid))
    h, h_all = diag_scan_chunk(a, bx, h)
    return h, h_all[:, :n_valid]


def apply_rglru(p, cfg: ModelConfig, x, state: Optional[dict] = None,
                rules=None):
    """x: (B, S, d) -> (out, new_state); ``state`` = ``{"conv", "h"}``
    for decode and for a prefill that continues from it, None for
    training.  Training with grad enabled runs each chunk under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's scan
    runs ``jax.checkpoint(step)``.  On ranks ``p`` and ``state`` are
    this rank's channels (module docstring)."""
    b, s, _ = x.shape

    xz = x @ gather_dim(p["in_proj"], rules, "fsdp", 0)
    x_in, gate = torch.chunk(xz, 2, dim=-1)
    w = x_in.shape[-1]
    if state is not None:
        x_c, conv_state = apply_conv1d(p["conv"], x_in, state["conv"])
    else:
        x_c, conv_state = apply_conv1d(p["conv"], x_in), None
    x_all = gather_dim(x_c, rules, "d_inner", x_c.dim() - 1, "tp")

    if state is not None and s == 1:
        a, bx = _gates(p, x_c, x_all)
        h = a[:, 0] * state["h"] + bx[:, 0]
        y = h[:, None]
        new_state = {"conv": conv_state, "h": h}
    else:
        chunk = min(cfg.mamba_chunk, s)
        h = torch.zeros((b, w), dtype=torch.float32, device=x.device) \
            if state is None else state["h"]
        remat = state is None and torch.is_grad_enabled()
        ys = []
        for c0 in range(0, s, chunk):
            x_chunk, x_all_chunk = x_c[:, c0:c0 + chunk], \
                x_all[:, c0:c0 + chunk]
            if remat:
                h, y_c = checkpoint(_chunk_step, p, h, x_chunk, x_all_chunk,
                                    chunk, use_reentrant=False)
            else:
                h, y_c = _chunk_step(p, h, x_chunk, x_all_chunk, chunk)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
        new_state = None if state is None else {"conv": conv_state, "h": h}

    y = y.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ gather_dim(p["out_proj"], rules, "fsdp", 1)
    return psum_over(out, rules, "d_inner", "tp"), new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    w = cfg.resolved_rglru_width
    return {"conv": torch.zeros((batch, cfg.conv_k - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device)}


def abstract_rglru_state(cfg: ModelConfig, batch: int, dtype) -> dict:
    """``init_rglru_state``'s shapes and dtypes as ``"meta"`` tensors."""
    return init_rglru_state(cfg, batch, dtype, device="meta")
