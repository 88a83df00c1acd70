"""Mamba-1 selective SSM block (falcon-mamba-7b): the port of
``repro.models.ssm``.

The sequence runs in chunks of ``cfg.mamba_chunk`` positions: a Python
loop over the chunks carries the (B, d_inner, N) state, and inside a
chunk the diagonal linear recurrence ``h_t = a_t h_{t-1} + b_t`` runs as
a log-depth parallel scan (``diag_scan_chunk``, the reference's
``associative_scan`` with the same combine and the same odd/even
recursion), so the (B, chunk, d_inner, N) discretised tensors exist
only per chunk and a chunk costs O(log chunk) launches, not one per
position.  Single-token decode is the closed-form one-step update.

The state is ``{"conv": (B, k-1, d_inner), "ssm": (B, d_inner, N)
float32}``; ``apply_mamba`` returns a new state dict and leaves the one
it was given unchanged.

On ranks (``rules`` with a mesh) every rank holds its ``d_inner / M``
channels of each leaf: ``in_proj``'s block is its slice of both halves
(``parallel.sharding.Halves``), the conv, ``dt_proj``, ``dt_bias``,
``a_log``, ``d_skip``, the scan and the state are per channel and
local, and the two products that contract over the channels,
``x_proj`` and ``out_proj``, are summed over the ``d_inner`` axes.
``x_proj``'s product is taken once for the whole sequence (one sum a
layer, not one a chunk).
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


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, b1 * a2 + b2


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along axis 1 (``even`` one longer or as
    long as ``odd``)."""
    shape = (even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:]
    out = torch.empty(shape, dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """Inclusive scan of ``_combine`` over axis 1: the prefix products of
    ``a`` and the prefix sums ``b_t + a_t (b_{t-1} + ...)``.  The
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half, then fill the even positions, so the association
    order is the reference's (log2(n) levels, O(n) work)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    return (_interleave(torch.cat([a[:, :1], even[0]], dim=1), odd[0]),
            _interleave(torch.cat([b[:, :1], even[1]], dim=1), odd[1]))


def diag_scan_chunk(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` within one chunk (axis 1), given the
    carry.  a, b: (B, C, ...); h0: (B, ...).  Returns (h_last, h_all);
    ``h_last`` is a copy, so a carried state does not hold the chunk's
    ``h_all`` alive."""
    prod, pref = associative_scan(a, b)
    h_all = prod * h0[:, None] + pref
    return h_all[:, -1].clone(), h_all


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's distributions: S4D-real ``a_log = log(1..N)``,
    ``dt_bias`` the inverse softplus of a dt drawn log-uniformly in
    [1e-3, 1e-1], ``d_skip`` ones; those three in float32."""
    d, di = cfg.d_model, cfg.d_inner
    n, r, k = cfg.ssm_state, cfg.resolved_dt_rank, cfg.conv_k
    dev = gen.device
    a_init = torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev)[None].repeat(di, 1)
    u = random_uniform(gen, (di,))
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "in_proj": _normal(gen, (d, 2 * di), 1 / math.sqrt(d), dtype),
        "conv": init_conv1d(gen, di, k, dtype),
        "x_proj": _normal(gen, (di, r + 2 * n), 1 / math.sqrt(di), dtype),
        "dt_proj": _normal(gen, (r, di), 1 / math.sqrt(r), dtype),
        "dt_bias": dt_bias,
        "a_log": torch.log(a_init),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _normal(gen, (di, d), 1 / math.sqrt(di), dtype),
    }


def _xdb(p, x_c, rules):
    """``x_c @ x_proj`` (B, S, r + 2N): on ranks summed over the
    ``d_inner`` axes (each rank holds its channels' rows)."""
    return psum_over(x_c @ p["x_proj"], rules, "d_inner", "tp")


def _ssm_inputs(p, cfg: ModelConfig, xdb):
    """Per-position SSM tensors from ``_xdb`` of the conv output (any
    length): dt (softplus, float32), B and C (float32)."""
    n, r = cfg.ssm_state, cfg.resolved_dt_rank
    dt_low, b_in, c_in = torch.split(xdb, [r, n, n], dim=-1)
    dt = F.softplus((dt_low @ p["dt_proj"]).to(torch.float32)
                    + p["dt_bias"])
    return dt, b_in.to(torch.float32), c_in.to(torch.float32)


def _chunk_step(p, cfg: ModelConfig, a_neg, h, x_chunk, xdb_chunk,
                n_valid: int):
    """One chunk of the scan: (h_last, y (B, C, di) float32).  Positions
    from ``n_valid`` on are padding: they must not advance the state
    (a = 1, b = 0 there)."""
    dt, b_in, c_in = _ssm_inputs(p, cfg, xdb_chunk)
    xf = x_chunk.to(torch.float32)
    a = torch.exp(dt[..., None] * a_neg[None, None])        # (B,C,di,N)
    bx = dt[..., None] * b_in[:, :, None, :] * xf[..., None]
    if n_valid < x_chunk.shape[1]:
        vc = (torch.arange(x_chunk.shape[1], device=a.device)
              < n_valid)[None, :, None, None]
        a = torch.where(vc, a, torch.ones_like(a))
        bx = torch.where(vc, bx, torch.zeros_like(bx))
    h_last, h_all = diag_scan_chunk(a, bx, h)
    y = torch.einsum("bcdn,bcn->bcd", h_all, c_in)
    return h_last, y


def apply_mamba(p, cfg: ModelConfig, x, state: Optional[dict] = None,
                rules=None):
    """x: (B, S, d).  Returns (out, new_state).

    ``state`` = ``{"conv", "ssm"}`` for decode and for a prefill that
    continues from it; None for training (a zero initial state, no state
    returned).  Training with grad enabled runs each chunk under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's scan
    runs ``jax.checkpoint(step)``: the backward recomputes a chunk's
    (B, C, d_inner, N) tensors instead of keeping every chunk's, so the
    bytes saved for it do not grow with the number of chunks.  On ranks
    ``p`` and ``state`` are this rank's channels (module docstring)."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    a_neg = -torch.exp(p["a_log"])                          # (di, N)

    xz = x @ gather_dim(p["in_proj"], rules, "fsdp", 0)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    di = x_in.shape[-1]
    if state is not None:
        x_c, conv_state = apply_conv1d(p["conv"], x_in, state["conv"])
    else:
        x_c, conv_state = apply_conv1d(p["conv"], x_in), None
    x_c = F.silu(x_c)

    if state is not None and s == 1:
        # single-step decode: h' = exp(dt A) h + dt B x
        dt, b_in, c_in = _ssm_inputs(p, cfg, _xdb(p, x_c, rules))
        dt1, b1, c1 = dt[:, 0], b_in[:, 0], c_in[:, 0]
        x1 = x_c[:, 0].to(torch.float32)
        da = torch.exp(dt1[:, :, None] * a_neg[None])        # (B, di, N)
        db = dt1[:, :, None] * b1[:, None, :] * x1[:, :, None]
        h = da * state["ssm"] + db
        y = torch.einsum("bdn,bn->bd", h, c1)[:, None]
        new_state = {"conv": conv_state, "ssm": h}
    else:
        chunk = min(cfg.mamba_chunk, s)
        h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device) \
            if state is None else state["ssm"]
        remat = state is None and torch.is_grad_enabled()
        xdb = _xdb(p, x_c, rules)
        ys = []
        for c0 in range(0, s, chunk):
            x_chunk, xdb_chunk = x_c[:, c0:c0 + chunk], xdb[:, c0:c0 + chunk]
            n_valid = x_chunk.shape[1]
            if n_valid < chunk:          # the padded tail of the sequence
                x_chunk = F.pad(x_chunk, (0, 0, 0, chunk - n_valid))
                xdb_chunk = F.pad(xdb_chunk, (0, 0, 0, chunk - n_valid))
            if remat:
                h, y_c = checkpoint(_chunk_step, p, cfg, a_neg, h, x_chunk,
                                    xdb_chunk, n_valid, use_reentrant=False)
            else:
                h, y_c = _chunk_step(p, cfg, a_neg, h, x_chunk, xdb_chunk,
                                     n_valid)
            ys.append(y_c[:, :n_valid])
        y = torch.cat(ys, dim=1)
        new_state = None if state is None else \
            {"conv": conv_state, "ssm": h}

    y = (y + p["d_skip"] * x_c.to(torch.float32)).to(x.dtype)
    y = y * F.silu(z)
    out = y @ gather_dim(p["out_proj"], rules, "fsdp", 1)
    return psum_over(out, rules, "d_inner", "tp"), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    return {"conv": torch.zeros((batch, cfg.conv_k - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def abstract_mamba_state(cfg: ModelConfig, batch: int, dtype) -> dict:
    """``init_mamba_state``'s shapes and dtypes as ``"meta"`` tensors."""
    return init_mamba_state(cfg, batch, dtype, device="meta")
