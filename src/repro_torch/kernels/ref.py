"""Plain PyTorch versions of the CUDA kernels.

These are the semantics of record, mirroring ``repro/kernels/ref.py``.
Each kernel wrapper takes its plain version for CPU tensors, and
``chip_smoke.py`` holds every kernel against its plain version on the
card.  They run on any device.
"""

from __future__ import annotations

import torch

# repro-lint: ignore[dtype-bounds] the plain LIF evaluates each fused
# multiply-add in double and rounds once to float32 (the product of two
# float32 values is exact in double); nothing is stored in double
_F64 = torch.float64


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (to the precision of a fused
    multiply-add, up to double-rounding ties)."""
    return (a.to(_F64) * b + c.to(_F64)).to(torch.float32)


# ---------------------------------------------------------------------------
# LIF + SFA fused neuron update (kernels/lif_step.py)
# ---------------------------------------------------------------------------

def lif_step_ref(v, c, refrac, i_total, active, *, leak_decay, sfa_decay,
                 neg_g_dt, v_rest, v_reset, theta, alpha_c, refrac_steps):
    """Returns (v', c', refrac', spk f32).  Same arithmetic as the CUDA
    kernel: ``v_int = fma(neg_g_dt, c, fma(v - v_rest, leak, i)) + v_rest``
    (the ``v_rest`` terms only when it is nonzero), ``c' = fma(c,
    sfa_decay, alpha_c * spk)``."""
    u = v - v_rest if v_rest != 0.0 else v
    v_int = _fma(c, neg_g_dt, _fma(u, leak_decay, i_total))
    if v_rest != 0.0:
        v_int = v_int + v_rest
    v_new = torch.where(refrac > 0, torch.full_like(v, v_reset), v_int)
    spiked = (v_new >= theta) & active
    v_new = torch.where(spiked, torch.full_like(v, v_reset), v_new)
    spk = spiked.to(torch.float32)
    c_new = _fma(c, sfa_decay, alpha_c * spk)
    refrac_new = torch.where(spiked, torch.full_like(refrac, refrac_steps),
                             torch.clamp(refrac - 1, min=0))
    return v_new, c_new, refrac_new, spk


# ---------------------------------------------------------------------------
# Event-driven synaptic accumulation (kernels/synaptic_accum.py)
# ---------------------------------------------------------------------------

def synaptic_accum_ref(idx, t_slot: int, tgt, w, dslot, ring):
    """Deliver the rows listed in ``idx`` into the delay ring, in place.

    idx: (A,) row indices (padding rows point at the all-zero sink row
    ``tgt.shape[0]-1``); ring: (D, n_local) f32, updated and returned.
    """
    d_ring, n_local = ring.shape
    idx = idx.long()
    rows_t = tgt[idx].long()
    rows_w = w[idx].to(torch.float32)
    slots = (t_slot + dslot[idx].long()) % d_ring
    ring.view(-1).index_add_(0, (slots * n_local + rows_t).ravel(),
                             rows_w.ravel())
    return ring


def deliver_rows_ref(tables: dict, idx, ring, t_slot: int, events):
    """Plain version of the delivery kernel: ``synaptic_accum_ref`` over
    the tier's tables, plus the tier's synaptic events (``nnz`` of the
    delivered rows) added into the int32 counter ``events``."""
    synaptic_accum_ref(idx, t_slot, tables["tgt"], tables["w"],
                       tables["dslot"], ring)
    events += tables["nnz"][idx.long()].sum().to(torch.int32)
    return ring
