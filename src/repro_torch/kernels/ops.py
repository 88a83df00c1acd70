"""Engine-facing wrappers around the CUDA kernels.

Routing is by tensor device: each wrapper launches its CUDA kernel for
CUDA tensors (or raises; there is no fallback) and takes its plain
version (``ref.py``) for CPU tensors.  The engine calls these when
``EngineConfig.use_kernels`` is set; with it unset the engine runs the
plain ``core`` functions on any device.
"""

from __future__ import annotations

import torch

from .lif_step import lif_step as _lif_step
from .synaptic_accum import event_delivery_banded


def lif_step(state: dict, i_total, params, active=None):
    """Kernel-backed drop-in for ``core.neuron.lif_sfa_step``."""
    a = (active if active is not None
         else torch.ones_like(state["v"], dtype=torch.bool))
    v, c, r, spk = _lif_step(state["v"], state["c"], state["refrac"],
                             i_total, a, **params.kernel_args())
    return {"v": v, "c": c, "refrac": r}, spk


def synaptic_accum_banded(tiers, i_ring, t_slot: int, d_ring: int,
                          plan=None):
    """Local + halo-band delivery (one kernel launch per tier).
    ``tiers``: [(tables, spikes, active_cap)]; ``plan``: optional
    ``SynapseTableSpec.delivery_plan()`` the tables are validated
    against.  Returns (ring, n_events, n_dropped) summed over tiers."""
    return event_delivery_banded(tiers, i_ring, t_slot, d_ring, plan=plan)
