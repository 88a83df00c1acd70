"""Engine- and model-facing wrappers around the CUDA kernels.

Routing is by tensor device: each wrapper launches its CUDA kernel for
CUDA tensors (or raises; there is no fallback) and takes its plain
version (``ref.py``) for CPU tensors.  The engine calls these when
``EngineConfig.use_kernels`` is set; with it unset the engine runs the
plain ``core`` functions on any device.  The LM stack calls
``attention`` when ``ModelConfig.attn_impl == "pallas"``.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .flash_attention import flash_attention
from .lif_step import lif_step as _lif_step
from .neuron_step import neuron_step as _neuron_step
from .plastic_step import plastic_delivery_ltd
from .spike_compact import spike_compact as _spike_compact
from .synaptic_accum import event_delivery, event_delivery_banded

# the row group (and target column width) of ``synaptic_accum_events``'
# run descriptor: any grouping delivers the same sums, this one a warp's
# rows
DEFAULT_ROW_GROUP = 32


def lif_step(state: dict, i_total, params, active=None):
    """Kernel-backed drop-in for ``core.neuron.lif_sfa_step``."""
    a = (active if active is not None
         else torch.ones_like(state["v"], dtype=torch.bool))
    v, c, r, spk = _lif_step(state["v"], state["c"], state["refrac"],
                             i_total, a, **params.kernel_args())
    return {"v": v, "c": c, "refrac": r}, spk


def lif_step_ref(state: dict, i_total, params, active=None):
    """The plain version of ``lif_step`` (``ref.lif_step_ref``) on any
    device."""
    a = (active if active is not None
         else torch.ones_like(state["v"], dtype=torch.bool))
    v, c, r, spk = ref.lif_step_ref(state["v"], state["c"], state["refrac"],
                                    i_total, a, **params.kernel_args())
    return {"v": v, "c": c, "refrac": r}, spk


def neuron_step(state: dict, i_ring, slot: int, drive, params, active,
                active_cap=None, inplace: bool = False):
    """The step's head in one kernel: ``i_ring[slot] + drive``, the
    LIF+SFA update of ``core.neuron.lif_sfa_step``, ``i_ring[slot] = 0``
    and, with ``active_cap``, the local tier's delivered-row bitmap.
    ``inplace`` writes the new state into ``state``'s tensors.  Returns
    (new state, spikes f32, bits int32 or None, count int32 0-d)."""
    v, c, r, spk, bits, count = _neuron_step(
        i_ring, slot, drive, state["v"], state["c"], state["refrac"],
        active, active_cap=active_cap,
        out=(state["v"], state["c"], state["refrac"]) if inplace else None,
        **params.kernel_args())
    return {"v": v, "c": c, "refrac": r}, spk, bits, count


def synaptic_accum_events(tables: dict, spikes_src, i_ring, t_slot: int,
                          d_ring: int, active_cap: int):
    """Kernel-backed drop-in for ``core.synapses.deliver_events``: one
    tier's delivery of its first ``active_cap`` spiking rows into the
    ring (in place).  On a CUDA ring the tier's run descriptor is built
    at first use and cached on its tensors (``core.synapses.column_runs``,
    rows and targets in groups of ``DEFAULT_ROW_GROUP``: the tables do
    not name their columns, and where the groups cut them the descriptor
    indexes a copy of the entries sorted by run, which delivers the same
    sums) and the column kernel delivers; a CPU ring takes the plain
    version.  Returns (ring, n_events, n_dropped)."""
    runs = None
    if _build.on_cuda(i_ring):
        from ..core.synapses import column_runs
        runs = column_runs([tables], DEFAULT_ROW_GROUP, DEFAULT_ROW_GROUP,
                           d_ring)[0]
    return event_delivery(tables, spikes_src, i_ring, t_slot, d_ring,
                          active_cap, runs=runs)


def synaptic_accum_banded(tiers, i_ring, t_slot: int, d_ring: int,
                          plan=None, runs=None, tier_bits=None):
    """Local + halo-band delivery (one kernel launch per tier).
    ``tiers``: [(tables, spikes, active_cap)]; ``plan``: optional
    ``SynapseTableSpec.delivery_plan()`` the tables are validated
    against; ``runs``: the tiers' run descriptors
    (``SynapseTables.column_runs``); ``tier_bits``: per tier its
    (bitmap, count), from ``neuron_step`` or ``ref.delivered_bits``,
    or None.  Returns (ring, n_events, n_dropped) summed over tiers."""
    return event_delivery_banded(tiers, i_ring, t_slot, d_ring, plan=plan,
                                 runs=runs, tier_bits=tier_bits)


def plastic_step_banded(tiers, masks, x_post_decayed, i_ring, t_slot: int,
                        d_ring: int, neg_a_minus: float, *, inv: dict,
                        plan=None):
    """Fixed-order delivery + in-pass LTD (one launch per tier) through
    the inverse index ``inv``.  ``x_post_decayed`` is the post trace
    after this step's decay, before its spike increment; ``masks=None``
    delivers only (static float32 weights).  Returns (ring, new_w_tiers,
    n_events, n_dropped); ring and weights are updated in place."""
    return plastic_delivery_ltd(tiers, masks, x_post_decayed, i_ring,
                                t_slot, d_ring, neg_a_minus, inv=inv,
                                plan=plan)


def spike_compact(spikes, n_rows: int, active_cap: int):
    """Kernel-backed drop-in for ``ref.compact_events``: the ascending
    spiking-row index list (sink-padded) plus the uncapped spike count
    (int32).  Feeds the device-side spike recorder."""
    return _spike_compact(spikes, n_rows, active_cap)


def attention(q, k, v, *, causal: bool = True, window=None, scale=None,
              q_offset: int = 0, return_lse: bool = False):
    """Masked multi-head attention with GQA: q (BH, Sq, D), k, v
    (BH_kv, Sk, D), BH % BH_kv == 0.  Returns (BH, Sq, D) in q's dtype;
    rows that see no key are 0.  ``return_lse``: also the rows' float32
    ``(BH, Sq)`` statistic ``m + log l`` (+1e30 on a row that saw no
    key), the training backward's residual."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, q_offset=q_offset,
                           return_lse=return_lse)
