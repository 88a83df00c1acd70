"""Metrics of the paper: cost per synaptic event and bytes per synapse.

The port of the memory half of ``repro.core.metrics``.  The paper's
headline unit is::

    cost = elapsed_sec / (simulated_sec * total_synapses * firing_rate)

seconds of wall clock per *synaptic event* (one spike crossing one
synapse).  The reference's analytic strong-scaling model
(``HardwareModel``, ``step_time_model``, ``strong_scaling_curve``) holds
TPU constants and is not ported here.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .synapses import TORCH_DTYPES, SynapseTableSpec


def cost_per_synaptic_event(elapsed_s: float, simulated_s: float,
                            total_synapses: float, rate_hz: float) -> float:
    """Paper's Figure-1 metric (elapsed sec per synaptic event)."""
    events = simulated_s * total_synapses * rate_hz
    return elapsed_s / max(events, 1e-30)


def speedup_efficiency(cost_1: float, cost_n: float, n: int) -> float:
    """Fraction of ideal strong-scaling speedup reached at n processes."""
    return (cost_1 / cost_n) / n


def time_fn(fn: Callable, *args, iters: int = 3, warmup: int = 1,
            device="cuda") -> float:
    """Median wall time of ``fn(*args)``, the device synchronised after
    each call (a CUDA ``device``; none on the CPU)."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn(*args)
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# Memory accounting (paper Fig. 3: bytes / synapse)
# ---------------------------------------------------------------------------

def shard_memory_bytes(spec: SynapseTableSpec, storage=None,
                       plastic: bool = False,
                       recorder_capacity: int = 0) -> dict:
    """Per-shard buffer bytes of everything the reference's engine holds
    live, as the reference counts them.

    ``storage`` (a ``TableStorage``) sizes the synapse tables -- pass a
    materialized (compressed) descriptor for realized caps; ``None``
    uses the spec's analytic storage.  ``plastic=True`` adds the STDP
    carry (every weight tier, the local pre-trace, post-traces, the
    inverse index at ``cap_pad=1.3`` over the mean in-degree) and folds
    the tables' weights to the 1-byte mask.  ``recorder_capacity`` adds
    the recorder's event buffer.  The port's own structures -- the
    column kernel's run descriptors and the inverse index's
    target-major bytes -- are not counted here."""
    n_local = spec.n_local
    if storage is None:
        storage = spec.storage()
    table = spec.table_bytes(storage)
    neuron = n_local * (4 + 4 + 4)          # v, c, refrac
    ring = spec.d_ring * n_local * 4        # delayed-current ring
    active = n_local * 1
    out = {"tables": table, "neuron_state": neuron, "ring": ring,
           "active_mask": active}
    if plastic:
        w_item = TORCH_DTYPES[storage.weight_dtype].itemsize
        plan = spec.delivery_plan(storage)
        caps = storage.caps()
        w_slots = sum((p.rows + 1) * c for p, c in zip(plan, caps))
        # fold-away: static w leaves hold the 1-byte mask, not weights
        out["tables"] = table - w_slots * (w_item - 1)
        mean_in = spec.expected_synapses() / max(n_local, 1)
        inv_cap = int(np.ceil(1.3 * mean_in))
        out["plastic"] = (w_slots * w_item     # live weight tiers (carry)
                          + (n_local + 1) * 4  # local pre-trace
                          + n_local * 4        # post-traces
                          + n_local * inv_cap * 4)  # inverse index slots
    if recorder_capacity:
        out["recorder"] = recorder_capacity * (4 + 4) + 8
    out["total"] = sum(out.values())
    return out


def bytes_per_synapse(spec: SynapseTableSpec, storage=None,
                      **kw) -> float:
    """Analytic bytes per synapse of one interior shard (paper Fig. 3):
    every live per-shard buffer (``shard_memory_bytes``) over the
    expected synapses."""
    mem = shard_memory_bytes(spec, storage, **kw)
    return mem["total"] / max(spec.expected_synapses(), 1.0)
