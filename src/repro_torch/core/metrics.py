"""Metrics of the paper: cost per synaptic event and bytes per synapse.

The port of the memory half of ``repro.core.metrics``.  The paper's
headline unit is::

    cost = elapsed_sec / (simulated_sec * total_synapses * firing_rate)

seconds of wall clock per *synaptic event* (one spike crossing one
synapse).  The analytic strong-scaling model (``HardwareModel``,
``step_time_model``, ``strong_scaling_curve``, the paper's Fig. 1
projection) keeps the reference's formulas; its constants are the
H100 SXM's and the port's own kernels' byte counts (``HardwareModel``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .connectivity import EXTERNAL_RATE_HZ, ConnectivityLaw
from .grid import ColumnGrid, TileDecomposition
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


# ---------------------------------------------------------------------------
# Analytic strong-scaling model (the paper's Fig. 1 projection on H100s)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-card constants of the model, for one H100 SXM and the port's
    kernels.  The field names are the reference's, so its constants can
    be passed in; on this card they mean:

    * ``peak_flops``: the rate at which delivery adds.  The column
      kernel (``csrc/event_delivery.cu``) adds in float32 on the CUDA
      cores, so this is the card's non-tensor FP32 rate, 66.9e12/s,
      not the bf16 tensor-core 989e12/s;
    * ``hbm_bw``: HBM3, 3.35e12 B/s;
    * ``ici_bw``: NVLink 4, 450e9 B/s in each direction per card (the
      field the reference uses for its TPU interconnect link);
    * ``flops_per_event``: one float32 add into the ring per event, as
      ``chip_smoke.time_delivery`` reckons kernel 2's operation bound;
    * ``bytes_per_event``: one table entry read per event, an int32
      target id, a bfloat16 weight and the delay byte (4 + 2 + 1), the
      per-event term of ``time_delivery``'s byte bound (the spiking
      rows' ids and the touched ring words come on top there);
    * ``bytes_per_neuron_step``: the fused step head's traffic per
      neuron, 21 B read (ring word, drive, v, c, refrac, active) and
      20 B written (v, c, refrac, spike, zeroed ring word), plus one bit
      of the delivered-row bitmap, as ``time_neuron_step`` reckons
      kernel 1's byte bound.

    None of these is fitted to a measured time."""

    peak_flops: float = 66.9e12       # float32, CUDA cores
    hbm_bw: float = 3.35e12           # B/s, HBM3
    ici_bw: float = 450e9             # B/s per direction, NVLink 4
    flops_per_event: float = 1.0      # one float32 add into the ring
    bytes_per_event: float = 7.0      # int32 id + bf16 weight + delay byte
    bytes_per_neuron_step: float = 41.125   # step head: 21 + 20 + 1/8


def step_time_model(spec: SynapseTableSpec, rate_hz: float,
                    hw: HardwareModel = HardwareModel(),
                    pack_spikes: bool = True,
                    ext_rate_hz: float = EXTERNAL_RATE_HZ,
                    ext_synapses: int = 540) -> dict:
    """Roofline step-time terms of one shard at the given firing rate
    (the reference's formulas): events per step = the spec's expected
    stored synapses x rate x dt, plus the external drive's events; the
    halo's bytes from the exact strip volume.  Seconds per simulated
    step."""
    d = spec.decomp
    dt_s = spec.dt_ms * 1e-3
    syn = spec.expected_synapses()
    events = syn * rate_hz * dt_s
    ext_events = spec.n_local * ext_synapses * ext_rate_hz * dt_s

    compute = (events + ext_events) * hw.flops_per_event / hw.peak_flops
    memory = ((events + ext_events) * hw.bytes_per_event
              + spec.n_local * hw.bytes_per_neuron_step) / hw.hbm_bw
    payload = (spec.n_exc_per_col + 7) // 8 if pack_spikes \
        else spec.n_exc_per_col * 4
    halo_cols = d.region_cols - d.tile_cols
    collective = halo_cols * payload / hw.ici_bw
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective,
            "step_s": max(compute, memory) + collective,
            "events_per_step": events}


def strong_scaling_curve(grid_h: int, grid_w: int, law: ConnectivityLaw,
                         shard_counts, rate_hz: float,
                         n_per_column: int,
                         hw: HardwareModel = HardwareModel(),
                         pack_spikes: bool = True) -> list:
    """Analytic cost per synaptic event against the number of shards
    (the paper's Fig. 1 shape): for each count n, the most nearly square
    tiling ``ty x tx = n`` and ``step_time_model`` of one shard; all
    shards step at once, so the wall time of a step is one shard's."""
    rows = []
    for n in shard_counts:
        ty = int(np.sqrt(n))
        while n % ty:
            ty -= 1
        tx = n // ty
        dec = TileDecomposition(grid=ColumnGrid(grid_h, grid_w,
                                                n_per_column),
                                tiles_y=ty, tiles_x=tx, radius=law.radius)
        spec = SynapseTableSpec(decomp=dec, law=law, single_shard=(n == 1))
        t = step_time_model(spec, rate_hz, hw, pack_spikes)
        events_total = t["events_per_step"] * n
        rows.append({
            "shards": n, "tiles": (ty, tx),
            "step_s": t["step_s"],
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"],
            "cost_per_event": t["step_s"] / max(events_total, 1e-30),
        })
    return rows
