"""Device-side spike recorder: a bounded per-segment event buffer.

The port of ``repro.obs.record``.  Each step's spike vector is compacted
to its spiking-row indices -- through the compaction kernel
(``kernels.spike_compact``) or the plain ``compact_events``, following
``RecorderSpec.use_kernels`` -- and appended as ``(sim_step,
global_neuron_id)`` pairs to a fixed-capacity buffer.  Overflow never
aborts or reallocates: spikes that do not fit add to an explicit drop
counter, so ``dropped == spikes - appended`` always.

Recording is a pure function of the spike vector: it consumes no random
numbers and feeds nothing back, so the spike trains are bit-identical
with it on or off.  Neuron identity is the tiling-invariant global
neuron id ``global_column_id * n_per_column + within_column``.

Unlike the reference, which returns new buffers, ``record_step`` updates
the recorder state in place and takes the step as a device tensor, so
nothing waits for the device and a recorded step can be captured in a
CUDA graph.  The engines keep one resident recorder per run shape
(``resident_recorder``), zeroed in place at the start of each call, and
hand back a copy of it (``copy_recorder``), so a returned recorder is
the call's own, as the reference's fresh buffers are.  Only a caller
that drains the buffers before its next call (``runtime.SimDriver``)
takes the resident buffers themselves (``make_sim_fn(...,
recorder_copy=False)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.grid import TileDecomposition, global_column_ids


@dataclasses.dataclass(frozen=True)
class RecorderSpec:
    """Static sizing of the recorder (one shard, one segment).

    ``capacity``: event slots.  ``active_cap``: per-step compaction width
    (spikes beyond it are dropped and counted).  ``n_rows``: neuron slots
    per shard.  ``use_kernels``: compact through the kernel wrapper
    (True) or the plain ``compact_events`` (False)."""

    capacity: int
    active_cap: int
    n_rows: int
    use_kernels: bool = True

    def __post_init__(self):
        if self.capacity <= 0:
            raise ValueError(f"recorder capacity={self.capacity} must be > 0")


def recorder_spec(engine_cfg, segment_steps: int,
                  capacity: Optional[int] = None) -> RecorderSpec:
    """Size a recorder for ``engine_cfg``.  The default capacity
    ``active_cap_local * segment_steps`` is the no-drop bound; pass
    ``capacity`` to trade memory for (counted) drops."""
    spec = engine_cfg.spec()
    cap = spec.active_cap_local * segment_steps if capacity is None \
        else capacity
    return RecorderSpec(capacity=cap, active_cap=spec.active_cap_local,
                        n_rows=spec.n_local,
                        use_kernels=bool(engine_cfg.use_kernels))


def init_recorder_state(rspec: RecorderSpec, device="cuda",
                        tiles: tuple = ()) -> dict:
    """Empty recorder: int32 ``step``/``gid`` buffers of ``capacity``
    zeros, and int32 ``count``/``dropped`` scalars, for one shard or,
    with ``tiles=(TY, TX)``, stacked for every tile of a tiling."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(tuple(tiles) + shape, dtype=torch.int32,
                           device=dev)
    return {"step": zeros(rspec.capacity), "gid": zeros(rspec.capacity),
            "count": zeros(), "dropped": zeros()}


def resident_recorder(cache: dict, rspec: RecorderSpec, device,
                      lead: tuple = ()) -> dict:
    """The recorder ``cache`` keeps for ``(rspec, device, lead)``, made by
    ``init_recorder_state`` at first use (``lead``: the leading axes,
    e.g. tiles and members) and zeroed in place at every later one, so
    its tensors keep their addresses (a captured graph writes them)."""
    dev = resolve_device(device)
    key = (rspec, dev, tuple(lead))
    rec = cache.get(key)
    if rec is None:
        rec = cache[key] = init_recorder_state(rspec, device=dev,
                                               tiles=tuple(lead))
    else:
        for x in rec.values():
            x.zero_()
    return rec


def copy_recorder(rec: dict) -> dict:
    """A copy of a recorder's buffers and counters on their device (one
    copy of ``8 B x capacity`` for the ``step`` and ``gid`` buffers plus
    the two scalars, times the leading axes): what a recorded call hands
    back while its resident recorder stays with the engine."""
    return {k: x.clone() for k, x in rec.items()}


def tile_gid_map(decomp: TileDecomposition, tile_y: int,
                 tile_x: int) -> np.ndarray:
    """(n_local + 1,) global neuron id of each local slot; -1 for slots
    in padded columns and for the trailing compaction-sink slot."""
    gid_col = global_column_ids(decomp)[tile_y, tile_x]      # (tile_cols,)
    n_per = decomp.grid.n_per_column
    gnid = gid_col[:, None] * n_per + np.arange(n_per)[None, :]
    gnid = np.where(gid_col[:, None] >= 0, gnid, -1).ravel()
    return np.concatenate([gnid, [-1]]).astype(np.int32)


def stacked_gid_maps(decomp: TileDecomposition) -> np.ndarray:
    """(TY, TX, n_local + 1) int32: every tile's gid map, stacked like
    the multi-shard state and tables."""
    return np.stack([
        np.stack([tile_gid_map(decomp, y, x)
                  for x in range(decomp.tiles_x)])
        for y in range(decomp.tiles_y)])


def record_step(rec: dict, spikes: torch.Tensor, gids: torch.Tensor, t,
                rspec: RecorderSpec) -> dict:
    """Append this step's spikes to the buffer, in place.

    ``spikes``: (n_rows,) spike vector (> 0 == spiked); ``gids``: the
    (n_rows + 1,) int32 global-id map (sink slot last); ``t``: the
    absolute step the spikes belong to, a 0-d int32 tensor on the
    spikes' device (the engines' device step counter; an int is taken
    too, outside a captured graph).  The appended entries land on
    slots past ``count``, which still hold their initial zeros, so the
    write is an integer ``index_add_`` (exact in any order): lanes that
    append nothing add 0 to a slot of their own instead of being
    branched away (one shared slot would serialize the atomics of a
    CUDA ``index_add_``).  Returns ``rec``."""
    if rspec.use_kernels:
        from ..kernels import ops as kops
        idx, n_spk = kops.spike_compact(spikes, rspec.n_rows,
                                        rspec.active_cap)
    else:
        from ..kernels.ref import compact_events
        idx, n_spk = compact_events(spikes, rspec.n_rows, rspec.active_cap)
        n_spk = n_spk.to(torch.int32)
    count = rec["count"]
    take = torch.clamp(n_spk, max=rspec.active_cap)
    room = torch.clamp(rspec.capacity - count, min=0)
    appended = torch.minimum(take, room)
    dev = spikes.device
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(int(t), dtype=torch.int32, device=dev)
    ar = torch.arange(rspec.active_cap, dtype=torch.int32, device=dev)
    live = ar < appended
    pos = torch.where(live, count + ar, ar % rspec.capacity).long()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rec["step"].index_add_(0, pos, torch.where(live, t.to(torch.int32),
                                               zero))
    rec["gid"].index_add_(0, pos, torch.where(live, gids[idx.long()], zero))
    rec["count"] += appended
    rec["dropped"] += n_spk - appended
    return rec
