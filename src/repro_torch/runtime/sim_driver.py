"""Resilient long-run SNN simulation driver (segmented + elastic).

The port of ``repro.runtime.sim_driver`` on one device.  DPSNN's
production runs are long-lived distributed jobs resubmitted across MPI
geometries (companion scaling study, arXiv:1511.09325); this driver
gives the multi-shard engine the same operational envelope:

  * the single ``n_steps`` run becomes fixed-size **segments** driven
    from the host -- one sim function (``make_sim_fn``) reused per
    segment, the state updated in place segment to segment.  On a CUDA
    device a static run captures its CUDA graph once and replays it in
    every later segment (``core.engine.GraphLoop``);
  * an ``AsyncCheckpointer`` snapshot between segments, labelled by the
    simulation step ``t`` (resume works across different segment
    sizes);
  * SIGTERM preemption, bounded-retry restore-and-replay and the
    straggler watchdog are inherited from ``FaultTolerantLoop``;
  * **elastic re-tiling**: a run checkpointed on tiles ``(a, b)`` can
    resume on tiles ``(c, d)`` -- neuron state and the in-flight delay
    ring are permuted by global column id (``core.retile``) while the
    synapse tables are rebuilt deterministically for the new
    decomposition from the engine seed.  Every tile lives on the one
    device, so a tiling is the stacked ``(TY, TX)`` layout;
  * **spike recording** (``record_events=True``): the device-side
    recorder (``obs.record``) streams every spike as a ``(step, global
    neuron id)`` event into a bounded per-segment buffer (the sim's
    resident recorder, zeroed in place at the start of each segment: the
    drain copies a segment's events to the host before the next segment
    overwrites them), which the host spooler (``obs.spool``)
    drains asynchronously into sharded append-only logs under
    ``<ckpt_dir>/spool``.  Per-shard spool offsets ride in every
    checkpoint manifest, and every restore truncates the logs back to
    that frontier, so preemption/failure replay yields each event
    exactly once.  ``spike_counts()`` reads the spool back;
  * **plasticity** (``dist_cfg.engine.stdp`` set): the STDP weights and
    pre/post traces ride in the state (``state["plastic"]``), so every
    checkpoint snapshots the learned weights with the neuron state.
    The multi-shard step fuses the post trace's decay and increment
    whatever the segment sizes (``core.stdp.post_trace(..., fused=True)``),
    so a preempted plastic run resumes bit-identically.  Across an
    elastic retile the realization itself is relaid by global (pre,
    post) synapse id (``core.retile.retile_tables``) -- never
    re-sampled.  The checkpoint meta records the STDP parameters and
    ``born_tiles``, the tiling the realization was sampled on.

  * **ensembles** (``dist_cfg.ensemble_seeds`` set): the driver runs M
    member realizations through the one sim function (state stacked on
    a member axis, see ``core.dist_engine``), drains each member's
    recorder rows into its own ``member_{m:03d}/`` spool stream, and
    carries the member seeds in the checkpoint meta, so preempt->resume
    restores every member's carry and spool frontier exactly once.
    Elastic retiling of ensembles is refused (resume on the checkpointed
    tiling).

The tiling, grid, seed and connectivity law of the saved state ride
inside each checkpoint's manifest (atomic with the checkpoint), so a
resuming process detects a geometry change -- and refuses a silently
different model -- without guessing from array shapes.

Cumulative metric totals (spikes/events/dropped) are **global scalars**:
the manifest carries ``metric_base`` (totals lost to state zeroing at
an elastic retile) and ``metric_totals`` (base + current state sums),
and every total the driver reports adds the base back -- so totals are
identical whatever tiling history a run went through.

Checkpoints hold ``dist_engine.state_tree(state)``: the state's tensors,
``t`` and each tile's generator state.  A restore loads them into the
driver's live state in place (``dist_engine.load_state``), so a
captured graph goes on reading the same tensors and generators.

**Ranks** (``mesh=``): each process of a ``torch.distributed`` group
runs one tile (``core.dist_engine``'s rank form), building only its own
tables.  Each checkpoint is gathered to rank 0 and written there in the
single-device driver's format, so one checkpoint resumes on ranks or on
one device, and retiles between them (every rank reads the checkpoint,
relays it as the single-device driver does, and keeps its block).  The
recorders are gathered to rank 0 each segment and spooled there in
``(y, x[, m])`` order.  Preemption is agreed at each segment's end (an
all-reduce of the ranks' flags), so every rank stops after the same
segment.  A failed segment fails the run: a rank cannot replay a
segment while its peers go on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.store import (LeafSpec, checkpoint_meta, latest_step,
                                refuse_meta_drift, restore_checkpoint)
from ..core.dist_engine import (DistConfig, SimInputs, all_reduce_host,
                                build_dist_inverse_index, build_dist_tables,
                                fold_plastic_tables, gather_blocks,
                                init_dist_plastic_state, init_dist_state,
                                load_state, make_sim_fn, rank_block,
                                rank_tile, state_like, state_tree)
from ..core.retile import (gather_synapse_stream, retile_config,
                           retile_plastic, retile_state, retile_tables)
from ..core.synapses import TableStorage, compress_tables
from ..obs.telemetry import NULL, Telemetry
from .driver import DriverConfig, FaultTolerantLoop, block_until_ready, log

METRIC_KEYS = ("spikes", "events", "dropped")


def sim_fingerprint(dist_cfg: DistConfig, segment_steps: int, recorder,
                    storage) -> tuple:
    """Cache key for the segment function.

    Everything that shapes the sim function is in the key; everything
    that only changes *values* is normalized out -- the seed (tables
    are data, not structure), the member seeds (only the ensemble width
    M is a shape) and the state seed.  Two jobs differing only in seeds
    therefore share one sim function when constructed with the same
    ``sim_cache`` dict (the job server's contract).
    """
    e = dataclasses.replace(dist_cfg.engine, seed=0, state_seed=None)
    seeds = dist_cfg.ensemble_seeds
    dc = dataclasses.replace(
        dist_cfg, engine=e,
        ensemble_seeds=None if seeds is None
        else tuple(range(len(seeds))))
    return (repr(dc), int(segment_steps), repr(recorder),
            repr(storage.meta() if storage is not None else None))


class SimDriver(FaultTolerantLoop):
    """Segmented, checkpointed multi-shard SNN simulation on one device.

    ``run(n_steps)`` advances the simulation to step ``n_steps`` (rounded
    up to a whole segment) in segments of ``segment_steps``; the loop's
    step counter *is* the simulation time ``t``, so checkpoint labels
    and resume targets are sim steps, not segment indices.

    ``device``: where the state, tables and steps live (the reference's
    ``mesh``).  ``cfg.ckpt_every`` counts **segments** between
    checkpoints.  ``allow_retile=True`` permits resuming a checkpoint
    written under a different tiling (state is relaid out by global
    column id; plastic weight tables by global synapse id).
    ``preempt_after_segments`` deterministically simulates a SIGTERM
    after that many segments (counted in this process) -- the driver
    checkpoints at the segment boundary and exits, exactly like the
    signal path.

    ``record_events=True`` turns on the spike observatory;
    ``record_capacity`` overrides the per-shard per-segment event
    buffer (default: the no-drop bound ``active_cap_local *
    segment_steps``; overflow is counted, never silent).  Recording is
    a pure observer -- spike trains are bit-identical with it on or
    off -- but for *complete* logs it must be enabled for the whole
    run: segments simulated with recording off are simply absent from
    the spool.

    ``drive``: an injected drive indexed by absolute step, ``(n_steps,
    TY, TX, n_local)`` in mV on this tiling (rows before a resume's
    start are not read); each segment passes its rows as
    ``SimInputs.drive``.  For parity runs against the reference only.
    ``sim_cache``: a caller-owned dict mapping ``sim_fingerprint`` keys
    to sim functions.  An ensemble's ``drive`` is ``(n_steps, TY, TX,
    M, n_local)``.

    ``mesh``: a ``launch.mesh.RankMesh`` holding the tiling, one tile a
    rank (see the module docstring); ``transport`` moves the halo
    strips (``core.halo.Transport``).  Every rank constructs the driver
    and calls the same methods; the spool and the checkpoint files are
    rank 0's, and ``spike_counts`` reads them there.
    """

    def __init__(self, cfg: DriverConfig, dist_cfg: DistConfig, device,
                 segment_steps: int,
                 allow_retile: bool = False,
                 fault_hook: Optional[Callable] = None,
                 preempt_after_segments: Optional[int] = None,
                 record_events: bool = False,
                 record_capacity: Optional[int] = None,
                 telemetry: Telemetry = NULL,
                 sim_cache: Optional[dict] = None,
                 job_meta: Optional[dict] = None,
                 drive: Optional[torch.Tensor] = None,
                 mesh=None, transport="gloo"):
        super().__init__(cfg, telemetry=telemetry)
        self.mesh = mesh
        self.root = mesh is None or mesh.rank == 0
        self.retry_failures = mesh is None
        if mesh is not None:
            self._tile = rank_tile(dist_cfg, mesh)
        if segment_steps <= 0:
            raise ValueError(f"segment_steps={segment_steps} must be > 0")
        self.dist_cfg = dist_cfg
        self.device = dev = resolve_device(device)
        self.step_size = segment_steps
        self.allow_retile = allow_retile
        self.fault_hook = fault_hook
        self._preempt_after = preempt_after_segments
        self._segments_done = 0
        e = dist_cfg.engine
        self.plastic = e.stdp is not None
        self.n_members = dist_cfg.n_members
        self._job_meta = job_meta
        self._drive = drive
        self._state: Optional[dict] = None     # the live state

        # ---- synapse tables ------------------------------------------
        # A plastic realization is *born* on one tiling and relaid to
        # every later one by global synapse id (re-sampling would build
        # a different network under the learned weights).  The birth
        # tiling rides in the checkpoint meta.
        self._born_tiles = dist_cfg.tiles
        if self.plastic:
            last0 = latest_step(cfg.ckpt_dir)
            if last0 is not None:
                born = checkpoint_meta(cfg.ckpt_dir, last0).get("born_tiles")
                if born:
                    self._born_tiles = tuple(born)
        # the birth tables of every tile (None until a retile needs
        # them, on ranks, where a rank builds its own tile)
        self._birth_tables = None
        if self.plastic and self._born_tiles != dist_cfg.tiles:
            from ..core.synapses import materialized_table_bytes
            born_cfg = retile_config(dist_cfg, *self._born_tiles)
            self._birth_tables, self.table_stats = build_dist_tables(
                born_cfg, device="cpu")
            # relayed at the analytic caps, then compressed: the caps
            # derive from the realized occupancy, which the relay
            # preserves exactly, so any process resuming on this tiling
            # reconstructs the identical storage descriptor
            tables = compress_tables(retile_tables(
                self._birth_tables, born_cfg.engine.decomp,
                born_cfg.engine.spec(), e.decomp, e.spec()))
            ty, tx = dist_cfg.tiles
            self.table_stats = dict(
                self.table_stats,
                table_bytes_per_shard=materialized_table_bytes(
                    tables, ty * tx))
            if mesh is not None:
                tables = rank_block(dist_cfg, tables, mesh)
        elif self.plastic:
            tables, self.table_stats = build_dist_tables(
                dist_cfg, device="cpu", mesh=mesh)
            if mesh is None:
                self._birth_tables = tables
        else:
            tables, self.table_stats = build_dist_tables(
                dist_cfg, device=dev, mesh=mesh)
        # the materialized (compressed) storage descriptor: everything
        # that sizes shapes from the spec -- the delivery plan, the
        # plastic weight tiers, checkpoint meta -- goes through it
        self.storage = tables.storage
        self._tables_host = tables if self.plastic else None
        self._inv_slots = None
        if self.plastic:
            self._inv_slots = build_dist_inverse_index(
                dist_cfg, tables, mesh=mesh)[0].to(dev)
            # the state carries the single live weight copy; the
            # resident tables keep only the int8 plastic mask
            tables = fold_plastic_tables(tables).to(dev)
        # the birth-weight stream is constant over the driver's lifetime;
        # plastic_summary gathers it once, at its first call
        self._birth_stream = None
        self.tables = tables

        # cumulative totals not represented in the (possibly retiled)
        # device state -- see module docstring
        self._metric_base = {k: 0.0 for k in METRIC_KEYS}
        # previous segment's cumulative totals: per-segment *deltas* in
        # the telemetry stream come from here (reset on every restore,
        # so replayed segments report their own deltas, not the gap to
        # the abandoned timeline)
        self._prev_totals: Optional[Dict[str, float]] = None
        self.recorder = None
        self.spool = None
        self.recorder_dropped = 0
        self.drain_s = 0.0          # host seconds spent draining recorders
        self._gids = None
        if record_events:
            from ..obs.record import recorder_spec, stacked_gid_maps
            from ..obs.spool import SpikeSpooler
            d = e.decomp
            self.recorder = recorder_spec(e, segment_steps,
                                          capacity=record_capacity)
            gids = stacked_gid_maps(d)
            if mesh is not None:
                gids = rank_block(dist_cfg, gids, mesh)
            self._gids = torch.from_numpy(gids).to(dev)
            header = {"grid": [d.grid.height, d.grid.width,
                               d.grid.n_per_column],
                      "law": e.law.kind, "seed": e.seed,
                      "dt_ms": e.lif.dt_ms,
                      "n_neurons": d.grid.n_neurons,
                      "recorder_capacity": self.recorder.capacity}
            if self.n_members is None:
                # the member streams carry their own state_seed; a solo
                # spool records it at the top, so an ensemble member's
                # stream compares header for header
                header["state_seed"] = e.state_seed_value
            if self.root:
                self.spool = SpikeSpooler(
                    os.path.join(cfg.ckpt_dir, "spool"), dist_cfg.tiles,
                    header=header, telemetry=telemetry,
                    members=dist_cfg.ensemble_seeds)
        # the driver never consumes the per-step spike output (the
        # spool is the per-step record), so it is not returned
        self._sim_key = sim_fingerprint(dist_cfg, segment_steps,
                                        self.recorder, self.storage)
        self._sim = None if sim_cache is None else sim_cache.get(
            self._sim_key)
        if self._sim is None:
            # the segment's recorder is drained before the next segment
            # runs (``_step_once``), so it takes the resident buffers
            self._sim = make_sim_fn(dist_cfg, segment_steps,
                                    record_rate=False,
                                    recorder=self.recorder,
                                    storage=self.storage, device=dev,
                                    recorder_copy=False, mesh=mesh,
                                    transport=transport)
            if sim_cache is not None:
                sim_cache[self._sim_key] = self._sim
        # a shared sim counts every job's captures: this driver's start
        self._captures0 = self._sim.captures
        self._sim_inputs = SimInputs(tables=self.tables,
                                     inv_slots=self._inv_slots,
                                     gids=self._gids)

    # ---- checkpoint metadata (identity of the saved state) ------------
    def _meta(self) -> dict:
        from ..core.synapses import TABLE_REALIZATION_VERSION
        e = self.dist_cfg.engine
        d = e.decomp
        return {"tiles_y": d.tiles_y, "tiles_x": d.tiles_x,
                "grid": [d.grid.height, d.grid.width, d.grid.n_per_column],
                "law": e.law.kind, "radius": d.radius, "seed": e.seed,
                "state_seed": e.state_seed_value,
                "table_realization": TABLE_REALIZATION_VERSION,
                "storage": self.storage.meta(),
                # repro-lint: ignore[meta-drift] report-only: resume is
                # bit-identical across segment sizes by design
                "segment_steps": self.step_size,
                "stdp": (dataclasses.asdict(e.stdp)
                         if self.plastic else None),
                "ensemble_seeds": (None if self.n_members is None
                                   else list(self.dist_cfg.ensemble_seeds)),
                # repro-lint: ignore[meta-drift] report-only: full job
                # provenance (the typed SimJobSpec); identity fields are
                # refused individually above
                "job": self._job_meta,
                "born_tiles": (list(self._born_tiles)
                               if self.plastic else None),
                "metric_base": dict(self._metric_base)}

    def _save(self, step: int, state):
        # meta rides inside the checkpoint's manifest: atomic with the
        # checkpoint, so a crash can never publish meta describing a
        # tiling (or spool frontier) the newest on-disk checkpoint does
        # not have
        meta = self._meta()
        # repro-lint: ignore[meta-drift] report-only running totals; the
        # resumable base rides (and is validated via) 'metric_base'
        meta["metric_totals"] = self.metric_totals(state)
        tree = state_tree(state)
        if self.mesh is not None:
            # every rank's block, stacked on rank 0: the single-device
            # driver's checkpoint
            tree = gather_blocks(self.dist_cfg, tree, self.mesh)
            if not self.root:
                return
        if self.spool is not None:
            # the manifest's spool offsets must never reference bytes
            # that are not yet durable: drain the (small) spool queue
            # first
            with self.tel.span("ckpt.spool_sync", step=step):
                self.spool.wait()
            meta["spool_offsets"] = self.spool.offsets()
            meta["recorder_dropped"] = self.recorder_dropped
        self.ckpt.save(step, tree, meta=meta)

    # ---- restore / init ----------------------------------------------
    def _like(self, cfg: DistConfig, storage) -> dict:
        """The checkpoint tree's shapes and dtypes for ``cfg`` (host
        zeros; each generator's state as this device's generators
        write it)."""
        tree = state_tree(state_like(cfg, storage, device="cpu"))
        n = tuple(torch.Generator(device=self.device).get_state().shape)
        tree["rng"] = [LeafSpec(n, torch.uint8) for _ in tree["rng"]]
        return tree

    def _install(self, tree: dict, block: bool = False) -> dict:
        """Load a state tree into the live state (made at first use): a
        stacked tree, of which a rank keeps its block, or (``block``) a
        rank's block already."""
        if self._state is None:
            self._state = state_like(self.dist_cfg, self.storage,
                                     device=self.device, mesh=self.mesh)
        if self.mesh is not None and not block:
            tree = rank_block(self.dist_cfg, tree, self.mesh)
        return load_state(self._state, tree)

    def _agreed(self, value):
        """Rank 0's ``value`` on every rank (``value`` itself off
        ranks)."""
        if self.mesh is None:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _restore_or_init(self):
        last = self._agreed(latest_step(self.cfg.ckpt_dir))
        self._prev_totals = None           # deltas restart per timeline
        if last is None:
            self._metric_base = {k: 0.0 for k in METRIC_KEYS}
            with self.tel.span("restore.init"):
                if self.spool is not None:
                    self.spool.truncate({})
                fresh = init_dist_state(self.dist_cfg, device=self.device,
                                        mesh=self.mesh)
                if self.plastic:
                    # from the host build tables: the device tables
                    # carry only the folded int8 mask, not the build
                    # weights
                    fresh["plastic"] = init_dist_plastic_state(
                        self.dist_cfg, self._tables_host)
                state = self._install(state_tree(fresh), block=True)
            return 0, state
        d = self.dist_cfg.engine.decomp
        meta = checkpoint_meta(self.cfg.ckpt_dir, last)
        mine = self._meta()
        # plasticity identity first: the plastic weight tables live in
        # the checkpointed state, so a static checkpoint cannot resume
        # plastic (there are no tables to continue from), a plastic
        # checkpoint cannot resume static (the learned weights would be
        # silently replaced by the seed realization), and an STDP
        # parameter change mid-run is a different model
        theirs = meta.get("stdp")
        if theirs != mine["stdp"]:
            raise ValueError(
                f"checkpoint in {self.cfg.ckpt_dir} was written with "
                f"stdp={theirs} but the current config has "
                f"stdp={mine['stdp']} -- a plastic run resumes only a "
                "checkpoint with identical STDP parameters, and a "
                "static run only a static checkpoint")
        # the state relayout is only valid for the *same model*: grid,
        # connectivity law, synapse seed AND sampling-procedure version
        # must match
        refuse_meta_drift(
            meta, mine,
            ("grid", "law", "radius", "seed", "state_seed",
             "ensemble_seeds", "table_realization"),
            self.cfg.ckpt_dir)
        base = meta.get("metric_base", {})
        self._metric_base = {k: float(base.get(k, 0.0))
                             for k in METRIC_KEYS}
        old_tiles = (meta.get("tiles_y", d.tiles_y),
                     meta.get("tiles_x", d.tiles_x))
        if old_tiles == (d.tiles_y, d.tiles_x):
            # same tiling => deterministically the same storage
            # descriptor; drift means the checkpointed bytes (weight
            # dtype, compressed caps) no longer describe this build --
            # refuse rather than reinterpret
            refuse_meta_drift(meta, mine, ("storage",), self.cfg.ckpt_dir)
            self.tel.event("resume", logger=log,
                           msg=f"resuming from sim step {last}",
                           step=last)
            with self.tel.span("restore.load", step=last):
                host = restore_checkpoint(
                    self.cfg.ckpt_dir, last,
                    self._like(self.dist_cfg, self.storage), device="cpu")
                state = self._install(host)
        else:
            if self.n_members is not None:
                raise ValueError(
                    f"checkpoint tiling {old_tiles} != configured "
                    f"{(d.tiles_y, d.tiles_x)} on an ensemble run: "
                    "elastic retiling of the stacked member axis is not "
                    "supported yet -- resume ensembles on the tiling "
                    "they were checkpointed under")
            if not self.allow_retile:
                raise ValueError(
                    f"checkpoint tiling {old_tiles} != configured "
                    f"{(d.tiles_y, d.tiles_x)}; pass allow_retile=True "
                    "(CLI: --retile) to relayout the state")
            self.tel.event(
                "resume", logger=log,
                msg=f"resuming from sim step {last} with retile "
                    f"{old_tiles} -> {(d.tiles_y, d.tiles_x)}",
                step=last, old_tiles=list(old_tiles),
                new_tiles=[d.tiles_y, d.tiles_x])
            with self.tel.span("restore.retile", step=last,
                               old_tiles=list(old_tiles),
                               new_tiles=[d.tiles_y, d.tiles_x]):
                state = self._install(self._retiled(meta, last, old_tiles))
        if self.spool is not None:
            # exactly-once: cut every log back to this checkpoint's
            # frontier; replayed segments re-append their events
            with self.tel.span("spool.truncate", step=last):
                self.spool.truncate(meta.get("spool_offsets", {}))
            self.recorder_dropped = int(meta.get("recorder_dropped", 0))
        return last, state

    def _retiled(self, meta: dict, last: int, old_tiles) -> dict:
        """The checkpoint at ``last``, written on ``old_tiles``, relaid
        onto this driver's tiling (a host tree for ``_install``)."""
        d = self.dist_cfg.engine.decomp
        old_cfg = retile_config(self.dist_cfg, *old_tiles)
        # the old tiling's storage descriptor (compressed caps, weight
        # dtype) sizes the checkpointed plastic weight tiers; it rides
        # in the manifest
        old_storage = (TableStorage.from_meta(meta["storage"])
                       if meta.get("storage") is not None
                       else old_cfg.engine.spec().storage())
        host_state = restore_checkpoint(self.cfg.ckpt_dir, last,
                                        self._like(old_cfg, old_storage),
                                        device="cpu")
        # the relayout zeroes per-tile metrics: fold the restored
        # partial sums into the global base so totals survive the
        # retile exactly (whatever tiling we came from)
        for k in METRIC_KEYS:
            self._metric_base[k] += float(host_state["metrics"][k].sum())
        plastic_host = host_state.pop("plastic", None)
        state = retile_state(host_state, old_cfg.engine.decomp, d,
                             self.dist_cfg.engine.state_seed_value)
        if self.plastic:
            # the checkpointed weights are laid out for the *old*
            # tiling's structure (itself a deterministic relay of the
            # birth realization); relay them onward by global synapse id
            old_d = old_cfg.engine.decomp
            old_spec = old_cfg.engine.spec()
            born_cfg = retile_config(self.dist_cfg, *self._born_tiles)
            if self._birth_tables is None:
                # a rank built its own tile only: every tile's birth
                # tables, as the single-device driver holds them
                self._birth_tables = build_dist_tables(born_cfg,
                                                       device="cpu")[0]
            if old_tiles == self._born_tiles:
                old_tabs = self._birth_tables
            else:
                # compressed exactly as the old process built them (the
                # relay preserves per-row occupancy, so the realized caps
                # -- and hence the checkpointed w shapes -- are
                # reproduced deterministically)
                old_tabs = compress_tables(retile_tables(
                    self._birth_tables, born_cfg.engine.decomp,
                    born_cfg.engine.spec(), old_d, old_spec))
            state["plastic"] = retile_plastic(
                plastic_host, old_tabs, old_d, old_spec, d,
                self.dist_cfg.engine.spec(), storage=self.storage)
        return state

    # ---- one segment --------------------------------------------------
    def _step_once(self, state, step):
        if self.fault_hook:
            self.fault_hook(step)
        t0 = time.perf_counter()
        inputs = self._sim_inputs
        if self._drive is not None:
            drive = self._drive[step:step + self.step_size]
            if self.mesh is not None:
                y, x = self._tile
                drive = drive[:, y:y + 1, x:x + 1]
            inputs = dataclasses.replace(inputs, drive=drive)
        with self.tel.span("segment.compute", step=step):
            out = self._sim(state, inputs)
            state = out[0]
            if self.tel.enabled:
                # fence so the span covers the device work it queued,
                # not just the host-side launches.  Pure observer: the
                # run loop waits on this segment's metrics right after
                # anyway -- tracing only moves the wait inside the span.
                block_until_ready(state)
        d_rec_dropped = 0
        if self.recorder is not None:
            t_drain = time.perf_counter()
            with self.tel.span("segment.spool_drain", step=step):
                rec = out[2]
                if self.mesh is not None:
                    # every rank's recorder on rank 0, which spools
                    rec = gather_blocks(self.dist_cfg, rec, self.mesh)
                if rec is not None:
                    d_rec_dropped = self._drain_recorder(rec, step)
            self.drain_s += time.perf_counter() - t_drain
        self._segments_done += 1
        if self._preempt_after is not None \
                and self._segments_done >= self._preempt_after:
            self.preempted = True
        if self.mesh is not None:
            # a SIGTERM reaches the ranks apart: all stop after the same
            # segment
            self.preempted = bool(all_reduce_host(
                [int(self.preempted)], op="max")[0])
        totals = self.metric_totals(state)
        prev = self._prev_totals or {k: 0.0 for k in METRIC_KEYS}
        delta = {k: totals[k] - prev[k] for k in METRIC_KEYS}
        self._prev_totals = totals
        if delta["dropped"] > 0:
            # at most once per segment, with the segment's own delta
            self.tel.event(
                "delivery_drops", level="warning", logger=log,
                msg=f"event-delivery compaction dropped "
                    f"{int(delta['dropped'])} spike(s) this segment "
                    f"({int(totals['dropped'])} total; active_cap "
                    "overflow) -- results undercount synaptic events; "
                    "raise EngineConfig.cap_headroom",
                step=step, dropped=int(delta["dropped"]),
                dropped_total=int(totals["dropped"]))
        wall = time.perf_counter() - t0
        self.tel.metrics(
            "segment", step=step, wall_s=wall,
            steps_per_s=self.step_size / max(wall, 1e-9),
            d_spikes=delta["spikes"], d_events=delta["events"],
            d_dropped=delta["dropped"],
            d_recorder_dropped=float(d_rec_dropped),
            spikes=totals["spikes"], events=totals["events"],
            dropped=totals["dropped"])
        metrics = {"sim_t": int(np.max(state["t"])),
                   "spikes": totals["spikes"], "events": totals["events"],
                   "dropped": totals["dropped"],
                   "d_spikes": delta["spikes"],
                   "d_events": delta["events"],
                   "d_dropped": delta["dropped"],
                   "d_recorder_dropped": float(d_rec_dropped)}
        return state, metrics

    def _drain_recorder(self, rec, step=None) -> int:
        """Spool one segment's event buffers (all shards, all ensemble
        members), copied to the host before the next segment reuses
        them; returns the segment's recorder-overflow drop count."""
        rec_h = {k: v.cpu().numpy() for k, v in rec.items()}
        ty, tx = self.dist_cfg.tiles
        for y in range(ty):
            for x in range(tx):
                if self.n_members is None:
                    cnt = int(rec_h["count"][y, x])
                    self.spool.append(y, x, rec_h["step"][y, x, :cnt],
                                      rec_h["gid"][y, x, :cnt])
                    continue
                for m in range(self.n_members):
                    cnt = int(rec_h["count"][y, x, m])
                    self.spool.append(
                        y, x, rec_h["step"][y, x, m, :cnt],
                        rec_h["gid"][y, x, m, :cnt], member=m)
        seg_dropped = int(np.sum(rec_h["dropped"]))
        if seg_dropped:
            self.recorder_dropped += seg_dropped
            self.tel.event(
                "recorder_drops", level="warning", logger=log,
                msg=f"spike recorder dropped {seg_dropped} event(s) "
                    f"this segment ({self.recorder_dropped} total) -- "
                    "raise record_capacity (CLI: --record-cap) for "
                    "complete logs",
                step=step, dropped=seg_dropped,
                dropped_total=self.recorder_dropped)
        return seg_dropped

    # ---- host-side views ----------------------------------------------
    def _whole(self, tree):
        """A tree of per-tile tensors of every tile (on ranks, gathered
        to every rank)."""
        if self.mesh is None:
            return tree
        return gather_blocks(self.dist_cfg, tree, self.mesh, dst=None)

    def metric_totals(self, state) -> Dict[str, float]:
        """Cumulative run totals: the manifest-carried base (history
        predating an elastic retile) plus the live state's per-tile
        partial sums.  Tiling-independent by construction.  On ranks
        every rank calls it and gets the same totals."""
        metrics = self._whole(state["metrics"])
        return {k: self._metric_base[k] + float(metrics[k].sum())
                for k in METRIC_KEYS}

    def firing_rate_hz(self, state) -> float:
        """Mean rate over the whole run (active neurons), retile-proof:
        uses ``metric_totals`` rather than raw state sums."""
        t = int(np.max(state["t"]))
        n_active = float(self._whole(state["active"]).sum())
        sim_sec = t * self.dist_cfg.engine.lif.dt_ms * 1e-3
        return self.metric_totals(state)["spikes"] \
            / max(n_active, 1.0) / max(sim_sec, 1e-9)

    def _check_member(self, what: str, member: Optional[int]) -> None:
        if (member is None) != (self.n_members is None):
            raise ValueError(
                f"{what}(member={member!r}) on a driver with "
                f"n_members={self.n_members!r}: pass a member index "
                "exactly when the run is an ensemble")

    def spike_counts(self, n_steps: Optional[int] = None,
                     member: Optional[int] = None) -> np.ndarray:
        """Global per-step spike counts, read back from the spooled
        spike logs (sim step order; the exactly-once truncation
        contract guarantees replayed segments appear once).  Covers the
        whole run recorded into this checkpoint directory -- including
        segments written by earlier processes of a resumed run.

        ``n_steps`` fixes the returned length (steps past the last
        spike would otherwise be trimmed).  Requires
        ``record_events=True``: the spool *is* the per-step record.
        Ensemble runs read one member's stream -- pass ``member``.
        """
        if self.spool is None:
            raise ValueError(
                "spike_counts() reads the spike spool; construct the "
                "driver with record_events=True" + (
                    "" if self.root else " (on ranks, rank 0 spools)"))
        from ..obs.spool import RECORD_DTYPE, member_name, shard_events
        self._check_member("spike_counts", member)
        self.spool.wait()
        d = self.spool.directory
        if member is not None:
            d = os.path.join(d, member_name(member))
        shards = list(shard_events(d).values())
        ev = (np.concatenate(shards) if shards
              else np.empty(0, RECORD_DTYPE))
        if n_steps is None:
            n_steps = int(ev["step"].max()) + 1 if len(ev) else 0
        return np.bincount(ev["step"], minlength=n_steps)[:n_steps] \
            .astype(np.float32)

    def plastic_summary(self, state, member: Optional[int] = None) -> dict:
        """Tiling-invariant digest of the live plastic tables.

        ``weight_checksum`` hashes every synapse's ``(pre_gid,
        post_gid, dslot, weight-bits)`` record in canonical (sorted)
        order, so two runs agree iff their learned weights are
        bit-identical per global synapse -- whatever tilings either
        went through.  Drift stats compare against the birth weights.
        Ensemble runs digest one member's carried weights -- pass
        ``member``.
        """
        if not self.plastic:
            raise ValueError("plastic_summary() needs a plastic engine "
                             "(EngineConfig.stdp set)")
        self._check_member("plastic_summary", member)
        if self.mesh is not None:
            # every tile's weights and build tables on rank 0, whose
            # digest every rank returns
            pl = gather_blocks(self.dist_cfg, state["plastic"], self.mesh)
            host = gather_blocks(self.dist_cfg, self._tables_host,
                                 self.mesh)
            out = (self._summary(pl, host, member) if self.root
                   else None)
            return self._agreed(out)
        return self._summary(state["plastic"], self._tables_host, member)

    def _summary(self, pl: dict, host, member: Optional[int]) -> dict:
        e = self.dist_cfg.engine
        d, spec = e.decomp, e.spec()

        def pick(w):
            return w if member is None else w[:, :, member]
        live_tabs = {
            "local": dict(host["local"], w=pick(pl["w"][0])),
            "halo": [dict(t, w=pick(pw)) for t, pw in
                     zip(host["halo"], pl["w"][1:])],
        }
        live = gather_synapse_stream(live_tabs, d, spec)
        if self._birth_stream is None:
            self._birth_stream = gather_synapse_stream(host, d, spec)
        birth = self._birth_stream        # same gather order as `live`
        w = np.ascontiguousarray(live["w"])
        wbits = w.view({2: np.uint16, 4: np.uint32,
                        8: np.uint64}[w.dtype.itemsize])
        order = np.lexsort((wbits, live["dslot"], live["post"],
                            live["pre"]))
        rec = np.column_stack([
            live["pre"][order], live["post"][order],
            live["dslot"][order].astype(np.int64),
            wbits[order].astype(np.int64)]).astype(np.int64)
        checksum = hashlib.sha256(
            np.ascontiguousarray(rec).tobytes()).hexdigest()
        mask = birth["w"] > 0
        return {
            "weight_checksum": checksum,
            "n_synapses": int(len(w)),
            "n_plastic": int(mask.sum()),
            "w_sum": float(w.sum()),
            "w_l1_delta": float(np.abs(w - birth["w"])[mask].sum()),
        }

    def compiled_step_cache_size(self) -> int:
        """Sim functions this driver ran segments through: its one
        ``make_sim_fn`` (own or shared through ``sim_cache``) once a
        segment ran, else 0.  The counterpart of the reference's count
        of compiled programs of its segment function, which a job
        reports as its ``compiled_steps``."""
        return int(self._segments_done > 0)

    def captures(self) -> int:
        """CUDA graph captures of this driver's sim function in this
        driver's runs (the counterpart of the reference's
        compiled-program count): 1 for an uninterrupted static run on
        the card, recorded or not, 0 where it steps eagerly.  A sim
        shared through ``sim_cache`` captures once per job: each job's
        state is new to the graph."""
        return self._sim.captures - self._captures0

    def run(self, n_steps: int):
        out = super().run(n_steps)
        if self.spool is not None:
            self.spool.wait()            # logs durable before we report
        return out
