"""Single-shard DPSNN engine: time-driven outer loop, event-driven delivery.

The port of ``repro.core.engine``: static, plastic (STDP) and recorded
single-shard runs.  One engine instance
simulates one tile of the column grid.  Step structure (dt = 1 ms):

  1. read the delayed-current ring slot for t, add external Poisson drive
  2. LIF+SFA update -> spikes
  3. zero the consumed ring slot
  4. deliver local+halo spikes through the synapse tables into future
     ring slots (event mode: cost ~ spikes x fan-out = synaptic events)

State is a dict of tensors plus the step counter ``t`` (a Python int,
so ring slots never wait on the device) and the drive's
``torch.Generator``.  ``simulate`` is a Python loop over ``step``; the
ring is updated in place.  On the kernel path steps 1-3 are one launch
(``kops.neuron_step``), and a static run on the card replays one
captured CUDA graph of ``d_ring`` steps (``_StepGraph``), the
counterpart of the reference's jitted ``lax.scan``.  Plastic runs
(``simulate(plasticity=)``) replace step 4 by ``plastic_delivery_stdp``:
delivery and STDP on a working copy of the local tier's float32
weights.

The external drive is drawn with ``torch.poisson`` on the state's
generator, which cannot reproduce ``jax.random.poisson``: for parity
runs ``simulate(..., drive=...)`` injects the reference's drive.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..kernels import _build
from ..kernels import ops as kops
from ..kernels.plastic_step import bind_plastic_bits
from ..kernels.synaptic_accum import bind_column_weights
from .connectivity import (ConnectivityLaw, EXTERNAL_RATE_HZ,
                           EXTERNAL_SYNAPSES)
from .grid import TileDecomposition
from .neuron import LIFParams, init_state, lif_sfa_step
from .stdp import (STDPParams, check_weight_invariant, init_stdp_state,
                   plastic_masks, stdp_ltp_finalize, stdp_step,
                   target_major_meta)
from .synapses import (SynapseTableSpec, SynapseTables, TierPlan,
                       build_tables, column_runs, compress_tables,
                       deliver_events, deliver_gather_all, inverse_index,
                       tier_list, with_local_tier)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    decomp: TileDecomposition
    law: ConnectivityLaw
    lif: LIFParams = LIFParams()
    d_ring: int = 8
    mode: str = "event"              # "event" | "gather_all"
    ext_synapses: int = EXTERNAL_SYNAPSES
    ext_rate_hz: float = EXTERNAL_RATE_HZ
    rate_cap_hz: float = 100.0
    cap_headroom: float = 8.0        # event-list sizing (perf knob)
    seed: int = 0
    # Weight storage dtype: bfloat16 weights are quantized at build time
    # and cast up to float32 before any delivery arithmetic.
    weight_dtype: str = "bfloat16"
    # True: LIF and event delivery go through ``kernels.ops`` (the CUDA
    # kernels on CUDA tensors, their plain versions on CPU tensors);
    # False: the plain ``core`` functions on any device.
    use_kernels: bool = True
    # Seed of the state realization (membrane init + drive generator);
    # None follows ``seed``, which also fixes the synapse tables.
    state_seed: Optional[int] = None
    stdp: Optional[STDPParams] = None   # plastic when set

    @property
    def state_seed_value(self) -> int:
        return self.seed if self.state_seed is None else self.state_seed

    def spec(self) -> SynapseTableSpec:
        return _spec(self)


@functools.lru_cache(maxsize=64)
def _spec(cfg: EngineConfig) -> SynapseTableSpec:
    single = cfg.decomp.tiles_y == 1 and cfg.decomp.tiles_x == 1
    # plastic runs keep band rows for every stencil-reachable halo column
    # (floor 0.0) and force float32 weights: STDP increments fall below
    # the bfloat16 ulp at typical weight magnitudes
    plastic = cfg.stdp is not None
    return SynapseTableSpec(
        decomp=cfg.decomp, law=cfg.law, d_ring=cfg.d_ring,
        dt_ms=cfg.lif.dt_ms, rate_cap_hz=cfg.rate_cap_hz,
        cap_headroom=cfg.cap_headroom,
        weight_dtype="float32" if plastic else cfg.weight_dtype,
        single_shard=single, halo_floor=0.0 if plastic else 0.5)


def init_sim_state(cfg: EngineConfig, tile_y: int = 0, tile_x: int = 0,
                   seed_offset: int = 0, device="cuda") -> dict:
    """Initial state of one tile on ``device``: the reference's membrane
    init (same numpy draws), an empty ring, and the drive generator."""
    dev = resolve_device(device)
    n_local = cfg.spec().n_local
    sseed = cfg.state_seed_value
    rng = np.random.default_rng(
        np.random.SeedSequence([sseed, 7 + seed_offset, tile_y, tile_x]))
    neuron = init_state(n_local, cfg.lif, rng, device=dev)
    active_cols = cfg.decomp.active_mask(tile_y, tile_x).ravel()
    active = np.repeat(active_cols, cfg.decomp.grid.n_per_column)
    gen = torch.Generator(device=dev)
    gen.manual_seed(sseed + 1000 * seed_offset + 17 * tile_y + tile_x)

    def zero():
        return torch.zeros((), dtype=torch.float32, device=dev)

    return {
        "neuron": neuron,
        "i_ring": torch.zeros((cfg.d_ring, n_local), dtype=torch.float32,
                              device=dev),
        "t": 0,
        "rng": gen,
        "active": torch.from_numpy(active).to(dev),
        "metrics": {"spikes": zero(), "events": zero(), "dropped": zero()},
    }


def build_shard_tables(cfg: EngineConfig, tile_y: int = 0, tile_x: int = 0,
                       compress: bool = True, device="cuda"
                       ) -> SynapseTables:
    """Materialize (host-side numpy, the reference's draws) and by default
    compress one shard's tables, placed on ``device``."""
    dev = resolve_device(device)
    spec = cfg.spec()
    tabs = build_tables(spec, tile_y, tile_x, j_exc=cfg.lif.j_exc_mv,
                        j_inh=cfg.lif.j_inh_mv, seed=cfg.seed, device="cpu")
    if compress:
        tabs = compress_tables(tabs)
    return tabs.to(dev)


# (device, n, rate) -> the drive's constant rate vector, made once: a
# captured step reads it at a fixed address, so entries are never dropped
_RATES: dict = {}


def external_drive(gen: torch.Generator, n_local: int,
                   cfg: EngineConfig) -> torch.Tensor:
    """Poisson thalamo-cortical drive (mV): ext_synapses firing at
    ext_rate, drawn on ``gen``'s device."""
    lam = cfg.ext_synapses * cfg.ext_rate_hz * 1e-3 * cfg.lif.dt_ms
    key = (gen.device, n_local, lam)
    if key not in _RATES:
        _RATES[key] = torch.full((n_local,), lam, dtype=torch.float32,
                                 device=gen.device)
    return torch.poisson(_RATES[key], generator=gen) * cfg.lif.j_ext_mv


def deliver_event_tiers(tables, spikes, halo_band_spikes, spec, i_ring,
                        slot: int, d_ring: int, use_kernels: bool,
                        plan: Optional[List[TierPlan]] = None,
                        tier_bits=None):
    """Event-driven delivery of the local tier + every halo band into
    ``i_ring`` (in place).  With ``use_kernels`` all tiers go to
    ``kops.synaptic_accum_banded`` (bfloat16 weights, adds in any order,
    through the tiers' run descriptors on the card; ``tier_bits``, per
    tier its (bitmap, count) or None -- the local tier's from
    ``kops.neuron_step`` -- spares it those bitmaps) or,
    for float32 weights, whose sums depend on their order, to the
    fixed-order ``kops.plastic_step_banded`` with LTD off, through the
    tiers' inverse index; otherwise ``deliver_events`` runs per tier.
    ``tables``: ``SynapseTables`` or a ``{"local": ..., "halo": [...]}``
    dict (both reach the structures cached on the tier tensors).
    Returns (i_ring, events, dropped) as f32 scalars, summed as the
    reference sums them."""
    if plan is None:
        plan = spec.delivery_plan(getattr(tables, "storage", None))
    halo = list(zip(plan[1:], tables["halo"], halo_band_spikes))
    if use_kernels:
        tiers = [(tables["local"], spikes, plan[0].active_cap)]
        tiers += [(tab, spk, p.active_cap) for p, tab, spk in halo]
        if tables["local"]["w"].dtype == torch.float32:
            i_ring, _, ev, dr = kops.plastic_step_banded(
                tiers, None, None, i_ring, slot, d_ring, 0.0,
                inv=inverse_index(tier_list(tables)), plan=plan)
        else:
            runs = (column_runs(tier_list(tables), spec.n_per_col,
                                spec.n_exc_per_col, d_ring)
                    if i_ring.device.type == "cuda" else None)
            i_ring, ev, dr = kops.synaptic_accum_banded(
                tiers, i_ring, slot, d_ring, plan=plan, runs=runs,
                tier_bits=tier_bits)
        return i_ring, ev.to(torch.float32), dr.to(torch.float32)
    i_ring, ev, dr = deliver_events(tables["local"], spikes, i_ring, slot,
                                    d_ring, plan[0].active_cap)
    ev = ev.to(torch.float32)
    dr = dr.to(torch.float32)
    for p, tab, spk in halo:
        i_ring, ev_b, dr_b = deliver_events(tab, spk, i_ring, slot, d_ring,
                                            p.active_cap)
        ev = ev + ev_b.to(torch.float32)
        dr = dr + dr_b.to(torch.float32)
    return i_ring, ev, dr


def step_head(neuron: dict, i_ring, slot: int, drive, gen, cfg: EngineConfig,
              active, active_cap: Optional[int] = None,
              inplace: bool = False):
    """Steps 1-3 of a step: read ring slot ``slot``, add the external
    drive (``drive``, or drawn on ``gen`` when None), LIF+SFA update,
    zero the slot (``i_ring`` in place).  With ``cfg.use_kernels`` this
    is one kernel (``kops.neuron_step``), which with ``active_cap`` also
    writes the local tier's delivered-row bitmap.  ``inplace``: the new
    neuron state is written into ``neuron``'s own tensors.  Returns
    (neuron, spikes, bits, count): ``bits`` the local tier's (bitmap,
    count) or None, ``count`` the spike count (0-d)."""
    if drive is None:
        drive = external_drive(gen, active.shape[0], cfg)
    if cfg.use_kernels:
        neuron, spikes, bits, count = kops.neuron_step(
            neuron, i_ring, slot, drive, cfg.lif, active,
            active_cap=active_cap, inplace=inplace)
        return neuron, spikes, None if bits is None else (bits, count), count
    new, spikes = lif_sfa_step(neuron, i_ring[slot] + drive, cfg.lif, active)
    i_ring[slot] = 0.0
    if inplace:
        for k, x in new.items():
            neuron[k].copy_(x)
        new = neuron
    return new, spikes, None, spikes.sum()


def deliver_gather_all_tiers(tables, spikes, halo_band_spikes, i_ring,
                             slot: int, d_ring: int):
    """Time-driven delivery (``mode="gather_all"``) of the local tier and
    every halo band into ``i_ring`` (in place).  Returns (i_ring,
    events), the events an f32 scalar summed as the reference sums
    them."""
    local = tables["local"]
    i_ring = deliver_gather_all(local, spikes, i_ring, slot, d_ring)
    ev = (local["nnz"][:spikes.shape[0]].to(torch.float32) * spikes).sum()
    for tab, spk in zip(tables["halo"], halo_band_spikes):
        i_ring = deliver_gather_all(tab, spk, i_ring, slot, d_ring)
        ev = ev + (tab["nnz"][:-1].to(torch.float32) * spk).sum()
    return i_ring, ev


def step(state: dict, tables, cfg: EngineConfig,
         halo_band_spikes: Optional[list] = None,
         drive: Optional[torch.Tensor] = None,
         plan: Optional[List[TierPlan]] = None, deliver: bool = True):
    """One simulation step.

    ``halo_band_spikes``: per-band (rows_b,) spike vectors of the halo
    excitatory sources this step (None single-shard).  ``drive``: this
    step's external current (mV, (n_local,)); None draws it from
    ``state["rng"]``.  ``plan``: the tables' delivery plan (computed
    when None).  ``deliver=False`` stops after the LIF update and the
    ring-slot consume: the plastic loop delivers together with STDP
    (``plastic_delivery_stdp``).  With ``cfg.use_kernels`` steps 1-3
    are one kernel (``kops.neuron_step``), which also writes the local
    tier's delivered-row bitmap for step 4.  Returns (new_state,
    local_spikes); the ring tensor is updated in place and carried over.
    """
    new_state, spikes, _ = _step(state, tables, cfg, halo_band_spikes,
                                 drive, plan, deliver)
    return new_state, spikes


def _step(state: dict, tables, cfg: EngineConfig,
          halo_band_spikes: Optional[list] = None,
          drive: Optional[torch.Tensor] = None,
          plan: Optional[List[TierPlan]] = None, deliver: bool = True,
          inplace: bool = False):
    """``step``, also returning the step's spike count (f32 0-d).
    ``inplace`` (kernel path): the new neuron state and metrics are
    written into ``state``'s own tensors, whose addresses a captured
    graph holds."""
    spec = cfg.spec()
    event = cfg.mode == "event" and deliver
    if plan is None and event:
        plan = spec.delivery_plan(getattr(tables, "storage", None))
    slot = state["t"] % cfg.d_ring
    i_ring = state["i_ring"]
    halo_band_spikes = halo_band_spikes or []
    neuron, spikes, bits, count = step_head(
        state["neuron"], i_ring, slot, drive, state["rng"], cfg,
        state["active"], active_cap=plan[0].active_cap if event else None,
        inplace=inplace)
    n_spk = count.to(torch.float32)
    tier_bits = (None if bits is None
                 else [bits] + [None] * len(halo_band_spikes))

    if not deliver:
        adds = {"spikes": n_spk}
    elif cfg.mode == "event":
        i_ring, ev, dr = deliver_event_tiers(
            tables, spikes, halo_band_spikes, spec, i_ring, slot,
            cfg.d_ring, cfg.use_kernels, plan=plan, tier_bits=tier_bits)
        adds = {"spikes": n_spk, "events": ev, "dropped": dr}
    elif cfg.mode == "gather_all":
        i_ring, ev = deliver_gather_all_tiers(tables, spikes,
                                              halo_band_spikes, i_ring,
                                              slot, cfg.d_ring)
        adds = {"spikes": n_spk, "events": ev}
    else:
        raise ValueError(f"unknown mode {cfg.mode}")

    m = state["metrics"]
    if inplace:
        for k, x in adds.items():
            m[k].add_(x)
        metrics = m
    else:
        metrics = {k: m[k] + adds[k] if k in adds else m[k] for k in m}
    new_state = {
        "neuron": neuron, "i_ring": i_ring, "t": state["t"] + 1,
        "rng": state["rng"], "active": state["active"], "metrics": metrics,
    }
    return new_state, spikes, n_spk


def plastic_delivery_stdp(tiers, masks, inv, traces, spike_tiers, spec,
                          i_ring, slot: int, cfg: EngineConfig, plan,
                          fused_post: bool = False):
    """One plastic update: event delivery + STDP over ``tiers``.

    With ``cfg.use_kernels`` one fixed-order launch per tier delivers
    the old weights and applies LTD (``kops.plastic_step_banded``, the
    CUDA kernel on CUDA tensors), then the plain ``stdp_ltp_finalize``
    adds LTP, the clamp and the trace increments.  Otherwise the plain
    two-pass reference: ``deliver_event_tiers`` then ``stdp_step``.
    Both are bit-identical to the reference on the CPU.  ``tiers`` carry
    the live weights (updated in place on the kernel path); ``traces``
    is ``{"x_pre": [per tier], "x_post"}``; ``fused_post`` picks the post
    trace's rounding (``stdp.post_trace``: the reference's sharded scan
    rounds it once, its single-shard scan twice).  Returns (i_ring,
    new_tiers, new_traces, events, dropped) with events/dropped as f32
    scalars.
    """
    p = cfg.stdp
    spikes_local = spike_tiers[0]
    post_cap = spec.active_cap_local
    if cfg.use_kernels:
        # decay first (updates read the previous activity), as stdp_step
        x_pre_d = [xp * p.decay_plus for xp in traces["x_pre"]]
        x_post_d = traces["x_post"] * p.decay_minus
        tier_args = [(t, spk, tp.active_cap)
                     for t, spk, tp in zip(tiers, spike_tiers, plan)]
        i_ring, new_w, ev, dr = kops.plastic_step_banded(
            tier_args, masks, x_post_d, i_ring, slot, cfg.d_ring,
            -p.a_minus, inv=inv, plan=plan)
        new_tiers = [dict(t, w=w) for t, w in zip(tiers, new_w)]
        new_tiers, new_traces = stdp_ltp_finalize(
            new_tiers, masks, inv, x_pre_d, traces["x_post"], spike_tiers,
            spikes_local, p, post_cap, fused_post)
        return (i_ring, new_tiers, new_traces, ev.to(torch.float32),
                dr.to(torch.float32))
    tabs = {"local": tiers[0], "halo": list(tiers[1:])}
    i_ring, ev, dr = deliver_event_tiers(
        tabs, spikes_local, list(spike_tiers[1:]), spec, i_ring, slot,
        cfg.d_ring, False, plan=plan)
    new_tiers, new_traces = stdp_step(
        tiers, masks, inv, traces, spike_tiers, spikes_local, p,
        [tp.active_cap for tp in plan], post_cap, fused_post)
    return i_ring, new_tiers, new_traces, ev, dr


DriveSource = Union[torch.Tensor, Callable[[int], torch.Tensor], None]


def _check_device(state: dict, tables, dev: torch.device) -> None:
    have = {state["i_ring"].device, state["neuron"]["v"].device,
            tables["local"]["tgt"].device}
    if any(d.type != dev.type for d in have):
        raise ValueError(
            f"simulate(device={str(dev)!r}) but the state/tables live on "
            f"{sorted(str(d) for d in have)}; build them with the same "
            "device=")


def init_ensemble_state(cfg: EngineConfig, seeds, device="cuda") -> dict:
    """Stack ``len(seeds)`` member states on a leading ensemble axis.

    Member ``m`` is ``init_sim_state`` of the same config with
    ``state_seed=seeds[m]``: every member shares the table realization
    (``cfg.seed``) and draws its own membrane init and drive, so
    ``simulate(..., ensemble=M)`` over this state reproduces each
    member's solo run bit for bit.  Tensor leaves are ``(M, ...)``;
    ``rng`` is the list of the members' generators and ``t`` the one
    step all members share."""
    seeds = tuple(int(s) for s in seeds)
    if not seeds:
        raise ValueError("ensemble needs at least one member seed")
    members = [init_sim_state(dataclasses.replace(cfg, state_seed=s),
                              device=device) for s in seeds]

    def stack(get):
        return torch.stack([get(m) for m in members])

    return {
        "neuron": {k: stack(lambda m, k=k: m["neuron"][k])
                   for k in members[0]["neuron"]},
        "i_ring": stack(lambda m: m["i_ring"]),
        "t": 0,
        "rng": [m["rng"] for m in members],
        "active": stack(lambda m: m["active"]),
        "metrics": {k: stack(lambda m, k=k: m["metrics"][k])
                    for k in members[0]["metrics"]},
    }


def _check_members(state: dict, m: int) -> None:
    """An ensemble state of ``m`` members: every tensor leaf and the
    generator list lead with ``m``."""
    lead = {x.shape[0] if x.dim() else None
            for x in [state["i_ring"], state["active"]]
            + list(state["neuron"].values())
            + list(state["metrics"].values())}
    rng = state["rng"]
    lead.add(len(rng) if isinstance(rng, (list, tuple)) else None)
    if lead != {m}:
        raise ValueError(
            f"ensemble={m} but state leading axes are "
            f"{sorted(lead, key=str)}; build the state with "
            "init_ensemble_state(cfg, seeds)")


def _member(state: dict, i: int) -> dict:
    """Member ``i`` of an ensemble state: views of its rows."""
    return {"neuron": {k: x[i] for k, x in state["neuron"].items()},
            "i_ring": state["i_ring"][i], "t": state["t"],
            "rng": state["rng"][i], "active": state["active"][i],
            "metrics": {k: x[i] for k, x in state["metrics"].items()}}


def _drive_at(drive: DriveSource, k: int, t: int):
    """Step k's injected drive (None: draw it from the state's rng)."""
    if isinstance(drive, torch.Tensor):
        return drive[k]
    if drive is not None:
        return drive(t)
    return None


def simulate(state: dict, tables, cfg: EngineConfig, n_steps: int,
             record_spikes: bool = False, drive: DriveSource = None,
             device="cuda", plasticity: Optional[dict] = None,
             recorder=None, ensemble: Optional[int] = None):
    """Run ``n_steps`` of single-shard simulation (no halo sources).

      - static (``plasticity=None``): returns ``(state, out)``; ``out``
        is the per-step spike count ``(n_steps,)`` f32, or the full
        raster ``(n_steps, n_local)`` f32 with ``record_spikes=True``.
      - ``recorder``: an ``obs.record.RecorderSpec`` (static runs only);
        every spike is also appended as a ``(sim_step, global_neuron_id)``
        event to a bounded buffer, and the return becomes ``(state, out,
        recorder_state)``.  Recording is a pure observer.  The steps
        append to a resident buffer (``obs.record.resident_recorder``),
        which the next call with the same spec zeroes and refills; the
        call returns a copy of it (``obs.record.copy_recorder``), made
        after the run, outside any captured graph.
      - ``plasticity=init_plasticity(tables, cfg)``: STDP each step;
        returns ``((state, tables, traces), per_step_spike_counts)``.
        The local tier's weights are cloned once on entry, so the
        caller's ``tables`` are never changed.
      - ``ensemble=M``: ``state`` is ``init_ensemble_state``'s, M
        members sharing ``tables``; every return leaf grows a leading
        member axis (``out`` ``(M, n_steps[, n_local])``, the recorder's
        buffers, the plastic tables and traces: the local tier's weights
        per member, the other leaves expanded views), as the reference's
        vmap returns them.  Member m is bit for bit the solo run with
        ``state_seed=seeds[m]``.  A state whose leading axes are not M
        raises.

    ``drive``: None draws the Poisson drive from ``state["rng"]``; a
    tensor ``(n_steps, n_local)`` (``(n_steps, M, n_local)`` for an
    ensemble) gives step k of this call its row k (mV); a callable
    ``drive(t)`` is called with the absolute step ``t`` and returns one
    step's rows.  ``device`` must be where ``state`` and ``tables`` live
    (default ``"cuda"``, which raises without CUDA).

    The neuron state and metrics are stepped in place on copies (the
    caller's tensors keep their values); the ring is updated in place.
    On a CUDA ring with ``cfg.use_kernels`` and ``mode="event"``, a
    static run whose drive is None or a tensor (``record_spikes``,
    ``recorder`` and ``ensemble`` or not) runs as replays of one CUDA
    graph of ``d_ring`` consecutive steps of every member
    (``_StepGraph``): the first ``d_ring`` steps run eagerly, then every
    full block of ``d_ring`` steps is one replay, and a tail of fewer
    steps runs eagerly; the results are the eager steps' bit for bit.
    A capture that fails raises.  Runs with a callable drive or
    plasticity, the plain path (``use_kernels`` unset) and
    ``mode="gather_all"`` step eagerly, one ``step`` at a time (through
    the same fused step head on the kernel path).
    """
    dev = resolve_device(device)
    _check_device(state, tables, dev)
    spec = cfg.spec()
    n_local = spec.n_local
    m = None if ensemble is None else int(ensemble)
    if m is not None:
        _check_members(state, m)
    lead = () if m is None else (m,)
    if isinstance(drive, torch.Tensor) and \
            tuple(drive.shape) != (n_steps,) + lead + (n_local,):
        raise ValueError(f"drive has shape {tuple(drive.shape)}, expected "
                         f"{(n_steps,) + lead + (n_local,)}")
    if plasticity is not None:
        if recorder is not None or record_spikes:
            raise ValueError("plastic runs do not support recorder/"
                             "record_spikes (use the distributed driver)")
        if m is None:
            return _run_plastic(state, tables, plasticity, cfg, n_steps,
                                drive)
        return _run_plastic_members(state, tables, plasticity, cfg,
                                    n_steps, drive, m)
    solo = m is None
    if solo:       # one member: the solo state with a member axis of 1
        ens = {"neuron": {k: x[None] for k, x in state["neuron"].items()},
               "i_ring": state["i_ring"][None], "t": state["t"],
               "rng": [state["rng"]], "active": state["active"][None],
               "metrics": {k: x[None] for k, x in state["metrics"].items()}}
        if isinstance(drive, torch.Tensor):
            drive = drive[:, None]
        elif drive is not None:
            drive = (lambda f: lambda t: f(t)[None])(drive)
    else:
        ens = state
    loop = _StepGraph(ens, tables, cfg, record_spikes, drive, recorder, dev)
    width = len(loop.views)
    out = torch.empty((n_steps, width) + ((n_local,) if record_spikes
                                          else ()),
                      dtype=torch.float32, device=dev)
    if loop.captured:
        loop.run(n_steps, out)
    else:
        for k in range(n_steps):
            loop.eager(k, out[k])
    fin = loop.state
    if solo:
        out = out[:, 0]
        fin = {"neuron": {k: x[0] for k, x in fin["neuron"].items()},
               "i_ring": state["i_ring"], "t": fin["t"],
               "rng": state["rng"], "active": state["active"],
               "metrics": {k: x[0] for k, x in fin["metrics"].items()}}
        rec = None if loop.rec is None else {
            k: x[0] for k, x in loop.rec.items()}
    else:
        out = out.transpose(0, 1).contiguous()
        rec = loop.rec
    if rec is None:
        return fin, out
    from ..obs.record import copy_recorder
    return fin, out, copy_recorder(rec)


def bind_tier_structures(tiers: list, spec, d_ring: int) -> None:
    """Make the derived structures the kernel path reads for ``tiers``
    ready, eagerly (binding reads the device, so it must precede a
    capture): the inverse index for float32 weights, else the run
    descriptors, bound to the tiers' weights."""
    if tiers[0]["w"].dtype == torch.float32:
        inverse_index(tiers)
        return
    for runs, tier in zip(column_runs(tiers, spec.n_per_col,
                                      spec.n_exc_per_col, d_ring), tiers):
        bind_column_weights(runs, tier)


class GraphLoop:
    """A static loop on a CUDA ring, ``d_ring`` steps at a time.

    The slot sequence repeats every ``d_ring`` steps, so one CUDA graph
    of ``d_ring`` consecutive steps serves every block.  A subclass
    steps ``self.state`` in place (``_one``: one step, its output
    copied to ``dst``), so every replay reads and writes the same
    tensors, and names what a capture depends on: the tier tensors
    (``_tier_tensors``), their eager binding (``_bind``) and the drive
    generators (``_generators``).  ``run`` drives ``n_steps``: before
    the first capture ``d_ring`` eager steps, then one replay per full
    block (captured at the first), then an eager tail.  A loop kept
    across runs (``dist_engine``'s sim) replays from a run's first
    step.  The graph holds the ring slots of the phase it was captured
    at (``phase``: the first captured step's ``t % d_ring``); a block
    that starts at another phase rolls the ring along its slot axis so
    that slot ``phase`` holds the current step's slot, replays, and
    rolls it back.  Every step reads and writes slots relative to its
    own, so this is the same arithmetic on the same values, bit for
    bit.  The drive is drawn inside the graph on the generators
    (registered with the graph: replays draw what eager steps would,
    and a ``set_state`` on the same generator objects carries over) or
    copied from the injected drive into a static buffer; outputs come
    out of a static buffer, one copy per block.  A graph holds the tier
    tensors and the run descriptors' weights as they were at capture:
    before each replay the tier tensors are checked by identity and
    version, and a change rebinds and captures again (``captures``
    counts the captures).  Each replay counts as ``step_graph`` and as
    a launch of each kernel it holds.  ``state["t"]`` is an int or a
    numpy array, advanced by rebinding (never in place)."""

    def __init__(self, state: dict, d_ring: int, dev: torch.device,
                 drive: Optional[torch.Tensor], drive_shape: tuple,
                 out_shape: tuple):
        self.state, self.d, self.dev = state, d_ring, dev
        self.drive = drive
        self.injected = drive is not None
        self.drive_shape, self.out_shape = drive_shape, out_shape
        self.drive_buf = self.out_buf = self.stream = None
        self.graph = self.tally = self.stamp = None
        self.phase, self.captures = 0, 0

    def _one(self, drive, dst) -> None:
        raise NotImplementedError

    def _tier_tensors(self) -> list:
        raise NotImplementedError

    def _bind(self) -> None:
        raise NotImplementedError

    def _generators(self) -> list:
        raise NotImplementedError

    def run(self, n_steps: int, out: torch.Tensor) -> None:
        k, d = 0, self.d
        while k < n_steps:
            blocks = (n_steps - k) // d
            if blocks and (self.graph is not None or k >= d):
                self.replay(k, blocks, out[k:k + blocks * d])
                k += blocks * d
            else:
                self.eager(k, out[k])
                k += 1

    def eager(self, k: int, dst) -> None:
        self._one(_drive_at(self.drive, k, self.state["t"]), dst)

    def _unchanged(self) -> bool:
        now = self._tier_tensors()
        return len(now) == len(self.stamp) and all(
            x is y and x._version == v for (x, v), y in zip(self.stamp, now))

    def _capture(self) -> None:
        self._bind()
        self.stamp = [(x, x._version) for x in self._tier_tensors()]
        self.graph = None       # a stale graph's memory goes first
        if self.out_buf is None:
            self.out_buf = torch.empty((self.d,) + self.out_shape,
                                       dtype=torch.float32, device=self.dev)
            if self.injected:
                self.drive_buf = torch.empty((self.d,) + self.drive_shape,
                                             dtype=torch.float32,
                                             device=self.dev)
            self.stream = torch.cuda.Stream(device=self.dev)
        graph = torch.cuda.CUDAGraph()
        if not self.injected:
            for gen in self._generators():
                graph.register_generator_state(gen)
        t0 = self.state["t"]
        # captured on a side stream (the default stream cannot be), with
        # none of torch.cuda.graph's collection and cache emptying; a
        # capture ignores other threads' CUDA calls (a checkpoint
        # writer's copies, a job server's other threads).  The garbage
        # collector is held off meanwhile: a collection in any thread
        # could destroy an unreachable graph (a sim and its loop form a
        # cycle), which a capture does not permit and which fails it
        main = torch.cuda.current_stream(self.dev)
        self.stream.wait_stream(main)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.capture_tally() as tally, \
                    torch.cuda.stream(self.stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    for j in range(self.d):
                        self._one(None if self.drive_buf is None
                                  else self.drive_buf[j], self.out_buf[j])
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(self.stream)
        self.state["t"] = t0
        self.graph, self.tally = graph, tally
        self.phase = self._slot()
        self.captures += 1

    def _slot(self) -> int:
        return int(np.asarray(self.state["t"]).flat[0]) % self.d

    def replay(self, k: int, blocks: int, dst) -> None:
        """``blocks`` replays from the run's step ``k``, their outputs
        into ``dst``."""
        if self.graph is None or not self._unchanged():
            self._capture()
        d = self.d
        shift = (self.phase - self._slot()) % d
        ring = self.state["i_ring"]
        if shift:
            ring.copy_(torch.roll(ring, shift, dims=-2))
        for b in range(blocks):
            if self.drive_buf is not None:
                self.drive_buf.copy_(self.drive[k + b * d:k + (b + 1) * d])
            self.graph.replay()
            _build.count_replay("step_graph", self.tally)
            dst[b * d:(b + 1) * d].copy_(self.out_buf)
            self.state["t"] = self.state["t"] + d
        if shift:
            ring.copy_(torch.roll(ring, -shift, dims=-2))


class _StepGraph(GraphLoop):
    """The single-shard static loop over the members of an ensemble
    state (a solo run is one member): every member's step, its recorder
    append and its output, in place on copies of the neuron state and
    metrics (the ring is updated in place on every path).  On a CUDA
    ring with the kernels in event mode and a drive that is drawn or a
    tensor (``captured``) ``run`` replays one graph of ``d_ring`` steps
    of all members (``GraphLoop``); otherwise ``simulate`` steps it
    eagerly.  A recorded step appends to the resident recorder with the
    step read from a device counter, which each step advances, so a
    replay records its own steps."""

    def __init__(self, state: dict, tables, cfg: EngineConfig,
                 record_spikes: bool, drive, recorder, dev: torch.device):
        n = cfg.spec().n_local
        m = len(state["rng"])
        super().__init__(
            dict(state,
                 neuron={k: x.clone() for k, x in state["neuron"].items()},
                 metrics={k: x.clone() for k, x in state["metrics"].items()}),
            cfg.d_ring, dev, drive if isinstance(drive, torch.Tensor)
            else None, (m, n), (m, n) if record_spikes else (m,))
        self.drive = drive
        self.tables, self.cfg = tables, cfg
        self.plan = (cfg.spec().delivery_plan(getattr(tables, "storage",
                                                      None))
                     if cfg.mode == "event" else None)
        self.record = record_spikes
        self.captured = (dev.type == "cuda" and cfg.use_kernels
                         and cfg.mode == "event"
                         and (drive is None
                              or isinstance(drive, torch.Tensor)))
        self.views = [_member(self.state, i) for i in range(m)]
        self.recorder = recorder
        self.rec = self.recs = None
        if recorder is not None:
            from ..obs.record import resident_recorder, tile_gid_map
            self.gids = torch.from_numpy(tile_gid_map(cfg.decomp, 0,
                                                      0)).to(dev)
            self.rec = resident_recorder(_RECORDERS, recorder, dev, (m,))
            self.recs = [{k: x[i] for k, x in self.rec.items()}
                         for i in range(m)]
            self.t_dev = torch.full((), state["t"], dtype=torch.int32,
                                    device=dev)

    def _one(self, drive, dst) -> None:
        t = self.state["t"]
        for i, view in enumerate(self.views):
            view["t"] = t
            _, spikes, n_spk = _step(view, self.tables, self.cfg,
                                     drive=None if drive is None
                                     else drive[i], plan=self.plan,
                                     inplace=True)
            if self.rec is not None:
                from ..obs.record import record_step
                record_step(self.recs[i], spikes, self.gids, self.t_dev,
                            self.recorder)
            dst[i].copy_(spikes if self.record else n_spk)
        if self.rec is not None:
            self.t_dev.add_(1)
        self.state["t"] = t + 1

    def _tier_tensors(self) -> list:
        return [t[name] for t in tier_list(self.tables)
                for name in ("tgt", "dslot", "nnz", "w")]

    def _bind(self) -> None:
        bind_tier_structures(tier_list(self.tables), self.cfg.spec(),
                             self.cfg.d_ring)

    def _generators(self) -> list:
        return list(self.state["rng"])


# (spec, device, leading axes) -> the single-shard engine's resident
# recorder (``obs.record.resident_recorder``)
_RECORDERS: dict = {}


def _run_plastic_members(state: dict, tables, stdp_aux: dict,
                         cfg: EngineConfig, n_steps: int, drive, m: int):
    """The plastic loop of an ensemble: each member's solo plastic run in
    turn, on its rows of the state (the ring in place), stacked on a
    leading member axis: the state, the per-step counts, the traces,
    and the tables (the local tier's weights per member; every other
    leaf an expanded view of the shared realization)."""
    runs = []
    for i in range(m):
        if isinstance(drive, torch.Tensor):
            d = drive[:, i]
        elif drive is not None:
            d = (lambda f, i: lambda t: f(t)[i])(drive, i)
        else:
            d = None
        runs.append(_run_plastic(_member(state, i), tables, stdp_aux, cfg,
                                 n_steps, d))

    def stack(xs):
        return torch.stack(list(xs))

    fins = [r[0][0] for r in runs]
    fin = {"neuron": {k: stack(f["neuron"][k] for f in fins)
                      for k in fins[0]["neuron"]},
           "i_ring": state["i_ring"], "t": fins[0]["t"],
           "rng": state["rng"], "active": state["active"],
           "metrics": {k: stack(f["metrics"][k] for f in fins)
                       for k in fins[0]["metrics"]}}

    def lift(tier, w=None):
        return {k: w if k == "w" and w is not None
                else x.expand((m,) + tuple(x.shape)) for k, x in tier.items()}

    local = lift(tables["local"], stack(r[0][1]["local"]["w"]
                                        for r in runs))
    halo = [lift(t) for t in tables["halo"]]
    if isinstance(tables, SynapseTables):
        ens_tables = SynapseTables(local, halo, tables.storage,
                                   stats=tables.stats)
    else:
        ens_tables = dict(tables, local=local, halo=halo)
    traces = {"x_pre": [stack(r[0][2]["x_pre"][j] for r in runs)
                        for j in range(len(runs[0][0][2]["x_pre"]))],
              "x_post": stack(r[0][2]["x_post"] for r in runs)}
    return (fin, ens_tables, traces), stack(r[1] for r in runs)


def _run_plastic(state: dict, tables, stdp_aux: dict, cfg: EngineConfig,
                 n_steps: int, drive: DriveSource):
    """The plastic loop: the local tier's weights join the carry.

    Single-shard only: only the local tier is stepped; halo tiers in
    ``stdp_aux`` (a multi-tile config's tables) are ignored, as delivery
    ignores them without halo spikes.  The inverse index still covers
    every tier, as in the reference."""
    if cfg.mode != "event":
        raise ValueError(
            f"plastic runs require mode='event' (got {cfg.mode!r}): the "
            "STDP update is event-driven on the same compaction as "
            "delivery")
    if cfg.stdp is None or tables["local"]["w"].dtype != torch.float32:
        raise ValueError("plastic runs need cfg.stdp set and float32 "
                         "tables built from that config")
    spec = cfg.spec()
    plan = spec.delivery_plan(getattr(tables, "storage", None))[:1]
    masks = stdp_aux["masks"][:1]
    traces = {"x_pre": stdp_aux["traces"]["x_pre"][:1],
              "x_post": stdp_aux["traces"]["x_post"]}
    tiers = [dict(tables["local"], w=tables["local"]["w"].clone())]
    inv = stdp_aux["inv"]
    if "tm" not in inv and cfg.use_kernels \
            and state["i_ring"].device.type == "cuda":
        # an index converted from the reference's arrays: the kernel's
        # target-major delays and plastic bits, once per call
        inv = dict(inv, tm=target_major_meta(
            tier_list(tables), inv, stdp_aux["masks"]))
    out = torch.empty((n_steps,), dtype=torch.float32,
                      device=state["i_ring"].device)
    for k in range(n_steps):
        slot = state["t"] % cfg.d_ring
        state, spikes, n_spk = _step(state, tables, cfg,
                                     drive=_drive_at(drive, k, state["t"]),
                                     deliver=False)
        i_ring, tiers, traces, ev, dr = plastic_delivery_stdp(
            tiers, masks, inv, traces, [spikes], spec,
            state["i_ring"], slot, cfg, plan)
        m = state["metrics"]
        state = dict(state, i_ring=i_ring,
                     metrics=dict(m, events=m["events"] + ev,
                                  dropped=m["dropped"] + dr))
        out[k] = n_spk
    return (state, with_local_tier(tables, tiers[0]), traces), out


def init_plasticity(tables, cfg: EngineConfig) -> dict:
    """Build the STDP auxiliaries: the inverse index over every tier the
    tables carry (``synapses.inverse_index``, host numpy, cached on the
    tier tensors) with these masks bound into its plastic bits, the
    plastic masks and zero traces, on the tables' device.  ``tables``:
    ``SynapseTables`` or the dict form."""
    tiers = tier_list(tables)
    n_local = cfg.spec().n_local
    dev = tables["local"]["tgt"].device
    check_weight_invariant(tiers, cfg.stdp)
    if tables["local"]["tgt"].shape[0] - 1 != n_local:
        raise ValueError("the tables do not belong to this config")
    inv, masks = inverse_index(tiers), plastic_masks(tiers)
    for ti, mask in enumerate(masks):
        # the kernel reads plastic bits from inv["tm"]: bind these masks
        bind_plastic_bits(inv, ti, mask)
    return {"inv": inv, "masks": masks,
            "traces": init_stdp_state(tiers, n_local, device=dev)}


def firing_rate_hz(state: dict, cfg: EngineConfig,
                   n_steps: Optional[int] = None) -> float:
    """Mean firing rate over the simulated window (active neurons only);
    ``n_steps=None`` takes the window from the state's step counter."""
    if n_steps is None:
        n_steps = int(state["t"])
    n_active = float(state["active"].sum())
    spikes = float(state["metrics"]["spikes"])
    sim_sec = n_steps * cfg.lif.dt_ms * 1e-3
    return spikes / max(n_active, 1.0) / max(sim_sec, 1e-9)
