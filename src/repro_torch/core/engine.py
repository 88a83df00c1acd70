"""Single-shard DPSNN engine: time-driven outer loop, event-driven delivery.

The port of ``repro.core.engine`` (static runs).  One engine instance
simulates one tile of the column grid.  Step structure (dt = 1 ms):

  1. read the delayed-current ring slot for t, add external Poisson drive
  2. LIF+SFA update -> spikes
  3. zero the consumed ring slot
  4. deliver local+halo spikes through the synapse tables into future
     ring slots (event mode: cost ~ spikes x fan-out = synaptic events)

State is a dict of tensors plus the step counter ``t`` (a Python int,
so ring slots never wait on the device) and the drive's
``torch.Generator``.  ``simulate`` is a Python loop over ``step``; the
ring is updated in place.

The external drive is drawn with ``torch.poisson`` on the state's
generator, which cannot reproduce ``jax.random.poisson``: for parity
runs ``simulate(..., drive=...)`` injects the reference's drive.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..kernels import ops as kops
from .connectivity import (ConnectivityLaw, EXTERNAL_RATE_HZ,
                           EXTERNAL_SYNAPSES)
from .grid import TileDecomposition
from .neuron import LIFParams, init_state, lif_sfa_step
from .synapses import (SynapseTableSpec, SynapseTables, TierPlan,
                       build_tables, compress_tables, deliver_events,
                       deliver_gather_all)


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

    @property
    def state_seed_value(self) -> int:
        return self.seed if self.state_seed is None else self.state_seed

    def spec(self) -> SynapseTableSpec:
        return _spec(self)


@functools.lru_cache(maxsize=64)
def _spec(cfg: EngineConfig) -> SynapseTableSpec:
    single = cfg.decomp.tiles_y == 1 and cfg.decomp.tiles_x == 1
    return SynapseTableSpec(
        decomp=cfg.decomp, law=cfg.law, d_ring=cfg.d_ring,
        dt_ms=cfg.lif.dt_ms, rate_cap_hz=cfg.rate_cap_hz,
        cap_headroom=cfg.cap_headroom, weight_dtype=cfg.weight_dtype,
        single_shard=single, halo_floor=0.5)


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
                        j_inh=cfg.lif.j_inh_mv, seed=cfg.seed)
    if compress:
        tabs = compress_tables(tabs)
    return tabs.to(dev)


def external_drive(gen: torch.Generator, n_local: int,
                   cfg: EngineConfig) -> torch.Tensor:
    """Poisson thalamo-cortical drive (mV): ext_synapses firing at
    ext_rate, drawn on ``gen``'s device."""
    lam = cfg.ext_synapses * cfg.ext_rate_hz * 1e-3 * cfg.lif.dt_ms
    rate = torch.full((n_local,), lam, dtype=torch.float32,
                      device=gen.device)
    return torch.poisson(rate, generator=gen) * cfg.lif.j_ext_mv


def deliver_event_tiers(tables, spikes, halo_band_spikes, spec, i_ring,
                        slot: int, d_ring: int, use_kernels: bool,
                        plan: Optional[List[TierPlan]] = None):
    """Event-driven delivery of the local tier + every halo band into
    ``i_ring`` (in place).  With ``use_kernels`` all tiers go to
    ``kops.synaptic_accum_banded``; otherwise ``deliver_events`` runs
    per tier.  Returns (i_ring, events, dropped) as f32 scalars, summed
    as the reference sums them."""
    if plan is None:
        plan = spec.delivery_plan(getattr(tables, "storage", None))
    halo = list(zip(plan[1:], tables["halo"], halo_band_spikes))
    if use_kernels:
        tiers = [(tables["local"], spikes, plan[0].active_cap)]
        tiers += [(tab, spk, p.active_cap) for p, tab, spk in halo]
        i_ring, ev, dr = kops.synaptic_accum_banded(
            tiers, i_ring, slot, d_ring, plan=plan)
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


def step(state: dict, tables, cfg: EngineConfig,
         halo_band_spikes: Optional[list] = None,
         drive: Optional[torch.Tensor] = None,
         plan: Optional[List[TierPlan]] = None):
    """One simulation step.

    ``halo_band_spikes``: per-band (rows_b,) spike vectors of the halo
    excitatory sources this step (None single-shard).  ``drive``: this
    step's external current (mV, (n_local,)); None draws it from
    ``state["rng"]``.  ``plan``: the tables' delivery plan (computed
    when None).  Returns (new_state, local_spikes); the ring tensor is
    updated in place and carried over.
    """
    spec = cfg.spec()
    n_local = spec.n_local
    if plan is None and cfg.mode == "event":
        plan = spec.delivery_plan(getattr(tables, "storage", None))
    slot = state["t"] % cfg.d_ring
    if drive is None:
        drive = external_drive(state["rng"], n_local, cfg)

    i_ring = state["i_ring"]
    i_now = i_ring[slot] + drive
    if cfg.use_kernels:
        neuron, spikes = kops.lif_step(state["neuron"], i_now, cfg.lif,
                                       state["active"])
    else:
        neuron, spikes = lif_sfa_step(state["neuron"], i_now, cfg.lif,
                                      state["active"])
    i_ring[slot] = 0.0

    halo_band_spikes = halo_band_spikes or []
    m = state["metrics"]
    n_spk = spikes.sum()
    if cfg.mode == "event":
        i_ring, ev, dr = deliver_event_tiers(
            tables, spikes, halo_band_spikes, spec, i_ring, slot,
            cfg.d_ring, cfg.use_kernels, plan=plan)
        metrics = {"spikes": m["spikes"] + n_spk,
                   "events": m["events"] + ev,
                   "dropped": m["dropped"] + dr}
    elif cfg.mode == "gather_all":
        local = tables["local"]
        i_ring = deliver_gather_all(local, spikes, i_ring, slot, cfg.d_ring)
        ev = (local["nnz"][:n_local].to(torch.float32) * spikes).sum()
        for tab, spk in zip(tables["halo"], halo_band_spikes):
            i_ring = deliver_gather_all(tab, spk, i_ring, slot, cfg.d_ring)
            ev = ev + (tab["nnz"][:-1].to(torch.float32) * spk).sum()
        metrics = {"spikes": m["spikes"] + n_spk,
                   "events": m["events"] + ev,
                   "dropped": m["dropped"]}
    else:
        raise ValueError(f"unknown mode {cfg.mode}")

    new_state = {
        "neuron": neuron, "i_ring": i_ring, "t": state["t"] + 1,
        "rng": state["rng"], "active": state["active"], "metrics": metrics,
    }
    return new_state, spikes


DriveSource = Union[torch.Tensor, Callable[[int], torch.Tensor], None]


def _check_device(state: dict, tables, dev: torch.device) -> None:
    have = {state["i_ring"].device, state["neuron"]["v"].device,
            tables["local"]["tgt"].device}
    if any(d.type != dev.type for d in have):
        raise ValueError(
            f"simulate(device={str(dev)!r}) but the state/tables live on "
            f"{sorted(str(d) for d in have)}; build them with the same "
            "device=")


def simulate(state: dict, tables, cfg: EngineConfig, n_steps: int,
             record_spikes: bool = False, drive: DriveSource = None,
             device="cuda"):
    """Run ``n_steps`` of single-shard static simulation (no halo sources).

    Returns ``(state, out)``: ``out`` is the per-step spike count
    ``(n_steps,)`` f32, or the full raster ``(n_steps, n_local)`` f32
    with ``record_spikes=True``.

    ``drive``: None draws the Poisson drive from ``state["rng"]``; a
    tensor ``(n_steps, n_local)`` gives step k of this call its row k
    (mV); a callable ``drive(t) -> (n_local,)`` is called with the
    absolute step ``t``.  ``device`` must be where ``state`` and
    ``tables`` live (default ``"cuda"``, which raises without CUDA).
    """
    dev = resolve_device(device)
    _check_device(state, tables, dev)
    spec = cfg.spec()
    n_local = spec.n_local
    plan = (spec.delivery_plan(getattr(tables, "storage", None))
            if cfg.mode == "event" else None)
    if isinstance(drive, torch.Tensor) and \
            tuple(drive.shape) != (n_steps, n_local):
        raise ValueError(f"drive has shape {tuple(drive.shape)}, expected "
                         f"{(n_steps, n_local)}")
    shape = (n_steps, n_local) if record_spikes else (n_steps,)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    for k in range(n_steps):
        if isinstance(drive, torch.Tensor):
            d = drive[k]
        elif drive is not None:
            d = drive(state["t"])
        else:
            d = None
        state, spikes = step(state, tables, cfg, drive=d, plan=plan)
        out[k] = spikes if record_spikes else spikes.sum()
    return state, out


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
