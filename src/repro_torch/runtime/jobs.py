"""Typed simulation jobs: a frozen spec, a JSON wire format, a builder.

The port of ``repro.runtime.jobs``' ``SimJobSpec`` and
``build_sim_driver``.  The CLI launcher (``launch.sim``) and the job
server (``launch.serve --arch sim``) describe a run with one frozen
:class:`SimJobSpec`:
everything that shapes the simulation (model geometry, law, seeds,
schedule, observability) lives in the spec; everything operational
(device, telemetry sink, sim-function cache) is passed to
:func:`build_sim_driver`.

* **Frozen + JSON round-trip.**  ``SimJobSpec.from_json(spec.to_json())
  == spec`` exactly; the wire format is a flat JSON object, the same as
  the reference's.  ``__post_init__`` normalizes (lists -> tuples) and
  validates, so a spec that constructs is a spec that runs.

* **Provenance rides the manifest.**  ``job_meta()`` is stored under
  the checkpoint manifest's ``"job"`` key.  The identity fields that
  must never drift across a resume are enforced individually by the
  driver's ``refuse_meta_drift`` check.

* **Ensembles** (``seeds``): member m runs as if ``state_seed=seeds[m]``,
  every member through the one sim function; jobs that differ only in
  seeds share it through a common ``sim_cache``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from ..obs.telemetry import NULL, Telemetry

LAWS = ("gaussian", "exponential")


class JobError(RuntimeError):
    """A job spec that cannot be built/run as submitted (bad resume
    target, occupied checkpoint directory, ...)."""


@dataclasses.dataclass(frozen=True)
class SimJobSpec:
    """Everything that defines one simulation job.

    ``seed`` realizes the synapse tables; ``state_seed`` (default:
    follows ``seed``) the initial membrane state and per-step noise;
    ``seeds`` runs an ensemble of members, member m initialized as if
    ``state_seed=seeds[m]``, all sharing the one table realization.
    """

    ckpt_dir: str
    grid: int = 8
    n_per_column: int = 60
    law: str = "gaussian"
    seed: int = 0
    state_seed: Optional[int] = None
    seeds: Optional[Tuple[int, ...]] = None
    t_steps: int = 300
    segment_steps: int = 50
    tiles: Optional[Tuple[int, int]] = None
    ckpt_every: int = 1
    keep: int = 3
    record: bool = False
    record_cap: Optional[int] = None
    plastic: bool = False
    stdp: Optional[Dict[str, float]] = None
    resume: bool = False
    retile: bool = False
    preempt_after: Optional[int] = None

    def __post_init__(self):
        if self.law not in LAWS:
            raise ValueError(f"law={self.law!r}: expected one of {LAWS}")
        for name in ("grid", "n_per_column", "t_steps", "segment_steps",
                     "ckpt_every", "keep"):
            v = getattr(self, name)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"{name}={v!r} must be a positive int")
        if not self.ckpt_dir:
            raise ValueError("ckpt_dir must be a non-empty path")
        if self.seeds is not None:
            seeds = tuple(int(s) for s in self.seeds)
            if not seeds:
                raise ValueError("seeds=() -- an ensemble needs >= 1 "
                                 "member; use seeds=None for a solo run")
            object.__setattr__(self, "seeds", seeds)
            if self.state_seed is not None:
                raise ValueError("state_seed and seeds are mutually "
                                 "exclusive (member m's state seed IS "
                                 "seeds[m])")
        if self.tiles is not None:
            ty, tx = self.tiles
            object.__setattr__(self, "tiles", (int(ty), int(tx)))
        if self.stdp is not None:
            object.__setattr__(
                self, "stdp", {str(k): float(v)
                               for k, v in self.stdp.items()})
            if not self.plastic:
                raise ValueError("stdp overrides given without plastic="
                                 "True")

    @property
    def n_members(self) -> Optional[int]:
        return None if self.seeds is None else len(self.seeds)

    # ---- wire format --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SimJobSpec":
        payload = json.loads(text)
        if not isinstance(payload, dict):
            raise ValueError(f"job spec must be a JSON object, got "
                             f"{type(payload).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(payload) - known)
        if unknown:
            raise ValueError(f"unknown job spec fields: {unknown}; "
                             f"known: {sorted(known)}")
        for key in ("seeds", "tiles"):
            if payload.get(key) is not None:
                payload[key] = tuple(payload[key])
        return cls(**payload)

    def job_meta(self) -> dict:
        """JSON-safe dict for the checkpoint manifest's ``job`` key."""
        return json.loads(self.to_json())


def dist_config_for(spec: SimJobSpec, tiles: Tuple[int, int]):
    """The engine-facing config a spec denotes on a concrete tiling."""
    from ..configs.snn import reduced_case
    from ..core.dist_engine import DistConfig
    from ..core.engine import EngineConfig
    from ..core.grid import ColumnGrid, TileDecomposition

    case = reduced_case(spec.law, grid=spec.grid,
                        n_per_column=spec.n_per_column)
    law = case.connectivity()
    dec = TileDecomposition(
        grid=ColumnGrid(*case.grid, case.n_per_column),
        tiles_y=tiles[0], tiles_x=tiles[1], radius=law.radius)
    stdp = None
    if spec.plastic:
        from ..core.stdp import STDPParams
        stdp = STDPParams(**(spec.stdp or {}))
    return DistConfig(
        engine=EngineConfig(decomp=dec, law=law, seed=spec.seed,
                            state_seed=spec.state_seed, stdp=stdp),
        ensemble_seeds=spec.seeds)


def build_sim_driver(spec: SimJobSpec, device="cuda",
                     telemetry: Telemetry = NULL,
                     sim_cache: Optional[dict] = None, mesh=None,
                     transport="gloo"):
    """Construct the :class:`~repro_torch.runtime.SimDriver` a spec
    denotes, every tile on ``device``; the tiling is ``spec.tiles``
    (default 1x1: the port stacks every tile on one device, where the
    reference defaulted to the host mesh).  With ``mesh`` (a
    ``launch.mesh.RankMesh``, every rank calls this) the tiling is the
    mesh's ``("data", "model")`` shape, one tile a rank, its strips
    moved by ``transport``; ``spec.tiles``, when given, must be that
    shape.  Pass the same ``sim_cache`` dict across calls to share sim
    functions between jobs that differ only in seeds (see
    ``sim_fingerprint``).

    Raises :class:`JobError` for specs that must not run: a fresh job
    aimed at an occupied checkpoint directory, or ``resume=True`` with
    nothing to resume.
    """
    from ..checkpoint.store import latest_step
    from .driver import DriverConfig
    from .sim_driver import SimDriver

    tiles = spec.tiles or (1, 1)
    if mesh is not None:
        tiles = (mesh.axis_size("data"), mesh.axis_size("model"))
        if spec.tiles is not None and tuple(spec.tiles) != tiles:
            raise JobError(f"tiles={spec.tiles} but the rank mesh holds "
                           f"{tiles[0]}x{tiles[1]} tiles")
    last = latest_step(spec.ckpt_dir)
    if last is not None and not spec.resume:
        raise JobError(
            f"{spec.ckpt_dir} already holds a checkpoint at sim step "
            f"{last}; set resume=true to continue it or use a fresh "
            "ckpt_dir")
    if spec.resume and last is None:
        # a silent fresh start here would restart a multi-hour job from
        # step 0 while reporting success
        raise JobError(f"resume: no checkpoint found in {spec.ckpt_dir}")
    return SimDriver(
        DriverConfig(ckpt_dir=spec.ckpt_dir, ckpt_every=spec.ckpt_every,
                     keep=spec.keep),
        dist_config_for(spec, tiles), device,
        segment_steps=spec.segment_steps,
        allow_retile=spec.retile,
        preempt_after_segments=spec.preempt_after,
        record_events=spec.record,
        record_capacity=spec.record_cap,
        telemetry=telemetry,
        sim_cache=sim_cache,
        job_meta=spec.job_meta(),
        mesh=mesh, transport=transport)
