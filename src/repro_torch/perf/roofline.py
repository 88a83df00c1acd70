"""Roofline terms of a dry-run cell against one H100 SXM (the port of
``repro.perf.roofline``, whose constants are a TPU's):

    compute    = FLOPs / peak FLOP/s        (989.4e12 dense bf16)
    memory     = bytes / HBM rate           (3.35e12 B/s)
    collective = collective bytes / link    (450e9 B/s, NVLink 4)

The FLOPs and bytes are ``perf.op_analysis``'s count of the eager
program of one card or, on a mesh (``launch.dryrun --mesh``), of one
rank; the collective bytes are that rank's ring wire bytes, counted by
``parallel.collectives.DryCollectives`` (0 on one card).  One link rate
serves every collective, as the reference keeps one.  The dominant
term is the bottleneck.  ``model_flops`` (6 N D train / 2 N D prefill /
2 N_active B decode) over the counted matmul FLOPs says how much of the
computed work is useful: the training recompute and the padded or
masked attention chunks show up there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.config import ModelConfig, ShapeConfig
from .op_analysis import Costs


@dataclasses.dataclass(frozen=True)
class HW:
    name: str = "h100-sxm"
    peak_flops: float = 989.4e12        # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12             # B/s, HBM3
    ici_bw: float = 450e9               # B/s per direction, NVLink 4


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs for the cell (6ND / 2ND / 2NB convention)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float                     # per device (the op count's)
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    peak_bytes_per_device: Optional[float] = None
    notes: tuple = ()
    hw: HW = HW()

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound on step time."""
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def useful_frac(self) -> float:
        """MODEL_FLOPS / all counted FLOPs."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline this step achieves: useful
        model FLOPs over (step time x peak), per card, at the peak of the
        ``hw`` the terms were computed for."""
        denom = self.step_time_s * self.chips
        if denom <= 0:
            return 0.0
        return self.model_flops / denom / self.hw.peak_flops

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_time_s=self.step_time_s,
                 useful_frac=self.useful_frac,
                 roofline_frac=self.roofline_frac)
        return d


def roofline_terms(arch: str, shape: str, mesh_name: str, chips: int,
                   costs: Costs, mflops: float,
                   peak_bytes: Optional[float] = None,
                   hw: HW = HW()) -> RooflineReport:
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=costs.flops / hw.peak_flops,
        memory_s=costs.bytes / hw.hbm_bw,
        collective_s=costs.coll_bytes / hw.ici_bw,
        model_flops=mflops,
        hlo_flops=costs.flops, hlo_bytes=costs.bytes,
        coll_bytes=costs.coll_bytes, coll_by_kind=dict(costs.coll_by_kind),
        peak_bytes_per_device=peak_bytes,
        notes=tuple(costs.notes[:8]), hw=hw)
