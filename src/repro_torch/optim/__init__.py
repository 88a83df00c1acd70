"""Optimizers and learning-rate schedules of the port (the port of
``repro.optim``, without the pod-axis gradient compression)."""

from .optimizers import Optimizer, adafactor, adamw, global_norm
from .schedules import constant, warmup_cosine, warmup_rsqrt

__all__ = ["Optimizer", "adafactor", "adamw", "constant", "global_norm",
           "warmup_cosine", "warmup_rsqrt"]
