"""Optimizers, learning-rate schedules and the pod-axis gradient
compression of the port (the port of ``repro.optim``)."""

from .compression import (CompressedAllReduce, int8_dequantize,
                          int8_quantize)
from .optimizers import Optimizer, adafactor, adamw, global_norm
from .schedules import constant, warmup_cosine, warmup_rsqrt

__all__ = ["CompressedAllReduce", "Optimizer", "adafactor", "adamw",
           "constant", "global_norm", "int8_dequantize", "int8_quantize",
           "warmup_cosine", "warmup_rsqrt"]
