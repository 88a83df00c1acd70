"""Configurations of the port: the paper's SNN cases (``configs.snn``)
and the ten LM architectures (``get_config``/``get_reduced``), with the
shape cells each runs (``shape_cells``/``all_cells``).
"""

from __future__ import annotations

from ..models.config import SHAPES, ModelConfig
from . import (falcon_mamba_7b, gemma_2b, granite_moe_1b, internvl2_26b,
               kimi_k2_1t, qwen2_1_5b, qwen2_5_3b, qwen3_8b,
               recurrentgemma_9b, snn, whisper_small)

_MODULES = {
    "recurrentgemma-9b": recurrentgemma_9b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "qwen2-1.5b": qwen2_1_5b,
    "qwen3-8b": qwen3_8b,
    "gemma-2b": gemma_2b,
    "qwen2.5-3b": qwen2_5_3b,
    "internvl2-26b": internvl2_26b,
    "whisper-small": whisper_small,
    "granite-moe-1b-a400m": granite_moe_1b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
}

ARCH_NAMES = tuple(_MODULES)

# sub-quadratic archs run the long_500k cell; pure full-attention archs
# skip it
LONG_CONTEXT_ARCHS = ("recurrentgemma-9b", "falcon-mamba-7b")


def _module(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise KeyError(f"unknown architecture {name!r} (known: "
                       f"{', '.join(ARCH_NAMES)})") from None


def get_config(name: str) -> ModelConfig:
    """The published full-width configuration of an architecture."""
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """The reduced (test-size) configuration of an architecture."""
    return _module(name).reduced()


def shape_cells(arch: str):
    """The shape cells an architecture runs (the reference's skips
    applied)."""
    _module(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return [SHAPES[c] for c in cells]


def all_cells():
    """Every (arch, shape) cell of the architectures."""
    for a in ARCH_NAMES:
        for s in shape_cells(a):
            yield a, s
