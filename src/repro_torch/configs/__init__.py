"""Configurations of the port: the paper's SNN cases (``configs.snn``)
and the LM architectures ported so far (``get_config``/``get_reduced``).
"""

from __future__ import annotations

from ..models.config import ModelConfig
from . import gemma_2b, qwen2_1_5b, snn

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "gemma-2b": gemma_2b,
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise KeyError(
            f"architecture {name!r} is not ported yet (ported: "
            f"{', '.join(ARCH_NAMES)}); see ROADMAP.md for the slice "
            "that brings it") from None


def get_config(name: str) -> ModelConfig:
    """The published full-width configuration of a ported architecture."""
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """The reduced (test-size) configuration of a ported architecture."""
    return _module(name).reduced()
