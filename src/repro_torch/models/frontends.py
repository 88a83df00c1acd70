"""Modality frontends (the port of ``repro.models.frontends``): stubs, as
in the reference.

Whisper's conv tower and InternVL's ViT tower are out of scope: the
batch carries precomputed frame or patch embeddings of width
``STUB_WIDTH``, and each stub is a learned linear adapter from that width
to ``d_model`` (the audio one adds sinusoidal positions).
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import gather_dim
from .config import ModelConfig
from .layers import _normal, sinusoidal_positions

# width of the precomputed embeddings the data feeds (a copy of
# ``repro.models.frontends.STUB_WIDTH``)
STUB_WIDTH = 256


def init_frontend(gen, cfg: ModelConfig, dtype) -> dict:
    return {"adapter": _normal(gen, (STUB_WIDTH, cfg.d_model),
                               1 / math.sqrt(STUB_WIDTH), dtype)}


def _adapt(p, x, rules=None):
    """``x @ adapter`` in the wider of the two dtypes, as the reference's
    product promotes them (float32 embeddings into a bf16 model).  On
    ranks the adapter's ``(None, "fsdp")`` block is gathered whole."""
    w = gather_dim(p["adapter"], rules, "fsdp", 1)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def apply_audio_frontend(p, frames, rules=None):
    """frames: (B, n_frames, STUB_WIDTH) precomputed conv features."""
    x = _adapt(p, frames, rules)
    pos = sinusoidal_positions(frames.shape[1], x.shape[-1],
                               device=x.device).to(x.dtype)
    return x + pos[None]


def apply_patch_frontend(p, patches, rules=None):
    """patches: (B, n_patches, STUB_WIDTH) precomputed ViT patch embeds."""
    return _adapt(p, patches, rules)
