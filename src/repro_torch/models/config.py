"""Model configuration of the LM stack (a copy of ``repro.models.config``).

``ModelConfig``, ``ShapeConfig`` and ``SHAPES`` as the JAX package defines
them, so that the port reads the same configurations without importing
it.  Every field is kept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None    # sliding-window width (local attn)
    use_rope: bool = True

    # mlp
    mlp_act: str = "silu"           # swiglu ("silu") | geglu ("gelu")

    # norm / embedding
    rms_offset: bool = False        # gemma-style (1 + w) rmsnorm scale
    embed_scale: bool = False       # gemma: inputs *= sqrt(d_model)
    tie_embeddings: bool = True

    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm (mamba1)
    ssm_state: int = 16
    d_inner_mult: int = 2
    conv_k: int = 4
    dt_rank: Optional[int] = None   # default ceil(d_model / 16)

    # hybrid layer pattern, cycled over n_layers ("attn" | "rglru" | "mamba")
    pattern: Tuple[str, ...] = ("attn",)
    rglru_width: Optional[int] = None    # default d_model

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0            # stub frontend frames (whisper: 1500)
    cross_attn: bool = False

    # vlm (internvl)
    n_patches: int = 0              # stub patch-embedding count

    # numerics / implementation
    dtype: str = "bfloat16"
    vocab_pad_to: int = 256
    attn_impl: str = "chunked"      # chunked | pallas | naive
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    remat: bool = True
    loss_chunk: int = 1024
    scan_layers: bool = True
    mamba_chunk: int = 128

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def resolved_rglru_width(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer block kind for all n_layers (pattern cycled)."""
        p = self.pattern
        base = "moe" if self.is_moe else None
        kinds = tuple(p[i % len(p)] for i in range(self.n_layers))
        if base == "moe":
            kinds = tuple("moe" if k == "attn" else k for k in kinds)
        return kinds

    @property
    def pattern_periods(self) -> Tuple[int, int]:
        """(full periods to scan, remainder layers unrolled)."""
        per = len(self.pattern)
        return self.n_layers // per, self.n_layers % per

    def param_count(self) -> int:
        """Exact parameter count (used by roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        h, kv = self.n_heads, self.n_kv_heads
        attn = d * hd * (h + 2 * kv) + h * hd * d
        if self.qkv_bias:
            attn += hd * (h + 2 * kv)
        if self.qk_norm:
            attn += 2 * hd
        dense_mlp = 3 * d * self.d_ff
        moe_mlp = (3 * d * self.d_ff * self.n_experts
                   + d * self.n_experts) if self.is_moe else 0
        mamba = 0
        if "mamba" in self.pattern:
            di, n, r = self.d_inner, self.ssm_state, self.resolved_dt_rank
            mamba = (d * 2 * di + di * self.conv_k + di * (r + 2 * n)
                     + r * di + di * n + di + di * d)
        rglru = 0
        if "rglru" in self.pattern:
            w = self.resolved_rglru_width
            rglru = 2 * d * w + 2 * w * self.conv_k + 2 * w * w // 1 \
                + 2 * w + w * d  # in-proj x2, conv, gates, Lambda, out
        total = 0
        for kind in self.layer_kinds:
            total += 2 * d  # pre-norms
            if kind == "attn":
                total += attn + dense_mlp
            elif kind == "moe":
                total += attn + moe_mlp
            elif kind == "mamba":
                total += mamba
            elif kind == "rglru":
                total += rglru + dense_mlp
        total += v * d              # embedding (+ tied head)
        if not self.tie_embeddings:
            total += v * d
        total += d                  # final norm
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_mlp + 2 * d)
            if self.cross_attn:
                total += self.n_layers * (attn + d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        inactive = (self.n_experts - self.moe_top_k) * 3 * d * self.d_ff
        return int(self.param_count() - self.n_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
