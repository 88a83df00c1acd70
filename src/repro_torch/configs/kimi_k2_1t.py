"""kimi-k2-1t-a32b [moe] -- trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840,
MoE 384 experts top-8 [arXiv:2501.kimi2; unverified].

GQA 64H/kv=8 (not Kimi's MLA), as the reference configures it; head_dim
112.  Total params ~1.04e12, active ~30e9/token: its full width needs
more than one card, so one card runs ``reduced()``.  The same
configuration as ``repro.configs.kimi_k2_1t``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, n_experts=384, moe_top_k=8, head_dim=112,
    rope_theta=5e4,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b-reduced", family="moe",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=32,
        vocab_size=512, n_experts=8, moe_top_k=2, head_dim=8,
        capacity_factor=2.0, dtype="float32",
        attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
