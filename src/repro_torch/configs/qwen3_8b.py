"""qwen3-8b [dense] -- GQA with per-head qk RMSNorm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
[hf:Qwen/Qwen3-8B; hf].  The same configuration as
``repro.configs.qwen3_8b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-reduced", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16, qk_norm=True, dtype="float32",
        attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
