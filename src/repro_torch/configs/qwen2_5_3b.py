"""qwen2.5-3b [dense] -- GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936
[hf:Qwen/Qwen2.5-0.5B; hf].  The same configuration as
``repro.configs.qwen2_5_3b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-reduced", family="dense",
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=512, qkv_bias=True, dtype="float32",
        attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
