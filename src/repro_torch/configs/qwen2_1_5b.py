"""qwen2-1.5b [dense] -- GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2407.10671; hf].  The same configuration as
``repro.configs.qwen2_1_5b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-reduced", family="dense",
        n_layers=3, d_model=48, n_heads=6, n_kv_heads=2, d_ff=96,
        vocab_size=512, qkv_bias=True, dtype="float32",
        attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
