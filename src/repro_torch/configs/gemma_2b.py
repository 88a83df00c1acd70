"""gemma-2b [dense] -- MQA, GeGLU, head_dim 256, scaled embeddings.

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000
[arXiv:2403.08295; hf].  The same configuration as
``repro.configs.gemma_2b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256, mlp_act="gelu",
    rms_offset=True, embed_scale=True, rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced", family="dense",
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=512, head_dim=16, mlp_act="gelu", rms_offset=True,
        embed_scale=True, dtype="float32",
        attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
