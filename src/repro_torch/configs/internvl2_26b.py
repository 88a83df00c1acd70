"""internvl2-26b [vlm] -- InternViT + InternLM2 backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf].  The same configuration as
``repro.configs.internvl2_26b``: the ViT tower is a stub, and 256
precomputed patch embeddings (448 px, patch 14, pixel-unshuffled) go
through a learned adapter and prefix the token sequence.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, head_dim=128, n_patches=256, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-reduced", family="vlm",
        n_layers=3, d_model=48, n_heads=6, n_kv_heads=2, d_ff=96,
        vocab_size=512, head_dim=8, n_patches=8, dtype="float32",
        attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
