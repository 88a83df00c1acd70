"""granite-moe-1b-a400m [moe] -- 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
The same configuration as ``repro.configs.granite_moe_1b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155, n_experts=32, moe_top_k=8,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-reduced", family="moe",
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab_size=512, n_experts=4, moe_top_k=2, capacity_factor=2.0,
        dtype="float32", attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
