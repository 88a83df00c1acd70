"""recurrentgemma-9b [hybrid] -- RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified].  Griffin block pattern: two RG-LRU
recurrent blocks then one local (sliding-window 2048) attention block;
38 = 12 full periods + 2 remainder recurrent layers.
Sub-quadratic -> runs the long_500k cell.
The same configuration as ``repro.configs.recurrentgemma_9b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, head_dim=256,
    pattern=("rglru", "rglru", "attn"), window=2048,
    mlp_act="gelu", rms_offset=True, embed_scale=True,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=512, head_dim=16, pattern=("rglru", "rglru", "attn"),
        window=16, mlp_act="gelu", rms_offset=True, embed_scale=True,
        dtype="float32", attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
        mamba_chunk=16,
    )
