"""whisper-small [audio] -- encoder-decoder with a stub conv frontend.

12L d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865
[arXiv:2212.04356].  The same configuration as
``repro.configs.whisper_small``: 12 encoder layers over 1500
precomputed frame embeddings (30 s of audio), cross-attention in every
decoder layer, no rope (sinusoidal absolute positions).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865, use_rope=False, mlp_act="gelu",
    encoder_layers=12, encoder_seq=1500, cross_attn=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced", family="audio",
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=512, use_rope=False, mlp_act="gelu",
        encoder_layers=2, encoder_seq=12, cross_attn=True,
        dtype="float32", attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
    )
