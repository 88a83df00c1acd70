"""falcon-mamba-7b [ssm] -- attention-free mamba1 architecture.

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16
[arXiv:2410.05355; unverified].  d_inner = 2*d = 8192, conv_k = 4,
dt_rank = ceil(d/16) = 256.  Sub-quadratic -> runs the long_500k cell.
The same configuration as ``repro.configs.falcon_mamba_7b``.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=65024, pattern=("mamba",), ssm_state=16,
    d_inner_mult=2, conv_k=4, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-reduced", family="ssm",
        n_layers=4, d_model=48, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=512, pattern=("mamba",), ssm_state=4, conv_k=4,
        dtype="float32", loss_chunk=32, mamba_chunk=16,
    )
