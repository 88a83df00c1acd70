"""The LM stack of the port: dense GQA transformers (qwen2, gemma),
served by batched prefill and greedy decode."""

from .config import ModelConfig, ShapeConfig, SHAPES
from .model import lm_logits, make_prefill, make_serve_step
from .transformer import forward, init_decode_state, init_model
