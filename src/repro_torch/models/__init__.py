"""The LM stack of the port: dense GQA transformers (qwen2, qwen2.5,
qwen3, gemma), served by batched prefill and greedy decode, and trained
(the chunked loss, train and eval steps)."""

from .config import ModelConfig, ShapeConfig, SHAPES
from .model import (lm_logits, loss_fn, make_eval_step, make_prefill,
                    make_serve_step, make_train_step)
from .transformer import forward, init_decode_state, init_model
