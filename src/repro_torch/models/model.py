"""Public serving API of the LM stack (the port of the serving half of
``repro.models.model``): ``make_prefill``, ``make_serve_step`` and
``lm_logits``.  The loss and the train steps come with training.

The reference's functions take sharding ``rules``; one card has none,
so these take the config alone.  Nothing is jitted: the returned
functions run eagerly.
"""

from __future__ import annotations

from .config import ModelConfig
from .transformer import forward, logits as lm_logits


def make_prefill(cfg: ModelConfig):
    """prefill(params, batch, state) -> (last-position logits (B, 1, V),
    state).

    Runs the full forward on the prompt while writing the KV caches, so
    decode continues from ``pos = prompt_len``."""

    def prefill(params, batch, state):
        x, new_state = forward(params, cfg, batch, state=state, cache_pos=0)
        return lm_logits(params, x[:, -1:, :]), new_state

    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, state, token, pos) -> (logits (B, 1, V), state).

    One decode step: ``token`` (B, 1) at position ``pos`` (an int) given
    caches filled up to ``pos``."""

    def serve_step(params, state, token, pos: int):
        x, new_state = forward(params, cfg, {"tokens": token}, state=state,
                               cache_pos=pos)
        return lm_logits(params, x), new_state

    return serve_step
