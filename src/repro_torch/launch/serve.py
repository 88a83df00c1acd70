"""LM batch serving on one card: a batched prefill, then greedy decode
(the port of ``repro.launch.serve.serve_batch``).

    from repro_torch.launch.serve import serve_batch
    out = serve_batch("qwen2-1.5b", batch=4, prompt_len=32, gen=16)

Like the reference it serves the architecture's reduced configuration.
The reference's simulation job server (``--arch sim``) and its CLI are
not ported yet (ROADMAP.md, item 8).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_reduced
from ..models.model import make_prefill, make_serve_step
from ..models.transformer import init_decode_state, init_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_batch(arch: str, batch: int, prompt_len: int, gen: int,
                seed: int = 0, greedy: bool = True, device="cuda") -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (numpy
    ``default_rng(seed)``, as the reference draws them), then decode
    ``gen`` tokens greedily.  Parameters come from ``init_model`` seeded
    with ``seed``.  Returns ``tokens`` ((batch, gen) int32 numpy),
    ``prefill_s``, ``decode_s_per_token`` (host clock, CUDA-synchronised)
    and ``config`` (the config's name)."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is implemented "
                                  "(the reference decodes greedily too)")
    dev = resolve_device(device)
    cfg = get_reduced(arch)
    params = init_model(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    state = init_decode_state(cfg, batch, prompt_len + gen, device=dev)
    prefill = make_prefill(cfg)
    serve_step = make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(params, {"tokens": tokens}, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(gen):
        toks.append(tok)
        logits, state = serve_step(params, state, tok, prompt_len + i)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = (torch.cat(toks, dim=1).cpu().numpy() if toks
           else np.zeros((batch, 0), np.int32))
    return {
        "tokens": out,
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / gen if gen else 0.0,
        "config": cfg.name,
    }
