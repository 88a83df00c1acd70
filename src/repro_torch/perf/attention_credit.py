"""The flash kernel's memory credit (the port of
``repro.perf.attention_credit``).

The dry run traces attention in its plain chunked form
(``attn_impl="chunked"``), whose float32 (cq, ck) score and probability
chunks go through device memory, and ``perf.op_analysis`` counts that
traffic.  The flash kernel keeps them on chip, so this module computes
those chunks' bytes for the roofline's ``memory_s_flash``.

``chunk_traffic_bytes`` keeps the reference's formula and defaults
(its per-device share on a 256-chip mesh, four forward passes, plus
eight backward and four recompute passes to train): the reference's
backward is a Pallas kernel too.  The port's is not: its training
backward is plain chunked PyTorch (``models.attention._flash_bwd``), so
only the forward's chunks stay on chip, once to serve and twice to
train (the forward and its per-layer recompute).  ``flash_credit_bytes``
gives that credit from the same pieces (``chunk_pass_bytes``), which
the dry run subtracts.
"""

from __future__ import annotations

from ..models.attention import _live
from ..models.config import ModelConfig, ShapeConfig

FORWARD_PASSES = 4          # s and p, each written and read once


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds if k in ("attn", "moe")) + \
        cfg.encoder_layers + (cfg.n_layers if cfg.cross_attn else 0)


def chunk_pass_bytes(cfg: ModelConfig, shape: ShapeConfig,
                     chips: int = 256, model_axis: int = 16,
                     microbatches: int = 1) -> float:
    """Bytes of one pass over every live float32 (cq, ck) chunk of every
    attention layer, per device (the reference's liveness estimate:
    half the pairs causal, three a row under a window)."""
    if shape.is_decode:
        return 0.0                       # decode path has no chunk loop
    s = shape.seq_len
    s_k_eff = min(cfg.window * 2, s) if cfg.window else s
    cq = min(cfg.attn_chunk_q, s)
    ck = min(cfg.attn_chunk_k, s)
    nq = -(-s // cq)
    nk = -(-s_k_eff // ck)
    live_pairs = nq * nk / 2 if not cfg.window else nq * min(nk, 3)

    b_local = max(shape.global_batch // (chips // model_axis), 1)
    b_local = max(b_local // microbatches, 1)
    heads_sharded = cfg.n_heads % model_axis == 0
    h_local = cfg.n_heads // model_axis if heads_sharded else cfg.n_heads
    chunk_bytes = cq * ck * 4.0              # one f32 (cq, ck) tensor
    per_layer = live_pairs * b_local * h_local * chunk_bytes
    return per_layer * _attn_layers(cfg) * microbatches


def chunk_traffic_bytes(cfg: ModelConfig, shape: ShapeConfig,
                        chips: int = 256, model_axis: int = 16,
                        microbatches: int = 1) -> float:
    """The reference's per-device credit: forward s + p (4 passes);
    training adds the backward's s, p, dp, ds (8) and the recompute (4)."""
    passes = FORWARD_PASSES + (8 + 4 if shape.kind == "train" else 0)
    return chunk_pass_bytes(cfg, shape, chips, model_axis,
                            microbatches) * passes


def flash_credit_bytes(cfg: ModelConfig, shape: ShapeConfig,
                       microbatches: int = 1, chips: int = 1,
                       model_axis: int = 1) -> float:
    """The port's credit on one card (or one of ``chips`` ranks with
    ``model_axis`` on the model axis): the forward's passes only, twice
    to train (the per-layer recompute runs the flash forward again); the
    plain chunked backward's chunks stay in device memory."""
    passes = FORWARD_PASSES * (2 if shape.kind == "train" else 1)
    return chunk_pass_bytes(cfg, shape, chips=chips, model_axis=model_axis,
                            microbatches=microbatches) * passes


def live_chunk_pairs(seq_q: int, seq_k: int, chunk_q: int, chunk_k: int,
                     causal: bool = True, window=None,
                     q_offset: int = 0) -> int:
    """The (q chunk, k chunk) pairs the chunked forward computes, by the
    same liveness test (``models.attention._live``), keys padded to whole
    chunks."""
    cq, ck = min(chunk_q, seq_q), min(chunk_k, seq_k)
    n = 0
    for qi in range(-(-seq_q // cq)):
        q_first = q_offset + qi * cq
        for ki in range(-(-seq_k // ck)):
            n += _live(q_first, q_first + cq - 1, ki * ck,
                       (ki + 1) * ck - 1, seq_k, causal, window)
    return n
