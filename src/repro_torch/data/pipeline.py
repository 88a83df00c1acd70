"""Deterministic synthetic token / frame / patch pipeline, the port of
``repro.data.pipeline`` (numpy only): byte for byte the reference's
batches.

Stateless, counter-based generation: batch ``i`` is a pure function of
(seed, step), so restarts reproduce the exact stream without data-state
checkpointing -- the restore path only needs the step counter.  Tokens
follow a Zipf-ish marginal plus a bigram structure so losses actually
decrease during the example runs (pure uniform tokens give a flat loss
at ln(V)).

Multi-host sharding: each host materializes only its slice of the global
batch (``host_shard_slice``); one card is one host.  The reference's
``make_batch_specs`` needs a mesh and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..models.config import ModelConfig, ShapeConfig
from ..models.frontends import STUB_WIDTH


def host_shard_slice(global_batch: int, host_id: int, n_hosts: int):
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


@dataclasses.dataclass
class LMBatchPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def _tokens(self, rng, b: int, s: int) -> np.ndarray:
        v = self.cfg.vocab_size
        # zipf marginal folded into vocab + deterministic bigram drift:
        # next ~ (prev * 31 + zipf) % V on half the positions
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % v
        toks = base.copy()
        mix = rng.random((b, s)) < 0.5
        toks[:, 1:] = np.where(mix[:, 1:],
                               (toks[:, :-1] * 31 + base[:, 1:]) % v,
                               base[:, 1:])
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The numpy arrays of batch ``step``: ``tokens`` and, for a
        train shape, ``labels`` (the tokens shifted by one); ``token``
        (B, 1) for a decode shape; the stub frontends' ``patch_embeds``
        / ``frames`` where the family has them."""
        rng = self._rng(step)
        b = self.shape.global_batch // self.n_hosts
        cfg, shape = self.cfg, self.shape

        if shape.kind == "decode":
            return {"token": self._tokens(rng, b, 1)}

        s = shape.seq_len
        out: Dict[str, np.ndarray] = {}
        if cfg.n_patches:
            out["patch_embeds"] = rng.standard_normal(
                (b, cfg.n_patches, STUB_WIDTH)).astype(np.float32)
            s = s - cfg.n_patches
        if cfg.encoder_seq:
            out["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq, STUB_WIDTH)).astype(np.float32)
        toks = self._tokens(rng, b, s + 1)
        out["tokens"] = toks[:, :-1]
        if shape.kind == "train":
            out["labels"] = toks[:, 1:].astype(np.int32)
        return out
