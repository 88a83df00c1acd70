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
batch (``host_shard_slice``).  On ranks, ``make_batch_specs`` names the
batch dim's mesh axes and ``rank_batch`` cuts a batch to one rank's
slice along them.
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


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules):
    """The port's ``PartitionSpec`` (a tuple of mesh axes) of every
    input of a shape cell: the batch dim on the ``batch`` axes, the
    rest whole."""
    from ..models.model import input_specs
    specs = input_specs(cfg, shape)
    return {k: rules.pspec("batch", *([None] * (v.dim() - 1)))
            for k, v in specs.items()}


def rank_batch(batch: Dict, rules) -> Dict:
    """This rank's slice of ``batch`` (numpy arrays or tensors, batch
    first) along the ``batch`` axes of ``rules`` (pod-major for
    ``("pod", "data")``); raises when the batch does not divide (the
    dry run's ``_batch_rules`` replicates such a batch)."""
    import torch
    from ..parallel.sharding import block
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        out[k] = block(t, ("batch",) + (None,) * (t.dim() - 1), rules)
    return out
