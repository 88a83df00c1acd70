"""Deterministic synthetic data pipelines (the port of ``repro.data``)."""

from .pipeline import LMBatchPipeline, host_shard_slice

__all__ = ["LMBatchPipeline", "host_shard_slice"]
