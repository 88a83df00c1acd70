"""The port's synthetic data pipeline against the reference's
(``repro.data.pipeline``): batches equal array for array (dtype, shape
and bytes) for several seeds, steps, shapes and hosts, the stub
frontends' inputs included."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import LMBatchPipeline as JPipeline
from repro.data.pipeline import host_shard_slice as jhost_shard_slice
from repro.models.config import ShapeConfig as JShape
from repro.models.frontends import STUB_WIDTH as J_STUB_WIDTH
from repro_torch.data import pipeline as tpipe
from repro_torch.models.config import ModelConfig, ShapeConfig


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-8b",
                                  "internvl2-26b", "whisper-small"])
@pytest.mark.parametrize("kind,seq,batch", [("train", 33, 4),
                                            ("prefill", 20, 2),
                                            ("decode", 64, 3)])
def test_batches_equal_the_reference(arch, kind, seq, batch):
    jcfg = jget_reduced(arch)
    if jcfg.n_patches:
        seq = max(seq, jcfg.n_patches + 4)
    for seed, step, hosts, host in ((0, 0, 1, 0), (3, 7, 1, 0),
                                    (11, 250, 2, 1), (5, 12345, 2, 0)):
        ref = JPipeline(jcfg, JShape("c", seq, batch * hosts, kind),
                        seed=seed, host_id=host, n_hosts=hosts).batch(step)
        got = tpipe.LMBatchPipeline(
            _port_cfg(jcfg), ShapeConfig("c", seq, batch * hosts, kind),
            seed=seed, host_id=host, n_hosts=hosts).batch(step)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and \
                got[k].shape == ref[k].shape, k
            assert got[k].tobytes() == ref[k].tobytes(), (k, seed, step)


def test_labels_are_the_shifted_tokens():
    cfg = _port_cfg(jget_reduced("qwen2-1.5b"))
    b = tpipe.LMBatchPipeline(cfg, ShapeConfig("t", 16, 2, "train"),
                              seed=1).batch(3)
    again = tpipe.LMBatchPipeline(cfg, ShapeConfig("t", 16, 2, "train"),
                                  seed=1).batch(3)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert all(np.array_equal(b[k], again[k]) for k in b)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < cfg.vocab_size


def test_host_slices_and_stub_width():
    assert tpipe.STUB_WIDTH == J_STUB_WIDTH
    for gb, n in ((8, 1), (8, 2), (12, 4)):
        for h in range(n):
            assert tpipe.host_shard_slice(gb, h, n) == \
                jhost_shard_slice(gb, h, n)
