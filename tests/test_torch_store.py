"""Port parity: the checkpoint store (``repro_torch.checkpoint.store``).

Each contract of the reference's checkpoint tests
(``tests/test_optim_data_ckpt.py``: round trip and keep-k, corruption,
dtype drift, structure mismatch, the async writer and its snapshot)
holds in the port; a numpy tree saved by either package gives the same
leaf files and digests and restores in the other; bfloat16 leaves go
to disk as their raw bits.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint.store import (AsyncCheckpointer, LeafSpec,
                                          checkpoint_meta, latest_step,
                                          refuse_meta_drift,
                                          restore_checkpoint,
                                          save_checkpoint,
                                          set_thread_asserts)
from repro_torch.tree import tree_flatten, tree_unflatten


def _tree(rng):
    return {"a": torch.tensor(rng.normal(size=(4, 5)), dtype=torch.float32),
            "b": [torch.arange(3), {"c": torch.tensor(2.5)}],
            "t": np.arange(6, dtype=np.int32).reshape(2, 3),
            "none": None, "flag": torch.tensor([True, False])}


def _assert_tree_equal(x, y):
    lx, dx = tree_flatten(x)
    ly, dy = tree_flatten(y)
    assert dx == dy
    for a, b in zip(lx, ly):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_roundtrip_and_gc(tmp_path, rng):
    tree = _tree(rng)
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        save_checkpoint(d, step, tree, keep=2)
    assert latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    _assert_tree_equal(tree, restore_checkpoint(d, 4, tree, "cpu"))


def test_tree_flatten_orders_dict_keys_as_the_reference():
    tree = {"z": 1, "a": [2, (3, None, 4)], "m": {"y": 5, "b": 6}}
    leaves, treedef = tree_flatten(tree)
    assert leaves == [2, 3, 4, 6, 5, 1]
    assert tree_unflatten(treedef, leaves) == tree


def test_checkpoint_detects_corruption(tmp_path, rng):
    tree = {"a": torch.tensor(rng.normal(size=(64,)), dtype=torch.float32)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    fn = os.path.join(path, "leaf_00000.npy")
    blob = bytearray(open(fn, "rb").read())
    blob[-1] ^= 0xFF
    open(fn, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 1, tree, device="cpu")


def test_checkpoint_rejects_dtype_drift(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(str(tmp_path), 1,
                           {"a": LeafSpec((4,), torch.float16)}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1,
                           {"a": LeafSpec((5,), torch.float32)}, "cpu")
    out = restore_checkpoint(str(tmp_path), 1,
                             {"a": LeafSpec((4,), "float32")}, "cpu")
    assert out["a"].dtype == torch.float32


def test_checkpoint_structure_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3),
                                              "b": torch.zeros(2)}, "cpu")


def test_bfloat16_leaf_is_stored_as_raw_bits(tmp_path):
    """numpy has no bfloat16 here: the leaf is written as its uint16
    bits with "bfloat16" in the manifest, and restored exactly."""
    w = torch.tensor([1.0, -2.5, 3.140625, 1e-30, float("inf")],
                     dtype=torch.bfloat16)
    path = save_checkpoint(str(tmp_path), 3, {"w": w})
    with open(os.path.join(path, "manifest.json")) as f:
        leaf = json.load(f)["leaves"][0]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [5]
    raw = np.load(os.path.join(path, leaf["file"]))
    assert raw.dtype == np.uint16
    assert np.array_equal(raw, w.view(torch.int16).numpy().view(np.uint16))
    out = restore_checkpoint(str(tmp_path), 3,
                             {"w": LeafSpec((5,), torch.bfloat16)},
                             "cpu")["w"]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), w.view(torch.int16))
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(str(tmp_path), 3,
                           {"w": LeafSpec((5,), torch.int16)}, "cpu")


def test_checkpoints_cross_between_packages(tmp_path, rng):
    """The same numpy tree saved by both packages: identical leaf files
    and digests; each package restores the other's checkpoint."""
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "n": [np.arange(5, dtype=np.int32),
                  np.asarray([True, False])]}
    pj = jstore.save_checkpoint(str(tmp_path / "jax"), 7, tree,
                                meta={"k": 1})
    pt = save_checkpoint(str(tmp_path / "torch"), 7, tree, meta={"k": 1})
    mj = json.load(open(os.path.join(pj, "manifest.json")))
    mt = json.load(open(os.path.join(pt, "manifest.json")))
    assert mj["leaves"] == mt["leaves"] and mj["meta"] == mt["meta"]
    for leaf in mj["leaves"]:
        assert open(os.path.join(pj, leaf["file"]), "rb").read() == \
            open(os.path.join(pt, leaf["file"]), "rb").read()
    back = restore_checkpoint(str(tmp_path / "jax"), 7, tree, "cpu")
    _assert_tree_equal(tree, back)
    for a, b in zip(jstore.restore_checkpoint(str(tmp_path / "torch"), 7,
                                              tree)["n"], tree["n"]):
        assert np.array_equal(a, b)
    assert checkpoint_meta(str(tmp_path / "jax"), 7) == {"k": 1}


def test_refuse_meta_drift():
    refuse_meta_drift({"grid": [4, 4, 10]}, {"grid": [4, 4, 10],
                                             "seed": 1}, ("grid", "seed"),
                      "here")
    with pytest.raises(ValueError, match="seed=0"):
        refuse_meta_drift({"seed": 0}, {"seed": 1}, ("seed",), "here")


def test_async_checkpointer(tmp_path, rng):
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    tree = {"w": torch.tensor(rng.normal(size=(8,)), dtype=torch.float32)}
    for s in (10, 20):
        ck.save(s, tree, meta={"s": s})
    ck.close()
    assert latest_step(str(tmp_path)) == 20
    assert checkpoint_meta(str(tmp_path), 10) == {"s": 10}


def test_async_checkpointer_snapshot_immutable(tmp_path, rng):
    """``save`` snapshots and returns; the caller may overwrite the live
    tensors in place at once (the port's counterpart of donating them to
    the next segment).  The checkpoint holds the values at save time."""
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    t0 = np.arange(4, dtype=np.int32)
    tree = {"w": torch.from_numpy(w0.copy()), "t": t0.copy()}
    ck.save(1, tree)
    tree["w"].mul_(0).sub_(1.0)
    tree["t"][:] = -7
    ck.close()
    out = restore_checkpoint(str(tmp_path), 1, tree, device="cpu")
    assert np.array_equal(out["w"].numpy(), w0)
    assert np.array_equal(out["t"], t0)
    assert torch.equal(tree["w"], torch.full((64,), -1.0))


def test_async_writer_surfaces_errors_and_thread_asserts(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker), keep=1)
    ck.save(1, {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        ck.wait()
    ck2 = AsyncCheckpointer(str(tmp_path / "ok"))
    errors = []

    def other():
        try:
            ck2.save(1, {"a": torch.zeros(1)})
        except AssertionError as e:
            errors.append(e)

    set_thread_asserts(True)
    try:
        th = threading.Thread(target=other)
        th.start()
        th.join()
    finally:
        set_thread_asserts(False)
    ck2.close()
    assert errors and "owned by" in str(errors[0])
