"""Checkpoint store: atomic save/restore of tensor trees, async writer.

The port of ``repro.checkpoint.store``.  Layout (one directory per
step)::

    <dir>/step_000120/
        manifest.json      # tree structure, shapes, dtypes, sha256s
        leaf_00000.npy ...

Fault-tolerance properties (the reference's):
  * **atomic**: written to ``step_X.tmp-<pid>`` then ``os.rename``d --
    a crash mid-write never corrupts the latest checkpoint;
  * **verified**: every leaf carries a sha256 in the manifest, checked
    on restore (detects torn/bit-rotted files before they poison a run);
  * **keep-k**: old steps garbage-collected after a successful rename;
  * **refusing**: a leaf whose shape or dtype differs from the expected
    one, or a tree with another number of leaves, is refused;
  * **async**: ``AsyncCheckpointer.save`` snapshots the tree on its
    device and returns; the device-to-host copy and the file writes
    happen on a daemon thread.

Trees are nested dicts (keys in sorted order, as the reference
flattens them), lists and tuples; ``None`` is an empty subtree; every
other value is a leaf: a torch tensor or a numpy array.  numpy has no
bfloat16 without ``ml_dtypes``, which the port does not use, so a
bfloat16 tensor is written as its raw ``uint16`` bits with
``"bfloat16"`` as its manifest dtype, and restored as bfloat16 from
those bits.

On a CUDA device the snapshot is a ``clone()`` of each device leaf on
the caller's stream, followed by an event.  The worker waits for that
event on a stream of its own, copies into pinned host memory there and
synchronizes only its own stream: a ``.cpu()`` on the default stream
would queue behind the caller's next segment, and nothing would
overlap.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of an expected leaf (the port's counterpart of
    ``jax.ShapeDtypeStruct``): a ``restore_checkpoint`` ``like`` leaf
    that allocates nothing.  ``dtype``: a torch dtype or its name."""
    shape: Tuple[int, ...]
    dtype: Any


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _treedef_str(d: tuple) -> str:
    kind = d[0]
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_treedef_str(v)}"
                               for k, v in d[1]) + "}"
    if kind in ("list", "tuple"):
        inner = ", ".join(_treedef_str(v) for v in d[1])
        return f"[{inner}]" if kind == "list" else f"({inner})"
    return "None" if kind == "none" else "*"


def _dtype_name(dtype) -> str:
    """One name for a torch dtype, a numpy dtype or a name: ``float32``,
    ``bfloat16``, ``bool``, ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A host leaf as the array written to disk and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), _dtype_name(x.dtype)
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, tree, keep: int = 3,
                    meta: Optional[dict] = None) -> str:
    """``meta``: optional JSON-serializable dict stored inside the
    step's manifest -- atomic with the checkpoint itself (a sidecar
    file could describe a checkpoint that never got published)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, treedef = tree_flatten(tree)
    manifest = {"step": step, "treedef": _treedef_str(treedef),
                "meta": meta or {}, "leaves": []}
    for i, leaf in enumerate(flat):
        arr, dt = _host_array(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({
            "file": fn, "shape": list(arr.shape), "dtype": dt,
            "sha256": _file_digest(os.path.join(tmp, fn)),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                    # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def checkpoint_meta(directory: str, step: int) -> dict:
    """The ``meta`` dict stored with ``save_checkpoint`` (empty for
    checkpoints written without one)."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f).get("meta", {})


def refuse_meta_drift(meta: dict, mine: dict, keys, where: str):
    """Refuse to resume a checkpoint whose manifest meta disagrees with
    the current config on any of ``keys`` (keys absent from ``meta`` are
    skipped: pre-versioning manifests).  Shared by the drivers so every
    identity refusal carries the same actionable message."""
    for key in keys:
        if key in meta and meta[key] != mine[key]:
            raise ValueError(
                f"checkpoint in {where} was written with "
                f"{key}={meta[key]}, current config has "
                f"{key}={mine[key]} -- resuming would silently "
                "continue a different model")


def restore_checkpoint(directory: str, step: int, like, device="cuda",
                       verify: bool = True):
    """Restore into the structure of ``like`` (a tree of tensors, numpy
    arrays or ``LeafSpec``s: only shapes and dtypes are read).  A leaf
    comes back as a numpy array where ``like`` holds one, else as a
    torch tensor on ``device`` (``"cpu"`` for a host tree)."""
    from .. import resolve_device
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like, treedef = tree_flatten(like)
    if len(manifest["leaves"]) != len(flat_like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(flat_like)} -- structure mismatch")
    leaves = []
    for meta, want in zip(manifest["leaves"], flat_like):
        fp = os.path.join(path, meta["file"])
        if verify and _file_digest(fp) != meta["sha256"]:
            raise IOError(f"checksum mismatch in {fp}")
        arr = np.load(fp)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{meta['file']}: shape {arr.shape} != "
                             f"expected {tuple(want.shape)}")
        want_dtype = _dtype_name(want.dtype)
        if meta["dtype"] != want_dtype:
            raise ValueError(
                f"{meta['file']}: dtype {meta['dtype']} != expected "
                f"{want_dtype} -- a drifted dtype would corrupt the "
                "state the step reads")
        if isinstance(want, np.ndarray):
            leaves.append(arr)
            continue
        if want_dtype == "bfloat16":
            x = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(arr)
        leaves.append(x.to(dev))
    return tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Async writers
# ---------------------------------------------------------------------------

_THREAD_ASSERTS = False


def set_thread_asserts(enabled: bool):
    """Toggle the owning-thread assertion mode on every
    ``AsyncWriterThread`` (``--sanitize`` wires this on).  When on,
    subclasses' non-queue state mutations (``_assert_owner`` call
    sites: spool offset counters, checkpoint submission) raise if
    invoked off the constructing thread."""
    global _THREAD_ASSERTS
    _THREAD_ASSERTS = enabled


class AsyncWriterThread:
    """Daemon-thread work queue with deferred error surfacing.

    Shared writer machinery for everything that must stay off the hot
    path (checkpoints, spike-log spooling): ``_submit`` enqueues, the
    daemon thread calls ``_write(item)``, a failing write is latched and
    re-raised on the next ``_submit``/``wait`` (never swallowed),
    ``wait()`` drains pending work, ``close()`` shuts the thread down.

    Only the queue is thread-safe.  Everything else a subclass keeps
    (offset counters, snapshot buffers) is owned by the constructing
    thread; subclasses call ``_assert_owner`` before mutating such
    state, which raises under ``set_thread_asserts(True)``.
    """

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._owner = threading.current_thread()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _assert_owner(self, what: str):
        """Sanitizer hook: non-queue state is single-owner by contract."""
        if _THREAD_ASSERTS and threading.current_thread() is not self._owner:
            raise AssertionError(
                f"{type(self).__name__}.{what} called from thread "
                f"{threading.current_thread().name!r} but this writer's "
                f"non-queue state is owned by {self._owner.name!r} -- "
                "offsets/manifests would race (run without --sanitize "
                "only if you know the access is synchronized)")

    def _write(self, item):
        raise NotImplementedError

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(item)
            except BaseException as e:   # surfaced on next submit/wait
                self._err = e
            finally:
                self._q.task_done()

    def _submit(self, item):
        if self._err:
            raise self._err
        self._q.put(item)

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()


def _snapshot_tree(tree) -> tuple:
    """A copy of ``tree`` that the caller may overwrite at once: each
    tensor ``clone()``d on its device (on the current stream), each
    numpy array copied.  Returns ``(leaves, treedef, event)``, ``event``
    a CUDA event recorded after the clones (None without device
    leaves)."""
    leaves, treedef = tree_flatten(tree)
    snap, event = [], None
    for x in leaves:
        if isinstance(x, torch.Tensor):
            snap.append(x.detach().clone())
            if x.device.type == "cuda" and event is None:
                event = x.device
        else:
            snap.append(np.array(x, copy=True))
    if event is not None:
        dev = event
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return snap, treedef, event


class AsyncCheckpointer(AsyncWriterThread):
    """Daemon-thread writer; ``save`` returns once the device-side
    snapshot is queued -- the device-to-host copy runs in ``_write`` on
    the worker thread (on its own CUDA stream, after the snapshot's
    event), overlapped with whatever the caller queues next.
    ``wait()`` drains pending writes (call before exit).

    ``telemetry``: optional ``obs.telemetry.Telemetry``.  The caller's
    snapshot cost (``ckpt.snapshot``) and the worker's device-to-host
    copy (``ckpt.d2h``) / file write (``ckpt.write``) become separate
    spans on their own threads, so the overlap with segment compute is
    visible in the Chrome trace."""

    def __init__(self, directory: str, keep: int = 3, telemetry=None):
        self.directory = directory
        self.keep = keep
        if telemetry is None:
            # imported lazily: obs.spool imports this module, so a
            # top-level obs.telemetry import would cycle
            from ..obs.telemetry import NULL as telemetry
        self.tel = telemetry
        self._streams: dict = {}          # device -> the worker's stream
        super().__init__()

    def _to_host(self, leaves: list, event) -> list:
        if event is None:
            return leaves
        out = list(leaves)
        cuda = [i for i, x in enumerate(leaves)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"]
        dev = leaves[cuda[0]].device
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            for i in cuda:
                x = leaves[i]
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                out[i] = host
        stream.synchronize()
        return out

    def _write(self, item):
        step, (leaves, treedef, event), meta = item
        with self.tel.span("ckpt.d2h", step=step):
            host = self._to_host(leaves, event)
        with self.tel.span("ckpt.write", step=step):
            save_checkpoint(self.directory, step,
                            tree_unflatten(treedef, host), self.keep,
                            meta=meta)

    def save(self, step: int, tree, meta: Optional[dict] = None):
        self._assert_owner("save")
        # a device copy, not a host transfer: the caller's next segment
        # updates the live state in place, so the snapshot must not
        # alias it -- but it stays on the device until the worker drains
        # it
        with self.tel.span("ckpt.snapshot", step=step):
            snap = _snapshot_tree(tree)
        self._submit((step, snap, meta))
