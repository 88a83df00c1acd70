"""Host-side spike-log spooler: sharded, append-only, exactly-once.

The port of ``repro.obs.spool``, pure numpy: its files are the
reference's, byte for byte.

Layout (one directory per run, by default ``<ckpt_dir>/spool``)::

    spool/
        header.json                  # format + model identity (once)
        events_000_000.spk ...       # one log per recording shard

    spool/                           # ensemble run (M member streams)
        header.json                  # shared identity + ensemble_seeds
        member_000/
            header.json              # + member index / state_seed
            events_000_000.spk ...
        member_001/ ...

Each ``.spk`` file is a raw little-endian stream of fixed 8-byte
records ``(step int32, gid int32)`` -- ``RECORD_DTYPE`` -- appended in
sim-step order by a daemon writer thread (same pattern as
``checkpoint.store.AsyncCheckpointer``: ``append`` costs a host-side
copy, the file write happens off the hot path).

Exactly-once contract with the segmented driver: the spooler's
per-shard event counts are updated synchronously at ``append`` time, so
the driver can snapshot ``offsets()`` into each checkpoint's manifest
(atomic with the checkpoint).  On any restore -- preemption resume,
failure rewind, elastic retile -- ``truncate(manifest_offsets)`` cuts
every log back to the checkpoint's frontier and wipes logs the manifest
does not know, so replayed segments re-append their events exactly once
and a crash can never leave phantom events from an abandoned timeline.
Ensemble member logs are ordinary shard logs under a subdirectory --
their offsets ride the same manifest under their relative path, so the
contract covers every member uniformly.

Shard files are keyed by the *writing* tile, but events carry global
neuron ids, so logs written under different tilings (before/after an
elastic retile) concatenate into one coherent global stream --
``load_events`` merges and orders them by ``(step, gid)``.

The append-only layout doubles as a streaming surface: a reader that
remembers per-log record offsets (``offsets()``-shaped) can poll
``read_new_events`` for just the records appended since its cursor --
this is what the sim job server's incremental endpoint serves to
concurrent clients while a run is still in flight.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..checkpoint.store import AsyncWriterThread
from .telemetry import NULL, Telemetry

RECORD_DTYPE = np.dtype([("step", "<i4"), ("gid", "<i4")])
FORMAT = "dpsnn-spk-v1"


def shard_name(tile_y: int, tile_x: int) -> str:
    return f"events_{tile_y:03d}_{tile_x:03d}.spk"


def member_name(member: int) -> str:
    return f"member_{member:03d}"


def _write_or_validate_header(directory: str, header: dict):
    """Create ``header.json`` or validate an existing one key-by-key."""
    hpath = os.path.join(directory, "header.json")
    if os.path.exists(hpath):
        with open(hpath) as f:
            have = json.load(f)
        for k, v in header.items():
            if k in have and have[k] != v:
                raise ValueError(
                    f"spool header {hpath} was written with {k}="
                    f"{have[k]!r}, current run has {k}={v!r} -- "
                    "this spool directory belongs to a different "
                    "model; use a fresh --ckpt-dir or delete it")
    else:
        with open(hpath, "w") as f:
            json.dump({"format": FORMAT,
                       "record": [list(t[:2]) for t in RECORD_DTYPE.descr],
                       **header}, f, indent=1)


class SpikeSpooler(AsyncWriterThread):
    """Async writer of per-shard spike logs.

    ``tiles``: the recording tiling -- its shard files are created
    eagerly so zero-spike runs still leave valid (empty) logs.
    ``header``: model-identity dict written to ``header.json`` on first
    open (grid, law, dt -- everything analysis needs).  An existing
    header is kept (resumes must not rewrite history) but **validated**:
    a spool directory left behind by a *different* model is refused, the
    same way the driver refuses a checkpoint-meta mismatch -- silently
    appending 8x8x60 events to a 4x4x20 header would poison every
    downstream rate (analysis normalizes by the header's n_neurons).

    ``members``: member state seeds of an ensemble run.  When given,
    each member gets its own ``member_{m:03d}/`` stream (own validated
    header carrying that member's ``state_seed``), ``append`` takes the
    member index, and offsets/truncation key logs by their relative
    path -- the exactly-once contract is per member log.
    """

    def __init__(self, directory: str, tiles, header: Optional[dict] = None,
                 telemetry: Telemetry = NULL, members=None):
        self.directory = directory
        self.tel = telemetry
        self.members = (None if members is None
                        else tuple(int(s) for s in members))
        os.makedirs(directory, exist_ok=True)
        header = dict(header or {})
        if self.members is None:
            shard_dirs = [("", header)]
        else:
            _write_or_validate_header(
                directory, dict(header, ensemble_seeds=list(self.members)))
            shard_dirs = []
            for m, s in enumerate(self.members):
                sub = member_name(m)
                os.makedirs(os.path.join(directory, sub), exist_ok=True)
                shard_dirs.append(
                    (sub, dict(header, member=m, state_seed=s)))
        self._counts: Dict[str, int] = {}
        for sub, hdr in shard_dirs:
            _write_or_validate_header(os.path.join(directory, sub), hdr)
            for ty in range(tiles[0]):
                for tx in range(tiles[1]):
                    name = os.path.join(sub, shard_name(ty, tx)) if sub \
                        else shard_name(ty, tx)
                    path = os.path.join(directory, name)
                    with open(path, "ab"):
                        pass
                    self._counts[name] = os.path.getsize(path) \
                        // RECORD_DTYPE.itemsize
        # pre-existing logs of *other* tilings (elastic resume) keep
        # appending under their own names; count them too
        for name in _iter_spk(directory):
            if name not in self._counts:
                self._counts[name] = os.path.getsize(
                    os.path.join(directory, name)) // RECORD_DTYPE.itemsize
        super().__init__()

    # ---- writer thread (AsyncWriterThread) -----------------------------
    def _write(self, item):
        name, arr = item
        with self.tel.span("spool.write", shard=name, events=len(arr)):
            with open(os.path.join(self.directory, name), "ab") as f:
                arr.tofile(f)

    # ---- producer API --------------------------------------------------
    def append(self, tile_y: int, tile_x: int, steps, gids,
               member: Optional[int] = None):
        """Enqueue one shard's segment events (valid prefixes only).

        The shard's offset advances *synchronously*, so ``offsets()``
        read immediately after covers this append -- the property the
        checkpoint-manifest snapshot relies on.  Ensemble spoolers
        require the ``member`` index (and solo spoolers refuse one)."""
        self._assert_owner("append")
        if (member is None) != (self.members is None):
            raise ValueError(
                f"append(member={member!r}) on a spooler with members="
                f"{self.members!r}: member index is required exactly "
                "when the spool is an ensemble")
        steps = np.asarray(steps)
        n = len(steps)
        name = shard_name(tile_y, tile_x)
        if member is not None:
            name = os.path.join(member_name(member), name)
        if name not in self._counts:          # a tiling seen mid-run
            with open(os.path.join(self.directory, name), "ab"):
                pass
            self._counts[name] = 0
        if n == 0:
            return
        arr = np.empty(n, RECORD_DTYPE)
        arr["step"] = steps
        arr["gid"] = np.asarray(gids)
        self._counts[name] += n
        self._submit((name, arr))

    def offsets(self) -> Dict[str, int]:
        """Per-shard event counts covering every ``append`` so far (the
        writes themselves may still be in flight).  Keys are paths
        relative to the spool directory (``member_000/...`` for
        ensemble streams)."""
        self._assert_owner("offsets")
        return dict(self._counts)

    def truncate(self, offsets: Dict[str, int]):
        """Rewind every log to a checkpoint's spool frontier.

        Logs absent from ``offsets`` are cut to zero: they belong to a
        timeline the checkpoint does not know about (events appended
        after the checkpoint, possibly under a different tiling)."""
        self._assert_owner("truncate")
        self.wait()
        for fn in sorted(self._counts):
            path = os.path.join(self.directory, fn)
            want = int(offsets.get(fn, 0)) * RECORD_DTYPE.itemsize
            have = os.path.getsize(path)
            if have < want:
                raise IOError(
                    f"spool log {path} holds {have} bytes but the "
                    f"checkpoint manifest expects {want} -- the log was "
                    "truncated or deleted behind the driver's back")
            if have > want:
                os.truncate(path, want)
            self._counts[fn] = want // RECORD_DTYPE.itemsize
        for fn, n in offsets.items():
            if fn not in self._counts and int(n) > 0:
                raise IOError(
                    f"checkpoint manifest expects {n} events in missing "
                    f"spool log {os.path.join(self.directory, fn)}")


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------

def _spool_dir(run_dir: str) -> str:
    sub = os.path.join(run_dir, "spool")
    return sub if os.path.isdir(sub) else run_dir


def _iter_spk(directory: str):
    """Relative paths of every ``.spk`` log: top level plus one level of
    ``member_*`` subdirectories, in sorted order."""
    for fn in sorted(os.listdir(directory)):
        path = os.path.join(directory, fn)
        if fn.endswith(".spk"):
            yield fn
        elif fn.startswith("member_") and os.path.isdir(path):
            for sub in sorted(os.listdir(path)):
                if sub.endswith(".spk"):
                    yield os.path.join(fn, sub)


def read_header(run_dir: str) -> dict:
    """The spool's ``header.json``; ``run_dir`` may be the run (ckpt)
    directory, the spool directory, or one member's stream directory."""
    with open(os.path.join(_spool_dir(run_dir), "header.json")) as f:
        h = json.load(f)
    if h.get("format") != FORMAT:
        raise ValueError(f"{run_dir}: unknown spool format "
                         f"{h.get('format')!r} (expected {FORMAT!r})")
    return h


def member_dirs(run_dir: str) -> Dict[str, str]:
    """Ensemble member streams under a run: ``{"member_000": abspath,
    ...}`` in member order; empty for a solo run."""
    d = _spool_dir(run_dir)
    out = {}
    for fn in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        path = os.path.join(d, fn)
        if fn.startswith("member_") and os.path.isdir(path):
            out[fn] = path
    return out


def shard_events(run_dir: str) -> Dict[str, np.ndarray]:
    """Per-shard raw event arrays (file order preserved).  For an
    ensemble run this is ONE member's stream directory -- pass a
    ``member_dirs`` entry, not the spool root."""
    d = _spool_dir(run_dir)
    out = {}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".spk"):
            out[fn] = np.fromfile(os.path.join(d, fn), dtype=RECORD_DTYPE)
    return out


def load_events(run_dir: str) -> np.ndarray:
    """All spooled events merged into one global stream, ordered by
    ``(step, gid)`` -- the canonical order for comparing runs (shard
    interleaving is tiling-dependent; the ordered stream is not)."""
    shards = list(shard_events(run_dir).values())
    if not shards:
        raise FileNotFoundError(f"no .spk spike logs under {run_dir}")
    ev = np.concatenate(shards) if len(shards) > 1 else shards[0]
    return ev[np.lexsort((ev["gid"], ev["step"]))]


def read_new_events(run_dir: str, cursor: Optional[Dict[str, int]] = None
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Incremental read: records appended since ``cursor``.

    ``cursor`` maps relative log paths to record offsets (the shape of
    ``SpikeSpooler.offsets()``); ``None`` reads from the beginning.
    Returns ``(new_events, new_cursor)`` where ``new_events`` holds the
    per-log arrays appended at/after the cursor (only logs with new
    records appear) and ``new_cursor`` covers every log seen.  Safe
    against concurrent appends: a torn trailing record (partial 8-byte
    write in flight) is excluded by reading whole records only, and the
    writer is append-only, so successive cursors are monotone.  This is
    the read side of the exactly-once offset contract and the backing
    of the job server's streaming endpoint.
    """
    d = _spool_dir(run_dir)
    cursor = dict(cursor or {})
    new = {}
    for name in _iter_spk(d):
        path = os.path.join(d, name)
        have = os.path.getsize(path) // RECORD_DTYPE.itemsize
        done = int(cursor.get(name, 0))
        if have > done:
            new[name] = np.fromfile(
                path, dtype=RECORD_DTYPE, count=have - done,
                offset=done * RECORD_DTYPE.itemsize)
        cursor[name] = max(have, done)
    return new, cursor
