"""Trace exporters for the runtime telemetry stream.

The port of ``repro.perf.trace``.  Thin, dependency-free views over
``repro_torch.obs.telemetry`` records:

  * **Chrome trace** (``chrome://tracing`` / Perfetto / speedscope):
    every span becomes a complete ``"ph": "X"`` duration event on its
    emitting thread, so the async checkpoint writer's D2H/file-write
    lanes render *under* the main thread's segment lane and the
    double-buffered overlap is visible instead of inferred; structured
    events become instant (``"ph": "i"``) markers.
  * **JSONL**: the raw record stream (``Telemetry.flush_jsonl`` is the
    incremental writer; ``write_jsonl`` here is the one-shot export for
    already-collected record lists).
  * **torch.profiler wrapper**: the opt-in deep profile
    (``repro_torch.launch.sim --trace-dir``) capturing host operators
    and, on a CUDA device, the kernels the card ran -- heavyweight, so
    it is a separate flag from the always-cheap span tracer.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import List, Optional

from ..obs.telemetry import FORMAT, Telemetry

__all__ = ["to_chrome_trace", "write_chrome_trace", "write_jsonl",
           "torch_profiler_trace"]


def to_chrome_trace(records: List[dict], pid: Optional[int] = None) -> dict:
    """Convert telemetry records to the Chrome Trace Event JSON format.

    Spans map to complete events (``ph: "X"``; microsecond ``ts`` /
    ``dur`` relative to the tracer epoch), events to instant markers
    scoped to their thread, and each thread gets a ``thread_name``
    metadata event so the viewer shows ``MainThread`` vs the writer
    daemons by name.
    """
    pid = os.getpid() if pid is None else pid
    trace_events: List[dict] = []
    thread_names = {}
    for rec in records:
        if rec.get("type") == "span":
            thread_names.setdefault(rec["tid"], rec["thread"])
            args = dict(rec.get("attrs", {}))
            if rec.get("parent"):
                args["parent"] = rec["parent"]
            args["depth"] = rec["depth"]
            trace_events.append({
                "name": rec["name"], "cat": "span", "ph": "X",
                "ts": rec["t0"] * 1e6, "dur": rec["dur"] * 1e6,
                "pid": pid, "tid": rec["tid"], "args": args,
            })
        elif rec.get("type") in ("event", "metrics"):
            payload = {k: v for k, v in rec.items()
                       if k not in ("type", "kind", "t")}
            trace_events.append({
                "name": rec["kind"], "cat": rec["type"], "ph": "i",
                "ts": rec["t"] * 1e6, "pid": pid, "tid": 0, "s": "p",
                "args": payload,
            })
    for tid, name in sorted(thread_names.items()):
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"format": FORMAT}}


def write_chrome_trace(source, path: str) -> str:
    """Write a Chrome trace JSON for ``source`` (a ``Telemetry`` tracer
    or a raw record list); returns ``path``.  Load it in
    ``chrome://tracing`` or https://ui.perfetto.dev."""
    records = source.records() if isinstance(source, Telemetry) else source
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records), f, indent=1)
    return path


def write_jsonl(source, path: str) -> int:
    """One-shot JSONL export (header + every record).  For incremental
    exactly-once appends during a run use ``Telemetry.flush_jsonl``."""
    if isinstance(source, Telemetry):
        return source.flush_jsonl(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"type": "header", "format": FORMAT,
                            "pid": os.getpid()}) + "\n")
        for rec in source:
            f.write(json.dumps(rec) + "\n")
    return len(source)


@contextlib.contextmanager
def torch_profiler_trace(trace_dir: Optional[str], cuda: bool = True):
    """Opt-in ``torch.profiler`` wrapper (``--trace-dir``).

    ``None`` is a no-op, so call sites wrap unconditionally.  Profiles
    host operators and, with ``cuda`` and a CUDA device present, the
    card's activity, and exports one Chrome trace
    (``<trace_dir>/torch_trace_<pid>.json``) when the block ends.  It
    sees device kernels the span tracer cannot; it is heavyweight, so
    it stays separate from the always-cheap spans.
    """
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"torch_trace_{os.getpid()}.json"))
