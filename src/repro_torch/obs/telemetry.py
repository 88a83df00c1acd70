"""Host-side runtime telemetry: span tracer + structured event stream.

The port of ``repro.obs.telemetry``; it is pure Python and keeps the
reference's record schema, so a JSONL stream written by either package
reads the same.

DPSNN's companion scaling study (arXiv:1511.09325) decomposes
time-per-simulated-second into phases (spike delivery, synaptic/neural
dynamics, inter-process exchange).  This module is the host half of
that instrument for the segmented driver: a low-overhead span tracer
every runtime phase reports into -- segment compute, checkpoint
snapshot / D2H / file write, spool drain, restore and retile,
straggler stalls -- plus a structured per-segment metrics stream.  The
device half is ``torch.profiler`` (``perf.trace.torch_profiler_trace``).

Design constraints, in order:

  * **pure observer** -- telemetry must never perturb the simulation:
    spans run host-side only (monotonic ``perf_counter`` reads), never
    inside a captured CUDA graph (a clock read there would run at
    capture, not at replay), and a disabled tracer costs one attribute
    check per instrumentation site.  Spike trains and plastic weight checksums
    are bit-identical with tracing on or off (tested).
  * **thread-aware** -- the async writers (``AsyncCheckpointer``,
    ``SpikeSpooler``) do their D2H transfers and file writes on daemon
    threads; their spans record the emitting thread so checkpoint wall
    time is attributed to the writer, not the segment that overlapped
    it.  Span nesting is tracked per-thread (a thread-local stack).
  * **exactly-once flush** -- ``flush_jsonl`` appends only records not
    yet written (a cursor, not a rewrite), so periodic flushes plus the
    final one never duplicate a span, and a preempted process's file
    picks up cleanly when the resuming process appends to it.

Record types (each one JSON dict in the JSONL stream)::

    {"type": "header",  "format": "dpsnn-telemetry-v1", "pid": ..., ...}
    {"type": "span",    "name": "segment.compute", "t0": s, "dur": s,
                        "thread": ..., "tid": ..., "depth": n,
                        "parent": name-or-null, "attrs": {...}}
    {"type": "event",   "kind": "straggler", "level": "warning",
                        "t": s, "msg": ..., ...fields}
    {"type": "metrics", "kind": "segment", "t": s, ...fields}

Timestamps are seconds relative to the tracer's construction
(``epoch_unix`` in the header anchors them to wall time).  Chrome-trace
export (``chrome://tracing`` / Perfetto) is a view over the same
records: ``repro_torch.perf.trace.write_chrome_trace``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

FORMAT = "dpsnn-telemetry-v1"

log = logging.getLogger("repro_torch.telemetry")

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR}


class Telemetry:
    """Span tracer + structured event/metrics stream.

    ``enabled=False`` (the drivers' default) makes every method a
    near-no-op -- ``span`` yields immediately, ``event`` only forwards
    to the stdlib logger -- so instrumentation sites are unconditional
    and the uninstrumented hot path stays unchanged.

    All record-appending methods are thread-safe; span *nesting* is
    per-thread (each thread sees its own stack, so a checkpoint
    writer's ``ckpt.write`` span never claims the main thread's
    ``segment`` span as parent).
    """

    def __init__(self, enabled: bool = True,
                 jsonl_path: Optional[str] = None):
        self.enabled = enabled
        self.jsonl_path = jsonl_path
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self._lock = threading.Lock()
        self._records: List[dict] = []
        self._local = threading.local()
        self._flushed = 0                 # JSONL cursor (exactly-once)
        self._header_written = False

    # ---- clock ---------------------------------------------------------
    def now(self) -> float:
        """Seconds since tracer construction (monotonic)."""
        return time.perf_counter() - self.epoch

    # ---- spans ---------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a host-side phase.  Pure observer: the only work inside
        the ``with`` boundary is two monotonic clock reads and (on
        exit) one locked list append.  Never use inside a CUDA graph
        capture -- the clock would read at capture, not per replay."""
        if not self.enabled:
            yield self
            return
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            th = threading.current_thread()
            rec = {"type": "span", "name": name,
                   "t0": t0 - self.epoch, "dur": dur,
                   "thread": th.name, "tid": th.ident,
                   "depth": len(stack), "parent": parent}
            if attrs:
                rec["attrs"] = attrs
            with self._lock:
                self._records.append(rec)

    # ---- structured events / metrics ----------------------------------
    def event(self, kind: str, msg: Optional[str] = None,
              level: str = "info", logger: Optional[logging.Logger] = None,
              **fields):
        """One structured event: logged through the stdlib logger
        (human-readable, or JSON lines under ``enable_json_logging``)
        AND appended to the telemetry stream when enabled -- the
        drivers' replacement for ad-hoc ``log.warning`` calls, so every
        operational notice (drop warning, straggler, retry, preempt)
        lands in the same machine-readable JSONL as the spans."""
        lg = logger or log
        lg.log(_LEVELS.get(level, logging.INFO), "%s",
               msg if msg is not None else kind,
               extra={"repro_event": {"kind": kind, **fields}})
        if not self.enabled:
            return
        rec = {"type": "event", "kind": kind, "level": level,
               "t": self.now(), **fields}
        if msg is not None:
            rec["msg"] = msg
        with self._lock:
            self._records.append(rec)

    def metrics(self, kind: str, **fields):
        """One structured metrics sample (e.g. the per-segment record:
        spike/event/drop deltas, segment wall, steps/s)."""
        if not self.enabled:
            return
        with self._lock:
            self._records.append(
                {"type": "metrics", "kind": kind, "t": self.now(),
                 **fields})

    # ---- views ---------------------------------------------------------
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def spans(self, name: Optional[str] = None) -> List[dict]:
        return [r for r in self.records() if r["type"] == "span"
                and (name is None or r["name"] == name)]

    def events(self, kind: Optional[str] = None) -> List[dict]:
        return [r for r in self.records() if r["type"] == "event"
                and (kind is None or r["kind"] == kind)]

    def _header(self) -> dict:
        return {"type": "header", "format": FORMAT, "pid": os.getpid(),
                "epoch_unix": self.epoch_unix}

    # ---- JSONL flush (exactly-once) ------------------------------------
    def flush_jsonl(self, path: Optional[str] = None) -> int:
        """Append records not yet flushed to ``path`` (default: the
        tracer's ``jsonl_path``); returns the number written.

        Exactly-once by cursor: repeated flushes (periodic + final)
        never rewrite or duplicate a record.  The file is append-only,
        so a resumed process (its own tracer, its own header line)
        extends the preempted process's stream rather than clobbering
        it -- the reader groups by the interleaved header records.
        """
        path = path or self.jsonl_path
        if not self.enabled or path is None:
            return 0
        with self._lock:
            pending = self._records[self._flushed:]
            self._flushed = len(self._records)
            write_header = not self._header_written
            self._header_written = True
        if not pending and not write_header:
            return 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            if write_header:
                f.write(json.dumps(self._header()) + "\n")
            for rec in pending:
                f.write(json.dumps(rec) + "\n")
        return len(pending)


#: Shared disabled tracer: the default for every instrumented component,
#: so call sites never need a None check.
NULL = Telemetry(enabled=False)

_default: Telemetry = NULL


def set_default(tel: Telemetry) -> Telemetry:
    """Install the process-default tracer (used by module-level
    ``span``); returns the previous one."""
    global _default
    prev, _default = _default, tel
    return prev


def get_default() -> Telemetry:
    return _default


def span(name: str, **attrs):
    """Module-level convenience: a span on the process-default tracer.
    Host-side only: inside a CUDA graph capture it would time the
    capture, not the replays."""
    return _default.span(name, **attrs)


# ---------------------------------------------------------------------------
# Structured (JSON-lines) logging -- the --log-json flag
# ---------------------------------------------------------------------------

class JsonLogFormatter(logging.Formatter):
    """Formats every log record as one JSON object per line, carrying
    the structured ``repro_event`` payload ``Telemetry.event`` attaches
    (plain third-party records format with ``event: null``)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {"ts": round(record.created, 6),
               "level": record.levelname.lower(),
               "logger": record.name,
               "msg": record.getMessage(),
               "event": getattr(record, "repro_event", None)}
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def enable_json_logging(logger_name: str = "repro_torch",
                        stream=None) -> logging.Handler:
    """Route the ``repro_torch.*`` loggers through ``JsonLogFormatter`` (the
    sim CLI's ``--log-json``).  Returns the installed handler (tests
    detach it)."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonLogFormatter())
    lg = logging.getLogger(logger_name)
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    return handler


def read_jsonl(path: str) -> Dict[str, List[dict]]:
    """Parse a telemetry JSONL stream back into records grouped by
    type: ``{"header": [...], "span": [...], "event": [...],
    "metrics": [...]}``.  Validates the format marker of every header
    line (a resumed run appends one header per process)."""
    out: Dict[str, List[dict]] = {"header": [], "span": [], "event": [],
                                  "metrics": []}
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "header" and rec.get("format") != FORMAT:
                raise ValueError(
                    f"{path}:{i}: unknown telemetry format "
                    f"{rec.get('format')!r} (expected {FORMAT!r})")
            if kind not in out:
                raise ValueError(f"{path}:{i}: unknown record type "
                                 f"{kind!r}")
            out[kind].append(rec)
    if not out["header"]:
        raise ValueError(f"{path}: no telemetry header record")
    return out


def summarize(groups: Dict[str, List[dict]]) -> dict:
    """Aggregate a ``read_jsonl`` grouping into the compact per-run
    digest ``repro_torch.launch.analyze --telemetry`` folds into its report:
    per-span wall totals (where the host time went), event counts by
    kind, and segment throughput with the per-segment delta sums.

    ``total_s`` double-counts nested spans by design (``segment``
    contains ``segment.compute``) -- it answers "how long was this
    phase open", not "exclusive self time"; read the hierarchy from
    the Chrome trace when exclusivity matters.
    """
    spans: Dict[str, dict] = {}
    for s in groups["span"]:
        d = spans.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                         "max_s": 0.0})
        d["count"] += 1
        d["total_s"] += s["dur"]
        d["max_s"] = max(d["max_s"], s["dur"])
    for d in spans.values():
        d["mean_s"] = d["total_s"] / d["count"]
    events: Dict[str, int] = {}
    for e in groups["event"]:
        events[e["kind"]] = events.get(e["kind"], 0) + 1
    out = {"processes": len(groups["header"]), "spans": spans,
           "events": events}
    segs = [m for m in groups["metrics"] if m.get("kind") == "segment"]
    if segs:
        sps = [m["steps_per_s"] for m in segs]
        out["segments"] = {
            "n": len(segs),
            "wall_s": sum(m["wall_s"] for m in segs),
            "steps_per_s_mean": sum(sps) / len(sps),
            "steps_per_s_min": min(sps),
            **{k: sum(m.get(k, 0) for m in segs)
               for k in ("d_spikes", "d_events", "d_dropped",
                         "d_recorder_dropped")},
        }
    return out
