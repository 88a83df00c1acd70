"""Port parity: runtime telemetry (``repro_torch.obs.telemetry``,
``repro_torch.perf.trace``).

Each contract of the reference's ``tests/test_telemetry.py`` holds in
the port: span nesting and thread attribution, the disabled tracer,
JSONL and Chrome round trips, exactly-once flushes, the summary, the
JSON log formatter, and on the segmented driver the pure-observer
contract (bit-identical runs with tracing on or off, across preempt ->
resume too) and the per-segment stream.  The record schema is the
reference's: each package reads the other's stream, and both make the
same Chrome trace of the same records.
"""

import io
import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from repro.obs import telemetry as jtel
from repro.perf import trace as jtrace
from repro_torch.core import connectivity as tconn
from repro_torch.core import dist_engine as tde
from repro_torch.core import engine as teng
from repro_torch.core import grid as tgrid
from repro_torch.core.stdp import STDPParams
from repro_torch.obs.telemetry import (FORMAT, Telemetry,
                                       enable_json_logging, get_default,
                                       read_jsonl, set_default, span,
                                       summarize)
from repro_torch.perf.trace import (to_chrome_trace, torch_profiler_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.runtime import DriverConfig, SimDriver

N, SEG = 40, 10


def _dist_cfg(law="gaussian", stdp=None):
    lw = getattr(tconn, f"{law}_law")()
    return tde.DistConfig(engine=teng.EngineConfig(
        decomp=tgrid.TileDecomposition(tgrid.ColumnGrid(4, 4, 20), 1, 1,
                                       lw.radius),
        law=lw, seed=3, ext_rate_hz=20.0, stdp=stdp))


def _driver(ckpt_dir, law="gaussian", stdp=None, **kw):
    cfg = DriverConfig(ckpt_dir=str(ckpt_dir), ckpt_every=1,
                       backoff_s=0.01, handle_sigterm=False)
    return SimDriver(cfg, _dist_cfg(law, stdp), "cpu", segment_steps=SEG,
                     **kw)


def _state_equal(a, b):
    ta, tb = tde.state_tree(a), tde.state_tree(b)
    from repro_torch.tree import tree_flatten
    for x, y in zip(tree_flatten(ta)[0], tree_flatten(tb)[0]):
        assert np.array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# tracer unit semantics
# ---------------------------------------------------------------------------

def test_span_nesting_and_thread_attribution():
    tel = Telemetry()
    with tel.span("outer", step=0):
        with tel.span("inner"):
            pass

    def worker():
        with tel.span("worker_span"):
            pass

    t = threading.Thread(target=worker, name="writer-0")
    t.start()
    t.join()
    outer, = tel.spans("outer")
    inner, = tel.spans("inner")
    wspan, = tel.spans("worker_span")
    assert inner["parent"] == "outer" and inner["depth"] == 1
    assert outer["parent"] is None and outer["depth"] == 0
    assert outer["attrs"] == {"step": 0}
    assert outer["dur"] >= inner["dur"] >= 0
    assert wspan["parent"] is None and wspan["depth"] == 0
    assert wspan["thread"] == "writer-0" and wspan["tid"] != outer["tid"]


def test_module_level_span_uses_the_process_default():
    tel = Telemetry()
    prev = set_default(tel)
    try:
        assert get_default() is tel
        with span("x", step=1):
            pass
    finally:
        set_default(prev)
    assert tel.spans("x")[0]["attrs"] == {"step": 1}
    off = Telemetry(enabled=False)
    prev = set_default(off)
    try:
        with span("y"):                 # a disabled default: a no-op
            pass
    finally:
        set_default(prev)
    assert off.records() == []


def test_disabled_tracer_is_a_no_op_but_still_logs(caplog):
    tel = Telemetry(enabled=False)
    with tel.span("segment", step=0):
        pass
    tel.metrics("segment", wall_s=1.0)
    with caplog.at_level(logging.WARNING, logger="repro_torch.telemetry"):
        tel.event("straggler", msg="step 3 overran", level="warning",
                  step=3)
    assert tel.records() == []
    assert "step 3 overran" in caplog.text
    assert caplog.records[0].repro_event == {"kind": "straggler",
                                             "step": 3}


def test_jsonl_roundtrip_and_chrome_schema(tmp_path):
    tel = Telemetry(jsonl_path=str(tmp_path / "t.jsonl"))
    with tel.span("segment", step=0):
        with tel.span("segment.compute", step=0):
            pass
    tel.event("straggler", msg="overran", level="warning", step=0,
              dt_s=2.0)
    tel.metrics("segment", step=0, wall_s=0.5, d_spikes=3.0)
    tel.flush_jsonl()
    back = read_jsonl(str(tmp_path / "t.jsonl"))
    assert [h["format"] for h in back["header"]] == [FORMAT]
    assert {s["name"] for s in back["span"]} == {"segment",
                                                 "segment.compute"}
    ev, = back["event"]
    assert ev["kind"] == "straggler" and ev["dt_s"] == 2.0
    m, = back["metrics"]
    assert m["kind"] == "segment" and m["d_spikes"] == 3.0
    trace = to_chrome_trace(tel.records(), pid=7)
    with open(write_chrome_trace(tel, str(tmp_path / "tr.json"))) as f:
        assert json.load(f)["otherData"]["format"] == FORMAT
    durs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in durs} == {"segment", "segment.compute"}
    for e in durs:
        assert e["pid"] == 7 and e["ts"] >= 0 and e["dur"] >= 0
    inner = next(e for e in durs if e["name"] == "segment.compute")
    assert inner["args"]["parent"] == "segment"
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "i"} \
        == {"straggler", "segment"}
    assert [e["args"]["name"] for e in trace["traceEvents"]
            if e["ph"] == "M"] == ["MainThread"]
    # one schema: the reference reads the port's stream and makes the
    # same Chrome trace of the same records
    assert jtel.read_jsonl(str(tmp_path / "t.jsonl")) == back
    assert jtrace.to_chrome_trace(tel.records(), pid=7) == trace
    assert FORMAT == jtel.FORMAT


def test_flush_jsonl_is_exactly_once(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tel = Telemetry(jsonl_path=path)
    with tel.span("a"):
        pass
    assert tel.flush_jsonl() == 1
    assert tel.flush_jsonl() == 0
    with tel.span("b"):
        pass
    assert tel.flush_jsonl() == 1
    back = read_jsonl(path)
    assert len(back["header"]) == 1
    assert [s["name"] for s in back["span"]] == ["a", "b"]
    assert write_jsonl(tel.records(), str(tmp_path / "one.jsonl")) == 2
    assert len(read_jsonl(str(tmp_path / "one.jsonl"))["span"]) == 2


def test_summarize_aggregates_spans_segments_and_events(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tel = Telemetry(jsonl_path=path)
    for step in (0, 10):
        with tel.span("segment", step=step):
            pass
        tel.metrics("segment", step=step, wall_s=0.5, steps_per_s=20.0,
                    d_spikes=3.0, d_events=7.0, d_dropped=0.0,
                    d_recorder_dropped=0.0)
    tel.event("straggler", msg="overran", level="warning", step=10)
    tel.flush_jsonl()
    s = summarize(read_jsonl(path))
    assert s == jtel.summarize(jtel.read_jsonl(path))
    assert s["processes"] == 1
    seg_span = s["spans"]["segment"]
    assert seg_span["count"] == 2
    assert seg_span["total_s"] >= seg_span["max_s"] >= \
        seg_span["mean_s"] >= 0
    assert s["events"] == {"straggler": 1}
    seg = s["segments"]
    assert seg["n"] == 2 and seg["wall_s"] == 1.0
    assert seg["steps_per_s_mean"] == seg["steps_per_s_min"] == 20.0
    assert seg["d_spikes"] == 6.0 and seg["d_events"] == 14.0


def test_read_jsonl_refuses_foreign_streams(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({"type": "header", "format": "other-v9"})
                 + "\n")
    with pytest.raises(ValueError, match="unknown telemetry format"):
        read_jsonl(str(p))
    p.write_text(json.dumps({"type": "span", "name": "x"}) + "\n")
    with pytest.raises(ValueError, match="no telemetry header"):
        read_jsonl(str(p))


def test_json_log_formatter_emits_structured_lines():
    stream = io.StringIO()
    handler = enable_json_logging(stream=stream)
    lg = logging.getLogger("repro_torch")
    try:
        Telemetry(enabled=False).event(
            "preempt", msg="SIGTERM received", level="warning",
            logger=logging.getLogger("repro_torch.runtime"), step=20)
    finally:
        lg.removeHandler(handler)
        lg.propagate = True
    rec = json.loads(stream.getvalue().strip())
    assert rec["level"] == "warning" and rec["msg"] == "SIGTERM received"
    assert rec["event"] == {"kind": "preempt", "step": 20}


def test_torch_profiler_trace_exports_chrome_json(tmp_path):
    with torch_profiler_trace(None):
        pass
    with torch_profiler_trace(str(tmp_path), cuda=False):
        torch.ones(8).cumsum(0)
    out, = os.listdir(tmp_path)
    with open(tmp_path / out) as f:
        assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# driver integration: pure observer + per-segment stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_pure_observer_bit_identity_static(tmp_path, law):
    ref = _driver(tmp_path / "off", law=law, record_events=True)
    out_ref = ref.run(N)
    tel = Telemetry()
    traced = _driver(tmp_path / "on", law=law, record_events=True,
                     telemetry=tel)
    out_tel = traced.run(N)
    assert ref.spike_counts(N).sum() > 0
    np.testing.assert_array_equal(ref.spike_counts(N),
                                  traced.spike_counts(N))
    _state_equal(out_ref["state"], out_tel["state"])
    assert len(tel.spans("segment.compute")) == N // SEG
    assert len([r for r in tel.records()
                if r["type"] == "metrics"]) == N // SEG


def test_pure_observer_bit_identity_plastic_preempt_resume(tmp_path):
    ref = _driver(tmp_path / "ref", stdp=STDPParams(), record_events=True)
    out_ref = ref.run(N)
    first = _driver(tmp_path / "t", stdp=STDPParams(), record_events=True,
                    preempt_after_segments=1, telemetry=Telemetry())
    out1 = first.run(N)
    assert out1["preempted"] and out1["final_step"] == SEG
    second = _driver(tmp_path / "t", stdp=STDPParams(),
                     record_events=True, telemetry=Telemetry())
    out2 = second.run(N)
    assert out2["final_step"] == N
    np.testing.assert_array_equal(ref.spike_counts(N),
                                  second.spike_counts(N))
    _state_equal(out_ref["state"], out2["state"])
    assert ref.plastic_summary(out_ref["state"])["weight_checksum"] \
        == second.plastic_summary(out2["state"])["weight_checksum"]


def test_segment_stream_carries_deltas_and_spans(tmp_path):
    tel = Telemetry()
    drv = _driver(tmp_path, record_events=True, telemetry=tel)
    out = drv.run(N)
    segs = [r for r in tel.records() if r["type"] == "metrics"
            and r["kind"] == "segment"]
    assert [m["step"] for m in segs] == [0, 10, 20, 30]
    for m in segs:
        assert m["wall_s"] > 0 and m["steps_per_s"] > 0
        for k in ("d_spikes", "d_events", "d_dropped",
                  "d_recorder_dropped"):
            assert k in m
    totals = drv.metric_totals(out["state"])
    assert sum(m["d_spikes"] for m in segs) == totals["spikes"]
    assert sum(m["d_events"] for m in segs) == totals["events"]
    assert all("d_spikes" in row for row in out["metrics"])
    names = {s["name"] for s in tel.spans()}
    assert {"segment", "segment.compute", "segment.spool_drain",
            "ckpt.snapshot", "ckpt.spool_sync", "ckpt.d2h",
            "ckpt.write", "spool.write", "restore.init"} <= names
    main_tid = tel.spans("segment")[0]["tid"]
    assert all(s["tid"] != main_tid for s in tel.spans("ckpt.write"))
    assert all(s["tid"] != main_tid for s in tel.spans("ckpt.d2h"))
    compute = tel.spans("segment.compute")[0]
    assert compute["parent"] == "segment" and compute["depth"] == 1


def test_exactly_once_stream_across_preempt_resume(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    tel1 = Telemetry(jsonl_path=path)
    _driver(tmp_path, preempt_after_segments=1, telemetry=tel1).run(N)
    tel1.flush_jsonl()
    tel1.flush_jsonl()
    tel2 = Telemetry(jsonl_path=path)
    out = _driver(tmp_path, telemetry=tel2).run(N)
    assert out["final_step"] == N
    tel2.flush_jsonl()
    back = read_jsonl(path)
    assert len(back["header"]) == 2
    assert sorted(m["step"] for m in back["metrics"]
                  if m["kind"] == "segment") == [0, 10, 20, 30]
    resumes = [e for e in back["event"] if e["kind"] == "resume"]
    assert len(resumes) == 1 and resumes[0]["step"] == 10
