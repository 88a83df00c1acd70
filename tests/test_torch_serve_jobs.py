"""The simulation job service, in the port: the typed spec's round trip,
the queue on one device with a shared sim function, and the incremental
streaming endpoint under concurrent clients (the contracts of the
reference's ``tests/test_serve_jobs.py``), on the CPU over loopback."""

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from repro.launch.serve import SimJobServer as JSimJobServer
from repro.runtime import SimJobSpec as JSimJobSpec
from repro_torch.launch.serve import SimJobServer
from repro_torch.runtime import JobError, SimJobSpec, build_sim_driver

GRID, NPC = 4, 20


def _spec(ckpt_dir, **kw):
    base = dict(ckpt_dir=str(ckpt_dir), grid=GRID, n_per_column=NPC,
                law="exponential", t_steps=30, segment_steps=10,
                record=True)
    base.update(kw)
    return SimJobSpec(**base)


# ---------------------------------------------------------------------------
# spec round trip and validation
# ---------------------------------------------------------------------------

def test_spec_json_roundtrip(tmp_path):
    spec = _spec(tmp_path, seeds=(3, 1, 2), plastic=True,
                 stdp={"a_plus": 0.02}, tiles=(1, 1))
    again = SimJobSpec.from_json(spec.to_json())
    assert again == spec
    assert again.seeds == (3, 1, 2) and again.tiles == (1, 1)
    assert again.n_members == 3
    # job_meta is plain JSON data (manifest-safe)
    assert json.loads(json.dumps(spec.job_meta())) == spec.job_meta()


def test_spec_rejects_unknown_fields_and_bad_values(tmp_path):
    with pytest.raises(ValueError, match="bogus"):
        SimJobSpec.from_json(
            json.dumps({"ckpt_dir": str(tmp_path), "bogus": 1}))
    with pytest.raises(ValueError, match="law"):
        _spec(tmp_path, law="cauchy")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _spec(tmp_path, seeds=(1, 2), state_seed=7)
    with pytest.raises(ValueError, match="member"):
        _spec(tmp_path, seeds=())
    with pytest.raises(ValueError, match="t_steps"):
        _spec(tmp_path, t_steps=0)
    with pytest.raises(ValueError, match="plastic"):
        _spec(tmp_path, stdp={"a_plus": 0.02})


def test_build_refuses_bad_resume_targets(tmp_path):
    with pytest.raises(JobError, match="no checkpoint"):
        build_sim_driver(_spec(tmp_path / "empty", resume=True),
                         device="cpu")


# ---------------------------------------------------------------------------
# server and HTTP endpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    from repro_torch.launch.serve import serve_sim
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    httpd, jobs = serve_sim(port=0, device="cpu")
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}", jobs
    httpd.shutdown()
    jobs.shutdown()
    torch.set_num_threads(n)


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=payload.encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_runs_ensemble_with_concurrent_streams(server, tmp_path):
    base, jobs = server
    spec = _spec(tmp_path / "ens", seeds=(0, 1, 2))
    st, r = _post(base, "/v1/sim/jobs", spec.to_json())
    assert st == 200 and r["status"] == "queued"
    jid = r["job_id"]

    results = {}

    def client(name, pause):
        cursor, total = None, 0
        while True:
            q = "" if cursor is None else "?cursor=" + urllib.parse.quote(
                json.dumps(cursor))
            st, r = _get(base, f"/v1/sim/jobs/{jid}/stream{q}")
            assert st == 200, r
            cursor = r["cursor"]
            for member, g in r["streams"].items():
                assert member.startswith("member_")
                assert len(g["step"]) == g["n_new"]
                total += g["n_new"]
            if r["done"]:
                break
            time.sleep(pause)
        results[name] = total

    threads = [threading.Thread(target=client, args=("fast", 0.05)),
               threading.Thread(target=client, args=("slow", 0.3))]
    for t in threads:
        t.start()
    job = jobs.wait(jid, timeout=300)
    for t in threads:
        t.join(timeout=60)
    assert job.status == "done", job.error
    assert job.result["final_step"] == 30
    assert job.result["members"] == 3
    assert job.result["compiled_steps"] == 1
    assert job.result["captures"] == 0          # the CPU steps eagerly
    assert set(job.result["wall"]) == {"build_s", "run_s", "drain_s"}
    # both clients, at different pace, saw every spooled event
    assert results["fast"] == results["slow"] \
        == job.result["spooled_events"] > 0

    # a second job with different seeds reuses the sim function
    spec2 = _spec(tmp_path / "ens2", seeds=(7, 8, 9), t_steps=10)
    st, r = _post(base, "/v1/sim/jobs", spec2.to_json())
    job2 = jobs.wait(r["job_id"], timeout=300)
    assert job2.status == "done", job2.error
    assert jobs.compiled_steps() == 1

    st, r = _get(base, "/v1/sim/jobs")
    assert st == 200 and len(r["jobs"]) >= 2


def test_compiled_steps_per_job_match_the_reference(tmp_path):
    """Two jobs of different grids on one server: each job reports its
    own driver's sim-function count as ``compiled_steps`` and the
    server's cache beside it, the same sequence on both packages'
    servers ((1, 1), then (1, 2))."""
    seen = {}
    for name, server, spec_cls in (
            ("reference", JSimJobServer(), JSimJobSpec),
            ("port", SimJobServer(device="cpu"), SimJobSpec)):
        try:
            seq = []
            for grid in (4, 3):
                job = server.wait(server.submit(spec_cls(
                    ckpt_dir=str(tmp_path / f"{name}{grid}"), grid=grid,
                    n_per_column=10, law="gaussian", t_steps=10,
                    segment_steps=10)), timeout=300)
                assert job.status == "done", job.error
                seq.append((job.result["compiled_steps"],
                            job.result["server_compiled_steps"]))
            seen[name] = seq
        finally:
            server.shutdown()
    assert seen["port"] == seen["reference"] == [(1, 1), (1, 2)]


def test_server_rejects_bad_requests(server, tmp_path):
    base, jobs = server
    st, r = _post(base, "/v1/sim/jobs",
                  '{"ckpt_dir": "unused", "bogus": 1}')
    assert st == 400 and "bogus" in r["error"]
    st, r = _get(base, "/v1/sim/jobs/job-9999")
    assert st == 404
    st, r = _get(base, "/v1/nope")
    assert st == 404
    # a failing job (an occupied ckpt_dir without resume) fails, and the
    # server stays alive
    spec = _spec(tmp_path / "occupied", t_steps=10)
    _, r = _post(base, "/v1/sim/jobs", spec.to_json())
    assert jobs.wait(r["job_id"], timeout=300).status == "done"
    _, r = _post(base, "/v1/sim/jobs", spec.to_json())
    j = jobs.wait(r["job_id"], timeout=300)
    assert j.status == "failed" and "resume" in j.error
    # the stream of a job without recording is an explicit 400
    spec3 = _spec(tmp_path / "norec", record=False, t_steps=10)
    _, r = _post(base, "/v1/sim/jobs", spec3.to_json())
    norec_id = r["job_id"]
    jobs.wait(norec_id, timeout=300)
    st, r = _get(base, f"/v1/sim/jobs/{norec_id}/stream")
    assert st == 400 and "record" in r["error"]


def test_unknown_arch_is_explicit():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as ei:
        main(["--arch", "not-a-model"])
    msg = str(ei.value)
    assert "unknown arch" in msg and "sim" in msg and "gemma-2b" in msg


def test_service_entry_points_raise_without_cuda(tmp_path):
    """The job server, its HTTP front and the ensemble state default to
    the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.core import connectivity as tconn
    from repro_torch.core import engine as teng
    from repro_torch.core import grid as tgrid
    from repro_torch.examples import ensemble_service
    from repro_torch.launch.serve import SimJobServer, serve_sim
    lw = tconn.gaussian_law()
    cfg = teng.EngineConfig(decomp=tgrid.TileDecomposition(
        tgrid.ColumnGrid(2, 2, 10), 1, 1, lw.radius), law=lw)
    for call in (lambda: SimJobServer(), lambda: serve_sim(port=0),
                 lambda: teng.init_ensemble_state(cfg, (0, 1)),
                 lambda: ensemble_service.run(str(tmp_path))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
