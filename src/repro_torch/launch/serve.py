"""Serving launcher: LM batch serving on one card or on the ranks of a
process group, *and* the simulation job service (the port of
``repro.launch.serve``).

Two arch families behind one entry point:

* ``--arch <model>`` (any of ``configs.ARCH_NAMES``: the dense qwen2 /
  qwen3 / gemma models, granite-moe-1b-a400m, kimi-k2-1t-a32b,
  falcon-mamba-7b, recurrentgemma-9b, whisper-small, internvl2-26b): a
  batched prefill, then greedy decode, of the architecture's reduced
  configuration::

      PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
          --batch 4 --prompt-len 32 --gen 16

  ``--nproc N`` serves it on N rank processes (``launch.mesh.
  spawn_ranks``; the host-mesh shape for N, or ``--mesh DxM``), each
  with its blocks, its batch slice and its slots of every KV cache
  (``serve_batch(mesh=)``); ``--transport gloo`` (the default) lets the
  ranks share a card::

      PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
          --nproc 4 --device cpu

* ``--arch sim``: a long-lived **simulation job server**.  Clients POST
  typed :class:`~repro_torch.runtime.SimJobSpec` JSON; one worker thread
  owns the card and runs the queue in order, and every job it builds
  shares one ``sim_cache``, so jobs that differ only in seeds reuse one
  sim function (``sim_fingerprint`` normalizes them out)::

      PYTHONPATH=src python -m repro_torch.launch.serve --arch sim \\
          --port 8321

  Endpoints (JSON over HTTP, loopback by default), the reference's:

  ``POST /v1/sim/jobs``
      Body: ``SimJobSpec`` JSON.  Returns ``{"job_id", "status"}``.
      A malformed spec or an unknown field is a 400 with the
      validation error.
  ``GET /v1/sim/jobs``
      All jobs, in queue order.
  ``GET /v1/sim/jobs/<id>``
      One job: status (``queued|running|done|failed``), spec, result
      (final step, rate, totals, per-member plastic digests, the sim
      cache's size, the job's CUDA graph captures, wall times) or error.
  ``GET /v1/sim/jobs/<id>/stream[?cursor=<json>]``
      The spike records appended to the job's spool since ``cursor``
      (the per-log record offsets the previous call returned), grouped
      per ensemble member and step-ordered.  Each client owns its
      cursor, so any number of clients stream at their own pace.
      Returns ``{"streams", "cursor", "status", "done"}``.

The handler threads do no CUDA work: they read spool files only (the
append-only, whole-record logs are safe to read while the worker writes
them).  The worker thread sets the device and runs every simulation; a
CUDA graph is captured in a mode that ignores other threads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCH_NAMES, get_reduced
from ..kernels import _build
from ..models.config import ModelConfig
from ..models.frontends import STUB_WIDTH
from ..models.layers import torch_dtype
from ..models.model import make_prefill, make_serve_step
from ..models.transformer import init_decode_state, init_model
from ..parallel.sharding import rules_for_mesh
from ..obs.telemetry import NULL, Telemetry
from ..runtime.jobs import JobError, SimJobSpec


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --------------------------------------------------------------------------
# LM serving path
# --------------------------------------------------------------------------

def serve_rules(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The rules ``serve_batch`` serves ``cfg`` under on ``mesh``: the
    reference's ``serve_batch`` overrides (``heads``, ``mlp`` and
    ``experts`` whole where they do not divide over the ``model`` axis,
    ``kv_seq`` whole when the state's ``max_len`` does not, ``batch``
    whole when ``batch`` does not divide over the data ranks), its dry
    run's for ``d_inner`` and ``vocab``, and ``fsdp = None``: a rank
    holds its ``model``-axis blocks whole along ``data``."""
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model = axes.get("model", 1)
    ov = {"fsdp": None}
    if cfg.n_heads % model:
        ov["heads"] = None
    if cfg.d_ff % model or not cfg.d_ff:
        ov["mlp"] = None
    if cfg.n_experts and cfg.n_experts % model:
        ov["experts"] = None
    if max_len % model:
        ov["kv_seq"] = None
    if batch % (axes.get("data", 1) * axes.get("pod", 1)):
        ov["batch"] = None
    if cfg.d_inner % model or cfg.resolved_rglru_width % model:
        ov["d_inner"] = None
    if cfg.padded_vocab % model:
        ov["vocab"] = None
    return rules_for_mesh(mesh, **ov)


def serve_inputs(cfg: ModelConfig, batch: int, prompt_len: int,
                 seed: int = 0, device="cuda") -> dict:
    """The inputs ``serve_batch`` serves, drawn as the reference draws
    them from numpy ``default_rng(seed)``: ``tokens`` (batch,
    prompt_len) int32, then whisper's ``frames`` (batch, encoder_seq,
    STUB_WIDTH), then a VLM's ``patch_embeds`` (batch, n_patches,
    STUB_WIDTH), normal, in the config's dtype; on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    out = {"tokens": torch.from_numpy(prompts).to(dev)}
    for key, n in (("frames", cfg.encoder_seq),
                   ("patch_embeds", cfg.n_patches)):
        if n:
            out[key] = torch.from_numpy(rng.standard_normal(
                (batch, n, STUB_WIDTH))).to(dev, torch_dtype(cfg.dtype))
    return out


def serve_batch(arch: str, batch: int, prompt_len: int, gen: int,
                seed: int = 0, greedy: bool = True, device="cuda",
                cfg: Optional[ModelConfig] = None, mesh=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens greedily.  The inputs are ``serve_inputs``:
    the prompts, then whisper's frames, then a VLM's patch embeddings,
    drawn as the reference draws them.  A VLM's patches prefix the
    prompt: its state holds
    ``n_patches + prompt_len + gen`` positions and step ``i`` decodes at
    ``n_patches + prompt_len + i`` (the reference sizes and places its
    decode without the prefix).  Parameters come from ``init_model``
    seeded with ``seed``.  ``cfg``: the configuration served (default
    the architecture's reduced one, as the reference serves).  Returns
    ``tokens`` ((batch, gen) int32 numpy), ``prefill_s``,
    ``decode_s_per_token`` (host clock, CUDA-synchronised), ``config``
    (the config's name) and the kernels launched in each stage
    (``prefill_launches``, ``decode_launches``: name -> count).

    ``mesh``: a ``launch.mesh.RankMesh`` with its collectives
    (``parallel.collectives.attach``); every rank of it calls
    ``serve_batch`` alike.  Each rank draws the whole inputs and takes
    its batch slice (``data.pipeline.rank_batch``), holds its blocks of
    the parameters (``init_model(..., rules=)``) and of the decode state
    under ``serve_rules``, and every rank returns the whole ``tokens``
    (gathered over the batch axes).  ``prefill_s`` and
    ``decode_s_per_token`` are the slowest rank's; ``collectives`` holds
    this rank's per-channel counts of each stage.  Placement: the
    reference's ``serve_batch`` hands its jitted steps whole parameters,
    and FSDP over ``data`` would gather every layer's parameters through
    the host-staged transport at every decode step, so serving leaves
    ``fsdp`` whole (``serve_rules``)."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is implemented "
                                  "(the reference decodes greedily too)")
    dev = resolve_device(device)
    cfg = cfg or get_reduced(arch)
    start = cfg.n_patches + prompt_len
    rules = None if mesh is None else serve_rules(cfg, mesh, batch,
                                                  start + gen)
    params = init_model(cfg, seed=seed, device=dev, rules=rules)
    batch_in = serve_inputs(cfg, batch, prompt_len, seed, dev)
    if rules is not None:
        from ..data.pipeline import rank_batch
        batch_in = rank_batch(batch_in, rules)
    state = init_decode_state(cfg, batch, start + gen, device=dev,
                              rules=rules)
    prefill, serve_step = make_prefill(cfg, rules), make_serve_step(cfg,
                                                                    rules)
    comm = None if mesh is None else mesh.comm

    _sync(dev)
    if comm is not None:
        comm.reset_stats()
    before = _build.launch_counts()
    t0 = time.perf_counter()
    logits, state = prefill(params, batch_in, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_launches = _build.launches_since(before)
    stats = {}
    if comm is not None:
        stats["prefill"] = comm.stats
        comm.reset_stats()
    before = _build.launch_counts()

    toks = []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(gen):
        toks.append(tok)
        logits, state = serve_step(params, state, tok, start + i)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    decode_launches = _build.launches_since(before)
    out = (torch.cat(toks, dim=1) if toks
           else torch.zeros((batch_in["tokens"].shape[0], 0),
                            dtype=torch.int32, device=dev))
    res = {"prefill_s": t_prefill,
           "decode_s_per_token": t_decode / gen if gen else 0.0}
    if comm is not None:
        from ..parallel.collectives import (all_gather_plain,
                                            all_reduce_plain)
        stats["decode"] = comm.stats
        comm.reset_stats()
        out = all_gather_plain(out, mesh, rules.batch, 0, "serve")
        slowest = all_reduce_plain(torch.tensor(
            [t_prefill, res["decode_s_per_token"]], dtype=torch.float64,
            device=dev), mesh, mesh.axis_names, op="max", channel="serve")
        res = {"prefill_s": float(slowest[0]),
               "decode_s_per_token": float(slowest[1]),
               "collectives": stats}
    return {
        "tokens": out.cpu().numpy(),
        **res,
        "config": cfg.name,
        "prefill_launches": prefill_launches,
        "decode_launches": decode_launches,
    }


# --------------------------------------------------------------------------
# Simulation job service
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SimJob:
    """One queued, running or finished job: the spec and its lifecycle."""
    job_id: str
    spec: SimJobSpec
    status: str = "queued"        # queued -> running -> done | failed
    error: Optional[str] = None
    result: Optional[dict] = None

    def public(self) -> dict:
        return {"job_id": self.job_id, "status": self.status,
                "spec": self.spec.job_meta(), "error": self.error,
                "result": self.result}


class SimJobServer:
    """A queue of :class:`SimJobSpec` jobs on one device.

    One worker thread owns the device and runs jobs in submission order;
    ``sim_cache`` is shared by every job it builds, so jobs whose sim
    function is the same (same grid, law, tiling and ensemble width, any
    seeds: ``sim_fingerprint``) reuse one.  ``compiled_steps()`` is the
    cache's size.  Each job still captures its own CUDA graph once on
    the card: a graph holds its job's state tensors.
    """

    def __init__(self, device="cuda", telemetry: Telemetry = NULL):
        self.device = dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the caller's current card: the worker thread selects it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.tel = telemetry
        self.sim_cache: dict = {}
        self._jobs: Dict[str, SimJob] = {}
        self._order: list = []
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.Lock()
        self._n = 0
        self._worker = threading.Thread(target=self._run_jobs,
                                        name="sim-job-worker", daemon=True)
        self._worker.start()

    # ---- submission and introspection (any thread) --------------------
    def submit(self, spec: SimJobSpec) -> str:
        with self._lock:
            self._n += 1
            job_id = f"job-{self._n:04d}"
            self._jobs[job_id] = SimJob(job_id, spec)
            self._order.append(job_id)
        self._queue.put(job_id)
        return job_id

    def job(self, job_id: str) -> Optional[SimJob]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self):
        with self._lock:
            return [self._jobs[j] for j in self._order]

    def compiled_steps(self) -> int:
        """Sim functions in the shared cache."""
        return len(self.sim_cache)

    def wait(self, job_id: str, timeout: float = 600.0) -> SimJob:
        """Block until a job leaves the queued and running states."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            j = self.job(job_id)
            if j is None:
                raise KeyError(job_id)
            if j.status in ("done", "failed"):
                return j
            time.sleep(0.05)
        raise TimeoutError(f"{job_id} still {self.job(job_id).status} "
                           f"after {timeout}s")

    def shutdown(self):
        self._queue.put(None)
        self._worker.join(timeout=60)

    # ---- the worker thread: owns the device and all its work ----------
    def _run_jobs(self):
        from ..runtime.jobs import build_sim_driver
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            job_id = self._queue.get()
            if job_id is None:
                return
            job = self.job(job_id)
            job.status = "running"
            try:
                t0 = time.perf_counter()
                driver = build_sim_driver(job.spec, device=self.device,
                                          telemetry=self.tel,
                                          sim_cache=self.sim_cache)
                t1 = time.perf_counter()
                out = driver.run(job.spec.t_steps)
                _sync(self.device)
                wall = {"build_s": t1 - t0,
                        "run_s": time.perf_counter() - t1,
                        "drain_s": driver.drain_s}
                job.result = self._summarize(driver, out, wall)
                job.status = "done"
            except Exception as e:           # a bad job must not kill
                job.error = f"{type(e).__name__}: {e}"   # the server
                job.status = "failed"

    def _summarize(self, driver, out, wall: dict) -> dict:
        state = out["state"]
        res = {
            "final_step": int(np.max(state["t"])),
            "preempted": bool(out["preempted"]),
            "rate_hz": float(driver.firing_rate_hz(state)),
            "totals": driver.metric_totals(state),
            "n_synapses": int(driver.table_stats["n_synapses"]),
            "members": driver.n_members,
            "compiled_steps": driver.compiled_step_cache_size(),
            "server_compiled_steps": self.compiled_steps(),
            "captures": driver.captures(),
            "wall": wall,
        }
        if driver.spool is not None:
            res["spool_dir"] = driver.spool.directory
            res["spooled_events"] = sum(driver.spool.offsets().values())
        if driver.plastic:
            if driver.n_members is None:
                res["plastic"] = driver.plastic_summary(state)
            else:
                res["plastic_members"] = [
                    driver.plastic_summary(state, member=m)
                    for m in range(driver.n_members)]
        return res

    # ---- streaming read side (HTTP handler threads) -------------------
    def stream(self, job_id: str,
               cursor: Optional[Dict[str, int]] = None) -> dict:
        """Spool records appended since ``cursor``, grouped per member.

        File reads only, no lock against the worker: the logs are
        append-only and ``read_new_events`` reads whole records below
        the current file size.
        """
        from ..obs.spool import read_new_events
        job = self.job(job_id)
        if job is None:
            raise KeyError(job_id)
        if not job.spec.record:
            raise JobError(f"{job_id} was submitted with record=false; "
                           "there is no spike stream to read")
        try:
            new, new_cursor = read_new_events(job.spec.ckpt_dir, cursor)
        except FileNotFoundError:
            # a queued job whose spool does not exist yet: no delta
            new, new_cursor = {}, dict(cursor or {})
        streams: Dict[str, dict] = {}
        for rel, arr in new.items():
            member = rel.split("/", 1)[0] if "/" in rel else "solo"
            g = streams.setdefault(member, {"step": [], "gid": []})
            g["step"].append(arr["step"])
            g["gid"].append(arr["gid"])
        for member, g in streams.items():
            step = np.concatenate(g["step"])
            gid = np.concatenate(g["gid"])
            order = np.lexsort((gid, step))
            streams[member] = {"step": step[order].tolist(),
                               "gid": gid[order].tolist(),
                               "n_new": int(step.size)}
        return {"job_id": job_id, "status": job.status,
                "done": job.status in ("done", "failed"),
                "streams": streams, "cursor": new_cursor}


def _make_handler(server: SimJobServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):        # quiet; telemetry has spans
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/v1/sim/jobs":
                return self._send(404, {"error": f"no route {url.path}"})
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n).decode()
            try:
                spec = SimJobSpec.from_json(raw)
            except (ValueError, TypeError) as e:
                return self._send(400, {"error": str(e)})
            job_id = server.submit(spec)
            self._send(200, {"job_id": job_id, "status": "queued"})

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if parts[:3] != ["v1", "sim", "jobs"]:
                return self._send(404, {"error": f"no route {url.path}"})
            if len(parts) == 3:
                return self._send(200, {"jobs": [j.public()
                                                 for j in server.jobs()]})
            job_id = parts[3]
            if server.job(job_id) is None:
                return self._send(404, {"error": f"unknown job {job_id}"})
            if len(parts) == 4:
                return self._send(200, server.job(job_id).public())
            if len(parts) == 5 and parts[4] == "stream":
                q = urllib.parse.parse_qs(url.query)
                cursor = None
                if "cursor" in q:
                    try:
                        cursor = json.loads(q["cursor"][0])
                    except ValueError as e:
                        return self._send(400, {"error": f"cursor: {e}"})
                try:
                    return self._send(200, server.stream(job_id, cursor))
                except JobError as e:
                    return self._send(400, {"error": str(e)})
            self._send(404, {"error": f"no route {url.path}"})

    return Handler


def serve_sim(host: str = "127.0.0.1", port: int = 0, device="cuda",
              telemetry: Telemetry = NULL):
    """Start the job server and its HTTP front.  Returns ``(httpd,
    jobs)``; the HTTP server runs on a daemon thread, ``httpd.shutdown()``
    then ``jobs.shutdown()`` stops both."""
    jobs = SimJobServer(device=device, telemetry=telemetry)
    httpd = ThreadingHTTPServer((host, port), _make_handler(jobs))
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, name="sim-http",
                         daemon=True)
    t.start()
    return httpd, jobs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b",
                    help="'sim' for the simulation job server, or an "
                         "LM arch name")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --arch sim (loopback only "
                         "by default; the service is unauthenticated)")
    ap.add_argument("--port", type=int, default=8321,
                    help="port for --arch sim (0 picks a free one)")
    ap.add_argument("--device", default="cuda",
                    help="where the models or simulations run (default "
                         "cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--nproc", type=int, default=0,
                    help="LM rank processes (0: this process, no mesh)")
    ap.add_argument("--mesh", default=None,
                    help="DxM ranks on (data, model) (default: the "
                         "host-mesh shape of --nproc)")
    ap.add_argument("--transport", default="gloo",
                    choices=("gloo", "nccl"))
    args = ap.parse_args(argv)

    choices = ("sim",) + tuple(ARCH_NAMES)
    if args.arch == "sim":
        httpd, jobs = serve_sim(args.host, args.port, device=args.device)
        host, port = httpd.server_address[:2]
        print(f"sim job server on http://{host}:{port} "
              f"(POST /v1/sim/jobs)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            httpd.shutdown()
            jobs.shutdown()
        return
    if args.arch not in ARCH_NAMES:
        raise SystemExit(
            f"--arch {args.arch!r}: unknown arch; choices: "
            + ", ".join(choices))
    if args.nproc:
        from .mesh import spawn_ranks
        spawn_ranks(_serve_rank_main, args.nproc, args=(vars(args),),
                    backend=args.transport)
        return
    _report(serve_batch(args.arch, args.batch, args.prompt_len, args.gen,
                        device=args.device))


def _report(out: dict) -> None:
    print(f"{out['config']}: prefill {out['prefill_s']*1e3:.1f} ms, "
          f"decode {out['decode_s_per_token']*1e3:.2f} ms/token, "
          f"generated shape {out['tokens'].shape}")


def _serve_rank_main(rank: int, world: int, args: dict) -> None:
    """One rank of ``--nproc``: its mesh and collectives, then
    ``serve_batch(mesh=)``; rank 0 reports (the slowest rank's times)
    and the collectives of each stage."""
    from ..core.halo import Transport
    from ..parallel.collectives import attach
    from .mesh import make_host_mesh
    dims = None if args["mesh"] is None else tuple(
        int(v) for v in args["mesh"].lower().split("x"))
    dev = args["device"]
    if dev == "cuda":
        dev = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(dev)
    mesh = attach(make_host_mesh(dims), Transport(args["transport"], dev))
    out = serve_batch(args["arch"], args["batch"], args["prompt_len"],
                      args["gen"], device=dev, mesh=mesh)
    if rank == 0:
        _report(out)
        for stage, chans in out["collectives"].items():
            print(f"{stage} collectives (rank 0): " + json.dumps(chans))


if __name__ == "__main__":
    main()
