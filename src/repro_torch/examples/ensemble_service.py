"""Ensemble simulation service, end to end, on one device.

The port's counterpart of the reference's ``examples/ensemble_service.py``.
One script proves the service contract:

1. a **solo reference** run (state seed = member 0's seed) spools its
   spikes to disk;
2. a job server comes up on loopback; a 3-seed **ensemble job** is
   POSTed as a typed ``SimJobSpec`` and runs through one sim function;
3. while it runs, **two concurrent clients** stream the per-member spike
   deltas through the cursor endpoint at different paces -- both must end
   with every spooled event exactly once;
4. a second job with different seeds reuses the server's sim function
   (the cache's size stays 1);
5. ``launch.analyze`` stitches per-member activity reports;
6. member 0's spool shards are **byte-identical** to the solo reference:
   the ensemble axis is batching, not a new model.

Run (defaults: the reference's 4x4 columns of 20 neurons, one tile, on
the card)::

    PYTHONPATH=src python -m repro_torch.examples.ensemble_service \\
        [--device cpu] [--grid G --neurons-per-column N] [--tiles 2x2] \\
        [--out results/ensemble_smoke.json]

A segment of at least ``2 * d_ring`` (16) steps lets a job on the card
capture its CUDA graph (``--segment-steps``); the reference's 15 steps
run eagerly.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import urllib.parse
import urllib.request

GRID, NPC, LAW = 4, 20, "exponential"
SEEDS = (0, 1, 2)
T_STEPS, SEG = 60, 15


def spk_digests(spool_dir: str) -> dict:
    """sha256 of every ``.spk`` log under ``spool_dir``, by relative path."""
    out = {}
    for root, _, files in os.walk(spool_dir):
        for fn in sorted(files):
            if fn.endswith(".spk"):
                rel = os.path.relpath(os.path.join(root, fn), spool_dir)
                with open(os.path.join(root, fn), "rb") as f:
                    out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path) as r:
        return json.loads(r.read())


def post(base: str, path: str, payload: str) -> dict:
    req = urllib.request.Request(base + path, data=payload.encode(),
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def stream_until_done(base: str, job_id: str, pause: float, results: dict,
                      name: str) -> None:
    """Poll the job's stream with a cursor until the job is done; record
    the events seen, per member, and the polls."""
    cursor, total, polls = None, 0, 0
    per_member: dict = {}
    while True:
        q = "" if cursor is None else \
            "?cursor=" + urllib.parse.quote(json.dumps(cursor))
        r = get(base, f"/v1/sim/jobs/{job_id}/stream{q}")
        cursor = r["cursor"]
        for member, g in r["streams"].items():
            per_member[member] = per_member.get(member, 0) + g["n_new"]
            total += g["n_new"]
        polls += 1
        if r["done"]:
            break
        time.sleep(pause)
    results[name] = {"total": total, "polls": polls,
                     "per_member": per_member}


def run(workdir: str, device="cuda", grid: int = GRID, npc: int = NPC,
        tiles=None, t_steps: int = T_STEPS, seg: int = SEG,
        report_path: str = "ensemble_analysis.json") -> dict:
    """Steps 1-6 under ``workdir``; raises AssertionError on a broken
    contract.  Returns the summary, with each job's result."""
    from ..launch.analyze import main as analyze_main
    from ..launch.serve import serve_sim
    from ..runtime import SimJobSpec, build_sim_driver

    common = dict(grid=grid, n_per_column=npc, law=LAW, tiles=tiles,
                  segment_steps=seg, record=True)

    # 1. solo reference: a plain run whose dynamics seed is member 0's
    solo = build_sim_driver(SimJobSpec(
        ckpt_dir=os.path.join(workdir, "solo"), state_seed=SEEDS[0],
        t_steps=t_steps, **common), device=device)
    solo.run(t_steps)
    solo_digest = spk_digests(solo.spool.directory)

    # 2. the service: POST the ensemble job
    httpd, jobs = serve_sim(port=0, device=device)
    try:
        host, port = httpd.server_address[:2]
        base = f"http://{host}:{port}"
        ens_dir = os.path.join(workdir, "ens")
        spec = SimJobSpec(ckpt_dir=ens_dir, seeds=SEEDS, t_steps=t_steps,
                          **common)
        job_id = post(base, "/v1/sim/jobs", spec.to_json())["job_id"]

        # 3. two concurrent cursor-streaming clients at different paces
        results: dict = {}
        clients = [threading.Thread(target=stream_until_done,
                                    args=(base, job_id, pause, results,
                                          name))
                   for name, pause in (("fast", 0.05), ("slow", 0.4))]
        for c in clients:
            c.start()
        job = jobs.wait(job_id, timeout=600)
        for c in clients:
            c.join(timeout=120)
        assert job.status == "done", job.error
        res = job.result
        assert res["final_step"] == t_steps, res
        assert res["members"] == len(SEEDS), res
        assert res["compiled_steps"] == 1, res
        spooled = res["spooled_events"]
        assert spooled > 0
        for name in ("fast", "slow"):
            assert results[name]["total"] == spooled, (name, results,
                                                       spooled)
            assert len(results[name]["per_member"]) == len(SEEDS)

        # 4. a different-seeds job shares the server's sim function
        spec2 = SimJobSpec(ckpt_dir=os.path.join(workdir, "ens2"),
                           seeds=(7, 8, 9), t_steps=t_steps, **common)
        job2 = jobs.wait(post(base, "/v1/sim/jobs",
                              spec2.to_json())["job_id"], timeout=600)
        assert job2.status == "done", job2.error
        assert jobs.compiled_steps() == 1, jobs.compiled_steps()
    finally:
        httpd.shutdown()
        jobs.shutdown()

    # 5. stitched per-member analyze reports
    payload = analyze_main(["--run", f"ens={ens_dir}",
                            "--out", report_path])
    labels = sorted(payload["runs"])
    assert labels == [f"ens/member_{m:03d}" for m in range(len(SEEDS))]
    assert all(r["t_steps"] == t_steps for r in payload["runs"].values())
    assert "comparison" in payload

    # 6. member 0's spool == the solo reference, byte for byte
    ens_digest = spk_digests(os.path.join(ens_dir, "spool"))
    member0 = {rel.split(os.sep, 1)[1]: h for rel, h in ens_digest.items()
               if rel.startswith("member_000" + os.sep)}
    assert member0 == solo_digest, (member0, solo_digest)

    return {
        "seeds": list(SEEDS), "t_steps": t_steps, "segment_steps": seg,
        "grid": [grid, grid, npc], "tiles": list(tiles or (1, 1)),
        "spooled_events": spooled, "clients": results,
        "compiled_steps": res["compiled_steps"],
        "server_compiled_steps_after_2_jobs": jobs.compiled_steps(),
        "member0_matches_solo": True, "member_reports": labels,
        "rate_hz": res["rate_hz"], "jobs": [res, job2.result],
    }


def main(argv=None) -> dict:
    from ..launch.sim import parse_tiles
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("results",
                                                  "ensemble_smoke.json"))
    ap.add_argument("--workdir", default=None,
                    help="run/checkpoint directory (default: a fresh "
                         "temp dir, removed on success)")
    ap.add_argument("--device", default="cuda",
                    help="where the runs live (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--neurons-per-column", type=int, default=NPC)
    ap.add_argument("--tiles", default=None,
                    help="TYxTX tiling, every tile on the one device "
                         "(default 1x1)")
    ap.add_argument("--steps", type=int, default=T_STEPS)
    ap.add_argument("--segment-steps", type=int, default=SEG)
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix="ensemble_smoke_")
    os.makedirs(work, exist_ok=True)
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    summary = run(work, device=args.device, grid=args.grid,
                  npc=args.neurons_per_column,
                  tiles=parse_tiles(args.tiles), t_steps=args.steps,
                  seg=args.segment_steps,
                  report_path=os.path.join(out_dir,
                                           "ensemble_analysis.json"))
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"ensemble service smoke OK: {summary['spooled_events']} events, "
          f"{len(SEEDS)} members, 1 sim function, 2 clients -> "
          f"{args.out}")
    if args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return summary


if __name__ == "__main__":
    main()
