"""The segmented driver on ranks (``SimDriver(mesh=...)``,
``build_sim_driver(spec, mesh=...)``, ``launch.sim --nproc``) against
the single-device driver on the CPU.

A 2x2 rank job (4 processes) preempted after two segments writes the
single-device driver's checkpoint, leaf for leaf; resumed on 2x2 ranks
it ends with the straight single-device run's checkpoint and spool,
byte for byte; its checkpoint retiles onto 1x2 ranks and onto one
device as the single-device driver's own does; a plastic 2x2 rank job
checkpoints the single-device plastic run's leaves and learns the same
weights.  The jobs' reduced config (``configs.snn``) at 4x4 columns of
20 neurons, segments of 10 steps, recording at a capacity of 1000
events (a retile keeps the spool header's capacity).
"""

import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import SimJobSpec, build_sim_driver

import _torch_ranks as R

REPO = Path(__file__).resolve().parents[1]
BASE = {"grid": 4, "n_per_column": 20, "law": "gaussian",
        "segment_steps": 10, "record": True, "keep": 10,
        "record_cap": 1000}


def spec(ckpt_dir, **kw) -> dict:
    return dict(BASE, ckpt_dir=str(ckpt_dir), **kw)


def single(ckpt_dir, **kw):
    """The single-device driver's run of ``spec(ckpt_dir, **kw)``."""
    s = SimJobSpec(**spec(ckpt_dir, **kw))
    drv = build_sim_driver(s, device="cpu")
    out = drv.run(s.t_steps)
    return drv, out


def leaves(ckpt_dir, step: int) -> dict:
    """Every leaf file of the checkpoint at ``step`` (the manifest's
    meta aside), by name, as a digest."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(d.iterdir()) if f.suffix == ".npy"}


def spool(ckpt_dir) -> dict:
    root = Path(ckpt_dir) / "spool"
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(root.rglob("*")) if f.is_file()}


def rank_jobs(d) -> None:
    """The rank jobs: 4 ranks (2x2), then 2 (1x2)."""
    ops = {4: [
        {"op": "run", "spec": spec(d / "ranks", tiles=(2, 2), t_steps=40,
                                   preempt_after=2)},
        {"op": "copy", "src": str(d / "ranks"), "dst": str(d / "r_1x2")},
        {"op": "copy", "src": str(d / "ranks"), "dst": str(d / "r_dev")},
        {"op": "copy", "src": str(d / "ranks"),
         "dst": str(d / "r_dev_2x2")},
        {"op": "run", "spec": spec(d / "ranks", tiles=(2, 2), t_steps=40,
                                   resume=True)},
        {"op": "run", "spec": spec(d / "r_plastic", tiles=(2, 2),
                                   t_steps=60, plastic=True, record=False,
                                   preempt_after=2)},
        {"op": "run", "spec": spec(d / "r_plastic", tiles=(2, 2),
                                   t_steps=60, plastic=True, record=False,
                                   resume=True),
         "summary": str(d / "r_plastic.json")}],
        2: [{"op": "run", "spec": spec(d / "r_1x2", tiles=(1, 2),
                                       t_steps=40, resume=True,
                                       retile=True)}]}
    job = d / "job.pkl"
    job.write_bytes(pickle.dumps(ops))
    for world in (4, 2):
        tmesh.spawn_ranks(R.driver_worker, world, args=(str(job),),
                          timeout_s=600, store_dir=str(d))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank jobs, beside them the single-device runs, then
    one-device resumes of the ranks' checkpoint."""
    import threading
    d = tmp_path_factory.mktemp("rank_driver")
    failed = []

    def ranks():
        try:
            rank_jobs(d)
        except tmesh.RankFailure as e:
            failed.append(e)
    jobs = threading.Thread(target=ranks)
    jobs.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single(d / "straight", tiles=(2, 2), t_steps=40)
        single(d / "preempted", tiles=(2, 2), t_steps=40, preempt_after=2)
        shutil.copytree(d / "preempted", d / "single_retiled")
        single(d / "single_retiled", tiles=(1, 2), t_steps=40, resume=True,
               retile=True)
        drv, out = single(d / "plastic", tiles=(2, 2), t_steps=60,
                          plastic=True, record=False)
        (d / "plastic.json").write_text(json.dumps(
            drv.plastic_summary(out["state"])))
        jobs.join()
        if failed:
            raise failed[0]
        single(d / "r_dev", tiles=(1, 2), t_steps=40, resume=True,
               retile=True)
        single(d / "r_dev_2x2", tiles=(2, 2), t_steps=40, resume=True)
    finally:
        jobs.join()
        torch.set_num_threads(n)
    return d


def test_rank_checkpoints_are_the_single_device_drivers(runs):
    """Preempted after two segments: the step-20 checkpoint the ranks
    gathered to rank 0 is the single-device driver's, leaf for leaf; so
    is the final one after the resume on ranks."""
    assert leaves(runs / "ranks", 20) == leaves(runs / "preempted", 20)
    assert leaves(runs / "ranks", 40) == leaves(runs / "straight", 40)
    assert len(leaves(runs / "ranks", 40)) > 10


def test_rank_spool_is_the_single_device_spool(runs):
    got, want = spool(runs / "ranks"), spool(runs / "straight")
    assert got == want
    assert sum(len(v) for k, v in got.items() if k.endswith(".spk")) > 0


@pytest.mark.parametrize("run", ["r_1x2", "r_dev"])
def test_rank_checkpoint_retiles_as_the_single_device_one(runs, run):
    """The ranks' 2x2 checkpoint resumed on 1x2 ranks and on one device
    (1x2 tiles) with a retile: the single-device driver's own retile of
    its 2x2 checkpoint, leaves and spool."""
    assert leaves(runs / run, 40) == leaves(runs / "single_retiled", 40)
    assert spool(runs / run) == spool(runs / "single_retiled")


def test_rank_checkpoint_resumes_on_one_device(runs):
    assert leaves(runs / "r_dev_2x2", 40) == leaves(runs / "straight", 40)
    assert spool(runs / "r_dev_2x2") == spool(runs / "straight")


def test_plastic_rank_driver_is_the_single_device_one(runs):
    """A plastic 2x2 rank job preempted and resumed: the single-device
    plastic run's checkpoint leaves and learned-weight digest."""
    assert leaves(runs / "r_plastic", 60) == leaves(runs / "plastic", 60)
    got = json.loads((runs / "r_plastic.json").read_text())
    want = json.loads((runs / "plastic.json").read_text())
    assert got == want and got["w_l1_delta"] > 0


def test_launcher_runs_ranks(tmp_path):
    """``python -m repro_torch.launch.sim --nproc 2`` on the CPU: 2x1
    tiles (the host-mesh shape of two ranks), the single-device 2x1
    run's spool and final checkpoint; a rank that fails (a resume with
    no checkpoint) fails the launcher, non-zero."""
    argv = ["--device", "cpu", "--grid", "4", "--neurons-per-column", "20",
            "--steps", "20", "--segment-steps", "10", "--record",
            "--record-cap", "1000", "--nproc", "2", "--transport", "gloo"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sim", *argv,
         "--ckpt-dir", "ranks", "--metrics-out", "m.json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final_step=20" in proc.stdout
    report = json.loads((tmp_path / "m.json").read_text())
    assert report["tiles"] == [2, 1] and report["ranks"] == 2
    single(tmp_path / "one", tiles=(2, 1), t_steps=20)
    assert leaves(tmp_path / "ranks", 20) == leaves(tmp_path / "one", 20)
    assert spool(tmp_path / "ranks") == spool(tmp_path / "one")
    from repro_torch.launch import sim
    with pytest.raises(SystemExit, match="a rank failed"):
        sim.main(argv + ["--ckpt-dir", str(tmp_path / "empty"),
                         "--resume"])
