"""The port's package rules: it imports neither jax nor the JAX package,
its entry points default to CUDA and raise rather than fall back when
CUDA is missing, and repro-lint finds nothing in it."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import engine as teng
from repro_torch.core.convert import state_from_arrays, tables_from_arrays
from repro_torch.kernels import _build

from _torch_parity import configs

PORT = Path(repro_torch.__file__).resolve().parent
SRC = PORT.parent
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_rank_lm_modules_are_imported_and_checked():
    """The LM-on-ranks modules are among those that the import and the
    source checks cover."""
    for m in ("repro_torch.parallel", "repro_torch.parallel.sharding",
              "repro_torch.parallel.collectives",
              "repro_torch.optim.compression"):
        assert m in MODULES
        importlib.import_module(m)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_source_names_no_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path}: imports {n}"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    _, tcfg = configs("gaussian", grid=2, n_per_col=10)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        teng.init_sim_state(tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.build_shard_tables(tcfg)
    tabs = teng.build_shard_tables(tcfg, device="cpu")
    state = teng.init_sim_state(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        teng.simulate(state, tabs, tcfg, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.simulate(state, tabs, tcfg, 2, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tables_from_arrays({}, [], tabs.storage.meta())
    with pytest.raises(RuntimeError, match="cuda"):
        state_from_arrays({}, tcfg)


def test_resolve_device_and_routing_rules():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        repro_torch.resolve_device("meta")
    assert _build.on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        _build.on_cuda(torch.zeros(1, device="meta"))


def test_launch_counters_and_build_paths():
    _build.reset_launch_counts()
    _build.count_launch("lif_step")
    _build.count_launch("lif_step")
    assert _build.launch_counts() == {"lif_step": 2}
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build._lib_path(name).parent == _build.build_dir()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_cpu_run_launches_no_kernel():
    """On CPU tensors the wrappers take the plain versions: no launch is
    counted, and nothing is compiled."""
    _, tcfg = configs("gaussian", grid=2, n_per_col=10)
    _build.reset_launch_counts()
    teng.simulate(teng.init_sim_state(tcfg, device="cpu"),
                  teng.build_shard_tables(tcfg, device="cpu"), tcfg, 3,
                  device="cpu")
    assert _build.launch_counts() == {}


def test_repro_lint_clean_on_port():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.lint", str(PORT)],
        capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _public_callables():
    """Every public function of the port, and every public method of its
    public classes, defined in the port's own modules."""
    for name in MODULES:
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", "") != name:
                continue
            if inspect.isfunction(obj):
                yield f"{name}.{attr}", obj
            elif inspect.isclass(obj):
                for meth, fn in vars(obj).items():
                    if not meth.startswith("_") and inspect.isfunction(fn):
                        yield f"{name}.{attr}.{meth}", fn


def test_device_parameters_default_to_cuda():
    """Every public function of the port with a ``device`` parameter
    defaults it to ``"cuda"`` (or leaves it required): nothing defaults
    to the CPU."""
    checked, wrong = 0, []
    for qual, fn in _public_callables():
        param = inspect.signature(fn).parameters.get("device")
        if param is None:
            continue
        checked += 1
        if param.default is not inspect.Parameter.empty \
                and param.default != "cuda":
            wrong.append(f"{qual}: device={param.default!r}")
    assert not wrong, wrong
    assert checked >= 20, checked


def test_package_rules_cover_the_lm_modules():
    """The import, source-name and lint checks above walk every module of
    the port, the LM serving slice's included."""
    lm = {"repro_torch.models.config", "repro_torch.models.layers",
          "repro_torch.models.attention", "repro_torch.models.transformer",
          "repro_torch.models.model", "repro_torch.configs.qwen2_1_5b",
          "repro_torch.configs.gemma_2b", "repro_torch.launch.serve",
          "repro_torch.kernels.flash_attention"}
    assert lm <= set(MODULES), lm - set(MODULES)
    assert (_build.CSRC / "flash_attention_sm90.cu").exists()


def test_package_rules_cover_the_training_modules():
    """The import, source-name and lint checks above walk the LM
    training slice's modules too."""
    train = {"repro_torch.optim.optimizers", "repro_torch.optim.schedules",
             "repro_torch.data.pipeline", "repro_torch.launch.train",
             "repro_torch.configs.qwen2_5_3b", "repro_torch.configs.qwen3_8b",
             "repro_torch.examples.train_lm",
             "repro_torch.examples.fault_tolerance_demo"}
    assert train <= set(MODULES), train - set(MODULES)


def test_package_rules_cover_the_multishard_modules():
    """The import, source-name and lint checks above walk the
    multi-shard engine's modules too."""
    ms = {"repro_torch.core.halo", "repro_torch.core.dist_engine",
          "repro_torch.core.metrics"}
    assert ms <= set(MODULES), ms - set(MODULES)


def test_multishard_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    import dataclasses
    from repro_torch.core import dist_engine as tde
    from repro_torch.core import metrics as tmetrics
    _, tcfg = configs("gaussian", grid=2, n_per_col=10)
    cfg = tde.DistConfig(engine=dataclasses.replace(
        tcfg, decomp=dataclasses.replace(tcfg.decomp, tiles_y=2)))
    for call in (lambda: tde.init_dist_state(cfg),
                 lambda: tde.build_dist_tables(cfg),
                 lambda: tde.make_sim_fn(cfg, 2),
                 lambda: tde.simulate(cfg, 2),
                 lambda: tde.band_gather_maps(cfg, 10),
                 lambda: tmetrics.time_fn(lambda: None)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    tables, _ = tde.build_dist_tables(cfg, device="cpu")
    sim = tde.make_sim_fn(cfg, 2, storage=tables.storage, device="cpu")
    with pytest.raises(ValueError, match="device"):
        sim(tde.init_dist_state(cfg, device="cpu"),
            tde.SimInputs(tables=tables.to("meta")))


def test_package_rules_cover_the_segmented_run_modules():
    """The import, source-name and lint checks above walk the segmented
    run's modules too: checkpoints, runtime, telemetry, spool, analysis,
    retile, trace export and the launchers."""
    seg = {"repro_torch.checkpoint.store", "repro_torch.runtime.driver",
           "repro_torch.runtime.sim_driver", "repro_torch.runtime.jobs",
           "repro_torch.obs.telemetry", "repro_torch.obs.spool",
           "repro_torch.obs.analysis", "repro_torch.core.retile",
           "repro_torch.perf.trace", "repro_torch.launch.sim",
           "repro_torch.launch.analyze"}
    assert seg <= set(MODULES), seg - set(MODULES)


def test_segmented_run_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    import dataclasses
    from repro_torch.core import dist_engine as tde
    from repro_torch.launch import sim
    from repro_torch.runtime import (DriverConfig, SimDriver, SimJobSpec,
                                     TrainDriver, build_sim_driver)
    _, tcfg = configs("gaussian", grid=2, n_per_col=10)
    cfg = tde.DistConfig(engine=dataclasses.replace(
        tcfg, decomp=dataclasses.replace(tcfg.decomp, tiles_y=2)))
    dcfg = DriverConfig(ckpt_dir=str(tmp_path / "d"), handle_sigterm=False)
    spec = SimJobSpec(ckpt_dir=str(tmp_path / "j"), grid=2,
                      n_per_column=10)
    for call in (lambda: tde.state_like(cfg),
                 lambda: SimDriver(dcfg, cfg, "cuda", segment_steps=2),
                 lambda: build_sim_driver(spec),
                 lambda: TrainDriver(dcfg, lambda s, b: (s, {}),
                                     lambda step: None, lambda: {}),
                 lambda: sim.main(["--grid", "2", "--neurons-per-column",
                                   "10", "--ckpt-dir",
                                   str(tmp_path / "c")])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
