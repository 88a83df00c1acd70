"""The port's last three examples (``repro_torch.examples.quickstart``,
``serve_lm``, ``snn_simulation``) on the CPU at tiny sizes: each imports
without side effects, defaults to the card and raises without one;
quickstart's SNN half builds the reference's synapses at 6x6x50 and fires
within ``rel=0.35`` of the reference's rate (the drives differ:
``jax.random.poisson`` cannot be reproduced; ``tests/test_multidevice.py``'s
tolerance); serve_lm serves a reduced config end to end; snn_simulation
prints both laws and moves plastic weights."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch import configs as tconfigs
from repro_torch.examples import quickstart, serve_lm, snn_simulation
from repro_torch.kernels import _build

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = ("quickstart", "serve_lm", "snn_simulation")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_without_side_effects(name):
    """Importing the module prints nothing, starts nothing, and leaves
    ``main(argv=None)`` with a ``--device`` that defaults to the card."""
    code = ("import threading\n"
            f"import repro_torch.examples.{name} as m\n"
            "assert threading.active_count() == 1\n"
            "import inspect, sys\n"
            "assert list(inspect.signature(m.main).parameters) == ['argv']\n"
            "assert not any(x == 'jax' or x.startswith(('jax.', 'repro.'))\n"
            "               for x in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""
    mod = {"quickstart": quickstart, "serve_lm": serve_lm,
           "snn_simulation": snn_simulation}[name]
    assert 'ap.add_argument("--device", default="cuda")' in \
        inspect.getsource(mod)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    mod = {"quickstart": quickstart, "serve_lm": serve_lm,
           "snn_simulation": snn_simulation}[name]
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


def test_quickstart_snn_half_matches_the_reference():
    """6x6x50, both laws, 200 steps: the reference's synapse count
    exactly, and its rate within rel=0.35."""
    port = quickstart.snn_half(device="cpu")
    from repro.core import ColumnGrid, TileDecomposition
    from repro.core import exponential_law, gaussian_law
    for law in (gaussian_law(), exponential_law()):
        dec = TileDecomposition(grid=ColumnGrid(quickstart.SNN_GRID,
                                                quickstart.SNN_GRID,
                                                quickstart.SNN_NEURONS),
                                tiles_y=1, tiles_x=1, radius=law.radius)
        cfg = jeng.EngineConfig(decomp=dec, law=law)
        tabs = jeng.build_shard_tables(cfg)
        state, _ = jax.jit(lambda s: jeng.simulate(
            s, tabs, cfg, quickstart.SNN_STEPS))(jeng.init_sim_state(cfg))
        ref_rate = jeng.firing_rate_hz(state, cfg, quickstart.SNN_STEPS)
        mine = port[law.kind]
        assert mine["n_synapses"] == tabs.stats["n_synapses"], law.kind
        assert mine["rate_hz"] == pytest.approx(ref_rate, rel=0.35), \
            (law.kind, mine["rate_hz"], ref_rate)
        assert mine["events"] > 0 and mine["s_per_event"] > 0


def test_quickstart_lm_half_on_cpu():
    out = quickstart.lm_half(device="cpu")
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
    assert out["logits_shape"][:2] == (2, 1)
    assert all(0 <= t < out["logits_shape"][2] for t in out["argmax"])


def test_serve_lm_serves_a_reduced_config_end_to_end(capsys):
    out = serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                         "8", "--gen", "4"])
    cfg = tconfigs.get_reduced("gemma-2b")
    assert out["config"] == cfg.name
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.padded_vocab)).all()
    assert out["prefill_launches"] == {} == out["decode_launches"]
    text = capsys.readouterr().out
    assert "prefill:" in text and "ms/token" in text


def test_snn_simulation_prints_both_laws_and_moves_weights(capsys):
    _build.reset_launch_counts()
    out = snn_simulation.main(["--device", "cpu", "--grid", "4",
                               "--neurons-per-column", "20", "--steps",
                               "40"])
    text = capsys.readouterr().out
    for law in ("gaussian", "exponential"):
        assert any(line.startswith(law) and "rate" in line
                   for line in text.splitlines()), text
        assert np.isfinite(out["laws"][law]["rate"])
        assert out["laws"][law]["events"] > 0
    assert "cost ratio exp/gauss" in text
    assert out["stdp"]["moved"] > 0 and out["stdp"]["mean_abs_dw"] > 0
    assert _build.launch_counts() == {}      # the plain versions on CPU
