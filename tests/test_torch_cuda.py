"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(every CPU run) and run on an H100 with ``pytest -m cuda``.  Whether a
card is present is decided inside the fixture, never at import time.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core.neuron import LIFParams
from repro_torch.core.synapses import deliver_events
from repro_torch.kernels import _build, ref
from repro_torch.kernels.lif_step import lif_step_cuda
from repro_torch.kernels.synaptic_accum import event_delivery_banded

from _torch_parity import configs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_lif_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    n = 10_000
    v = torch.tensor(rng.uniform(-10, 25, n), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.uniform(0, 5, n), dtype=torch.float32, device=cuda)
    r = torch.tensor(rng.integers(0, 3, n), dtype=torch.int32, device=cuda)
    i = torch.tensor(rng.integers(-4000, 4000, n) * 2.0 ** -9,
                     dtype=torch.float32, device=cuda)
    a = torch.tensor(rng.random(n) < 0.9, device=cuda)
    kw = LIFParams().kernel_args()
    for x, y in zip(lif_step_cuda(v, c, r, i, a, **kw),
                    ref.lif_step_ref(v, c, r, i, a, **kw)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("law", ["gaussian", "exponential"])
def test_delivery_kernel_matches_plain(cuda, law):
    _, tcfg = configs(law, grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    spec = tcfg.spec()
    g = torch.Generator(device=cuda).manual_seed(1)
    for dens in (0.0, 0.05, 0.95):
        spk = (torch.rand(spec.n_local, device=cuda, generator=g)
               < dens).float()
        ring = torch.zeros((8, spec.n_local), device=cuda)
        rk, ek, dk = event_delivery_banded(
            [(tabs.local, spk, spec.active_cap_local)], ring.clone(), 2, 8)
        rp, ep, dp = deliver_events(tabs.local, spk, ring.clone(), 2, 8,
                                    spec.active_cap_local)
        assert torch.equal(rk, rp)
        assert int(ek) == int(ep) and int(dk) == int(dp)


def test_kernel_path_run_matches_plain_path(cuda):
    import dataclasses
    _, tcfg = configs("exponential", grid=4, n_per_col=100)
    tabs = teng.build_shard_tables(tcfg, device=cuda)
    _build.reset_launch_counts()
    fk, rk = teng.simulate(teng.init_sim_state(tcfg, device=cuda), tabs,
                           tcfg, 50, record_spikes=True, device=cuda)
    assert _build.launch_counts() == {"lif_step": 50, "event_delivery": 50}
    plain = dataclasses.replace(tcfg, use_kernels=False)
    fp, rp = teng.simulate(teng.init_sim_state(plain, device=cuda), tabs,
                           plain, 50, record_spikes=True, device=cuda)
    assert torch.equal(rk, rp)
    assert torch.equal(fk["i_ring"], fp["i_ring"])
