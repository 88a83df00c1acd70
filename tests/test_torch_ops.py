"""Port parity: the single-tier wrappers of ``kernels.ops``.

``ops.synaptic_accum_events`` is the reference's drop-in for
``core.synapses.deliver_events`` (``tests/test_event_delivery_equiv.py::
test_single_tier_fused_equals_deliver_events``): on the same tables,
spikes and ring the port's wrapper (its plain version on CPU tensors)
gives the reference's ``deliver_events`` ring bit for bit, and its fused
single-tier delivery bit for bit with bfloat16 weights (static bfloat16
delivery is order-exact) and within the reference test's 1e-5 with
float32 ones (its Pallas pipeline adds them in another order), with
equal event and drop counts.
``ops.lif_step_ref`` is the reference's plain LIF step: bit for bit its
jitted ``ops.lif_step_ref``, with and without an active mask.  Tables
come from both packages' builders (array for array the same), inputs
from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity as jconn
from repro.core import grid as jgrid
from repro.core import neuron as jneuron
from repro.core import synapses as jsyn
from repro.kernels import ops as jops
from repro_torch.core import connectivity as tconn
from repro_torch.core import grid as tgrid
from repro_torch.core import neuron as tneuron
from repro_torch.core import synapses as tsyn
from repro_torch.kernels import ops as tops

from _torch_parity import LAWS, assert_bits_equal


def _tables(law: str, weight_dtype: str):
    """One shard's single-shard tables at 4x4x30, as the reference's
    test builds them (``j_exc=0.4, j_inh=-2.0, seed=2``), in both
    packages."""
    specs = []
    for conn, grid, syn in ((jconn, jgrid, jsyn), (tconn, tgrid, tsyn)):
        lw = getattr(conn, f"{law}_law")()
        d = grid.TileDecomposition(grid=grid.ColumnGrid(4, 4, 30), tiles_y=1,
                                   tiles_x=1, radius=lw.radius)
        specs.append(syn.SynapseTableSpec(decomp=d, law=lw, single_shard=True,
                                          weight_dtype=weight_dtype))
    jt = jsyn.build_tables(specs[0], 0, 0, j_exc=0.4, j_inh=-2.0, seed=2)
    tt = tsyn.build_tables(specs[1], 0, 0, j_exc=0.4, j_inh=-2.0, seed=2,
                           device="cpu")
    return specs[1], jt, tt


@pytest.mark.parametrize("weights", ["bfloat16", "float32"])
@pytest.mark.parametrize("density", [0.1, 0.9])
@pytest.mark.parametrize("law", LAWS)
def test_synaptic_accum_events_is_the_references(law, density, weights):
    """The port's wrapper against the reference's ``deliver_events``
    (the ring bit for bit) and its ``ops.synaptic_accum_events`` (its
    Pallas pipeline, interpreted on the CPU: bit for bit in bfloat16,
    within 1e-5 in float32); events and drops equal (0.9 of the rows
    spiking passes ``active_cap``)."""
    spec, jt, tt = _tables(law, weights)
    assert tt.local["w"].dtype == getattr(torch, weights)
    rng = np.random.default_rng(int(density * 10))
    spikes = (rng.random(spec.n_local) < density).astype(np.float32)
    ring0 = (rng.integers(-300, 300, (spec.d_ring, spec.n_local))
             * 2.0 ** -9).astype(np.float32)
    cap = spec.active_cap_local
    jr, je, jd = jax.jit(lambda r: jops.synaptic_accum_events(
        jt["local"], jnp.asarray(spikes), r, 1, spec.d_ring, cap))(
        jnp.asarray(ring0))
    pr, pe, pd = jsyn.deliver_events(jt["local"], jnp.asarray(spikes),
                                     jnp.asarray(ring0), 1, spec.d_ring, cap)
    ring = torch.from_numpy(ring0.copy())
    tr, te, td = tops.synaptic_accum_events(
        tt.local, torch.from_numpy(spikes), ring, 1, spec.d_ring, cap)
    assert tr is ring                 # delivered in place
    assert_bits_equal(pr, tr, "ring vs deliver_events")
    if weights == "bfloat16":
        assert_bits_equal(jr, tr, "ring vs ops.synaptic_accum_events")
    else:
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-5)
    assert int(te) == int(je) == int(pe)
    assert int(td) == int(jd) == int(pd)
    assert (int(td) > 0) == (int(spikes.sum()) > cap)


@pytest.mark.parametrize("density", [0.1, 0.9])
@pytest.mark.parametrize("law", LAWS)
def test_synaptic_accum_events_card_descriptor_is_the_references(law,
                                                                 density):
    """The run descriptor ``ops.synaptic_accum_events`` builds for a CUDA
    ring (rows and targets in groups of ``ops.DEFAULT_ROW_GROUP``, which
    cut the 30-neuron columns: the permuted copy of the entries), walked
    by the column kernel's plain version (``ref.deliver_runs_ref``) over
    the rows the wrapper delivers, against the reference's
    ``deliver_events`` on bfloat16 tables: the ring bit for bit and the
    events equal."""
    from repro_torch.core.synapses import column_runs
    from repro_torch.kernels.ref import delivered_flags, deliver_runs_ref
    spec, jt, tt = _tables(law, "bfloat16")
    rng = np.random.default_rng(int(density * 10) + 7)
    spikes = (rng.random(spec.n_local) < density).astype(np.float32)
    ring0 = (rng.integers(-300, 300, (spec.d_ring, spec.n_local))
             * 2.0 ** -9).astype(np.float32)
    cap = spec.active_cap_local
    desc = column_runs([tt.local], tops.DEFAULT_ROW_GROUP,
                       tops.DEFAULT_ROW_GROUP, spec.d_ring)[0]
    assert desc["perm"] is not None   # the groups cut the columns
    pr, pe, _ = jsyn.deliver_events(jt["local"], jnp.asarray(spikes),
                                    jnp.asarray(ring0), 1, spec.d_ring, cap)
    flag = delivered_flags(torch.from_numpy(spikes), spec.n_local, cap)[0]
    events = torch.zeros((), dtype=torch.int32)
    tr = deliver_runs_ref(desc, flag, torch.from_numpy(ring0.copy()), 1,
                          events)
    assert_bits_equal(pr, tr, "descriptor walk vs deliver_events")
    assert int(events) == int(pe)


@pytest.mark.parametrize("masked", [False, True])
def test_lif_step_ref_is_the_references(masked):
    """``ops.lif_step_ref`` against the reference's jitted
    ``ops.lif_step_ref`` (XLA:CPU's fused multiply-adds, stated in the
    port's plain version): v, c, refrac and the spikes bit for bit."""
    rng = np.random.default_rng(5)
    n = 3000
    v = rng.normal(10.0, 8.0, n).astype(np.float32)
    c = rng.uniform(0.0, 2.0, n).astype(np.float32)
    refrac = rng.integers(0, 3, n).astype(np.int32)
    i_total = rng.normal(3.0, 4.0, n).astype(np.float32)
    active = rng.random(n) < 0.8 if masked else None
    jp, tp = jneuron.LIFParams(), tneuron.LIFParams()
    js, jspk = jax.jit(lambda s, i, a: jops.lif_step_ref(s, i, jp, a))(
        {"v": jnp.asarray(v), "c": jnp.asarray(c),
         "refrac": jnp.asarray(refrac)}, jnp.asarray(i_total),
        None if active is None else jnp.asarray(active))
    ts, tspk = tops.lif_step_ref(
        {"v": torch.from_numpy(v), "c": torch.from_numpy(c),
         "refrac": torch.from_numpy(refrac)}, torch.from_numpy(i_total), tp,
        None if active is None else torch.from_numpy(active))
    for key in ("v", "c", "refrac"):
        assert_bits_equal(js[key], ts[key], key)
    assert_bits_equal(jspk, tspk, "spikes")
    assert 0 < int(tspk.sum()) < n
