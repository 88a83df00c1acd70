"""Port parity: the LM on ranks (``MeshRules``, tensor-, expert- and
FSDP-parallel training, the int8 compressed pod step) over
``torch.distributed`` (gloo, CPU), against the JAX reference run single
device with the reference tests' ``nomesh`` rules.

The reference's own multi-device tests (``tests/test_multidevice.py``)
give the configurations and tolerances: ``test_moe_ep_equals_dense``
(EP on (data 4, model 2) against the dense dispatch),
``test_sharded_train_step_matches_single_device`` (the dense config's
loss on (4, 2); here also one AdamW step, every leaf) and
``test_compressed_pod_gradient_sync`` (on (pod 2, data 2, model 2),
held to its docstring: that reference test fails on every run).  The
test process runs the reference and writes one job; one spawn of 8
ranks (``launch.mesh.spawn_ranks``, one torch thread each) runs every
case (``tests/_torch_lm_ranks.py``) and each rank writes its verdicts.
Inputs come from numpy seeds; parameters cross through
``core.convert``.  The ranks also run each step's dry run on their own
coordinates (``DryCollectives`` on ``"meta"``), whose calls and bytes per
channel must be the gloo step's, and the ``seq`` legs run at lengths
that do not divide over the ``seq`` axis too.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JConfig
from repro.models import model as jm
from repro.models.moe import _apply_moe_dense, init_moe
from repro.optim import adamw as jadamw
from repro.optim.compression import CompressedAllReduce as JCar
from repro.optim.compression import int8_dequantize as jdeq
from repro.optim.compression import int8_quantize as jquant
from repro.optim.schedules import constant as jconstant
from repro.parallel.sharding import MeshRules as JRules
from repro.parallel.sharding import rules_for_mesh as jrules_for_mesh
from repro_torch import configs as tconfigs
from repro_torch.core.convert import (adafactor_state_from_arrays,
                                      model_params_from_arrays)
from repro_torch.data.pipeline import make_batch_specs, rank_batch
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import abstract_model
from repro_torch.optim import adafactor, adamw, constant
from repro_torch.optim import compression as tcomp
from repro_torch.parallel import sharding as S

import _torch_lm_ranks as R
from _torch_parity import (ShapeMesh, frontend_inputs, lm_params,
                           reference_dryrun)

NOMESH = JRules(batch=None, fsdp=None, heads=None, mlp=None, experts=None,
                vocab=None, kv_seq=None, d_inner=None)
# the reference tests' configurations
DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab_size=256, dtype="float32",
             attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32)
MOE = dict(name="moe", family="moe", n_layers=1, d_model=32, n_heads=2,
           n_kv_heads=2, d_ff=16, vocab_size=128, n_experts=8, moe_top_k=2,
           capacity_factor=8.0, dtype="float32")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def ep_job() -> dict:
    jcfg = JConfig(**MOE)
    p, _ = init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((8, 16, 32)),
                    jnp.float32)
    y, aux = _apply_moe_dense(p, jcfg, NOMESH, x)
    g = jax.grad(lambda p, x: jnp.sum(jnp.sin(
        _apply_moe_dense(p, jcfg, NOMESH, x)[0])))(p, x)
    return {"cfg": ModelConfig(**MOE), "p": {k: _t(v) for k, v in p.items()},
            "x": _t(x), "y": _t(y),
            "grads": {k: _t(v) for k, v in g.items()},
            "aux": {k: float(v) for k, v in aux.items()}}


# a sequence length that does not divide over the seq legs' model axis
# (2 ranks): each rank's block of 31 positions, the second's last one
# padding
ODD_LENGTH = 61


def train_job(length: int = 64) -> dict:
    """The dense config's parameters (zero-initialised leaves given
    small random values, ``lm_params``), a numpy batch of ``length``
    positions, the reference's loss and one jitted AdamW step."""
    jcfg = JConfig(**DENSE)
    params, host = lm_params(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, 256, size=(8, 64)) \
        .astype(np.int32)[:, :length]
    batch = {"tokens": tokens, "labels": tokens}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, _ = jm.loss_fn(params, jcfg, NOMESH, jbatch)
    grads = jax.grad(lambda p: jm.loss_fn(p, jcfg, NOMESH, jbatch)[0])(
        params)
    opt = jadamw(jconstant(R.LR))
    p1, _, out = jax.jit(jm.make_train_step(jcfg, NOMESH, opt))(
        params, opt.init(params), jbatch)
    cfg = ModelConfig(**DENSE)
    return {"cfg": cfg,
            "params": model_params_from_arrays(cfg, host, device="cpu"),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "loss": float(loss), "grad_norm": float(out["grad_norm"]),
            "grads": model_params_from_arrays(
                cfg, jax.tree.map(np.asarray, grads), device="cpu",
                dtype="float32"),
            "p1": model_params_from_arrays(
                cfg, jax.tree.map(np.asarray, p1), device="cpu")}


# Adafactor over split leaves: the configs the reference's dry run trains
# with it (above 15e9 parameters), reduced; the MoE at capacity factor 8,
# so that nothing drops (EP and the dense dispatch agree only then).
# Tokens a row: a VLM's patches come on top, and patches + tokens divide
# over the model axis for the seq legs.
ADAFACTOR = {"internvl2-26b": 24, "kimi-k2-1t-a32b": 32}
ADAFACTOR_STEPS = 2
# the VLM's seq leg at 8 patches + 23 tokens: 31 positions over 2 ranks
ODD_VLM, ODD_VLM_TOKENS = "internvl2-26b", 23


def adafactor_job(arch: str, n_tokens=None) -> dict:
    """The reduced ``arch``'s parameters (``lm_params``), two numpy
    batches (a VLM's patches too) and the reference's two Adafactor
    steps (``repro.optim.adafactor`` over its stacked layers, meshless):
    each step's loss and grad norm, the parameters and the state after
    the last.  The gradient is jitted, ``_clipped`` runs op by op and the
    update (jitted) has ``clip_norm=inf``: XLA:CPU's jitted global norm
    sums each leaf's squares sequentially (tests/test_torch_train_
    families.py)."""
    from repro.configs import get_reduced as jget_reduced
    from repro.optim import adafactor as jadafactor
    from repro.optim.optimizers import _clipped as jclipped
    jcfg = jget_reduced(arch)
    cfg = tconfigs.get_reduced(arch)
    if cfg.is_moe:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params, host = lm_params(jcfg, seed=0)
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(ADAFACTOR_STEPS):
        tokens = rng.integers(0, cfg.vocab_size,
                              size=(8, n_tokens or ADAFACTOR[arch])) \
            .astype(np.int32)
        batches.append({"tokens": tokens, "labels": tokens,
                        **frontend_inputs(cfg, rng, 8)})
    grads_of = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, jcfg, NOMESH, b)[0]))
    jopt = jadafactor(jconstant(R.LR), clip_norm=float("inf"))
    update = jax.jit(jopt.update)
    p, state, outs = params, jopt.init(params), []
    for b in batches:
        loss, grads = grads_of(p, {k: jnp.asarray(v) for k, v in b.items()})
        grads, gnorm = jclipped(grads, 1.0)
        p, state, _ = update(p, grads, state)
        outs.append({"loss": float(loss), "grad_norm": float(gnorm)})
    return {"cfg": cfg,
            "params": model_params_from_arrays(cfg, host, device="cpu"),
            "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                        for b in batches],
            "outs": outs,
            "p_end": model_params_from_arrays(
                cfg, jax.tree.map(np.asarray, p), device="cpu"),
            "v_end": adafactor_state_from_arrays(
                cfg, jax.tree.map(np.asarray, state), device="cpu")["v"]}


COMPRESSION_SHAPES = [(3, 301), (256,), (2, 5, 7), (1000,)]


def compression_job() -> dict:
    """Two pods' gradients and residuals (ragged, with an all-zero block
    and a zero residual) and the reference's mean and new residuals,
    the reference under ``vmap`` over its pod axis."""
    rng = np.random.default_rng(2)
    car = JCar(axis="pod")
    cases = []
    for shape in COMPRESSION_SHAPES:
        g = rng.standard_normal((2,) + shape).astype(np.float32)
        if g[0].size > BLOCK_ZERO:
            g.reshape(2, -1)[:, :BLOCK_ZERO] = 0.0
        r = (1e-3 * rng.standard_normal((2,) + shape)).astype(np.float32)
        r[0] = 0.0
        avg, res = jax.vmap(car, axis_name="pod")(jnp.asarray(g),
                                                  jnp.asarray(r))
        cases.append({"g": torch.from_numpy(g), "r": torch.from_numpy(r),
                      "avg": _t(avg[0]), "res": _t(res)})
    return {"cases": cases}


BLOCK_ZERO = 256     # the first block of a longer gradient is zero


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    """Every case on 8 ranks: ``{case: [rank result, ...]}``."""
    # the reference's runs in threads: most of their time is XLA's
    # compiles, which run beside each other
    with ThreadPoolExecutor(4) as pool:
        ep, train, odd, comp, *adaf = [
            pool.submit(fn, *a).result for fn, a in (
                (ep_job, ()), (train_job, ()), (train_job, (ODD_LENGTH,)),
                (compression_job, ()),
                (adafactor_job, (ODD_VLM, ODD_VLM_TOKENS)),
                *((adafactor_job, (a,)) for a in ADAFACTOR))]
        train, vlm_odd = train(), adaf.pop(0)
        job = {"ep": ep(), "train": train, "pod": train,
               "compression": comp(), "train_seq": train,
               "train_seq_odd": odd(),
               "adafactor": {a: f() for a, f in zip(ADAFACTOR, adaf)},
               "adafactor_odd": {ODD_VLM: vlm_odd()}}
    out_dir = tmp_path_factory.mktemp("lm_ranks")
    path = out_dir / "job.pt"
    torch.save(job, path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmesh.spawn_ranks(R.worker, 8, args=(str(path),), timeout_s=600,
                          store_dir=str(out_dir))
    finally:
        torch.set_num_threads(n)
    per_rank = [json.loads((out_dir / f"result_{r}.json").read_text())
                for r in range(8)]
    return {name: [r[name] for r in per_rank] for name in job}


def check(results: list) -> None:
    errors = [(rank, r["errors"]) for rank, r in enumerate(results)
              if r["errors"]]
    assert not errors, errors


# ---------------------------------------------------------------------------
# 1-3: the reference's multi-device cases on ranks
# ---------------------------------------------------------------------------

def test_torch_moe_ep_equals_dense(ranks8):
    """``_apply_moe_ep`` on (data 4, model 2) is the reference's dense
    dispatch to 2e-5 (its load-balance and z losses too), gradients of
    ``sum(sin(y))`` to 5e-4; capacity 8 drops nothing."""
    check(ranks8["ep"])
    assert all(r["frac_dropped"] == 0.0 for r in ranks8["ep"])


def test_torch_sharded_train_step_matches_single_device(ranks8):
    """The dense config on (data 4, model 2): the loss is the
    reference's to 1e-5, every leaf's gradient the reference's to 2e-5,
    and after one AdamW step every leaf the reference's to 2e-5 (its
    grad norm to 5e-5), but for the elements whose gradient is within
    1e-6 of zero, which AdamW's first update ``g / (|g| + 1e-8)`` moves
    by up to ``lr`` on the gradient's rounding: those within ``lr``."""
    check(ranks8["train"])


def test_torch_compressed_pod_gradient_sync(ranks8):
    """On (pod 2, data 2, model 2): the exact rank step is the
    reference's single-device step; the compressed step's first loss is
    the exact step's to 1e-5, its parameters within 5e-3, and the loss
    after five more steps below the first; each step puts
    ``wire_bytes`` of the rank's gradient elements on the pod wire."""
    check(ranks8["pod"])
    losses = ranks8["pod"][0]["losses"]
    assert all(r["losses"] == losses for r in ranks8["pod"])


def test_torch_compressed_all_reduce_is_the_references(ranks8):
    """Two pods' mean and each pod's new residual, bit for bit."""
    check(ranks8["compression"])


def test_torch_rank_bytes_are_the_blocks_held(ranks8):
    """``dryrun.rank_bytes`` under the rules equals the bytes of the
    blocks each rank holds (parameters and AdamW state)."""
    for r in ranks8["train"]:
        assert r["held_bytes"] == r["dryrun_bytes"]


@pytest.mark.parametrize("seq", [None, "model"])
@pytest.mark.parametrize("arch", sorted(ADAFACTOR))
def test_torch_adafactor_over_split_leaves_matches_reference(ranks8, arch,
                                                             seq):
    """Two Adafactor steps (over ``stack_groups``) on (pod 2, data 2,
    model 2), leaves split by FSDP, heads, MLP, experts and vocabulary,
    with and without ``seq``: each loss within 1e-5 and grad norm within
    5e-5 of the reference's single-device steps (its stacked layers),
    every parameter block and every row / col / full moment block within
    2e-5; the optimizer's reductions ran on their own channel, a few
    calls a step (one per set of mesh axes a stage)."""
    results = ranks8["adafactor"]
    check([r[f"{arch}/{seq}"] for r in results])
    calls = results[0][f"{arch}/{seq}"]["opt_calls"]
    assert 0 < calls <= 8 * ADAFACTOR_STEPS, calls


def test_torch_seq_training_matches_reference(ranks8):
    """One AdamW step of the dense config on (data 4, model 2) with the
    positions split over ``model`` (``seq``): loss 1e-5, grad norm 5e-5,
    every leaf 2e-5 (the flat-gradient elements within lr) of the
    reference's; the stream went through the seq gathers.  The MoE
    (kimi-k2) and the VLM prefix (internvl) run under ``seq`` in
    ``test_torch_adafactor_over_split_leaves_matches_reference``."""
    check(ranks8["train_seq"])
    assert all(r["seq_calls"] > 0 for r in ranks8["train_seq"])
    for arch in ADAFACTOR:
        assert all(r[f"{arch}/model"]["seq_calls"] > 0
                   and r[f"{arch}/None"]["seq_calls"] == 0
                   for r in ranks8["adafactor"])


def test_torch_adafactor_rank_bytes_are_the_blocks_held(ranks8):
    """``dryrun.rank_bytes`` under Adafactor counts the moment blocks
    (and the step) each rank holds."""
    for r in ranks8["adafactor"]:
        for leg in r.values():
            assert leg["held_bytes"] == leg["dryrun_bytes"]


@pytest.mark.parametrize("case", ["train", "train_seq", "train_seq_odd",
                                  "pod", "adafactor", "adafactor_odd"])
def test_torch_dry_run_counts_are_the_ranks(ranks8, case):
    """The dry run of each rank's step (``launch.dryrun.trace_rank_step``
    on ``"meta"`` copies of the rank's inputs, ``DryCollectives`` on a
    mesh of shapes at the rank's coordinates, no process group) counts
    exactly what the rank's step on gloo counted: per channel the calls,
    the bytes sent and the bytes received, rank by rank (the AdamW step,
    with ``seq`` at an even and an odd length, the compressed pod step,
    the Adafactor steps)."""
    for r in ranks8[case]:
        legs = list(r.values()) if case.startswith("adafactor") else [r]
        for leg in legs:
            assert leg["measured"] and leg["dry"] == leg["measured"]


# ---------------------------------------------------------------------------
# 4: compression, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", COMPRESSION_SHAPES + [(0,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_torch_int8_compression_is_bit_identical(shape):
    """``int8_quantize`` blocks and scales, ``int8_dequantize``,
    ``init_residuals`` and ``wire_bytes`` against the reference: ragged
    sizes, an all-zero block, round half to even."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    if x.size > BLOCK_ZERO:
        flat[:BLOCK_ZERO] = 0.0
    if x.size >= 3:
        # the last block's scale is exactly 1: ties at 2.5 and -3.5
        flat[-3:] = (127.0, 2.5, -3.5)
    q, s = tcomp.int8_quantize(torch.from_numpy(x))
    jq, js = jquant(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    d = tcomp.int8_dequantize(q, s, shape)
    jd = jdeq(jq, js, shape)
    assert np.array_equal(d.numpy().view(np.int32),
                          np.asarray(jd).view(np.int32))
    n = int(np.prod(shape))
    assert tcomp.CompressedAllReduce().wire_bytes(n) == JCar().wire_bytes(n)
    r = tcomp.init_residuals({"g": torch.from_numpy(x).to(torch.bfloat16)})
    assert r["g"].dtype == torch.float32 and not r["g"].any()


# ---------------------------------------------------------------------------
# 5: the rules, field for field the reference's
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fields(rules) -> dict:
    return {f.name: getattr(rules, f.name)
            for f in dataclasses.fields(JRules) if f.name != "mesh"}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_torch_rules_for_are_the_references(arch, mesh_name):
    """``_rules_for``, ``_batch_rules`` and ``make_batch_specs`` for each
    config on the production meshes: field for field the reference's."""
    from repro.configs import get_config as jget
    from repro.configs import shape_cells as jcells
    jdryrun = reference_dryrun()
    shape, axes = MESHES[mesh_name]
    tmesh_ = tmesh.RankMesh(shape, axes)
    rules, dp = dryrun._rules_for(tconfigs.get_config(arch), tmesh_)
    jrules, jdp = jdryrun._rules_for(jget(arch), ShapeMesh(shape, axes))
    assert dp == jdp and _fields(rules) == _fields(jrules)
    assert rules.mesh == tmesh_
    for tshape, jshape in zip(tconfigs.shape_cells(arch), jcells(arch)):
        br = dryrun._batch_rules(rules, tshape, dp)
        jbr = jdryrun._batch_rules(jrules, jshape, jdp)
        assert _fields(br) == _fields(jbr), tshape.name
        if tshape.kind == "decode":
            continue
        from repro.data.pipeline import make_batch_specs as jspecs
        want = {k: tuple(v) for k, v in
                jspecs(jget(arch), jshape, jbr).items()}
        assert make_batch_specs(tconfigs.get_config(arch), tshape,
                                br) == want


def test_torch_mesh_rules_defaults_and_specs():
    """``MeshRules``' defaults, ``pspec``, ``spec_tree`` over
    ``param_specs``, the pod and single-pod rules, ``constrain``."""
    assert _fields(S.MeshRules()) == _fields(JRules())
    for axes in (("data", "model"), ("pod", "data", "model")):
        assert _fields(S.rules_for_mesh(axes)) == \
            _fields(jrules_for_mesh(axes))
        assert _fields(S.rules_for_mesh(axes, heads=None)) == \
            _fields(jrules_for_mesh(axes, heads=None))
    rules = S.MULTI_POD_RULES
    assert rules.pspec("batch", None, "heads") == \
        tuple(JRules().pspec("batch", None, "heads"))
    cfg = tconfigs.get_reduced("qwen2-1.5b")
    _, specs = abstract_model(cfg)
    tree = rules.spec_tree(specs)
    assert tree["layers"][0]["attn"]["wq"] == ("data", "model", None)
    assert tree["embed"]["table"] == ("model", "data")
    x = torch.ones(2)
    assert S.constrain(x, rules, "batch") is x
    with pytest.raises(KeyError, match="unknown logical axis"):
        rules.axis("nope")


def test_torch_blocks_cover_the_whole():
    """``block`` cuts each split dim to the rank's index (folded axes
    pod-major); the blocks of every rank tile the whole tensor, and
    ``rank_batch`` cuts the batch the same way."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    seen = torch.zeros_like(x)
    for r in range(8):
        rules = S.rules_for_mesh(tmesh.RankMesh(shape, axes, r))
        b = S.block(x, ("batch", "vocab", None), rules)
        i, j = rules.mesh.axis_index(("pod", "data")), \
            rules.mesh.axis_index("model")
        assert torch.equal(b, x[2 * i:2 * i + 2, 3 * j:3 * j + 3])
        seen[2 * i:2 * i + 2, 3 * j:3 * j + 3] += 1
        got = rank_batch({"tokens": x.numpy()}, rules)["tokens"]
        assert torch.equal(got, x[2 * i:2 * i + 2])
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not divide"):
        S.block(torch.ones(3, 2), ("batch", None),
                S.rules_for_mesh(tmesh.RankMesh(shape, axes, 0)))


@pytest.mark.parametrize("heads,kv,ranks", [(4, 2, 2), (6, 2, 2), (16, 8, 2),
                                             (12, 2, 4), (12, 3, 2), (8, 8, 4)])
def test_torch_local_kv_heads_are_the_groups_of_the_local_query_heads(
        heads, kv, ranks):
    """Each rank's KV heads are those its query heads read (query head
    i reads KV head i // (heads // kv)): a slice for whole groups or
    one group, one KV head per query head otherwise."""
    from repro_torch.models.attention import local_kv_heads
    h_loc = heads // ranks
    for r in range(ranks):
        h0 = r * h_loc
        sel = local_kv_heads(heads, kv, h0, h_loc)
        want = [(h0 + i) // (heads // kv) for i in range(h_loc)]
        got = torch.arange(kv)[sel].tolist()
        if isinstance(sel, slice):
            group = h_loc // len(got)
            assert [got[i // group] for i in range(h_loc)] == want
        else:
            assert got == want


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-1.5b",
                                  "internvl2-26b", "kimi-k2-1t-a32b"])
def test_torch_rank_bytes_split_the_whole(arch):
    """The dry run's bytes per rank: every rank the same, and a mesh of
    one rank holds the whole tree (the phase-14 mesh at full width).
    Under the dry run's optimizer (Adafactor above 15e9 parameters:
    internvl2-26b, kimi-k2) on (data 2, model 2): the moments each rank
    makes from its blocks (``init`` on them) are the blocks of the whole
    state under ``state_specs``, so the blocks of the four ranks tile
    the whole state, and ``rank_bytes`` counts them."""
    from repro_torch.tree import tree_flatten
    cfg = tconfigs.get_config(arch)
    params, specs = abstract_model(cfg)
    whole = sum(x.numel() * x.element_size()
                for x in tree_flatten(params)[0])
    one = S.rules_for_mesh(tmesh.RankMesh((1, 1, 1),
                                          ("pod", "data", "model")))
    assert dryrun.rank_bytes(cfg, one)["params"] == whole
    opt, _ = dryrun.train_setup(cfg, sum(x.numel() for x in tree_flatten(
        params)[0]), {})
    if opt.kind == "adamw":
        rules, _ = dryrun._rules_for(cfg, tmesh.RankMesh(
            (2, 1, 2), ("pod", "data", "model")))
        got = dryrun.rank_bytes(cfg, rules, opt, residuals=True)
        assert whole // 2 < got["params"] < whole
        assert got["total"] == sum(got[k] for k in ("params", "optimizer",
                                                    "residuals"))
        return
    state = opt.abstract_state(params)
    leaves = list(zip(tree_flatten(state["v"])[0],
                      S.spec_leaves(opt.state_specs(specs)["v"])))
    total = sum(x.numel() for x, _ in leaves)
    counted = []
    for r in range(4):
        rules, _ = dryrun._rules_for(cfg, tmesh.RankMesh(
            (2, 2), ("data", "model"), r))
        blocks = S.block_tree(params, specs, rules)
        mine = tree_flatten(opt.init(blocks)["v"])[0]
        tiled = 0
        for m, (x, n) in zip(mine, leaves):
            assert tuple(m.shape) == S.block_shape(tuple(x.shape), n, rules)
            split = S.shard_axes(n, rules)
            tiled += m.numel() * (rules.mesh.axis_size(split) if split
                                  else 1)
        assert tiled == total
        counted.append(dryrun.rank_bytes(cfg, rules, opt)["optimizer"])
        assert counted[-1] == 4 + sum(m.numel() * m.element_size()
                                      for m in mine)
    assert len(set(counted)) == 1 and counted[0] < 4 * total


# ---------------------------------------------------------------------------
# 6: what the port does not split raises (serving, d_inner and the
# frontends on ranks: tests/test_torch_serve_ranks.py)
# ---------------------------------------------------------------------------

def _shape_rules(cfg, shape=(2, 1, 2)):
    """Rules over a mesh of shapes (rank 0, no process group): enough
    for every refusal, which comes before any collective."""
    mesh = tmesh.RankMesh(shape, ("pod", "data", "model"), 0)
    return dryrun._rules_for(cfg, mesh)[0]


def _tiny(arch):
    cfg = tconfigs.get_reduced(arch)
    from repro_torch.models.transformer import init_model
    return cfg, init_model(cfg, 0, device="cpu")


@pytest.mark.parametrize("case", ["batch-axis"])
def test_torch_seq_refusals_name_the_axis_and_length(case):
    """``seq`` on a mesh axis that ``batch`` uses (the reference's
    ``PartitionSpec`` refuses one mesh axis on two dims) raises
    ``ValueError`` before any collective, naming the axis and the
    length.  (A length that does not divide over the ``seq`` axes no
    longer raises: ``test_torch_seq_at_an_indivisible_length_matches_
    reference``.)"""
    cfg, params = _tiny("qwen2-1.5b")
    seq, length = {"batch-axis": ("data", 8)}[case]
    rules = dataclasses.replace(_shape_rules(cfg, (2, 2, 2)), seq=seq)
    batch = {"tokens": torch.zeros(2, length, dtype=torch.int32),
             "labels": torch.zeros(2, length, dtype=torch.int32)}
    with pytest.raises(ValueError, match=f"{seq}.*{length}|{length}.*"
                       f"{seq}"):
        tm.make_eval_step(cfg, rules)(params, batch)


@pytest.mark.parametrize("case", ["train_seq_odd", "adafactor_vlm_odd"])
def test_torch_seq_at_an_indivisible_length_matches_reference(ranks8, case):
    """``seq`` over ``model`` (2 ranks) at a length that does not
    divide, each rank's block padded (``transformer.seq_axes``), against
    the reference's unsharded steps: the dense config's AdamW step at 61
    positions on (data 4, model 2) (loss 1e-5, grad norm 5e-5, every
    leaf 2e-5, the flat-gradient elements within lr), and reduced
    internvl2-26b's two Adafactor steps at 8 patches + 23 tokens on
    (pod 2, data 2, model 2) (losses 1e-5, grad norms 5e-5, every leaf
    and moment block 2e-5).  The streams went through the seq
    gathers."""
    if case == "train_seq_odd":
        results = ranks8["train_seq_odd"]
        assert all(r["length"] == ODD_LENGTH for r in results)
    else:
        results = [r[f"{ODD_VLM}/model"] for r in ranks8["adafactor_odd"]]
    check(results)
    assert all(r["seq_calls"] > 0 for r in results)


def test_torch_nccl_refuses_two_ranks_on_one_card():
    """NCCL needs one card a rank: a shared card raises before any
    collective, and the transport carries no CPU tensor."""
    import torch.distributed as dist
    from repro_torch.core import halo
    store = dist.HashStore()
    store.set("card/1", "GPU-same")
    with pytest.raises(halo.SharedCardError, match="one card a rank"):
        halo.check_distinct_cards(store, 0, 2, "GPU-same")
    with pytest.raises(halo.TransportError, match="CUDA"):
        halo.Transport("nccl", "cpu")
    with pytest.raises(RuntimeError, match="no collectives"):
        from repro_torch.parallel.collectives import psum
        psum(torch.ones(2), tmesh.RankMesh((2,), ("model",), 0), "model",
             "tp")


# ---------------------------------------------------------------------------
# the launcher on ranks
# ---------------------------------------------------------------------------

def _launcher_round_trip(tmp_path, extra: list, rank_extra: list):
    """``launch.train.main`` of qwen2-1.5b (4 x 32, 3 steps, CPU) on two
    ranks (mesh 1x2, ``extra + rank_extra``), then straight in one
    process and again from the ranks' checkpoint (``extra``): the
    restored and the straight ``(params, opt_state)``."""
    from repro_torch.launch import train
    kw = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "32",
          "--steps", "3", "--device", "cpu"] + extra
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(kw + ["--ckpt-dir", str(tmp_path / "r"), "--nproc", "2",
                         "--mesh", "1x2"] + rank_extra)
    finally:
        torch.set_num_threads(n)
    straight = train.main(kw + ["--ckpt-dir", str(tmp_path / "s")])
    restored = train.main(kw + ["--ckpt-dir", str(tmp_path / "r")])
    assert restored["final_step"] == 3 and not restored["metrics"]
    (p_want, o_want), (p_got, o_got) = straight["state"], restored["state"]
    assert int(o_got["step"]) == int(o_want["step"]) == 3
    return (p_want, o_want), (p_got, o_got)


def _whole_trees_agree(pairs_by_tol) -> None:
    """Each ``(tol, want, got)``: the trees' leaves equal in shape and
    dtype, and the error norm over the norm of the whole tree within
    ``tol``."""
    from repro_torch.tree import tree_flatten
    for tol, want, got in pairs_by_tol:
        w_leaves, g_leaves = tree_flatten(want)[0], tree_flatten(got)[0]
        assert len(w_leaves) == len(g_leaves)
        pairs = list(zip(w_leaves, g_leaves))
        assert all(w.shape == g.shape and w.dtype == g.dtype
                   for w, g in pairs)
        assert R.rel_err(torch.cat([w.float().reshape(-1) for w, _ in pairs]),
                         torch.cat([g.float().reshape(-1) for _, g in pairs])
                         ) <= tol


def test_torch_train_launcher_on_ranks_resumes_on_one_process(tmp_path):
    """``python -m repro_torch.launch.train --nproc 2 --mesh 1x2``: its
    checkpoint (the whole tree, written by rank 0) restores in one
    process as the one process's trained state, leaf for leaf in shape
    and dtype, and in value to ``tests/test_torch_train.py``'s
    three-step tolerances over each whole tree (parameters 2e-5, AdamW's
    m 5e-5 and v 1e-4: the error norm over the norm).  Whole trees,
    because the zero-initialised biases hold nothing but three steps'
    updates, whose rounding a leaf's own norm does not bound.  The
    ranks differ from one process only in the order of their sums; the
    per-leaf parity of a rank step is the tests above."""
    (p_want, o_want), (p_got, o_got) = _launcher_round_trip(tmp_path, [], [])
    _whole_trees_agree(((R.LEAF_TOL, p_want, p_got),
                        (5e-5, o_want["m"], o_got["m"]),
                        (1e-4, o_want["v"], o_got["v"])))


def test_torch_train_launcher_adafactor_seq_on_ranks_resumes(tmp_path):
    """``launch.train --optimizer adafactor --nproc 2 --mesh 1x2
    --seq-axis model``: each sequence's positions split over ``model``
    between blocks, Adafactor over the stack groups with its factored
    moments split as the parameters are.  Rank 0's checkpoint gathers
    the moments whole: it restores in one process as the one process's
    Adafactor state after the same three steps, every ``row`` /
    ``col`` / ``full`` leaf in the one process's shape and dtype, and
    in value within the AdamW case's tolerances over each whole tree
    (parameters 2e-5, the moments 1e-4, as AdamW's v)."""
    (p_want, o_want), (p_got, o_got) = _launcher_round_trip(
        tmp_path, ["--optimizer", "adafactor"], ["--seq-axis", "model"])
    assert "m" not in o_got and set(o_got) == set(o_want) == {"v", "step"}
    _whole_trees_agree(((R.LEAF_TOL, p_want, p_got),
                        (1e-4, o_want["v"], o_got["v"])))
