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
``core.convert``.
"""

import dataclasses
import json
import os

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
from repro_torch.core.convert import model_params_from_arrays
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
from _torch_parity import lm_params

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


def train_job() -> dict:
    """The dense config's parameters (zero-initialised leaves given
    small random values, ``lm_params``), a numpy batch, the reference's
    loss and one jitted AdamW step."""
    jcfg = JConfig(**DENSE)
    params, host = lm_params(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, 256, size=(8, 64)) \
        .astype(np.int32)
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
    train = train_job()
    job = {"ep": ep_job(), "train": train, "pod": train,
           "compression": compression_job()}
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

class _Devices:
    def __init__(self, shape):
        self.shape = shape


class _ShapeMesh:
    """What the reference's ``_rules_for`` reads of a mesh (its axis
    names, iterable as ``rules_for_mesh`` takes a tuple, and its device
    array's shape): nothing runs on devices."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = _Devices(shape)

    def __iter__(self):
        return iter(self.axis_names)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fields(rules) -> dict:
    return {f.name: getattr(rules, f.name)
            for f in dataclasses.fields(JRules) if f.name != "mesh"}


def _reference_dryrun():
    """The reference's dry-run module, imported after jax has its
    devices (its import sets XLA_FLAGS for a later first init, which is
    put back)."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_torch_rules_for_are_the_references(arch, mesh_name):
    """``_rules_for``, ``_batch_rules`` and ``make_batch_specs`` for each
    config on the production meshes: field for field the reference's."""
    from repro.configs import get_config as jget
    from repro.configs import shape_cells as jcells
    jdryrun = _reference_dryrun()
    shape, axes = MESHES[mesh_name]
    tmesh_ = tmesh.RankMesh(shape, axes)
    rules, dp = dryrun._rules_for(tconfigs.get_config(arch), tmesh_)
    jrules, jdp = jdryrun._rules_for(jget(arch), _ShapeMesh(shape, axes))
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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-1.5b"])
def test_torch_rank_bytes_split_the_whole(arch):
    """The dry run's bytes per rank: every rank the same, and a mesh of
    one rank holds the whole tree (the phase-14 mesh at full width)."""
    from repro_torch.tree import tree_flatten
    cfg = tconfigs.get_config(arch)
    params, _ = abstract_model(cfg)
    whole = sum(x.numel() * x.element_size()
                for x in tree_flatten(params)[0])
    one = S.rules_for_mesh(tmesh.RankMesh((1, 1, 1),
                                          ("pod", "data", "model")))
    assert dryrun.rank_bytes(cfg, one)["params"] == whole
    rules, _ = dryrun._rules_for(cfg, tmesh.RankMesh(
        (2, 1, 2), ("pod", "data", "model")))
    got = dryrun.rank_bytes(cfg, rules, adamw(constant(1e-4)),
                            residuals=True)
    assert whole // 2 < got["params"] < whole
    assert got["total"] == sum(got[k] for k in ("params", "optimizer",
                                                "residuals"))


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


def test_torch_seq_and_adafactor_on_ranks_raise():
    cfg, params = _tiny("qwen2-1.5b")
    rules = dataclasses.replace(_shape_rules(cfg), seq="data")
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
             "labels": torch.zeros(2, 8, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="seq"):
        tm.make_eval_step(cfg, rules)(params, batch)
    from repro_torch.models.transformer import stack_groups
    opt = adafactor(constant(1e-3), stacks=stack_groups(cfg))
    step = tm.make_train_step(cfg, opt, rules=_shape_rules(cfg))
    with pytest.raises(NotImplementedError, match="Adafactor"):
        step(params, opt.init(params), batch)


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
    from repro_torch.launch import train
    kw = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "32",
          "--steps", "3", "--device", "cpu"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(kw + ["--ckpt-dir", str(tmp_path / "r"), "--nproc", "2",
                         "--mesh", "1x2"])
    finally:
        torch.set_num_threads(n)
    straight = train.main(kw + ["--ckpt-dir", str(tmp_path / "s")])
    restored = train.main(kw + ["--ckpt-dir", str(tmp_path / "r")])
    assert restored["final_step"] == 3 and not restored["metrics"]
    (p_want, o_want), (p_got, o_got) = straight["state"], restored["state"]
    assert int(o_got["step"]) == int(o_want["step"]) == 3
    from repro_torch.tree import tree_flatten
    for tol, want, got in ((R.LEAF_TOL, p_want, p_got),
                           (5e-5, o_want["m"], o_got["m"]),
                           (1e-4, o_want["v"], o_got["v"])):
        pairs = list(zip(tree_flatten(want)[0], tree_flatten(got)[0]))
        assert all(w.shape == g.shape and w.dtype == g.dtype
                   for w, g in pairs)
        assert R.rel_err(torch.cat([w.float().reshape(-1) for w, _ in pairs]),
                         torch.cat([g.float().reshape(-1) for _, g in pairs])
                         ) <= tol
