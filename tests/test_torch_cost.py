"""Port parity: the cost models against the reference's.

The abstract (``"meta"``) models, decode states, batches and optimizer
states of every published config against the reference's
``ShapeDtypeStruct`` trees, leaf for leaf (the reference stacks the
layers of each pattern position, the port keeps one tree node per
layer: the reference's trees are unstacked here), and against the
port's own real trees; the logical axis names; the SNN tables and
state; the scaling model and the roofline's conventions under the
reference's constants; ``perf.op_analysis`` against hand counts and
against the reference's HLO analysis; and the dry run on ``"meta"``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import dist_engine as jde
from repro.core import metrics as jmetrics
from repro.core.stdp import STDPParams as JSTDP
from repro.models import model as JM
from repro.models.attention import KVCache as JKVCache
from repro.models.config import SHAPES as JSHAPES
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup
from repro.perf import attention_credit as jcredit
from repro.perf import roofline as jroofline
from repro_torch.configs import (ARCH_NAMES, all_cells, get_config,
                                 get_reduced)
from repro_torch.configs.snn import CASES
from repro_torch.core import dist_engine as tde
from repro_torch.core import metrics as tmetrics
from repro_torch.core.stdp import STDPParams
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.perf import attention_credit, roofline
from repro_torch.perf.op_analysis import analyze
from repro_torch.tree import tree_flatten, tree_nbytes, tree_signature

from _torch_parity import ShapeMesh, configs, reference_dryrun

# ---------------------------------------------------------------------------
# the reference's abstract trees in the port's layout
# ---------------------------------------------------------------------------


def _node(x):
    """A reference tree with ``(shape, dtype)`` leaves (a ``KVCache`` as
    its ``k`` and ``v``)."""
    if x is None:
        return None
    if isinstance(x, JKVCache):
        return {"k": _node(x.k), "v": _node(x.v)}
    if isinstance(x, dict):
        return {k: _node(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_node(v) for v in x]
    return (tuple(x.shape), str(x.dtype))


def _unstack(node):
    """One period's subtree of a stacked subtree (the leading axis off)."""
    if isinstance(node, dict):
        return {k: _unstack(v) for k, v in node.items()}
    return (node[0][1:], node[1])


def _n_stacked(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node[0][0]


def _layers(cfg, stacked, rest) -> list:
    """Layer i of the reference's ``stacked`` (per pattern position,
    period-major) and ``rest`` lists, in layer order."""
    per = len(cfg.pattern)
    out = {}
    for pos, st in enumerate(stacked or []):
        if st is None:
            continue
        for i in range(_n_stacked(st)):
            out[i * per + pos] = _unstack(st)
    base = len(out)
    for j, lp in enumerate(rest or []):
        out[base + j] = lp
    return [out[i] for i in range(len(out))]


def ref_params(cfg) -> dict:
    tree = _node(JM.abstract_params(cfg)[0])
    out = {"embed": tree["embed"], "ln_f": tree["ln_f"],
           "layers": _layers(cfg, tree.get("blocks"), tree.get("rest"))}
    if "enc_blocks" in tree:
        enc = tree["enc_blocks"]
        out["enc_layers"] = [_unstack(enc)] * _n_stacked(enc)
    for k in ("enc_ln_f", "frontend"):
        if k in tree:
            out[k] = tree[k]
    return out


def ref_decode_state(cfg, shape) -> dict:
    tree = _node(JM.abstract_decode_state(cfg, shape))
    out = {"layers": _layers(cfg, tree["blocks"], tree["rest"])}
    if tree.get("cross") is not None or tree.get("cross_rest"):
        out["cross"] = _layers(cfg, tree.get("cross"),
                               tree.get("cross_rest"))
    return out


def _flat(node, path="") -> list:
    """``[(path, shape, dtype), ...]`` in ``tree_signature``'s order."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [e for k in sorted(node) for e in _flat(node[k],
                                                       f"{path}/{k}")]
    if isinstance(node, list):
        return [e for i, v in enumerate(node) for e in _flat(v,
                                                             f"{path}/{i}")]
    return [(path,) + node]


def port_sig(tree) -> list:
    return [e[:3] for e in tree_signature(tree)]


def _names(tree, path="", strip=False) -> dict:
    """``{path: names}`` of a tree of logical-name tuples (a KVCache's
    ``k`` and ``v``); ``strip`` drops a leading ``"stack"``."""
    if isinstance(tree, tuple):
        if strip and tree[:1] == ("stack",):
            tree = tree[1:]
        return {path: tree}
    if dataclasses.is_dataclass(tree):
        return {**_names(tree.k, f"{path}/k", strip),
                **_names(tree.v, f"{path}/v", strip)}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_names(tree[k], f"{path}/{k}", strip))
        return out
    out = {}
    for i, v in enumerate(tree or []):
        out.update(_names(v, f"{path}/{i}", strip))
    return out


def _ref_names_per_layer(cfg, specs, stacked="blocks", rest="rest"):
    """The reference's names of ``stacked``/``rest`` in layer order,
    ``"stack"`` dropped."""
    per = len(cfg.pattern)
    n_per, _ = cfg.pattern_periods
    out = {}
    for pos, st in enumerate(specs.get(stacked) or []):
        if st is None:
            continue
        for i in range(n_per if cfg.scan_layers and n_per > 1 else 0):
            out[i * per + pos] = _names(st, strip=True)
    base = len(out)
    for j, lp in enumerate(specs.get(rest) or []):
        out[base + j] = _names(lp)
    return [out[i] for i in range(len(out))]


# ---------------------------------------------------------------------------
# abstract models, decode states and batches: all ten published configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_model_matches_reference(arch):
    cfg = get_config(arch)
    params, specs = M.abstract_params(cfg)
    leaves = tree_flatten(params)[0]
    assert all(t.device.type == "meta" for t in leaves)
    assert port_sig(params) == _flat(ref_params(jget_config(arch)))
    n = sum(t.numel() for t in leaves)
    assert n == cfg.param_count() + T.param_count_gap(cfg)
    if arch == "kimi-k2-1t-a32b":
        assert n > 1.0e12
    # the names: the reference's, per layer ("stack" dropped)
    _, jspecs = JM.abstract_params(jget_config(arch))
    ours = _names(specs)
    layers = _ref_names_per_layer(cfg, jspecs)
    for i, ref in enumerate(layers):
        got = {k.removeprefix(f"/layers/{i}"): v for k, v in ours.items()
               if k.startswith(f"/layers/{i}/")}
        assert got == ref, (arch, i)
    for key in ("embed", "ln_f", "enc_ln_f", "frontend"):
        if key in jspecs:
            assert {k: v for k, v in ours.items()
                    if k.startswith(f"/{key}/")} == _names(jspecs[key],
                                                           f"/{key}")
    if "enc_blocks" in jspecs:
        enc = _names(jspecs["enc_blocks"], strip=True)
        got = {k.removeprefix("/enc_layers/0"): v for k, v in ours.items()
               if k.startswith("/enc_layers/0/")}
        assert got == enc


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_decode_state_and_inputs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = [SHAPES["decode_32k"], SHAPES["long_500k"]]
    for shape in shapes:
        st = M.abstract_decode_state(cfg, shape)
        assert port_sig(st) == _flat(ref_decode_state(
            jcfg, JSHAPES[shape.name])), shape.name
        assert all(e[0] for e in tree_signature(st))
        # the names, per layer and cross cache
        jnames = JM.decode_state_specs(jcfg, JSHAPES[shape.name])
        ours = _names(M.decode_state_specs(cfg, shape))
        for i, ref in enumerate(_ref_names_per_layer(cfg, jnames)):
            got = {k.removeprefix(f"/layers/{i}"): v
                   for k, v in ours.items()
                   if k.startswith(f"/layers/{i}/")}
            assert got == ref, (arch, shape.name, i)
        if cfg.cross_attn:
            refx = _ref_names_per_layer(cfg, jnames, "cross", "cross_rest")
            for i, ref in enumerate(refx):
                got = {k.removeprefix(f"/cross/{i}"): v
                       for k, v in ours.items()
                       if k.startswith(f"/cross/{i}/")}
                assert got == ref
    for shape in SHAPES.values():
        ours = M.input_specs(cfg, shape)
        ref = JM.input_specs(jcfg, JSHAPES[shape.name])
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in ours.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}
        assert all(v.device.type == "meta" for v in ours.values())


def test_windowed_ring_caches_hold_the_window():
    cfg = get_config("recurrentgemma-9b")
    st = M.abstract_decode_state(cfg, SHAPES["decode_32k"])
    caches = [c for c in st["layers"] if hasattr(c, "ring")]
    assert caches and all(c.ring and c.k.shape[1] == cfg.window
                          for c in caches)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_model_is_init_model_leaf_for_leaf(arch):
    cfg = get_reduced(arch)
    params, _ = T.abstract_model(cfg)
    real = T.init_model(cfg, seed=0, device="cpu")
    assert tree_signature(params) == tree_signature(real)
    st = T.init_decode_state(cfg, 2, 40, abstract=True)
    assert tree_signature(st) == tree_signature(
        T.init_decode_state(cfg, 2, 40, device="cpu"))
    opt = adamw(warmup_cosine(3e-4, 2, 5))
    assert tree_signature(opt.abstract_state(real)) == tree_signature(
        opt.init(real))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-9b",
                                  "kimi-k2-1t-a32b", "whisper-small",
                                  "internvl2-26b"])
def test_optimizer_state_and_names_match_reference(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    params, specs = M.abstract_params(cfg)
    jparams, jspecs = JM.abstract_params(jcfg)
    # AdamW: moments mirror the parameters exactly
    opt, jopt = adamw(warmup_cosine(3e-4, 2, 5)), jadamw(jwarmup(3e-4, 2, 5))
    st, jst = opt.abstract_state(params), jopt.abstract_state(jparams)
    for k in ("m", "v"):
        assert port_sig(st[k]) == _flat(ref_params(jcfg)) and \
            all(e[2] == "float32" for e in port_sig(st[k]))
    assert port_sig({"s": st["step"]}) == [("/s", (), str(jst["step"].dtype))]
    names = opt.state_specs(specs)
    assert names["m"] is specs and names["step"] == ()
    # Adafactor over the model's stack groups: the reference's state leaf
    # for leaf (its layout, shapes, dtypes) and its names, with no
    # exception (a stacked 1-D leaf's row over the layers, col over d)
    fac = adafactor(warmup_cosine(1e-4, 2, 5), stacks=T.stack_groups(cfg))
    jfac = jadafactor(jwarmup(1e-4, 2, 5))
    fst, jfst = fac.abstract_state(params), jfac.abstract_state(jparams)
    assert port_sig(fst["v"]) == _flat(_node(jfst["v"]))
    assert all(e[2] == "float32" for e in port_sig(fst["v"]))
    assert port_sig({"s": fst["step"]}) == [
        ("/s", (), str(jfst["step"].dtype))]
    assert _names(fac.state_specs(specs)["v"]) == \
        _names(jfac.state_specs(jspecs)["v"])
    assert fac.state_specs(specs)["step"] == ()
    n_periods, _ = cfg.pattern_periods
    stacked = [e for e in port_sig(fst["v"]) if e[0].startswith(
        ("/blocks/", "/enc_blocks/"))]
    assert bool(stacked) == (n_periods > 1 or bool(cfg.encoder_layers))


# ---------------------------------------------------------------------------
# model FLOPs, the attention credit, the scaling model
# ---------------------------------------------------------------------------

def test_model_flops_and_credit_match_reference_on_every_cell():
    cells = list(all_cells())
    assert len(cells) == 32
    for arch, shape in cells:
        cfg, jcfg = get_config(arch), jget_config(arch)
        jshape = JSHAPES[shape.name]
        assert roofline.model_flops(cfg, shape) == pytest.approx(
            jroofline.model_flops(jcfg, jshape), rel=1e-12, abs=0)
        for kw in ({}, {"chips": 16, "model_axis": 4, "microbatches": 2}):
            assert attention_credit.chunk_traffic_bytes(
                cfg, shape, **kw) == pytest.approx(
                jcredit.chunk_traffic_bytes(jcfg, jshape, **kw),
                rel=1e-12, abs=0)
        # the port's credit: the forward's passes only (x2 to train)
        fwd = attention_credit.chunk_pass_bytes(cfg, shape, 1, 1) * 4
        assert attention_credit.flash_credit_bytes(cfg, shape) == \
            pytest.approx(fwd * (2 if shape.kind == "train" else 1))
    rep = roofline.roofline_terms(
        "a", "s", "m", 1, dryrun_costs(2e15, 3.35e12), 1e12,
        hw=roofline.HW(peak_flops=1e15))
    assert rep.roofline_frac == pytest.approx(1e12 / 2.0 / 1e15)


def dryrun_costs(flops, nbytes):
    from repro_torch.perf.op_analysis import Costs
    return Costs(flops=flops, bytes=nbytes)


def _jhw() -> tmetrics.HardwareModel:
    """The reference's TPU constants, in the port's model."""
    return tmetrics.HardwareModel(**dataclasses.asdict(
        jmetrics.HardwareModel()))


SHARDS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]


@pytest.mark.parametrize("case", sorted(CASES))
def test_scaling_model_matches_reference_under_its_constants(case):
    c = CASES[case]
    from repro.configs.snn import CASES as JCASES
    jc = JCASES[case]
    law, jlaw = c.connectivity(), jc.connectivity()
    for rate in (38.0, 5.0):
        ours = tmetrics.strong_scaling_curve(
            c.grid[0], c.grid[1], law, SHARDS, rate, c.n_per_column,
            hw=_jhw())
        ref = jmetrics.strong_scaling_curve(
            jc.grid[0], jc.grid[1], jlaw, SHARDS, rate, jc.n_per_column)
        assert len(ours) == len(ref) == len(SHARDS)
        for a, b in zip(ours, ref):
            assert a["tiles"] == tuple(b["tiles"])
            for k in ("step_s", "compute_s", "memory_s", "collective_s",
                      "cost_per_event"):
                assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0), k
    spec = c.engine_config(2, 2).spec()
    jspec = jc.engine_config(2, 2).spec()
    a = tmetrics.step_time_model(spec, 38.0, hw=_jhw(), pack_spikes=False)
    b = jmetrics.step_time_model(jspec, 38.0, pack_spikes=False)
    assert a == pytest.approx(b, rel=1e-12)


def test_hardware_model_is_the_h100s():
    hw = tmetrics.HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (66.9e12, 3.35e12,
                                                      450e9)
    assert roofline.HW() == roofline.HW("h100-sxm", 989.4e12, 3.35e12,
                                        450e9)


# ---------------------------------------------------------------------------
# SNN tables and state
# ---------------------------------------------------------------------------

def _dist_cfgs(law, plastic: bool, members):
    jcfg, tcfg = configs(law, grid=4, n_per_col=30, tiles=2)
    if plastic:
        jcfg = dataclasses.replace(jcfg, stdp=JSTDP())
        tcfg = dataclasses.replace(tcfg, stdp=STDPParams())
    return (jde.DistConfig(engine=jcfg, ensemble_seeds=members),
            tde.DistConfig(engine=tcfg, ensemble_seeds=members))


@pytest.mark.parametrize("plastic,members", [(False, None), (True, None),
                                             (True, (3, 5))])
def test_abstract_dist_inputs_match_reference_and_real(plastic, members):
    jcfg, cfg = _dist_cfgs("gaussian", plastic, members)
    # the tables' spec alone: the reference's shapes and dtypes
    spec, jspec = cfg.engine.spec(), jcfg.engine.spec()
    tabs = spec.abstract_tables()
    jtabs = jspec.abstract_tables()
    assert port_sig({"local": tabs.local, "halo": list(tabs.halo)}) == \
        _flat(_node({"local": jtabs.local, "halo": list(jtabs.halo)}))
    assert spec.table_bytes() == tree_nbytes(tabs)
    # the analytic inputs against the reference's, rng and t aside
    state, tables = tde.abstract_dist_inputs(cfg, device="cpu")
    jstate, jtables = jde.abstract_dist_inputs(jcfg)
    jst = _node(jstate)
    lead = cfg.lead
    assert jst.pop("rng") == (lead + (2,), "uint32")
    assert jst.pop("t") == (lead, "int32")
    ours = {k: v for k, v in state.items() if k not in ("rng", "t")}
    assert port_sig(ours) == _flat(jst)
    assert port_sig(tables) == _flat(_node(
        {"local": jtables.local, "halo": list(jtables.halo)}))
    g = tde.generator_state_bytes("cpu")
    assert port_sig({"t": state["t"], "rng": state["rng"]}) == \
        [("/rng/%d" % i, (g,), "uint8") for i in range(int(np.prod(lead)))
         ] + [("/t", lead, "int32")]
    # built tables' storage: every leaf and byte of the real inputs
    real_tables, _ = tde.build_dist_tables(cfg, device="cpu")
    real_state = tde.init_dist_state(cfg, device="cpu")
    if plastic:
        real_state["plastic"] = tde.init_dist_plastic_state(cfg,
                                                            real_tables)
        real_tables = tde.fold_plastic_tables(real_tables)
    a_state, a_tables = tde.abstract_dist_inputs(
        cfg, storage=real_tables.storage, device="cpu")
    assert tree_signature((a_state, a_tables)) == tree_signature(
        (real_state, real_tables))
    assert tree_nbytes((a_state, a_tables)) == tree_nbytes(
        (real_state, real_tables))
    assert tde.generator_state_bytes("cuda") == 16


# ---------------------------------------------------------------------------
# the op counter
# ---------------------------------------------------------------------------

def test_op_analysis_counts_every_loop_iteration():
    """The counterpart of the reference's loop-aware HLO test: a Python
    loop of ten 128^3 products dispatches ten products."""
    x = torch.empty(128, 128, device="meta")
    w = torch.empty(128, 128, device="meta")

    def looped(x, w):
        for _ in range(10):
            x = x @ w
        return x.sum()

    c = analyze(looped, x, w)
    assert c.dot_flops == 10 * 2 * 128 ** 3
    assert c.by_op["mm"][2] == 10


def test_op_analysis_bytes_of_an_elementwise_chain():
    x = torch.empty(1000, device="meta")
    b = torch.empty(1, 1000, device="meta").expand(8, 1000)

    def chain(x, b):
        y = x * 2.0                       # read 4000, write 4000
        z = (y + b).to(torch.bfloat16)    # 4000 + 4000 + 32000; 32000 + 16000
        return torch.exp(z).view(-1)      # 16000 + 16000; the view is free

    c = analyze(chain, x, b)
    assert c.bytes == 8000 + 40000 + 48000 + 32000
    assert c.flops == 1000 + 8000 + 8000
    assert c.dot_flops == 0
    assert c.peak_bytes == 4000 + 32000 + 16000


def test_op_analysis_prefill_dot_flops_match_reference_hlo():
    """The reduced qwen2 prefill at Sq 128: the port's counted products
    equal the reference's loop-aware HLO count (``analyze_hlo`` of its
    jitted prefill) less the dead causal chunk pairs, which the
    reference's chunk loop multiplies and masks and the port's skips."""
    from repro.perf.hlo_analysis import analyze_hlo
    from repro.models.config import ShapeConfig as JShape
    from _torch_parity import serve_rules
    b, s = 2, 128
    jcfg = dataclasses.replace(jget_reduced("qwen2-1.5b"),
                               attn_impl="chunked")
    shape = JShape("prefill_128", s, b, "prefill")
    jparams, _ = JM.abstract_params(jcfg)
    compiled = jax.jit(JM.make_prefill(jcfg, serve_rules(jcfg, b, s))).lower(
        jparams, JM.input_specs(jcfg, shape),
        JM.abstract_decode_state(jcfg, shape)).compile()
    ref = analyze_hlo(compiled.as_text()).dot_flops

    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), attn_impl="chunked")
    tshape = ShapeConfig("prefill_128", s, b, "prefill")
    params, _ = M.abstract_params(cfg)
    c = analyze(M.make_prefill(cfg), params, M.input_specs(cfg, tshape),
                M.abstract_decode_state(cfg, tshape))
    cq = ck = cfg.attn_chunk_q
    live = attention_credit.live_chunk_pairs(s, s, cq, ck)
    dead = (s // cq) * (s // ck) - live
    pair = 2 * 2 * b * cfg.n_heads * cq * ck * cfg.resolved_head_dim
    assert c.dot_flops + cfg.n_layers * dead * pair == pytest.approx(
        ref, rel=0.01)


# ---------------------------------------------------------------------------
# the dry run on "meta"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b"])
def test_dryrun_cells_complete_on_meta(arch):
    out = {}
    for kind in ("prefill", "decode", "train"):
        r = dryrun.run_cell(arch, ShapeConfig(f"{kind}_64", 64, 2, kind),
                            out_dir=None, reduced=True)
        assert r["ok"], r.get("traceback")
        out[kind] = r
    pre = out["prefill"]
    assert pre["op_cost"]["dot_flops"] > 0
    assert pre["memory"]["peak_bytes"] > \
        pre["memory"]["input_state_bytes_per_device"] > 0
    assert pre["memory"]["fits_one_card"]
    assert out["decode"]["op_cost"]["dot_flops"] > 0
    tr = out["train"]
    # the train step's counted products cover 6 N T at least (remat
    # recomputes the forward on top)
    assert tr["op_cost"]["dot_flops"] >= 0.9 * tr["roofline"]["model_flops"]
    assert tr["roofline"]["hw"]["name"] == "h100-sxm"


def test_dryrun_snn_case_on_meta():
    r = dryrun.run_cell("snn-24x24-gaussian", "sim", out_dir=None)
    assert r["ok"], r.get("traceback")
    assert r["traced"] is False and r["memory"]["fits_one_card"]
    m = r["memory"]
    assert m["peak_bytes"] == m["input_state_bytes_per_device"] > 1e9
    assert r["step_time_model"]["step_s"] > 0
    assert r["roofline"]["dominant"] == "memory"


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "internvl2-26b"])
def test_dry_run_adafactor_state_matches_reference(arch):
    """The models above 15e9 parameters train with Adafactor in the dry
    run: its abstract state over the full-width model's stack groups
    equals the reference's Adafactor state leaf for leaf."""
    _, (params, opt_state, _), meta = dryrun.build_cell(arch, "train_4k")
    assert meta["optimizer"] == "adafactor"
    jparams, _ = JM.abstract_params(jget_config(arch))
    jst = jadafactor(jwarmup(1e-4, 100, 10000)).abstract_state(jparams)
    assert port_sig(opt_state["v"]) == _flat(_node(jst["v"]))
    assert all(t.device.type == "meta"
               for t in tree_flatten(opt_state)[0])


# ---------------------------------------------------------------------------
# the dry run on the production meshes (a rank's step, DryCollectives)
# ---------------------------------------------------------------------------

def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _ref_shard_bytes(tree, specs, rules, amesh) -> int:
    """The bytes of one device's shard of every leaf of the reference's
    abstract ``tree`` under its logical ``specs`` (``NamedSharding``
    over an ``AbstractMesh``: shapes only)."""
    from jax.sharding import NamedSharding
    leaves = jax.tree.leaves(tree)
    names = jax.tree.leaves(specs, is_leaf=_is_names)
    assert len(leaves) == len(names)
    return sum(int(np.prod(NamedSharding(amesh, rules.pspec(*n))
                           .shard_shape(x.shape))) * x.dtype.itemsize
               for x, n in zip(leaves, names))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JM.abstract_params(jget_config(arch))


def reference_input_bytes(arch, shape_name, mesh_kind) -> int:
    """The reference's per-device bytes of a cell's abstract inputs on a
    production mesh, as its ``build_cell`` lays them (``_rules_for``,
    ``_batch_rules``; params, the optimizer state, the decode state and
    the batch) less its scalar ``pos`` (a Python int in the port)."""
    from jax.sharding import AbstractMesh
    jdryrun = reference_dryrun()
    # the reference's make_production_mesh
    shape, axes = {"single": ((16, 16), ("data", "model")),
                   "multi": ((2, 16, 16), ("pod", "data", "model"))}[
                       mesh_kind]
    amesh = AbstractMesh(shape, axes)
    cfg = jget_config(arch)
    rules, dp = jdryrun._rules_for(cfg, ShapeMesh(shape, axes))
    jshape = JSHAPES[shape_name]
    rules = jdryrun._batch_rules(rules, jshape, dp)
    params, specs = _ref_params(arch)
    total = _ref_shard_bytes(params, specs, rules, amesh)
    if jshape.kind == "decode":
        token = jax.ShapeDtypeStruct((jshape.global_batch, 1), np.int32)
        return total + _ref_shard_bytes(
            (JM.abstract_decode_state(cfg, jshape), token),
            (JM.decode_state_specs(cfg, jshape), ("batch", None)), rules,
            amesh)
    batch = JM.input_specs(cfg, jshape)
    total += _ref_shard_bytes(
        batch, {k: ("batch",) + (None,) * (len(v.shape) - 1)
                for k, v in batch.items()}, rules, amesh)
    if jshape.kind == "prefill":
        return total + _ref_shard_bytes(JM.abstract_decode_state(cfg, jshape),
                                        JM.decode_state_specs(cfg, jshape),
                                        rules, amesh)
    big = sum(x.size for x in jax.tree.leaves(params)) > 15e9
    opt = jadafactor(jwarmup(1e-4, 100, 10000)) if big \
        else jadamw(jwarmup(3e-4, 100, 10000))
    return total + _ref_shard_bytes(opt.abstract_state(params),
                                    opt.state_specs(specs), rules, amesh)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_mesh_cells_hold_the_references_bytes_per_device(arch):
    """For every cell of ``arch`` on both production meshes, the dry
    run's inputs (rank 0's blocks on ``"meta"``: parameters, optimizer
    state, decode state and batch slice) hold exactly the reference's
    per-device bytes of the same abstract inputs under its rules
    (``NamedSharding(AbstractMesh).shard_shape``): shapes only, no
    trace."""
    from repro_torch.configs import shape_cells
    for mesh_kind in dryrun.MESHES:
        mesh = dryrun.production_rank_mesh(mesh_kind)
        for shape in shape_cells(arch):
            _, args, meta = dryrun.build_cell(arch, shape.name, mesh=mesh)
            got = dryrun.analytic_memory(args)[
                "input_state_bytes_per_device"]
            want = reference_input_bytes(arch, shape.name, mesh_kind)
            assert got == want, (mesh_kind, shape.name, got, want)
            assert meta["rank"] == 0 and all(
                t.device.type == "meta" for t in tree_flatten(args[0])[0])


def test_dry_collectives_follow_the_ring_convention():
    """``DryCollectives`` on rank 0 of a (data 2, model 2) mesh of
    shapes: an all-reduce of 60 bytes over 2 ranks puts 2 x 60 x 1 / 2
    = 60 on the wire, an all-gather of a 60-byte block over 4 ranks (a
    folded axis) 60 x 3 = 180, its output the four blocks joined; the
    channels count as the gloo transport does (an all-reduce its bytes
    sent and received, an all-gather its block sent and the others'
    received), seconds 0; the groups are the real ones."""
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.parallel.collectives import _rank_groups, attach_dry
    mesh = attach_dry(RankMesh((2, 2), ("data", "model"), 0))
    comm = mesh.comm
    x = torch.empty((3, 5), dtype=torch.float32, device="meta")
    y = comm.all_reduce(x, "model", channel="tp")
    assert y.shape == x.shape and y.device.type == "meta"
    z = comm.all_gather(x, ("data", "model"), 0, channel="fsdp")
    assert z.shape == (12, 5)
    assert len(comm.all_gather_list(x, "data")) == 2
    coll, by_kind = comm.wire()
    assert by_kind == {"all-reduce": 60.0, "all-gather": 180.0 + 60.0}
    assert coll == 300.0
    assert comm.stats["tp"] == {"calls": 1, "bytes_sent": 60,
                                "bytes_received": 60, "seconds": 0.0}
    assert comm.stats["fsdp"] == {"calls": 1, "bytes_sent": 60,
                                  "bytes_received": 180, "seconds": 0.0}
    assert comm._groups[("model",)] == (0, 1)
    assert comm._groups[("data", "model")] == (0, 1, 2, 3)
    assert [list(g) for g in [comm._groups[("data",)]]] == [
        g for g in _rank_groups(mesh, ("data",)) if 0 in g]
    # a collective over an axis of one rank is the identity, uncounted
    one = attach_dry(RankMesh((1, 2), ("data", "model"), 1))
    assert one.comm.all_reduce(x, "data") is x and not one.comm.stats


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b"])
def test_dryrun_mesh_cells_complete_on_meta(arch):
    """The reduced cells complete as a rank of (data 2, model 2) and of
    (pod 2, data 2, model 2) meshes of shapes (no process group), in
    prefill, decode and train: FLOPs, bytes and peak a rank, calls per
    channel, wire bytes by kind, and a collective term > 0."""
    from repro_torch.launch.mesh import RankMesh
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        for kind in ("prefill", "decode", "train"):
            r = dryrun._run_lm(arch, ShapeConfig(f"{kind}_32", 32, 4, kind),
                               None, True, RankMesh(shape, axes, 0),
                               "x".join(map(str, shape)))
            coll = r["collectives"]
            assert r["chips"] == int(np.prod(shape))
            assert coll["coll_bytes"] > 0 and coll["channels"]
            assert coll["coll_bytes"] == pytest.approx(
                sum(coll["coll_by_kind"].values()))
            assert r["roofline"]["collective_s"] > 0
            assert r["op_cost"]["dot_flops"] > 0
            assert r["memory"]["peak_bytes"] > \
                r["memory"]["input_state_bytes_per_device"] > 0
            if kind == "train":
                assert {"grad", "loss", "norm"} <= set(coll["channels"])


def test_dryrun_main_on_the_production_meshes(tmp_path, capsys):
    """``--mesh both`` writes one record a mesh, named as the reference
    names its cells; an SNN case takes the mesh's tiles, (16, 16) and
    (32, 16), and reports one tile's bytes and the halo's collective
    term."""
    dryrun.main(["--arch", "snn-24x24-gaussian", "--mesh", "both", "--out",
                 str(tmp_path)])
    for kind, tiles in (("single", [16, 16]), ("multi", [32, 16])):
        r = dryrun.run_cell("snn-24x24-gaussian", "sim", out_dir=str(tmp_path),
                            mesh_kind=kind)
        assert (tmp_path / f"snn-24x24-gaussian__sim__{kind}.json").exists()
        assert r["ok"] and list(r["meta"]["tiles"]) == tiles
        assert r["chips"] == tiles[0] * tiles[1]
        assert r["step_time_model"]["collective_s"] > 0
        assert r["roofline"]["collective_s"] == \
            r["step_time_model"]["collective_s"]
    assert capsys.readouterr().out.count("[OK ]") == 2
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_cell("qwen2-1.5b", "train_4k", out_dir=None,
                        mesh_kind="4x4")
