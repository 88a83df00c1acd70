"""Port parity: LM serving on ranks over ``torch.distributed`` (gloo,
CPU), against the JAX reference's ``make_prefill`` / ``make_serve_step``
run meshless and jitted on one device.

Each reduced float32 config (qwen2-1.5b with GQA and biases,
recurrentgemma-9b with a 16-slot ring that wraps, falcon-mamba-7b,
granite-moe-1b-a400m at S = 1, whisper-small's encoder and cross
caches, internvl2-26b's patch prefix) is served on (data 2, model 2) and
(data 1, model 4) under ``launch.serve.serve_rules``: the KV caches
split by sequence (``kv_seq``), the mamba and RG-LRU channels by
``d_inner``, the query heads by ``heads``.  Prefill and every decode
step's logits are held within 1e-4 of the largest |logit|, the greedy
tokens must be equal, and the gathered decode state equals the
one-process port's.  One case leaves the state's length indivisible
(``kv_seq`` whole) and one decodes while ranks 1.. hold only masked
slots.  A two-part prefill (the second part at ``cache_pos > 0``) is
held against the one-process port, and one AdamW step of the recurrent
and frontend families on (pod 2, data 1, model 2) against the
one-process step.  Under ``seq`` (the prompt's positions split over
``model``) the dense, mamba and whisper configs serve on (2, 2), and
three configs at lengths that do not divide over it.  The test process runs the reference and writes one
job; one spawn of 4 ranks (one torch thread each) runs every case
(``tests/_torch_serve_ranks.py``) and each rank writes its verdicts.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import model as jm
from repro.models import transformer as jt
from repro.parallel.sharding import MeshRules as JRules
from repro_torch import configs as tconfigs
from repro_torch.core.convert import model_params_from_arrays
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.parallel import sharding as S

import _torch_serve_ranks as W
from _torch_parity import frontend_inputs, lm_params

BATCH = 2
# (arch, prompt, tokens decoded, the state's length (None: prompt +
# tokens, a VLM's patches counted), a two-part prefill too)
SERVE = {
    "qwen2-1.5b": ("qwen2-1.5b", 12, 4, None, True),
    # 12 + 5 = 17 slots divide over no model axis: kv_seq stays whole
    "qwen2-1.5b-indivisible": ("qwen2-1.5b", 12, 5, None, False),
    # 32 slots, decode at 3..6: every slot of ranks 1.. is masked
    "qwen2-1.5b-masked": ("qwen2-1.5b", 3, 4, 32, False),
    # window 16 < 24: the ring wraps in the prefill and in decode
    "recurrentgemma-9b": ("recurrentgemma-9b", 24, 8, None, True),
    "falcon-mamba-7b": ("falcon-mamba-7b", 20, 4, None, True),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", 12, 4, None, True),
    "whisper-small": ("whisper-small", 12, 4, None, True),
    "internvl2-26b": ("internvl2-26b", 12, 4, None, True),
}
# served on 2x2 under seq="model" at lengths that do not divide over its
# 2 ranks: (arch, prompt, tokens decoded, config overrides): 13 tokens;
# 8 patches + 11 tokens; 11 encoder frames and 9 tokens
SEQ_ODD = {
    "qwen2-1.5b-odd": ("qwen2-1.5b", 13, 3, {}),
    "internvl2-26b-odd": ("internvl2-26b", 11, 3, {}),
    "whisper-small-odd": ("whisper-small", 9, 3, {"encoder_seq": 11}),
}
TRAIN = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-small",
         "internvl2-26b")
TRAIN_BATCH, TRAIN_SEQ = 4, 32


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def serve_case(arch, prompt, gen, max_len, two_part, overrides=None) -> dict:
    """The reference's prefill and ``gen`` greedy steps, meshless and
    jitted (its MoE then takes the dispatch the port ports): the
    weights (``lm_params``), the inputs, every step's logits and the
    tokens; the port's config and weights.  ``overrides``: fields of
    both configs."""
    jcfg = dataclasses.replace(jget_reduced(arch), **(overrides or {}))
    jp, arrays = lm_params(jcfg)
    cfg = dataclasses.replace(tconfigs.get_reduced(arch), **(overrides or {}))
    rng = np.random.default_rng(7)
    inputs = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, prompt))
              .astype(np.int32), **frontend_inputs(jcfg, rng, BATCH)}
    start = jcfg.n_patches + prompt
    max_len = max_len or start + gen
    rules = JRules()
    jlg, jst = jax.jit(jm.make_prefill(jcfg, rules))(
        jp, {k: jnp.asarray(v) for k, v in inputs.items()},
        jt.init_decode_state(jcfg, BATCH, max_len))
    step = jax.jit(jm.make_serve_step(jcfg, rules))
    logits, toks = [_t(jlg)], []
    for i in range(gen):
        tok = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        jlg, jst = step(jp, jst, tok, jnp.int32(start + i))
        logits.append(_t(jlg))
    return {"cfg": cfg,
            "params": model_params_from_arrays(cfg, arrays, device="cpu"),
            "inputs": {k: torch.from_numpy(v) for k, v in inputs.items()},
            "gen": gen, "max_len": max_len, "two_part": two_part,
            "ref_logits": logits,
            "ref_tokens": torch.from_numpy(np.concatenate(toks, axis=1))}


def train_case(arch) -> dict:
    """A reduced float32 config's weights (``lm_params``), a numpy batch
    (with whisper's frames or a VLM's patches), and the one-process
    port's loss, gradients and parameters after one AdamW step."""
    from repro_torch.optim import adamw, constant
    cfg = tconfigs.get_reduced(arch)
    _, arrays = lm_params(jget_reduced(arch))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)) \
        .astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens,
             **frontend_inputs(cfg, rng, TRAIN_BATCH)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = model_params_from_arrays(cfg, arrays, device="cpu")
    _, _, grads = tm._grads_of(params, cfg, batch)
    opt = adamw(constant(W.LR))
    p1, _, out = tm.make_train_step(cfg, opt)(
        model_params_from_arrays(cfg, arrays, device="cpu"),
        opt.init(params), batch)
    return {"cfg": cfg, "params": params, "batch": batch,
            "loss": float(out["loss"]), "grads": grads, "p1": p1}


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """Every case on 4 ranks: ``{case: [rank result, ...]}``."""
    job = {"serve": {k: serve_case(*v) for k, v in SERVE.items()},
           "serve_seq_odd": {k: serve_case(a, p, g, None, False, ov)
                             for k, (a, p, g, ov) in SEQ_ODD.items()},
           "train": {a: train_case(a) for a in TRAIN},
           "serve_batch": {"arch": "qwen2-1.5b", "batch": 4, "prompt": 8,
                           "gen": 4}}
    out_dir = tmp_path_factory.mktemp("serve_ranks")
    path = out_dir / "job.pt"
    torch.save(job, path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmesh.spawn_ranks(W.worker, 4, args=(str(path),), timeout_s=600,
                          store_dir=str(out_dir))
    finally:
        torch.set_num_threads(n)
    per_rank = [json.loads((out_dir / f"result_{r}.json").read_text())
                for r in range(4)]
    return {name: [r[name] for r in per_rank] for name in per_rank[0]}


def check(results: list) -> None:
    errors = [(rank, r["errors"]) for rank, r in enumerate(results)
              if r["errors"]]
    assert not errors, errors


MESHES = sorted(W.SERVE_MESHES)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(SERVE))
def test_torch_rank_serving_matches_reference(ranks4, case, mesh):
    """Prefill and each decode step's logits within 1e-4 of the largest
    |logit| of the reference's, the same greedy tokens, the gathered
    decode state after the prefill and at the end the one-process
    port's (1e-5); the blocks gather back to the parameters bit for
    bit, ``rank_nbytes`` and the dry run's decode-state bytes are what
    a rank holds."""
    check(ranks4[f"serve/{case}/{mesh}"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(k for k, v in SERVE.items()
                                        if v[4]))
def test_torch_two_part_prefill_on_ranks(ranks4, case, mesh):
    """A prefill continued at ``cache_pos > 0`` (over the cache gathered
    over ``kv_seq``, a wrapped ring included) gives the one-process
    port's last logits (1e-4) and decode state (1e-5)."""
    check(ranks4[f"two_part/{case}/{mesh}"])


@pytest.mark.parametrize("mesh", MESHES)
def test_torch_fully_masked_ranks_add_nothing(ranks4, mesh):
    """Decode steps at ``cache_pos < S / M``: the ranks past the first
    hold masked slots only (m = -1e30), weigh exactly nothing, and every
    logit is finite and the reference's."""
    results = ranks4[f"serve/qwen2-1.5b-masked/{mesh}"]
    check(results)
    assert all(r["kv_seq"] == "model" for r in results)
    assert all(np.isfinite(r["gaps"]).all() for r in results)


def test_torch_serve_rules_are_the_references_overrides(ranks4):
    """``kv_seq`` stays whole when the state's length does not divide
    over ``model`` (17 slots), ``heads`` when the heads do not (qwen2's
    six on four ranks); otherwise the caches split by sequence."""
    for mesh in MESHES:
        for r in ranks4[f"serve/qwen2-1.5b-indivisible/{mesh}"]:
            assert r["kv_seq"] is None
        for r in ranks4[f"serve/recurrentgemma-9b/{mesh}"]:
            assert r["kv_seq"] == "model"
    assert all(r["heads"] is None
               for r in ranks4["serve/qwen2-1.5b/1x4"])
    assert all(r["heads"] == "model"
               for r in ranks4["serve/qwen2-1.5b/2x2"])


def test_torch_serve_batch_on_ranks(ranks4):
    """``serve_batch(mesh=)`` on (2, 2): the one-process tokens on every
    rank, and collectives in both stages."""
    check(ranks4["serve_batch"])
    for r in ranks4["serve_batch"]:
        assert r["calls"]["prefill"] > 0 and r["calls"]["decode"] > 0


@pytest.mark.parametrize("arch", TRAIN)
def test_torch_rank_training_of_the_new_blocks(ranks4, arch):
    """One AdamW step on (pod 2, data 1, model 2) through the ``d_inner``
    blocks (mamba, RG-LRU), the encoder and cross-attention, and the
    patch prefix: the one-process loss within 1e-5 and every leaf within
    2e-5 (the tolerances of tests/test_torch_lm_ranks.py)."""
    check(ranks4[f"train/{arch}"])
    losses = {r["loss"] for r in ranks4[f"train/{arch}"]}
    assert len(losses) == 1


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_torch_halves_blocks_hold_both_halves(shape):
    """A ``Halves`` dim's block is the rank's slice of each half, ``[x_r
    | z_r]``: so a rank's ``torch.chunk(xz, 2)`` is its channels of both
    projections; the blocks tile the leaf and ``block_shape`` is their
    shape.  ``Halves("d_inner")`` is the plain name to every rule."""
    mesh_axes = ("data", "model")
    d, di = 6, 8
    x = torch.arange(d * 2 * di, dtype=torch.float32).reshape(d, 2 * di)
    names = ("fsdp", S.Halves("d_inner"))
    assert names == ("fsdp", "d_inner")
    seen = torch.zeros_like(x)
    for r in range(int(np.prod(shape))):
        rules = S.rules_for_mesh(tmesh.RankMesh(shape, mesh_axes, r))
        b = S.block(x, names, rules)
        i, n = rules.mesh.axis_index("model"), shape[1]
        f, nf = rules.mesh.axis_index("data"), shape[0]
        rows = slice(f * d // nf, (f + 1) * d // nf)
        cols = torch.cat([torch.arange(i * di // n, (i + 1) * di // n),
                          di + torch.arange(i * di // n, (i + 1) * di // n)])
        assert torch.equal(b, x[rows][:, cols])
        assert tuple(b.shape) == S.block_shape(tuple(x.shape), names, rules)
        seen[rows.start:rows.stop, cols] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not divide"):
        S.block(torch.ones(2, 6), (None, S.Halves("d_inner")),
                S.rules_for_mesh(tmesh.RankMesh((1, 4), mesh_axes, 0)))


def test_torch_serve_launcher_on_ranks(capsys):
    """``python -m repro_torch.launch.serve --nproc 2 --mesh 1x2``: the
    ranks serve and rank 0 reports the slowest rank's times and its
    collectives of each stage."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tserve.main(["--arch", "qwen2-1.5b", "--batch", "2", "--prompt-len",
                     "8", "--gen", "3", "--device", "cpu", "--nproc", "2",
                     "--mesh", "1x2"])
    finally:
        torch.set_num_threads(n)


def test_torch_rank_decode_state_is_the_named_blocks():
    """``init_decode_state(..., rules=)`` on a mesh of shapes: each leaf
    is ``block_shape`` of the whole leaf under ``decode_state_specs``
    (KV caches by batch and sequence, recurrent states by channel,
    cross caches by batch), and the dry run counts its bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tt
    from repro_torch.models.config import ShapeConfig
    for arch in ("recurrentgemma-9b", "falcon-mamba-7b", "whisper-small"):
        cfg = tconfigs.get_reduced(arch)
        shape = ShapeConfig("serve", 32, 4, "decode")
        rules = tserve.serve_rules(cfg, tmesh.RankMesh((2, 2), (
            "data", "model"), 3), 4, 32)
        got = tt.init_decode_state(cfg, 4, 32, abstract=True, rules=rules)
        whole = tm.abstract_decode_state(cfg, shape)
        names = tm.decode_state_specs(cfg, shape)
        pairs = list(zip(tt.decode_state_leaves(got),
                         tt.decode_state_leaves(whole)))
        spec_names = []
        tt._map_named(lambda x, n: spec_names.append(n), names, names)
        assert [n for (_, n), _ in pairs] == spec_names
        for (g, n), (w, _) in pairs:
            assert tuple(g.shape) == S.block_shape(tuple(w.shape), n, rules)
            assert g.dtype == w.dtype
        assert dryrun.rank_bytes(cfg, rules, serving=shape)[
            "decode_state"] == sum(g.numel() * g.element_size()
                                   for (g, _), _ in pairs)
        if cfg.cross_attn:
            assert got["cross"][0].k.shape[1] == cfg.encoder_seq


@pytest.mark.parametrize("case", W.SEQ_SERVE)
def test_torch_seq_serving_matches_reference(ranks4, case):
    """Prefill and decode on (data 2, model 2) with the prompt's
    positions (whisper's encoder frames too) split over ``model``
    (``seq``): the logits within 1e-4 of the reference's largest, the
    same greedy tokens and the one-process port's decode state, as
    ``test_torch_rank_serving_matches_reference`` holds them; the
    prefill went through the seq gathers, decode's one position
    whole."""
    results = ranks4[f"serve_seq/{case}"]
    check(results)
    assert all(r["seq_calls"] > 0 for r in results)


@pytest.mark.parametrize("case", sorted(SEQ_ODD))
def test_torch_seq_serving_at_an_indivisible_length_matches_reference(
        ranks4, case):
    """Prefill and decode on (data 2, model 2) under ``seq="model"`` at
    lengths that do not divide over its 2 ranks (a 13-token prompt;
    internvl's 8 patches + 11 tokens; whisper's 11 encoder frames and 9
    tokens), each rank's block padded between blocks
    (``transformer.seq_axes``): the logits within 1e-4 of the
    reference's largest, the same greedy tokens and the one-process
    port's decode state, as ``test_torch_rank_serving_matches_reference``
    holds them; the prefill went through the seq gathers."""
    results = ranks4[f"serve_seq_odd/{case}"]
    check(results)
    assert all(r["seq_calls"] > 0 for r in results)
