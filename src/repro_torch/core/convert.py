"""Carry the JAX package's tables, state and weights across to the port.

The counterpart of loading weights: ``tables_from_arrays``,
``state_from_arrays`` and ``plasticity_from_arrays`` take the
reference's synapse tables (bfloat16 or float32 weights), simulation
state and STDP auxiliaries as numpy arrays (``np.asarray`` of each leaf)
and return the port's; ``model_params_from_arrays`` does the same for
the parameters of an LM (and any tree of their structure: gradients,
moments), ``adamw_state_from_arrays`` and ``adafactor_state_from_arrays``
for the optimizers' states.  bfloat16 arrays (ml_dtypes' ``bfloat16``)
are reinterpreted bit for bit, so neither ml_dtypes nor jax is needed
here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.layers import torch_dtype
from .engine import EngineConfig
from .synapses import TORCH_DTYPES, SynapseTables, TableStorage


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind not in "iu":
        # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    elif dtype == torch.bfloat16:
        f = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        t = f.to(torch.bfloat16)
        if not torch.equal(t.to(torch.float32), f):
            raise ValueError("weights are not bfloat16-representable")
    else:
        t = torch.from_numpy(np.array(a)).to(dtype)
    # ascontiguousarray makes 0-d arrays 1-d; restore the shape
    return t.reshape(a.shape).to(device)


def _tier(arrays: dict, storage: TableStorage, device) -> dict:
    return {"tgt": _tensor(arrays["tgt"], TORCH_DTYPES[storage.tgt_dtype],
                           device),
            "w": _tensor(arrays["w"], TORCH_DTYPES[storage.weight_dtype],
                         device),
            "dslot": _tensor(arrays["dslot"], torch.int8, device),
            "nnz": _tensor(arrays["nnz"], torch.int32, device)}


def tables_from_arrays(local: dict, halo: Sequence[dict], storage_meta: dict,
                       stats: Optional[dict] = None,
                       device="cuda") -> SynapseTables:
    """The port's tables from the reference's: ``local`` and each ``halo``
    tier as dicts of numpy arrays, ``storage_meta`` the reference's
    ``TableStorage.meta()``."""
    dev = resolve_device(device)
    storage = TableStorage.from_meta(storage_meta)
    tabs = SynapseTables(_tier(local, storage, dev),
                         [_tier(t, storage, dev) for t in halo], storage,
                         stats=stats)
    caps = [t["tgt"].shape[1] for t in tabs.tiers()]
    if caps != storage.caps():
        raise ValueError(f"table capacities {caps} do not match the "
                         f"storage descriptor {storage.caps()}")
    return tabs


def state_from_arrays(arrays: dict, cfg: EngineConfig,
                      rng_seed: Optional[int] = None,
                      device="cuda") -> dict:
    """The port's state from the reference's state dict of numpy arrays.

    The reference's PRNG key has no torch counterpart: the drive
    generator is seeded with ``rng_seed`` (default: the seed
    ``init_sim_state`` uses for tile (0, 0))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.state_seed_value if rng_seed is None else rng_seed)

    def f32(x):
        return _tensor(x, torch.float32, dev)

    nrn = arrays["neuron"]
    return {
        "neuron": {"v": f32(nrn["v"]), "c": f32(nrn["c"]),
                   "refrac": _tensor(nrn["refrac"], torch.int32, dev)},
        "i_ring": f32(arrays["i_ring"]),
        "t": int(np.asarray(arrays["t"])),
        "rng": gen,
        "active": _tensor(arrays["active"], torch.bool, dev),
        "metrics": {k: f32(arrays["metrics"][k])
                    for k in ("spikes", "events", "dropped")},
    }


def plasticity_from_arrays(aux: dict, device="cuda") -> dict:
    """The port's ``init_plasticity`` output from the reference's, as
    numpy arrays: the inverse index (``slots``, ``n_in``, ``bases``,
    ``sizes``, ``total``, ``clipped``), the masks and the traces."""
    dev = resolve_device(device)
    inv = aux["inv"]

    def f32(x):
        return _tensor(x, torch.float32, dev)

    return {
        "inv": {"slots": _tensor(inv["slots"], torch.int32, dev),
                "n_in": _tensor(inv["n_in"], torch.int32, dev),
                "bases": np.asarray(inv["bases"], dtype=np.int64),
                "sizes": np.asarray(inv["sizes"], dtype=np.int64),
                "total": int(inv["total"]), "clipped": int(inv["clipped"])},
        "masks": [f32(m) for m in aux["masks"]],
        "traces": {"x_pre": [f32(x) for x in aux["traces"]["x_pre"]],
                   "x_post": f32(aux["traces"]["x_post"])},
    }


# the leaves the reference keeps in float32 whatever the model's dtype:
# the MoE router, the mamba block's dt_bias, a_log and d_skip, the RG-LRU
# block's gate biases and decay parameter
FLOAT32_LEAVES = ("router", "dt_bias", "a_log", "d_skip", "b_a", "b_x",
                  "lam")


def model_params_from_arrays(cfg, tree: dict, device="cuda",
                             dtype: Optional[str] = None) -> dict:
    """The port's LM parameters (``models.transformer`` layout) from the
    reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), in ``dtype`` (default
    ``cfg.dtype``, and float32 for the leaves the reference keeps in
    float32, ``FLOAT32_LEAVES``).  Any tree of the parameters' structure
    crosses the same way: gradients (``jax.grad``'s), AdamW's ``m`` and
    ``v`` (``dtype="float32"``).

    The reference stacks the layers of pattern position ``pos`` in
    ``blocks[pos]`` with a leading period axis and keeps the remainder
    layers in ``rest``: period ``i`` of ``blocks[pos]`` is layer
    ``i * len(cfg.pattern) + pos``, and ``rest`` follows (recurrentgemma:
    12 periods of (rglru, rglru, attn), then its 2 remainder rglru
    layers).  A decoder layer's ``cross`` and ``ln_x`` come with it.  The
    encoder's blocks (``enc_blocks``, stacked over the encoder's layers)
    become ``enc_layers``; ``enc_ln_f`` and ``frontend`` cross as they
    are."""
    dev = resolve_device(device)
    base_dtype = torch_dtype(dtype or cfg.dtype)
    keep_f32 = dtype is None

    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        f32 = keep_f32 and name in FLOAT32_LEAVES
        return _tensor(node, torch.float32 if f32 else base_dtype, dev)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    per = len(cfg.pattern)
    layers = {}
    for pos, stacked in enumerate(tree.get("blocks") or []):
        for i in range(np.asarray(stacked["ln1"]["scale"]).shape[0]):
            layers[i * per + pos] = conv(take(stacked, i))
    base = len(layers)
    for j, lp in enumerate(tree.get("rest") or []):
        layers[base + j] = conv(lp)
    if sorted(layers) != list(range(cfg.n_layers)):
        raise ValueError(f"the tree holds layers {sorted(layers)}, the "
                         f"config has {cfg.n_layers}")
    out = {"embed": conv(tree["embed"]), "ln_f": conv(tree["ln_f"]),
           "layers": [layers[i] for i in range(cfg.n_layers)]}
    if "enc_blocks" in tree:
        enc = tree["enc_blocks"]
        n_enc = np.asarray(enc["ln1"]["scale"]).shape[0]
        if n_enc != cfg.encoder_layers:
            raise ValueError(f"the tree holds {n_enc} encoder layers, the "
                             f"config has {cfg.encoder_layers}")
        out["enc_layers"] = [conv(take(enc, i)) for i in range(n_enc)]
    for name in ("enc_ln_f", "frontend"):
        if name in tree:
            out[name] = conv(tree[name])
    return out


def adamw_state_from_arrays(cfg, state: dict, device="cuda") -> dict:
    """The port's AdamW state (``optim.adamw``) from the reference's, as
    numpy arrays: ``m`` and ``v`` in the parameters' layout in float32,
    ``step`` an int32 0-d tensor."""
    dev = resolve_device(device)
    return {"m": model_params_from_arrays(cfg, state["m"], dev, "float32"),
            "v": model_params_from_arrays(cfg, state["v"], dev, "float32"),
            "step": _tensor(state["step"], torch.int32, dev)}


def adafactor_state_from_arrays(cfg, state: dict, device="cuda") -> dict:
    """The port's Adafactor state (``optim.adafactor(..., stacks=
    transformer.stack_groups(cfg))``) from the reference's, as numpy
    arrays: the moments keep the reference's layout (``blocks``,
    ``rest``, ``enc_blocks`` and the other parameter keys), each leaf in
    float32, ``step`` an int32 0-d tensor."""
    from ..models.transformer import stack_groups
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, torch.float32, dev)

    v = conv(state["v"])
    for key, (_, entries) in stack_groups(cfg).items():
        n = 1 if isinstance(entries, tuple) else len(entries)
        got = 1 if isinstance(entries, tuple) else len(v.get(key) or [])
        if key not in v or got != n:
            raise ValueError(f"the state's {key!r} does not hold the "
                             f"config's {n} entries")
    return {"v": v, "step": _tensor(state["step"], torch.int32, dev)}
