"""Logical-axis sharding rules for the LM stack (the port of
``repro.parallel.sharding``).

Every parameter and activation is named by *logical* axes;
``MeshRules`` maps them onto the axes of a rank mesh
(``launch.mesh.RankMesh``).  Changing parallelism = changing one rule,
not the model code.

Default mapping (mesh ("data", "model"), or ("pod", "data", "model")):

  batch          -> ("pod","data")   data parallelism (pod extends DP)
  fsdp (params)  -> "data"           FSDP: parameters and optimizer state
                                     sharded over the data ranks of a
                                     pod, gathered per layer
  heads          -> "model"          tensor parallelism (when divisible)
  mlp / experts  -> "model"          TP for the dense FFN, EP for MoE
  vocab          -> "model"          vocab-parallel embedding + logits
  kv_seq         -> "model"          decode-time KV caches (each rank
                                     holds a range of the slots)
  d_inner        -> "model"          the SSM / RG-LRU channels
  seq            -> None             (sequence parallelism between
                                     blocks, any length:
                                     ``transformer.seq_axes``)

The reference hands its specs to XLA (``NamedSharding``, GSPMD); here
the layout is explicit.  Each rank holds its ``block`` of every
parameter, the model code gathers and reduces what it needs
(``parallel.collectives``), and ``gather_block`` puts a whole tensor
back.  So ``constrain`` has nothing to constrain: it is the identity.

Two-halves leaves.  The mamba and RG-LRU ``in_proj`` (d, 2 di) holds
two projections side by side, ``[x | z]``, which the block splits in
half; its dim is named ``Halves("d_inner")``, which equals
``"d_inner"`` (the reference's name).  GSPMD reshuffles such a leaf
after the split; here the layout is blocked instead: a rank's block is
its slice of *each* half, ``[x_r | z_r]``, so the split of the block is
the rank's channels of both and nothing is exchanged per layer.
``gather_block`` puts the halves back in the reference's order, and a
block still holds ``1 / ranks`` of the leaf (``rank_nbytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    batch: Axis = ("pod", "data")
    fsdp: Axis = "data"
    heads: Axis = "model"
    kv_heads: Axis = None
    mlp: Axis = "model"
    experts: Axis = "model"
    vocab: Axis = "model"
    seq: Axis = None            # sequence parallelism for activations
    kv_seq: Axis = "model"      # decode KV-cache sequence sharding
    d_inner: Axis = "model"     # SSM / RG-LRU channel dim
    stack: Axis = None          # the reference's stacked-layer dim
    # the rank mesh (``launch.mesh.RankMesh``); None: rules as names only
    mesh: Optional[object] = None

    def axis(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        try:
            return getattr(self, logical)
        except AttributeError:
            raise KeyError(f"unknown logical axis {logical!r}") from None

    def pspec(self, *logical: Optional[str]) -> tuple:
        """The mesh axes of each named dim: the port's ``PartitionSpec``
        (a tuple of axis names, tuples of them, or None)."""
        return tuple(self.axis(name) for name in logical)

    def spec_tree(self, logical_tree):
        """A tree of logical-name tuples (``transformer.param_specs``,
        ``Optimizer.state_specs``) as a tree of ``pspec`` tuples."""
        if isinstance(logical_tree, tuple):
            return self.pspec(*logical_tree)
        if isinstance(logical_tree, dict):
            return {k: self.spec_tree(v) for k, v in logical_tree.items()}
        return [self.spec_tree(v) for v in logical_tree]


class Halves(str):
    """A logical axis name whose dim holds two equal halves side by side
    (the module docstring): the name itself for every rule (it equals
    and hashes as the plain string), and to ``block`` / ``gather_block``
    the blocked layout ``[half0_r | half1_r]``."""

    def __reduce__(self):
        return Halves, (str(self),)


def _mesh_axes(mesh_or_axes) -> tuple:
    names = getattr(mesh_or_axes, "axis_names", None)
    return tuple(names if names is not None else mesh_or_axes)


SINGLE_POD_RULES = MeshRules(batch="data")
MULTI_POD_RULES = MeshRules(batch=("pod", "data"))


def rules_for_mesh(mesh_or_axes, **overrides) -> MeshRules:
    """The default rules for a mesh (or a tuple of axis names): the
    multi-pod rules when it has a ``"pod"`` axis, with ``overrides``;
    a ``RankMesh`` becomes the rules' ``mesh``."""
    axes = _mesh_axes(mesh_or_axes)
    base = MULTI_POD_RULES if "pod" in axes else SINGLE_POD_RULES
    if hasattr(mesh_or_axes, "axis_names"):
        overrides = dict(overrides, mesh=mesh_or_axes)
    return dataclasses.replace(base, **overrides) if overrides else base


def constrain(x, rules: MeshRules, *logical: Optional[str]):
    """The reference's sharding constraint.  The port's layout is
    explicit (every rank holds its block), so there is nothing to
    constrain: ``x`` itself."""
    return x


# ---------------------------------------------------------------------------
# Blocks: the port's counterpart of ``shardings`` / ``device_put``
# ---------------------------------------------------------------------------

def on_ranks(rules: Optional[MeshRules]) -> bool:
    """Whether ``rules`` place the tensors on the ranks of a mesh."""
    return rules is not None and rules.mesh is not None


def rule_axes(rules: MeshRules) -> tuple:
    """The mesh axes (in the mesh's order) that any rule maps a logical
    axis to: the ranks these rules compute over together.  The pod
    step's per-pod rules (``batch="data"``) leave ``"pod"`` out."""
    used = set()
    for f in dataclasses.fields(rules):
        if f.name != "mesh":
            v = getattr(rules, f.name)
            used.update(() if v is None else (v,) if isinstance(v, str)
                        else v)
    return tuple(a for a in rules.mesh.axis_names if a in used)


def live_axes(rules: MeshRules, axis: Axis) -> tuple:
    """``axis`` as a tuple of the mesh's axis names, those of size 1
    dropped (nothing to split or reduce over them)."""
    if axis is None:
        return ()
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if rules.mesh.axis_size(a) > 1)


def dim_axes(names: tuple, rules: MeshRules) -> list:
    """For each dim of a leaf named ``names``: the live mesh axes that
    split it (``()`` for a whole dim).  A mesh axis may split one dim of
    a leaf only."""
    out = [live_axes(rules, rules.axis(n)) for n in names]
    used = [a for axes in out for a in axes]
    if len(used) != len(set(used)):
        raise ValueError(f"a mesh axis splits two dims of {names}: "
                         f"{rules.pspec(*names)}")
    return out


def shard_axes(names: tuple, rules: MeshRules) -> tuple:
    """Every live mesh axis that splits a leaf named ``names``, in the
    mesh's order."""
    used = {a for axes in dim_axes(names, rules) for a in axes}
    return tuple(a for a in rules.mesh.axis_names if a in used)


def replicated_axes(names: tuple, rules: MeshRules, within=None) -> tuple:
    """The live mesh axes (of ``within``, default all) that hold a
    whole copy of a leaf named ``names``: its gradient is summed over
    them."""
    split = set(shard_axes(names, rules))
    axes = rules.mesh.axis_names if within is None else within
    return tuple(a for a in axes if a not in split
                 and rules.mesh.axis_size(a) > 1)


def _halves(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` with dim ``d`` (of size 2 h) as two dims (2, h)."""
    return x.unflatten(d, (2, x.shape[d] // 2))


def block_shape(shape: tuple, names: tuple, rules: MeshRules) -> tuple:
    """The shape of ``block`` of a whole tensor of ``shape`` named
    ``names``; raises as ``block`` does when a dim does not divide."""
    if len(shape) != len(names):
        raise ValueError(f"a {len(shape)}-d tensor named {names}")
    out = list(shape)
    for d, axes in enumerate(dim_axes(names, rules)):
        if not axes:
            continue
        n = rules.mesh.axis_size(axes) * (2 if isinstance(names[d], Halves)
                                          else 1)
        if shape[d] % n:
            raise ValueError(f"dim {d} ({names[d]!r}) of {tuple(shape)} "
                             f"does not divide over {axes} ({n} parts)")
        out[d] = shape[d] // rules.mesh.axis_size(axes)
    return tuple(out)


def block(x: torch.Tensor, names: tuple, rules: MeshRules) -> torch.Tensor:
    """This rank's block of the whole tensor ``x``, whose dims are named
    ``names``: each split dim cut to the rank's index along its mesh
    axes (a tuple of axes folded pod-major); a ``Halves`` dim cut in
    each half.  Raises when a dim does not divide.  A new, contiguous
    tensor."""
    mesh = rules.mesh
    block_shape(tuple(x.shape), names, rules)
    for d, axes in enumerate(dim_axes(names, rules)):
        if not axes:
            continue
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        if isinstance(names[d], Halves):
            h = _halves(x, d)
            size = h.shape[d + 1] // n
            x = h.narrow(d + 1, i * size, size).flatten(d, d + 1)
        else:
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def gather_block(x: torch.Tensor, names: tuple, rules: MeshRules,
                 channel: str = "gather") -> torch.Tensor:
    """The whole tensor from every rank's ``block`` (each rank calls it
    with its own; every rank gets the whole), without autograd."""
    from .collectives import all_gather_plain
    for d, axes in enumerate(dim_axes(names, rules)):
        if not axes:
            continue
        if isinstance(names[d], Halves):
            # [x_0 | z_0], [x_1 | z_1], ... -> [x_0 x_1 ... | z_0 z_1 ...]
            x = all_gather_plain(_halves(x, d), rules.mesh, axes, d + 1,
                                 channel).flatten(d, d + 1)
        else:
            x = all_gather_plain(x, rules.mesh, axes, d, channel)
    return x


def spec_leaves(specs) -> list:
    """The logical-name tuples of a spec tree, in ``tree.tree_flatten``'s
    leaf order (a name tuple is a leaf, not a sequence)."""
    if isinstance(specs, tuple):
        return [specs]
    if isinstance(specs, dict):
        return [n for k in sorted(specs) for n in spec_leaves(specs[k])]
    return [n for v in specs for n in spec_leaves(v)]


def _map(fn, tree, specs):
    if isinstance(specs, tuple):
        return None if tree is None else fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _map(fn, tree[k], v) for k, v in specs.items()}
    return [_map(fn, t, v) for t, v in zip(tree, specs)]


def block_tree(tree, specs, rules: MeshRules):
    """``block`` of every leaf of ``tree`` (``specs``: its tree of
    logical-name tuples; a 0-d leaf is named ``()``)."""
    return _map(lambda x, n: block(x, n, rules), tree, specs)


def gather_tree(tree, specs, rules: MeshRules):
    """``gather_block`` of every leaf (every rank calls it)."""
    return _map(lambda x, n: gather_block(x, n, rules), tree, specs)


def rank_nbytes(tree, specs, rules: MeshRules) -> int:
    """The bytes one rank holds of ``tree`` (whole tensors, real or
    ``"meta"``) under ``rules``: each leaf's bytes over the ranks that
    split it.  ``rules.mesh`` need only carry its shape."""
    total = [0]

    def add(x, names):
        n = 1
        for axes in dim_axes(names, rules):
            if axes:
                n *= rules.mesh.axis_size(axes)
        total[0] += x.numel() * x.element_size() // n
        return None
    _map(add, tree, specs)
    return total[0]
