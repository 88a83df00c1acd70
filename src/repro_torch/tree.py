"""Trees: nested dicts, lists and tuples of tensors, flattened to their
leaves and back; ``tree_signature`` / ``tree_nbytes`` list a tree's
leaves by path, shape, dtype and bytes (an abstract ``"meta"`` tree
beside the real one it stands for).

Dict keys come in sorted order (as the reference flattens them), lists
and tuples in order; ``None`` is an empty subtree; every other value is
a leaf.  The checkpoint store writes a tree's leaves, and the engine
names the tensors a captured graph holds by them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)``: dict keys in sorted order, lists and tuples
    in order, ``None`` holding no leaf."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(x[k])) for k in sorted(x)))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if x is None:
            return ("none",)
        leaves.append(x)
        return ("leaf",)
    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "dict":
            return {k: build(v) for k, v in d[1]}
        if kind == "list":
            return [build(v) for v in d[1]]
        if kind == "tuple":
            return tuple(build(v) for v in d[1])
        return None if kind == "none" else next(it)
    return build(treedef)


def tree_flatten_up_to(treedef: tuple, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (a
    tree whose structure extends ``treedef``'s, such as a per-leaf state
    dict for every parameter), in ``treedef``'s leaf order."""
    out: List[Any] = []

    def walk(d, node):
        kind = d[0]
        if kind == "leaf":
            out.append(node)
        elif kind == "dict":
            for k, sub in d[1]:
                walk(sub, node[k])
        elif kind in ("list", "tuple"):
            for sub, x in zip(d[1], node):
                walk(sub, x)
    walk(treedef, tree)
    return out


def _leaf_entry(x):
    """(shape, dtype name, bytes) of a tensor, numpy array or generator
    (its state's bytes); None for anything else (a Python scalar, a
    flag)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).removeprefix("torch."),
                x.numel() * x.element_size())
    if isinstance(x, np.ndarray):
        return tuple(x.shape), x.dtype.name, int(x.nbytes)
    if isinstance(x, torch.Generator):
        n = int(x.get_state().numel())
        return (n,), "uint8", n
    return None


def tree_signature(tree, path: str = "") -> List[tuple]:
    """``[(path, shape, dtype, bytes), ...]`` of every array leaf:
    dicts in sorted key order, lists and tuples in order, a dataclass by
    its fields (a ``KVCache``), synapse tables by their ``local`` and
    ``halo`` tiers; a ``torch.Generator`` is a uint8 leaf of its
    state's bytes.  Python scalars are no leaf."""
    out: List[tuple] = []

    def walk(x, p):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{p}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{p}/{i}")
        elif hasattr(x, "tiers") and hasattr(x, "halo"):
            walk({"local": x.local, "halo": list(x.halo)}, p)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{p}/{f.name}")
        else:
            e = _leaf_entry(x)
            if e is not None:
                out.append((p,) + e)
    walk(tree, path)
    return out


def tree_nbytes(tree) -> int:
    """Total bytes of ``tree_signature(tree)``'s leaves."""
    return sum(e[3] for e in tree_signature(tree))
