"""Trees: nested dicts, lists and tuples of tensors, flattened to their
leaves and back.

Dict keys come in sorted order (as the reference flattens them), lists
and tuples in order; ``None`` is an empty subtree; every other value is
a leaf.  The checkpoint store writes a tree's leaves, and the engine
names the tensors a captured graph holds by them.
"""

from __future__ import annotations

from typing import Any, List, Tuple


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
