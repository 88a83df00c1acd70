"""AdamW and Adafactor over parameter trees (nested dicts and lists of
tensors), the port of ``repro.optim.optimizers``.

The update rules, defaults and dtypes are the reference's: the global
gradient norm accumulated in float32, clipping that keeps each
gradient's dtype, float32 moments, AdamW's bias-corrected step with
decoupled weight decay, and Adafactor's factored second moments over the
last two axes of every leaf with two or more, with relative-scale update
clipping.  Unlike the reference, ``update`` writes the new parameters
and state into their tensors in place (under ``torch.no_grad``) and
returns them.  The reference stacks the layers of an LM along a leading
axis, and its Adafactor treats each stacked leaf as one parameter; the
port keeps one tree node per layer, so its Adafactor takes the model's
stack groups (``stacks=models.transformer.stack_groups(cfg)``) and
factors and clips each group as the reference does its stacked leaf.
``abstract_state`` builds the state on ``"meta"`` through the same
``init`` (the dry run's input), and ``state_specs`` names its leaves as
the reference does.

On ranks (``update(..., specs=, rules=)``: the parameters, gradients and
moments are this rank's blocks) every reduction runs over the whole
leaf, as GSPMD runs the reference's: the global norm, and Adafactor's
row and column sums, its row factor's mean and its update clip's RMS.
Each is a local partial sum added across the ranks that split the
dimension it reduces, in one flattened all-reduce per set of mesh axes
(channel ``"opt"``), and divided by the whole leaf's length.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.profiler import record_function

from ..parallel.sharding import shard_axes, spec_leaves
from ..tree import tree_flatten, tree_flatten_up_to, tree_unflatten

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def global_norm(tree, specs=None, rules=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in float32
    (float64 for float64 leaves).

    On ranks (``rules`` with a mesh; ``specs`` the tree's logical names)
    each leaf is this rank's block: its squares are summed across the
    ranks that split it, once, and a leaf that a rank holds whole counts
    once, so every rank gets the norm of the whole tree."""
    leaves = tree_flatten(tree)[0]
    acc = torch.promote_types(leaves[0].dtype, torch.float32)
    sq = [torch.linalg.vector_norm(x, dtype=acc).square() for x in leaves]
    if rules is not None and rules.mesh is not None:
        sq = _sum_across([(s, shard_axes(n, rules))
                          for s, n in zip(sq, spec_leaves(specs))], rules,
                         "norm")
    return torch.sqrt(torch.stack(sq).sum())


def _is_names(t) -> bool:
    return isinstance(t, tuple)


def _map_names(fn, specs):
    """``specs`` (a tree of logical-name tuples) with ``fn`` applied to
    every tuple."""
    if _is_names(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_names(fn, v) for k, v in specs.items()}
    return [_map_names(fn, v) for v in specs]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable          # params -> opt_state
    _update: Callable       # (params, grads, state, specs, rules)
    _state_specs: Callable  # param logical-name tree -> state name tree
    kind: str = ""          # "adamw" / "adafactor"

    def abstract_state(self, params):
        """``init``'s state for parameters of ``params``' shapes and
        dtypes, on ``"meta"``: nothing is allocated."""
        leaves, treedef = tree_flatten(params)
        return self.init(tree_unflatten(treedef, [
            torch.empty(p.shape, dtype=p.dtype, device="meta")
            for p in leaves]))

    def state_specs(self, param_specs):
        """The logical axis names of the state's leaves, from the
        parameters' (``transformer.param_specs``): moments named as the
        parameters they mirror, ``step`` ``()``."""
        return self._state_specs(param_specs)

    def update(self, params, grads, state, specs=None, rules=None):
        """One step: ``(params, state, grad_norm)``, the parameters and
        the state updated in place (in the ``torch.profiler`` range
        ``optimizer_update``).  On ranks (``rules`` with a mesh,
        ``specs`` the parameters' logical names) the trees are this
        rank's blocks and every reduction covers the whole leaf, the
        clip's global norm too."""
        if rules is not None and rules.mesh is None:
            rules = None
        with torch.no_grad(), record_function("optimizer_update"):
            return self._update(params, grads, state, specs, rules)


def _clipped(grads, max_norm: float, specs, rules):
    """The leaves of ``grads`` scaled to a global norm of at most
    ``max_norm`` (each in its own dtype), and that norm
    (``global_norm(grads, specs, rules)``)."""
    g = global_norm(grads, specs, rules)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return [x * scale.to(x.dtype) for x in tree_flatten(grads)[0]], g


def _sum_across(parts: list, rules, channel: str = "opt") -> list:
    """``parts``: ``(tensor, mesh axes)`` pairs; each tensor summed over
    its axes, in one all-reduce a distinct set of axes (the set's
    tensors flattened into one buffer).  Over no axis, or off ranks,
    the tensor itself."""
    out = [t for t, _ in parts]
    if rules is None:
        return out
    from ..parallel.collectives import all_reduce_plain
    by_axes: dict = {}
    for i, (_, axes) in enumerate(parts):
        if axes:
            key = tuple(a for a in rules.mesh.axis_names if a in axes)
            by_axes.setdefault(key, []).append(i)
    for axes, ids in sorted(by_axes.items()):
        flat = all_reduce_plain(torch.cat([out[i].reshape(-1) for i in ids]),
                                rules.mesh, axes, channel=channel)
        for i, part in zip(ids, flat.split([out[i].numel() for i in ids])):
            out[i] = part.view_as(out[i])
    return out


def _split(names, rules, ndim: int) -> list:
    """Per dim of a leaf named ``names``: the live mesh axes that split
    it (``()`` for every dim off ranks)."""
    from ..parallel.sharding import dim_axes
    return dim_axes(names, rules) if rules is not None else [()] * ndim


def _parts(axes, rules) -> int:
    return rules.mesh.axis_size(axes) if axes else 1


def _zero_step(params) -> torch.Tensor:
    leaves = tree_flatten(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


def adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm: float = 1.0, moment_dtype="float32") -> Optimizer:
    """AdamW.  State ``{"m", "v"}`` (trees like the parameters, in
    ``moment_dtype``) and ``"step"`` (int32, 0-d, on the parameters'
    device); ``lr(step)`` is read at the incremented step."""
    mdt = MOMENT_DTYPES[moment_dtype]

    def init(params):
        leaves, treedef = tree_flatten(params)

        def zeros():
            return tree_unflatten(treedef, [torch.zeros_like(p, dtype=mdt)
                                            for p in leaves])
        return {"m": zeros(), "v": zeros(), "step": _zero_step(params)}

    def update(params, grads, state, specs, rules):
        flat_p, _ = tree_flatten(params)
        flat_g, gnorm = _clipped(grads, clip_norm, specs, rules)
        flat_m = tree_flatten(state["m"])[0]
        flat_v = tree_flatten(state["v"])[0]
        state["step"] += 1
        step = state["step"]
        lr_t = lr(step)
        s = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, s)
        c2 = 1.0 - torch.pow(b2, s)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            # the moments update in float32 from the (clipped) gradient
            # widened once: what XLA computes inside its fusion of the
            # reference's bf16 expressions
            acc = torch.promote_types(p.dtype, torch.float32)
            g32 = g.to(acc)
            m32 = b1 * m.to(acc) + (1 - b1) * g32
            v32 = b2 * v.to(acc) + (1 - b2) * torch.square(g32)
            upd = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            upd = upd + weight_decay * p.to(acc)
            p.copy_(p.to(acc) - lr_t * upd)
            m.copy_(m32)
            v.copy_(v32)
        return params, state, gnorm

    def state_specs(param_specs):
        return {"m": param_specs, "v": param_specs, "step": ()}

    return Optimizer(init=init, _update=update, _state_specs=state_specs,
                     kind="adamw")


class _Group(list):
    """The subtrees of the layers of one stack group, in the group's
    order (the reference's stacked leaf, unstacked)."""


def _regroup(tree, stacks):
    """``tree`` (parameters, gradients, names, or their leaves' flat
    indices) in the layout of ``stacks``: each of its keys in place of
    the key its layers come from, a layer index standing for that
    layer's subtree and a tuple of them for a ``_Group``."""
    if not stacks:
        return tree
    sources = {src for src, _ in stacks.values()}
    out = {k: v for k, v in tree.items() if k not in sources}
    for key, (src, entries) in stacks.items():
        nodes = tree[src]

        def one(e):
            return _Group(nodes[i] for i in e) if isinstance(e, tuple) \
                else nodes[e]
        out[key] = one(entries) if isinstance(entries, tuple) \
            else [one(e) for e in entries]
    return out


def _map_groups(fn_leaf, fn_group, node):
    """``node`` (a ``_regroup`` tree) with ``fn_group`` applied to each
    ``_Group`` and ``fn_leaf`` to every other leaf."""
    if isinstance(node, _Group):
        return fn_group(node)
    if isinstance(node, dict):
        return {k: _map_groups(fn_leaf, fn_group, v)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_map_groups(fn_leaf, fn_group, v) for v in node]
    return None if node is None else fn_leaf(node)


def _units(node, vnode, out: list) -> list:
    """``[(leaf indices, moments, stacked), ...]``: every parameter of a
    ``_regroup`` tree of flat leaf indices beside its moments in the
    state ``vnode`` (a group's leaves at one path share one unit)."""
    if isinstance(node, _Group):
        flats = [tree_flatten(n)[0] for n in node]
        treedef = tree_flatten(node[0])[1]
        for j, v in enumerate(tree_flatten_up_to(treedef, vnode)):
            out.append(([f[j] for f in flats], v, True))
    elif isinstance(node, dict):
        for k in node:
            _units(node[k], vnode[k], out)
    elif isinstance(node, list):
        for n, v in zip(node, vnode):
            _units(n, v, out)
    elif node is not None:
        out.append(([node], vnode, False))
    return out


def _moments(shape: tuple, device) -> dict:
    z = dict(dtype=torch.float32, device=device)
    if len(shape) >= 2:
        return {"row": torch.zeros(shape[:-1], **z),
                "col": torch.zeros(shape[:-2] + shape[-1:], **z)}
    return {"full": torch.zeros(shape, **z)}


def _factors(items: list, beta, eps: float, rules) -> list:
    """The reference's Adafactor second moments of each ``(g, v,
    names)`` of ``items``, updated in place in ``v``, and the small
    factors of its direction (``_direction``): factored over the last
    two axes of a leaf with two or more (``rsqrt`` of the row and of the
    column over the row factor's mean, cast to the gradient's dtype),
    full otherwise.  ``g`` may be a block of the leaf (``names`` its
    logical names, ``rules`` the mesh's): the row and column sums and
    the row factor's mean are taken over the whole leaf, in two rounds
    of ``_sum_across``."""
    fac = [i for i, (g, _, _) in enumerate(items) if g.dim() >= 2]
    dims = {i: _split(items[i][2], rules, items[i][0].dim()) for i in fac}
    parts = []
    for i in fac:
        g = items[i][0]
        sq = torch.square(g.to(torch.promote_types(g.dtype, torch.float32)))
        parts += [(sq.sum(dim=-1), dims[i][-1]), (sq.sum(dim=-2),
                                                  dims[i][-2])]
    sums = _sum_across(parts, rules)
    rows, cols, lens = {}, {}, {}
    for k, i in enumerate(fac):
        g, v, _ = items[i]
        last = g.shape[-1] * _parts(dims[i][-1], rules)
        lens[i] = g.shape[-2] * _parts(dims[i][-2], rules)
        rows[i] = beta * v["row"] + (1 - beta) * (sums[2 * k] / last + eps)
        cols[i] = beta * v["col"] + (1 - beta) * (sums[2 * k + 1] / lens[i]
                                                  + eps)
    row_sums = dict(zip(fac, _sum_across(
        [(rows[i].sum(dim=-1, keepdim=True), dims[i][-2]) for i in fac],
        rules)))
    out = []
    for i, (g, v, _) in enumerate(items):
        if i in rows:
            row, col = rows[i], cols[i]
            mean = row_sums[i] / lens[i]
            rinv = torch.rsqrt(row + eps)
            cinv = torch.rsqrt(col / (mean + eps) + eps)
            v["row"].copy_(row)
            v["col"].copy_(col)
            # the small factors cast before the outer product
            out.append((rinv.to(g.dtype)[..., None],
                        cinv.to(g.dtype)[..., None, :]))
            continue
        full = beta * v["full"] + (1 - beta) * (
            torch.square(g.to(torch.float32)) + eps)
        v["full"].copy_(full)
        out.append((torch.rsqrt(full + eps),))
    return out


def _direction(g, f: tuple):
    """The Adafactor direction of ``g`` (before the update clipping)
    from its ``_factors``; full-size intermediates keep the gradient's
    dtype."""
    if len(f) == 2:
        return (g * f[0]) * f[1]
    return (g.to(torch.float32) * f[0]).to(g.dtype)


def adafactor(lr: Callable, *, stacks: dict, decay=0.8, eps=1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0
              ) -> Optimizer:
    """Adafactor: factored second moments ``{"row", "col"}`` over the
    last two axes of leaves with two or more, ``{"full"}`` for the
    others, float32; ``"step"`` as AdamW's.  Full-size intermediates keep
    the gradient's dtype, as the reference's do.

    ``stacks`` (``models.transformer.stack_groups(cfg)``): ``{state
    key: (parameter key, entries)}``, the entries a list of layer
    indices (a layer on its own) and index tuples (a stack group), or
    one tuple.  The state's ``"v"`` then holds those keys in place of
    the parameter keys their layers come from, in the reference's
    layout: a group's moments are those of the reference's stacked leaf,
    ``(len(group),) + shape``.  So a per-layer 1-D leaf ``(d,)`` gets
    ``row (L,)`` and ``col (d,)``, a leaf of two or more dimensions the
    stacked moments whose per-layer slices are its own, and the update
    is clipped by the RMS over the whole group.  ``stacks={}`` groups
    nothing (a tree that is not a stacked model): ``"v"`` then mirrors
    the parameters."""

    def init(params):
        def group(g):
            leaves, treedef = tree_flatten(g[0])
            return tree_unflatten(treedef, [
                _moments((len(g),) + tuple(p.shape), p.device)
                for p in leaves])
        return {"v": _map_groups(lambda p: _moments(tuple(p.shape),
                                                    p.device), group,
                                 _regroup(params, stacks)),
                "step": _zero_step(params)}

    def update(params, grads, state, specs, rules):
        flat_p, treedef = tree_flatten(params)
        flat_g, gnorm = _clipped(grads, clip_norm, specs, rules)
        names = (spec_leaves(specs) if rules is not None
                 else [None] * len(flat_p))
        index = tree_unflatten(treedef, list(range(len(flat_p))))
        units = _units(_regroup(index, stacks), state["v"], [])
        state["step"] += 1
        step = state["step"]
        lr_t = lr(step)
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)
        # (gradient, moments, names, unit): a stacked leaf of two or more
        # dims slice by slice (the last two axes are each layer's own),
        # a stacked 1-D leaf as the (L, d) stack
        items = []
        for u, (ids, v, stacked) in enumerate(units):
            gs, n = [flat_g[i] for i in ids], names[ids[0]]
            if stacked and gs[0].dim() >= 2:
                items += [(g, {k: m[j] for k, m in v.items()}, n, u)
                          for j, g in enumerate(gs)]
            elif stacked:
                items.append((torch.stack(gs), v,
                              None if n is None else ("stack",) + n, u))
            else:
                items.append((gs[0], v, n, u))
        facs = _factors([it[:3] for it in items], beta, eps, rules)
        by_unit: dict = {}
        for it, f in zip(items, facs):
            by_unit.setdefault(it[3], []).append((it[0], f, it[2]))

        def apply(u, dirs, sq, n):
            # relative-scale update clipping over the whole (stacked)
            # leaf
            ids, _, stacked = units[u]
            if stacked and flat_g[ids[0]].dim() < 2:
                dirs = list(dirs[0].unbind(0))
            rms = torch.sqrt(sq / float(n) + 1e-12)
            scale = (lr_t / torch.clamp(rms, min=1.0)).to(dirs[0].dtype)
            for i, d in zip(ids, dirs):
                p = flat_p[i]
                dec = (1.0 - lr_t * weight_decay).to(p.dtype)
                p.copy_(p * dec - (d * scale).to(p.dtype))

        sqs, counts = [], []
        for u in range(len(units)):
            dirs = [_direction(g, f) for g, f, _ in by_unit[u]]
            acc = torch.promote_types(dirs[0].dtype, torch.float32)
            sq = sum(torch.square(d.to(acc)).sum() for d in dirs)
            n = sum(d.numel() * math.prod(
                _parts(a, rules) for a in _split(nm, rules, d.dim()))
                for d, (_, _, nm) in zip(dirs, by_unit[u]))
            if rules is None:
                apply(u, dirs, sq, n)
            sqs.append(sq)
            counts.append(n)
        if rules is not None:
            # on ranks the squares are summed across the ranks that split
            # each leaf first; the directions are made again to apply
            sqs = _sum_across([(sq, shard_axes(names[units[u][0][0]], rules))
                               for u, sq in enumerate(sqs)], rules)
            for u in range(len(units)):
                apply(u, [_direction(g, f) for g, f, _ in by_unit[u]],
                      sqs[u], counts[u])
        return params, state, gnorm

    def state_specs(param_specs):
        def moments(names):
            if len(names) >= 2:
                return {"row": names[:-1], "col": names[:-2] + names[-1:]}
            return {"full": names}

        def group(g):
            return _map_names(lambda n: moments(("stack",) + n), g[0])
        return {"v": _map_groups(moments, group,
                                 _regroup(param_specs, stacks)),
                "step": ()}

    return Optimizer(init=init, _update=update, _state_specs=state_specs,
                     kind="adafactor")
