"""Multi-shard DPSNN engine on one device: stacked tiles + halo exchange.

The port of ``repro.core.dist_engine`` in its single-device form.  One
tile owns a ``tile_h x tile_w`` rectangle of cortical columns; every
state and table tensor carries two leading *tile* axes ``(TY, TX)``,
and every tile lives on the same device (the reference shards the tile
axes over a TPU mesh).  Step structure, all tiles (dt = 1 ms):

  1. per tile: read ring slot t, add the external Poisson drive (drawn
     on the tile's own generator), LIF+SFA update, zero the slot -- the
     step head (``kops.neuron_step`` on the kernel path);
  2. halo exchange of the excitatory spikes and the halo bands' source
     vectors: ``exchange_halo_2d`` followed by each band's gather is
     one precomputed index map per band over the stacked spike vector
     (``band_gather_maps``), so each band is one gather for every tile;
  3. per tile: event-driven delivery of the local tier and every halo
     band (``engine.deliver_event_tiers``: the column kernel for
     bfloat16 weights, the fixed-order kernel for float32); plastic
     runs exchange the local pre-trace the same way and go through
     ``engine.plastic_delivery_stdp`` with every tier's weights in the
     carry.

The state is updated in place (the port's counterpart of the
reference's donated state).  ``state["t"]`` is a host-side ``(TY, TX)``
int32 numpy array and ``state["rng"]`` the row-major list of the tiles'
``torch.Generator``s.  An ensemble (``DistConfig.ensemble_seeds``, M
members) puts the member axis after the tile axes, ``(TY, TX, M, ...)``,
``t`` included, with the generators in (y, x, m) order; each (tile,
member) instance steps through the same per-tile launches, on the
tile's tables, and the exchange gathers each band once for every
instance.  A static event-mode run on a CUDA device with
``use_kernels``, recorded or not, replays one CUDA graph of ``d_ring``
steps of every instance (``engine.GraphLoop``); plastic and plain runs
step eagerly.  The drive is drawn with ``torch.poisson``, which cannot
reproduce ``jax.random.poisson``: parity runs inject the reference's
drive (``SimInputs.drive``).

**Ranks** (``mesh=``, a ``launch.mesh.RankMesh`` over a
``torch.distributed`` group): one tile per process, DPSNN's own layout
and the reference's ``shard_map`` (each shard takes ``a[0, 0]`` of its
block).  The rank's state, tables and inputs are its block of the
stacked form, leading ``(1, 1)`` (``(1, 1, M)`` for an ensemble): it
builds only its own tile's tables (``build_dist_tables``; the ranks
agree on each tier's realized cap), seeds its tile's generators as the
stacked state seeds tile ``y*TX + x``, and moves its excitatory spikes
(and plastic pre-traces) to its neighbours each step through
``halo.exchange_halo_2d(mesh=...)`` and a ``halo.Transport``.  The band
vectors it gathers from the region equal the stacked gather maps', so
every rank's run is bit for bit its tile of the stacked run.  A rank
steps eagerly: a host-staged exchange cannot sit inside a CUDA graph.
``rank_block`` / ``gather_blocks`` move between the two forms.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..kernels.ref import delivered_bits
from ..tree import tree_flatten, tree_unflatten
from .engine import (EngineConfig, GraphLoop, bind_tier_structures,
                     deliver_event_tiers, deliver_gather_all_tiers,
                     init_sim_state, plastic_delivery_stdp, step_head)
from .halo import Transport, exchange_halo_2d, pack_bits, unpack_bits
from .stdp import (build_inverse_index, check_weight_invariant,
                   plastic_masks, stdp_step, target_major_meta)
from .synapses import (SynapseTables, TableStorage, build_tables,
                       compress_tables, materialized_table_bytes, tier_list,
                       tile_views)


@dataclasses.dataclass
class SimInputs:
    """The sim function's second argument: synapse ``tables`` always
    (stacked ``SynapseTables`` or the ``{"local", "halo"}`` dict form);
    ``inv_slots`` (the stacked target-major inverse index,
    ``build_dist_inverse_index``) when the engine is plastic; ``gids``
    (the stacked global-neuron-id maps, ``obs.record.stacked_gid_maps``)
    when a recorder is attached; ``drive``, an injected ``(n_steps, TY,
    TX, n_local)`` drive in mV (``(n_steps, TY, TX, M, n_local)`` for an
    ensemble), or None to draw it on each instance's generator.  All
    but the drive are member-free: the members share one realization."""
    tables: Any
    inv_slots: Any = None
    gids: Any = None
    drive: Any = None


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distribution settings layered on an EngineConfig: the exchange's
    ``halo_mode`` ("strip" | "block") and wire format (``pack_spikes``: a
    1-bit payload, ``halo.pack_bits``), as ``band_gather_maps`` composes
    them into the bands' gather maps and as the ranks move their
    strips.  Every setting gives the same regions, so the same run.

    ``axis_y`` / ``axis_x``: the rank mesh's axes of the tile rows and
    columns (a tuple folds several axes into one, pod major, as
    ``("pod", "data")`` on the multi-pod mesh).  The stacked form
    ignores them.

    ``ensemble_seeds``: member state seeds of an ensemble run.  When
    set, every state leaf grows a member axis at position 2, ``(TY, TX,
    M, ...)``, and member m is bit for bit the solo run with
    ``engine.state_seed = ensemble_seeds[m]``: one table realization
    (``engine.seed``), one sim function, M realizations."""

    engine: EngineConfig
    axis_y: Union[str, Tuple[str, ...]] = "data"
    axis_x: Union[str, Tuple[str, ...]] = "model"
    halo_mode: str = "strip"
    pack_spikes: bool = True
    ensemble_seeds: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        for name in ("axis_y", "axis_x"):
            a = getattr(self, name)
            if not isinstance(a, str):
                object.__setattr__(self, name, tuple(a))
        if self.ensemble_seeds is not None:
            seeds = tuple(int(s) for s in self.ensemble_seeds)
            if not seeds:
                raise ValueError("ensemble_seeds must be a non-empty "
                                 "tuple (or None for a solo run)")
            object.__setattr__(self, "ensemble_seeds", seeds)

    @property
    def tiles(self) -> Tuple[int, int]:
        d = self.engine.decomp
        return d.tiles_y, d.tiles_x

    @property
    def n_members(self) -> Optional[int]:
        """Ensemble width M, or None for a solo run."""
        if self.ensemble_seeds is None:
            return None
        return len(self.ensemble_seeds)

    @property
    def lead(self) -> Tuple[int, ...]:
        """The state's leading axes: ``(TY, TX)``, or ``(TY, TX, M)``."""
        m = self.n_members
        return self.tiles + (() if m is None else (m,))


# ---------------------------------------------------------------------------
# Ranks: a rank's tile, its block of the stacked form, host collectives
# ---------------------------------------------------------------------------

def rank_tile(cfg: DistConfig, mesh) -> Tuple[int, int]:
    """This rank's tile ``(y, x)``: its index along ``cfg.axis_y`` and
    ``cfg.axis_x`` of ``mesh``, whose axes must hold the tiling exactly
    (every mesh axis one of them, their sizes ``cfg.tiles``)."""
    ty, tx = cfg.tiles
    have = (mesh.axis_size(cfg.axis_y), mesh.axis_size(cfg.axis_x))
    names = [cfg.axis_y] if isinstance(cfg.axis_y, str) else list(cfg.axis_y)
    names += [cfg.axis_x] if isinstance(cfg.axis_x, str) else list(cfg.axis_x)
    if have != (ty, tx) or sorted(names) != sorted(mesh.axis_names):
        raise ValueError(
            f"the mesh {dict(zip(mesh.axis_names, mesh.shape))} does not "
            f"hold the {ty}x{tx} tiling on axes y={cfg.axis_y!r}, "
            f"x={cfg.axis_x!r} (one tile per rank)")
    return mesh.axis_index(cfg.axis_y), mesh.axis_index(cfg.axis_x)


def _tiles_here(cfg: DistConfig, mesh) -> List[Tuple[int, int]]:
    """The tiles this process holds, row-major: all, or the rank's."""
    if mesh is None:
        ty, tx = cfg.tiles
        return [(y, x) for y in range(ty) for x in range(tx)]
    return [rank_tile(cfg, mesh)]


def _local_lead(cfg: DistConfig, mesh=None) -> Tuple[int, ...]:
    """The leading axes of this process's state: ``cfg.lead``, or a
    rank's block ``(1, 1)`` / ``(1, 1, M)``."""
    if mesh is None:
        return cfg.lead
    return (1, 1) + cfg.lead[2:]


def all_reduce_host(values, op: str = "sum") -> list:
    """``values`` (integers) summed (``"sum"``) or maximised (``"max"``)
    over the process group's ranks, on the host."""
    import torch.distributed as dist
    x = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return x.tolist()


def all_gather_host(value) -> list:
    """Every rank's ``value`` (any picklable object), in rank order."""
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    return got


def _host(tree):
    """``tree`` with every tensor leaf on the CPU."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.cpu() if isinstance(x, torch.Tensor)
                                    else x for x in leaves])


def _as_tree(x):
    if isinstance(x, SynapseTables):
        return {"local": x.local, "halo": list(x.halo)}
    return x


def rank_block(cfg: DistConfig, tree, mesh):
    """This rank's block of a stacked tree: every tensor or numpy leaf
    cut to ``[y:y+1, x:x+1]`` on its tile axes, ``"rng"`` lists (one
    entry per instance, ``state_tree``'s form) cut to the tile's
    instances; ``SynapseTables`` keep their storage descriptor."""
    y, x = rank_tile(cfg, mesh)
    per = cfg.n_members or 1
    i = y * cfg.tiles[1] + x

    def cut(node, key=None):
        if isinstance(node, SynapseTables):
            return SynapseTables(cut(node.local), [cut(t) for t in node.halo],
                                 node.storage, stats=node.stats)
        if isinstance(node, dict):
            return {k: cut(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if key == "rng":
                return list(node[i * per:(i + 1) * per])
            return type(node)(cut(v) for v in node)
        if isinstance(node, torch.Tensor):
            return node[y:y + 1, x:x + 1].contiguous()
        if isinstance(node, np.ndarray):
            return np.ascontiguousarray(node[y:y + 1, x:x + 1])
        return node
    return cut(tree)


def gather_blocks(cfg: DistConfig, block, mesh, dst: Optional[int] = 0):
    """The stacked tree of every rank's ``block`` (``rank_block``'s
    form), on rank ``dst`` (None elsewhere), or on every rank when
    ``dst`` is None.  Tensors come back on the CPU, stacked on the tile
    axes in tile order; ``"rng"`` lists are joined in (y, x, m) order.
    Every rank calls it."""
    import torch.distributed as dist
    ty, tx = cfg.tiles
    mine = (rank_tile(cfg, mesh), _host(_as_tree(block)))
    if dst is None:
        got = [None] * mesh.size
        dist.all_gather_object(got, mine)
    else:
        got = [None] * mesh.size if mesh.rank == dst else None
        dist.gather_object(mine, got, dst=dst)
        if got is None:
            return None
    blocks = [None] * (ty * tx)
    for (y, x), b in got:
        blocks[y * tx + x] = b

    def join(nodes, key=None):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: join([n[k] for n in nodes], k) for k in first}
        if isinstance(first, (list, tuple)):
            if key == "rng":
                return [g for n in nodes for g in n]
            return type(first)(join([n[j] for n in nodes])
                               for j in range(len(first)))
        if isinstance(first, torch.Tensor):
            return torch.cat([torch.cat(nodes[r * tx:(r + 1) * tx], dim=1)
                              for r in range(ty)], dim=0)
        if isinstance(first, np.ndarray):
            return np.concatenate([np.concatenate(nodes[r * tx:(r + 1) * tx],
                                                  axis=1)
                                   for r in range(ty)], axis=0)
        return first
    out = join(blocks)
    if isinstance(block, SynapseTables):
        out = SynapseTables(out["local"], out["halo"], block.storage,
                            stats=block.stats)
    return out


# ---------------------------------------------------------------------------
# Stacked state / tables
# ---------------------------------------------------------------------------

def init_dist_state(cfg: DistConfig, device="cuda", mesh=None) -> dict:
    """Every tile's ``engine.init_sim_state(e, y, x, seed_offset=y*TX+x)``
    stacked into ``(TY, TX, ...)`` tensors on ``device``; ``t`` a ``(TY,
    TX)`` int32 numpy array, ``rng`` the tiles' generators (row-major),
    the metrics ``(TY, TX)`` float32.  An ensemble stacks one such state
    per member seed on axis 2, ``(TY, TX, M, ...)`` (``t`` too), its
    generators in (y, x, m) order, each seeded as the solo run with
    ``state_seed=seeds[m]`` seeds that tile.  With ``mesh``, the rank's
    tile alone, ``(1, 1[, M], ...)``, seeded as the stacked state seeds
    that tile: the same draws."""
    dev = resolve_device(device)
    tx = cfg.tiles[1]
    engines = ([cfg.engine] if cfg.ensemble_seeds is None else
               [dataclasses.replace(cfg.engine, state_seed=s)
                for s in cfg.ensemble_seeds])
    insts = [init_sim_state(e, y, x, seed_offset=y * tx + x, device=dev)
             for y, x in _tiles_here(cfg, mesh) for e in engines]
    lead = _local_lead(cfg, mesh)

    def stack(get):
        x = torch.stack([get(s) for s in insts])
        return x.view(lead + tuple(x.shape[1:]))

    return {
        "neuron": {k: stack(lambda s, k=k: s["neuron"][k])
                   for k in insts[0]["neuron"]},
        "i_ring": stack(lambda s: s["i_ring"]),
        "t": np.zeros(lead, np.int32),
        "rng": [s["rng"] for s in insts],
        "active": stack(lambda s: s["active"]),
        "metrics": {k: stack(lambda s, k=k: s["metrics"][k])
                    for k in insts[0]["metrics"]},
    }


def state_like(cfg: DistConfig, storage: Optional[TableStorage] = None,
               device="cuda", mesh=None) -> dict:
    """A stacked state of zeros in the checkpoint's shapes and dtypes,
    with fresh (unseeded) generators, which ``load_state`` fills: the
    state of ``abstract_dist_inputs`` made real on ``device``.
    ``storage``: the tables' storage descriptor (sizes the plastic
    weight tiers; None for the spec's analytic caps).  Plastic engines
    grow the ``plastic`` carry: every tier's weights ``(TY, TX, rows +
    1, cap)``, the local pre-trace, the post-trace.  An ensemble's
    leaves lead with ``(TY, TX, M)``; with ``mesh``, the rank's block
    ``(1, 1[, M])``."""
    dev = resolve_device(device)
    abst = abstract_dist_inputs(cfg, storage, dev, mesh)[0]
    body = {k: v for k, v in abst.items() if k not in ("t", "rng")}
    leaves, treedef = tree_flatten(body)
    state = tree_unflatten(treedef, [
        torch.zeros(x.shape, dtype=x.dtype, device=dev) for x in leaves])
    state["t"] = np.zeros(_local_lead(cfg, mesh), np.int32)
    state["rng"] = [torch.Generator(device=dev) for _ in abst["rng"]]
    return state


def generator_state_bytes(device="cuda") -> int:
    """Bytes of one ``torch.Generator``'s state (``get_state()``) on a
    device of ``device``'s type, without touching that device: CUDA's
    Philox generator holds its seed and offset, two 64-bit words; the
    CPU's Mersenne twister holds its whole state."""
    if torch.device(device).type == "cuda":
        return 16
    return int(torch.Generator().get_state().numel())


def abstract_dist_inputs(cfg: DistConfig,
                         storage: Optional[TableStorage] = None,
                         device="cuda", mesh=None):
    """``(state, tables)`` as ``"meta"`` tensors, nothing allocated: the
    dry run's inputs, the reference's ``abstract_dist_inputs`` in the
    port's layout.

    ``storage``: the built tables' descriptor (``tables.storage``), or
    None for the spec's analytic (uncompressed) capacities.  Every state
    leaf leads with ``cfg.lead`` (``(TY, TX)``, ``(TY, TX, M)`` for an
    ensemble); the tables with ``(TY, TX)`` only (the members share one
    realization).  A plastic engine's state grows ``"plastic"``: every
    tier's weights in the storage's weight dtype (the live copy), the
    local pre-trace ``(n_local + 1,)`` and the post-trace; its tables'
    ``w`` fold to the int8 mask (``fold_plastic_tables``).

    Two leaves differ from the reference's, as the port's state does:
    ``"rng"`` is one uint8 leaf per (tile[, member]) instance, row-major,
    of ``generator_state_bytes(device)`` bytes (the port draws on a
    ``torch.Generator`` per instance, ``state_tree``'s checkpoint form),
    where the reference holds a ``(TY, TX, 2)`` uint32 key; ``"t"`` is
    the port's host ``(TY, TX)`` int32 array (here a meta tensor of that
    shape).  ``device`` names the device whose generators the real state
    holds; nothing is made there.  So the total bytes of these leaves
    equal ``tree_nbytes`` of ``init_dist_state`` (with
    ``init_dist_plastic_state``) and ``build_dist_tables`` (folded when
    plastic) on ``device``.  With ``mesh``, a rank's block: every tile
    axis 1."""
    lead = _local_lead(cfg, mesh)
    tiles = lead[:2]
    e = cfg.engine
    spec = e.spec()
    n = spec.n_local
    f32 = torch.float32

    def sd(shape, dtype=f32, prefix=lead):
        return torch.empty(prefix + tuple(shape), dtype=dtype,
                           device="meta")

    g_bytes = generator_state_bytes(device)
    state = {
        "neuron": {"v": sd((n,)), "c": sd((n,)),
                   "refrac": sd((n,), torch.int32)},
        "i_ring": sd((e.d_ring, n)),
        "t": sd((), torch.int32),
        "rng": [sd((g_bytes,), torch.uint8, ())
                for _ in range(int(np.prod(lead)))],
        "active": sd((n,), torch.bool),
        "metrics": {k: sd(()) for k in ("spikes", "events", "dropped")},
    }
    abst = spec.abstract_tables(storage)
    if e.stdp is not None:
        tiers = abst.tiers()
        state["plastic"] = {
            "w": [sd(t["w"].shape, t["w"].dtype) for t in tiers],
            "x_pre": [sd((tiers[0]["tgt"].shape[0],))],
            "x_post": sd((n,))}
        abst = fold_plastic_tables(abst)

    def lift(t):
        return {k: sd(v.shape, v.dtype, tiles) for k, v in t.items()}

    tables = SynapseTables(lift(abst.local), [lift(t) for t in abst.halo],
                           abst.storage)
    return state, tables


def state_tree(state: dict) -> dict:
    """The stacked state as the leaves the checkpoint store writes: its
    tensors (the live ones, not copies), ``t`` as the host array, and
    each tile's generator as its ``get_state()`` bytes (row-major)."""
    tree = {k: v for k, v in state.items() if k not in ("t", "rng")}
    tree["t"] = np.asarray(state["t"], dtype=np.int32)
    tree["rng"] = [g.get_state() for g in state["rng"]]
    return tree


def load_state(state: dict, tree: dict) -> dict:
    """Load ``tree`` (``state_tree``'s form; host or device leaves) into
    ``state`` in place and return it: each tensor copied into the live
    tensor (a captured graph keeps reading those), ``t`` rebound, each
    generator's state set in place (``set_state`` of its bytes, or
    ``manual_seed`` where the entry is an int seed, as
    ``core.retile.retile_state`` gives), so a graph that registered the
    generators draws on from there.  Structure, shapes and dtypes must
    match."""
    def body(x):
        return {k: v for k, v in x.items() if k not in ("t", "rng")}

    dst, dst_def = tree_flatten(body(state))
    src, src_def = tree_flatten(body(tree))
    t = np.array(tree["t"], dtype=np.int32)
    if (dst_def != src_def or t.shape != np.shape(state["t"])
            or len(tree["rng"]) != len(state["rng"])):
        raise ValueError("the checkpoint's structure is not the state's")
    for d, x in zip(dst, src):
        x = torch.as_tensor(x)
        if x.shape != d.shape or x.dtype != d.dtype:
            raise ValueError(f"a checkpoint leaf is {x.dtype} "
                             f"{tuple(x.shape)}, the state's {d.dtype} "
                             f"{tuple(d.shape)}")
        d.copy_(x)
    state["t"] = t
    for g, x in zip(state["rng"], tree["rng"]):
        if isinstance(x, (int, np.integer)):
            g.manual_seed(int(x))
        else:
            g.set_state(torch.as_tensor(x).cpu())
    return state


def _stack_tiers(tiers: List[dict], ty: int, tx: int) -> dict:
    out = {}
    for k in tiers[0]:
        x = torch.stack([t[k] for t in tiers])
        out[k] = x.view((ty, tx) + tuple(x.shape[1:]))
    return out


def build_dist_tables(cfg: DistConfig, compress: bool = True,
                      device="cuda", mesh=None) -> Tuple[SynapseTables, dict]:
    """Materialize every tile's synapse tables (host-side numpy, the
    reference's draws) stacked on ``(TY, TX)``, placed on ``device``.

    Tiles are built at the analytic caps (identical shapes), stacked,
    then compressed *jointly* (``compress_tables`` on the stack): the
    realized caps are maxima across tiles, so every tile has one
    storage descriptor and one delivery plan, as in the reference.
    Tiles are built by as many host threads as there are tiles and
    cores (each tile draws from its own seed, so the tables do not
    depend on the count).

    With ``mesh``, each rank builds its own tile alone (DPSNN's parallel
    construction) as a ``(1, 1, ...)`` block, and the ranks agree on
    each tier's realized cap (an all-reduce MAX) before the cut: the
    block equals the stacked build's ``[y, x]`` slice, storage
    descriptor included.  The stats are summed over the ranks."""
    dev = resolve_device(device)
    e = cfg.engine
    spec = e.spec()
    tiles = _tiles_here(cfg, mesh)
    ty, tx = _local_lead(cfg, mesh)[:2]

    def build(yx):
        return build_tables(spec, *yx, j_exc=e.lif.j_exc_mv,
                            j_inh=e.lif.j_inh_mv, seed=e.seed, device="cpu")

    with ThreadPoolExecutor(min(len(tiles), os.cpu_count() or 1)) as pool:
        tabs = list(pool.map(build, tiles))
    counts = [sum(t.stats[k] for t in tabs) for k in ("n_synapses",
                                                      "clipped")]
    if mesh is not None:
        counts = all_reduce_host(counts)
    stats = {"n_synapses": int(counts[0]), "clipped": int(counts[1])}
    out = SynapseTables(
        _stack_tiers([t.local for t in tabs], ty, tx),
        [_stack_tiers([t.halo[b] for t in tabs], ty, tx)
         for b in range(len(tabs[0].halo))],
        tabs[0].storage, stats=dict(stats))
    del tabs
    if compress:
        nnz_max = None
        if mesh is not None:
            nnz_max = all_reduce_host(
                [int(t["nnz"].max()) if t["nnz"].numel() else 0
                 for t in out.tiers()], op="max")
        out = compress_tables(out, nnz_max=nnz_max)
    stats["table_bytes_per_shard"] = materialized_table_bytes(out, ty * tx)
    return out.to(dev), stats


def tile_tables(tables) -> List[dict]:
    """Each tile's ``{"local": ..., "halo": [...]}`` tables as views of
    the stacked ``tables`` (row-major).  The structures derived from the
    tiers (``synapses.inverse_index``, ``column_runs``) are cached on the
    view tensors, so the views are made once: ``SynapseTables`` keep
    theirs (``SynapseTables.tile_views``), and a run keeps those of
    dict-form tables for as long as it is handed the same tensors.
    Views share their stacked tensor's version counter, so an in-place
    edit of one tile's tensor rebinds every tile's structures (correct,
    and costly)."""
    if isinstance(tables, SynapseTables):
        return tables.tile_views()
    return tile_views(tables)


def init_dist_plastic_state(cfg: DistConfig, tables) -> dict:
    """Fresh plastic carry: every tier's weights copied from the stacked
    build tables (copies, never views), traces at zero.  ``tables`` must
    carry the *build weights* (float), not the folded int8 masks
    (``fold_plastic_tables``).  The pre-trace is local-tier only: halo
    replicas are exchanged each step, never carried.  An ensemble gives
    every member its own copy of the weights and traces, on axis 2: the
    members start from the one build realization and diverge through
    their own STDP.  A rank's block of tables gives its block of the
    carry."""
    m = cfg.n_members
    n_local = cfg.engine.spec().n_local
    tiers = tier_list(tables)
    lead = tuple(tiers[0]["tgt"].shape[:2]) + (() if m is None else (m,))
    if any(t["w"].dtype == torch.int8 for t in tiers):
        raise ValueError(
            "init_dist_plastic_state needs the build-weight tables "
            "(float w); got int8-folded mask tables -- pass the tables "
            "taken before fold_plastic_tables")
    check_weight_invariant(tiers, cfg.engine.stdp)
    dev = tiers[0]["w"].device
    pre_rows = tiers[0]["tgt"].shape[-2]

    def weights(w):
        if m is None:
            return w.clone()
        return w.unsqueeze(2).expand(lead + tuple(w.shape[2:])).clone()

    return {
        "w": [weights(t["w"]) for t in tiers],
        "x_pre": [torch.zeros(lead + (pre_rows,), dtype=torch.float32,
                              device=dev)],
        "x_post": torch.zeros(lead + (n_local,), dtype=torch.float32,
                              device=dev),
    }


def fold_plastic_tables(tables: SynapseTables) -> SynapseTables:
    """Fold the static tables' weights down to the int8 plastic mask
    (``w > 0``: excitatory-at-build = plastic).  Plastic runs read live
    weights only from the carry (``init_dist_plastic_state``), so the
    tables keep 1 B per synapse for the mask."""
    def fold(t):
        return dict(t, w=(t["w"] > 0).to(torch.int8))
    return SynapseTables(fold(tables["local"]),
                         [fold(t) for t in tables["halo"]],
                         tables.storage, stats=tables.stats)


def build_dist_inverse_index(cfg: DistConfig, tables, mesh=None):
    """Per-tile target-major inverse indices (``stdp.build_inverse_index``,
    host numpy), stacked on ``(TY, TX)`` on the tables' device.

    Each tile's index maps a local (target) neuron to the virtual flat
    slots of its incoming synapses across *all* tiers, local and halo.
    In-degree padding differs per tile, so slots are padded to the max
    with the ``total`` sentinel.  Returns ``(slots, aux)``: ``slots``
    (TY, TX, n_local, K) int32, ``aux`` the tier geometry (``bases``,
    ``sizes``, ``total``, the same on every tile) and ``clipped`` (summed
    over tiles).  With ``mesh``, ``tables`` is the rank's block and so is
    ``slots``, ``(1, 1, n_local, K)``: the ranks agree on ``K`` (an
    all-reduce MAX) and sum ``clipped``."""
    ty, tx = tuple(tables["local"]["tgt"].shape[:2])
    n_local = cfg.engine.spec().n_local
    dev = tables["local"]["tgt"].device
    invs = [build_inverse_index(tier_list(v), n_local, device="cpu")
            for v in tile_tables(tables)]
    aux = {"bases": invs[0]["bases"], "sizes": invs[0]["sizes"],
           "total": invs[0]["total"],
           "clipped": int(sum(i["clipped"] for i in invs))}
    k_max = max(int(i["slots"].shape[1]) for i in invs)
    if mesh is not None:
        k_max = all_reduce_host([k_max], op="max")[0]
        aux["clipped"] = all_reduce_host([aux["clipped"]])[0]
    stacked = torch.full((ty * tx, n_local, k_max), aux["total"],
                         dtype=torch.int32)
    for i, inv in enumerate(invs):
        stacked[i, :, :inv["slots"].shape[1]] = inv["slots"]
    return stacked.view(ty, tx, n_local, k_max).to(dev), aux


# ---------------------------------------------------------------------------
# The exchange as gathers
# ---------------------------------------------------------------------------

def _exchange(cfg: DistConfig, ids: torch.Tensor) -> torch.Tensor:
    """``exchange_halo_2d`` of an integer payload ``(TY, TX, tile_h,
    tile_w, n_exc)`` in ``cfg.halo_mode``, moved as ``cfg.pack_spikes``
    says: packed, each bit plane of the ids goes through ``pack_bits``,
    the exchange and ``unpack_bits`` as a spike block would."""
    d = cfg.engine.decomp
    if not cfg.pack_spikes:
        return exchange_halo_2d(ids, radius=d.radius, mode=cfg.halo_mode)
    out = torch.zeros((), dtype=torch.int64)
    for b in range(int(ids.max()).bit_length()):
        plane = exchange_halo_2d(pack_bits((ids >> b) & 1),
                                 radius=d.radius, mode=cfg.halo_mode)
        out = out + (unpack_bits(plane, ids.shape[-1]).to(torch.int64) << b)
    return out


def band_gather_maps(cfg: DistConfig, stride: int, sink_column: bool = False,
                     device="cuda") -> List[torch.Tensor]:
    """Per halo band, the ``(TY*TX, rows_b)`` int64 map from each tile's
    band rows to a flat source vector: tile i's local neuron j at ``i *
    stride + j``, and one zero sink at ``TY*TX*stride`` (the vector's
    last element) for sources outside the slab.  Gathering a stacked
    excitatory-source vector through it equals ``exchange_halo_2d``
    (with ``cfg.halo_mode``) followed by the band's
    ``band_positions_exc`` gather, bit for bit: the map is made by
    exchanging each source's position (``+1``, so that the exchange's
    zero fill marks the sink), in ``cfg``'s mode and wire format
    (``_exchange``).  ``sink_column`` appends one column of the sink to
    every row (the reference's per-band zero sink of the pre-trace).

    For an ensemble of M members the rows are the ``TY*TX*M`` (tile,
    member) instances in (y, x, m) order, and the flat source holds
    instance ``i*M + m``'s neuron j at ``(i*M + m) * stride + j`` (the
    sink at its end): member m's bands gather member m's sources, and
    each band is still one gather for every instance."""
    dev = resolve_device(device)
    e = cfg.engine
    spec = e.spec()
    d = e.decomp
    ty, tx = cfg.tiles
    members = cfg.n_members or 1
    n_per, n_exc = spec.n_per_col, spec.n_exc_per_col
    sink = ty * tx * stride
    col = np.arange(d.tile_cols)[:, None] * n_per + np.arange(n_exc)[None, :]
    tile = np.arange(ty * tx)[:, None, None] * stride
    ids = torch.from_numpy((tile + col[None] + 1).reshape(
        ty, tx, d.tile_h, d.tile_w, n_exc))
    region = _exchange(cfg, ids).reshape(ty * tx, -1)
    maps = []
    for band in spec.halo_bands():
        m = region[:, torch.from_numpy(spec.band_positions_exc(band))] - 1
        m = torch.where(m < 0, torch.full_like(m, sink), m)
        if sink_column:
            m = torch.cat([m, torch.full((ty * tx, 1), sink,
                                         dtype=m.dtype)], dim=1)
        if members > 1:
            mem = torch.arange(members).view(1, members, 1)
            inst = (m // stride).unsqueeze(1) * members + mem
            m = torch.where(m.unsqueeze(1) == sink, sink * members,
                            inst * stride + (m % stride).unsqueeze(1))
            m = m.reshape(ty * tx * members, -1)
        maps.append(m.to(dev))
    return maps


# ---------------------------------------------------------------------------
# The multi-shard step / run
# ---------------------------------------------------------------------------

class _Tiles:
    """What a run reads per tile, made once per set of stacked tensors:
    the table views (``tile_tables``), the plastic masks, the inverse
    indices built from ``SimInputs.inv_slots``."""

    def __init__(self, tables, inv_slots, sim: "_DistSim"):
        self.key = _identity(tables, inv_slots)
        self.tables = tile_tables(tables)
        self.masks = self.inv = None
        if sim.plastic:
            self.masks = [plastic_masks(tier_list(v)) for v in self.tables]
            self.inv = [sim.tile_inverse_index(v, m, slots)
                        for v, m, slots in zip(self.tables, self.masks,
                                               inv_slots.flatten(0, 1))]

    def tier_tensors(self) -> list:
        return [t[name] for v in self.tables for t in tier_list(v)
                for name in ("tgt", "dslot", "nnz", "w")]


def _identity(tables, inv_slots) -> list:
    return [t[k] for t in tier_list(tables) for k in sorted(t)] + [inv_slots]


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class _DistSim:
    """``make_sim_fn``'s function: ``sim(state, inputs)``.  It steps
    ``n_inst`` instances: the tiles, or for an ensemble every (tile,
    member) pair in (y, x, m) order, instance ``i`` on tile ``i //
    members``'s tables."""

    def __init__(self, cfg: DistConfig, n_steps: int, record_rate: bool,
                 recorder, storage: Optional[TableStorage], dev,
                 recorder_copy: bool = True, mesh=None,
                 transport: Optional[Transport] = None):
        e = cfg.engine
        self.cfg, self.e, self.n_steps = cfg, e, n_steps
        self.record_rate, self.recorder, self.dev = record_rate, recorder, dev
        self.recorder_copy = recorder_copy
        self.spec = spec = e.spec()
        self.mesh, self.transport = mesh, transport
        self.lead = _local_lead(cfg, mesh)
        ty, tx = self.lead[:2]
        self.n_tiles = ty * tx
        self.members = cfg.n_members or 1
        self.n_inst = self.n_tiles * self.members
        self.n_local = spec.n_local
        self.event = e.mode == "event"
        if not self.event and e.mode != "gather_all":
            raise ValueError(f"unknown mode {e.mode}")
        bands = spec.halo_bands()
        self.plan = spec.delivery_plan(storage)
        self.plastic = e.stdp is not None
        self.maps = self.pre_maps = None
        if mesh is None:
            self.maps = band_gather_maps(cfg, self.n_local, device=dev)
            if self.plastic:
                self.pre_maps = band_gather_maps(
                    cfg, self.n_local + 1, sink_column=True, device=dev)
        else:
            rank_tile(cfg, mesh)
            if transport is None:
                raise ValueError("a run on ranks needs a transport")
            self.band_idx = [torch.from_numpy(
                spec.band_positions_exc(b).astype(np.int64)).to(dev)
                for b in bands]
        if self.plastic:
            self.pre_caps = [spec.active_cap_local] + [
                spec.active_cap_band(b) for b in bands]
        self.zero = torch.zeros((1,), dtype=torch.float32, device=dev)
        self.tiles: Optional[_Tiles] = None
        # the resident recorder (``obs.record.resident_recorder``) and the
        # device step counter its appends read
        self.recorders: dict = {}
        self.t_dev = torch.zeros((), dtype=torch.int32, device=dev)
        # the captured loop, kept across calls while it serves them
        # (``_DistStepGraph.serves``); None where the sim steps eagerly
        self.graph_loop: Optional[GraphLoop] = None
        self.captures = 0           # CUDA graph captures, all calls

    # ---- per-tile inputs ------------------------------------------------
    def tile_inverse_index(self, tables: dict, masks: list,
                           slots: torch.Tensor) -> dict:
        """A tile's inverse index from its rows of the stacked slots."""
        tiers = tier_list(tables)
        sizes = np.array([int(np.prod(tuple(t["tgt"].shape)))
                          for t in tiers], dtype=np.int64)
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.int64)
        total = int(bases[-1] + sizes[-1])
        inv = {"slots": slots, "n_in": (slots != total).sum(
            1, dtype=torch.int32), "bases": bases, "sizes": sizes,
            "total": total, "clipped": 0}
        if self.e.use_kernels and slots.device.type == "cuda":
            inv["tm"] = target_major_meta(tiers, inv, masks)
        return inv

    def _tiles_for(self, inputs: SimInputs) -> _Tiles:
        if self.plastic and inputs.inv_slots is None:
            raise ValueError("a plastic engine needs SimInputs.inv_slots "
                             "(build_dist_inverse_index)")
        if self.tiles is None or not _same(
                self.tiles.key, _identity(inputs.tables, inputs.inv_slots)):
            self.tiles = _Tiles(inputs.tables, inputs.inv_slots, self)
        return self.tiles

    # ---- one step of every instance, in place ---------------------------
    def step(self, st: dict, tiles: _Tiles, drive, dst) -> None:
        """One step of all instances.  ``st``: the run's per-instance
        views (``_views``; with a recorder, ``st["recs"]`` the instances'
        recorders, which append with the step read from ``t_dev``,
        advanced here); ``drive``: (n_inst, n_local) or None; ``dst``:
        the (n_inst,) per-step spike counts, or None."""
        e, spec, plan = self.e, self.spec, self.plan
        rec = st.get("recs")
        t = int(st["t"][0])
        slot = t % e.d_ring
        per = self.members
        # the local tier's bitmap from the head, where the column or
        # fixed-order delivery of a static run reads it
        cap = plan[0].active_cap if self.event and not self.plastic \
            else None
        spikes, n_spk, local_bits = [], [], []
        for i in range(self.n_inst):
            _, spk, bits, count = step_head(
                st["neuron"][i], st["ring"][i], slot,
                None if drive is None else drive[i], st["rng"][i], e,
                st["active"][i], active_cap=cap, inplace=True)
            spikes.append(spk)
            n_spk.append(count)
            local_bits.append(bits)

        # the halo exchange: every band's source vector (and pre-trace)
        # for every instance
        if self.mesh is None:
            band_spk, xpre_bands = self._gather_bands(st, spikes)
        else:
            band_spk, xpre_bands = self._exchange_bands(st, spikes)
        band_bits = None
        if (self.event and e.use_kernels and not self.plastic
                and spikes[0].device.type == "cuda"
                and tiles.tables[0]["local"]["w"].dtype != torch.float32):
            band_bits = [delivered_bits(b, p.rows, p.active_cap)
                         for b, p in zip(band_spk, plan[1:])]
        if self.plastic:
            pl = st["plastic"]

        evs, drs = [], []
        for i in range(self.n_inst):
            tile = i // per
            tabs = tiles.tables[tile]
            ring = st["ring"][i]
            halo = [b[i] for b in band_spk]
            if self.plastic:
                tiers = [dict(tier, w=w[i]) for tier, w in
                         zip(tier_list(tabs), pl["w"])]
                traces = {"x_pre": [pl["x_pre"][i]]
                          + [b[i] for b in xpre_bands],
                          "x_post": pl["x_post"][i]}
                spk_tiers = [spikes[i]] + halo
                if self.event:
                    ring, new_tiers, traces, ev, dr = plastic_delivery_stdp(
                        tiers, tiles.masks[tile], tiles.inv[tile], traces,
                        spk_tiers, spec, ring, slot, e, plan,
                        fused_post=True)
                else:
                    _, ev = deliver_gather_all_tiers(
                        {"local": tiers[0], "halo": tiers[1:]}, spikes[i],
                        halo, ring, slot, e.d_ring)
                    dr = torch.zeros((), dtype=torch.float32,
                                     device=ring.device)
                    new_tiers, traces = stdp_step(
                        tiers, tiles.masks[tile], tiles.inv[tile], traces,
                        spk_tiers, spikes[i], e.stdp, self.pre_caps,
                        spec.active_cap_local, fused_post=True)
                for w, nt in zip(pl["w"], new_tiers):
                    if nt["w"] is not w[i]:
                        w[i].copy_(nt["w"])
                pl["x_pre"][i].copy_(traces["x_pre"][0])
                pl["x_post"][i].copy_(traces["x_post"])
            elif self.event:
                bits = [local_bits[i]] + (
                    [(b[i], c[i]) for b, c in band_bits] if band_bits
                    else [None] * len(halo))
                ring, ev, dr = deliver_event_tiers(
                    tabs, spikes[i], halo, spec, ring, slot, e.d_ring,
                    e.use_kernels, plan=plan, tier_bits=bits)
            else:
                _, ev = deliver_gather_all_tiers(tabs, spikes[i], halo, ring,
                                                 slot, e.d_ring)
                dr = None
            evs.append(ev)
            drs.append(dr)
            if rec is not None:
                from ..obs.record import record_step
                record_step(rec[i], spikes[i], st["gids"][i], self.t_dev,
                            self.recorder)
        if rec is not None:
            self.t_dev.add_(1)

        counts = torch.stack(n_spk).to(torch.float32)
        m = st["metrics"]
        m["spikes"].add_(counts)
        m["events"].add_(torch.stack(evs))
        if drs[0] is not None:
            m["dropped"].add_(torch.stack(drs))
        if dst is not None:
            dst.copy_(counts)
        st["state"]["t"] = st["state"]["t"] + 1
        st["t"] = st["state"]["t"].reshape(-1)

    # ---- the exchange: two ways to the bands' vectors ------------------
    def _gather_bands(self, st: dict, spikes: list) -> tuple:
        """Stacked: one gather per band over every instance's spikes
        (and pre-traces), through the precomputed maps."""
        src = torch.cat(spikes + [self.zero])
        band_spk = [src[m] for m in self.maps]
        xpre_bands = None
        if self.plastic:
            xpre_src = torch.cat([st["x_pre_flat"], self.zero])
            xpre_bands = [xpre_src[m] for m in self.pre_maps]
        return band_spk, xpre_bands

    def _rank_region(self, x: torch.Tensor, packed: bool,
                     channel: int) -> torch.Tensor:
        """This rank's ``(M, rows)`` instances' excitatory lanes ``x``
        (``(M, n_local)``) exchanged with the neighbours: the flat
        ``(M, region)`` block the band positions index; the members
        travel in the same message."""
        cfg, spec = self.cfg, self.spec
        d = self.e.decomp
        n_exc = spec.n_exc_per_col
        blk = x.reshape(x.shape[0], d.tile_h, d.tile_w,
                        spec.n_per_col)[..., :n_exc].permute(1, 2, 0, 3)
        payload = pack_bits(blk) if packed else blk
        region = exchange_halo_2d(
            payload, radius=d.radius, mode=cfg.halo_mode, mesh=self.mesh,
            axis_y=cfg.axis_y, axis_x=cfg.axis_x, transport=self.transport,
            channel=channel)
        if packed:
            region = unpack_bits(region, n_exc)
        return region.permute(2, 0, 1, 3).reshape(x.shape[0], -1)

    def _exchange_bands(self, st: dict, spikes: list) -> tuple:
        """Ranks: this rank's spikes (bit-packed when ``pack_spikes``)
        and pre-traces go to its neighbours; each band gathers its
        positions of the region (the pre-trace with a zero sink)."""
        region = self._rank_region(torch.stack(spikes),
                                   self.cfg.pack_spikes, 0)
        band_spk = [region[:, idx] for idx in self.band_idx]
        xpre_bands = None
        if self.plastic:
            xpre = st["plastic"]["x_pre"]
            pre = self._rank_region(torch.stack(xpre)[:, :self.n_local],
                                    False, 1)
            sink = torch.zeros((self.n_inst, 1), dtype=pre.dtype,
                               device=pre.device)
            xpre_bands = [torch.cat([pre[:, idx], sink], dim=1)
                          for idx in self.band_idx]
        return band_spk, xpre_bands

    # ---- the run --------------------------------------------------------
    def _views(self, state: dict, inputs: SimInputs, recs) -> dict:
        """The stacked state's per-instance views (flattened leading
        axes)."""
        k = len(self.lead)
        flat = lambda x: x.flatten(0, k - 1)     # noqa: E731
        st = {
            "state": state,
            "t": state["t"].reshape(-1),
            "ring": flat(state["i_ring"]).unbind(0),
            "neuron": [dict(zip(state["neuron"], vs)) for vs in zip(
                *[flat(x).unbind(0) for x in state["neuron"].values()])],
            "active": flat(state["active"]).unbind(0),
            "rng": state["rng"],
            "metrics": {k: x.view(-1) for k, x in state["metrics"].items()},
        }
        if self.plastic:
            pl = state["plastic"]
            st["plastic"] = {"w": [flat(w).unbind(0) for w in pl["w"]],
                             "x_pre": flat(pl["x_pre"][0]).unbind(0),
                             "x_post": flat(pl["x_post"]).unbind(0)}
            st["x_pre_flat"] = pl["x_pre"][0].view(-1)
        if self.recorder is not None:
            st["gids"] = [g for g in inputs.gids.flatten(0, 1).unbind(0)
                          for _ in range(self.members)]
            st["recs"] = recs
        return st

    def __call__(self, state: dict, inputs: SimInputs):
        _check_state(state, inputs, self)
        tiles = self._tiles_for(inputs)
        lead = self.lead
        n, n_steps = self.n_inst, self.n_steps
        rec_state = recs = None
        if self.recorder is not None:
            from ..obs.record import resident_recorder
            rec_state = resident_recorder(self.recorders, self.recorder,
                                          self.dev, lead)
            recs = [{k: v.reshape((n,) + tuple(v.shape[len(lead):]))[i]
                     for k, v in rec_state.items()} for i in range(n)]
            self.t_dev.fill_(int(state["t"].flat[0]))
        st = self._views(state, inputs, recs)
        drive = inputs.drive
        if drive is not None:
            if tuple(drive.shape) != (n_steps,) + lead + (self.n_local,):
                raise ValueError(
                    f"drive has shape {tuple(drive.shape)}, expected "
                    f"{(n_steps,) + lead + (self.n_local,)}")
            drive = drive.reshape(n_steps, n, self.n_local)
        out = torch.empty((n_steps, n), dtype=torch.float32, device=self.dev)
        loop = None
        if (self.dev.type == "cuda" and self.e.use_kernels and self.event
                and not self.plastic and self.mesh is None):
            loop = self.graph_loop
            if loop is not None and loop.serves(st, tiles, drive):
                loop.rebind(st, drive)
            elif n_steps >= 2 * self.e.d_ring:
                loop = _DistStepGraph(self, st, tiles, drive)
            else:
                loop = None
        self.graph_loop = loop
        if loop is not None:
            before = loop.captures
            loop.run(n_steps, out)
            self.captures += loop.captures - before
        else:
            for k in range(n_steps):
                self.step(st, tiles, None if drive is None else drive[k],
                          out[k])
        per_step = (out.t().reshape(lead + (n_steps,)).contiguous()
                    if self.record_rate else None)
        if self.recorder is not None:
            if self.recorder_copy:
                from ..obs.record import copy_recorder
                rec_state = copy_recorder(rec_state)
            return state, per_step, rec_state
        return state, per_step


def _state_key(state: dict) -> list:
    """The objects a captured step holds of ``state``: its tensors and
    its generators."""
    return tree_flatten({k: v for k, v in state.items() if k != "t"})[0]


def _check_state(state: dict, inputs: SimInputs, sim: _DistSim) -> None:
    have = {state["i_ring"].device, inputs.tables["local"]["tgt"].device}
    if any(d.type != sim.dev.type for d in have):
        raise ValueError(
            f"make_sim_fn(device={str(sim.dev)!r}) but the state/tables "
            f"live on {sorted(str(d) for d in have)}; build them with the "
            "same device=")
    lead = sim.lead
    if tuple(state["i_ring"].shape[:-2]) != lead or \
            len(state["rng"]) != sim.n_inst:
        what = "tiles" if len(lead) == 2 else "tiles and members"
        raise ValueError(f"the state is not stacked on {lead} {what}")
    t = state["t"]
    if not (t == t.flat[0]).all():
        raise ValueError("the tiles' step counters differ")
    if sim.plastic and "plastic" not in state:
        raise ValueError("a plastic engine needs state['plastic'] "
                         "(init_dist_plastic_state)")
    if sim.recorder is not None and inputs.gids is None:
        raise ValueError("a recorder needs SimInputs.gids "
                         "(obs.record.stacked_gid_maps)")


class _DistStepGraph(GraphLoop):
    """The static multi-shard loop on a CUDA device: one graph holds
    ``d_ring`` steps of every instance (heads, exchange, band gathers,
    deliveries, recorder appends), with every instance's generator
    registered.  The sim keeps it across calls while they hand it the
    same state tensors, generators and tables (``serves``), so a
    segmented run captures once; its resident recorder is zeroed in
    place before each call."""

    def __init__(self, sim: _DistSim, st: dict, tiles: _Tiles, drive):
        super().__init__(st["state"], sim.e.d_ring, sim.dev, drive,
                         (sim.n_inst, sim.n_local), (sim.n_inst,))
        self.sim, self.st, self.tiles = sim, st, tiles
        self.key = _state_key(st["state"])

    def serves(self, st: dict, tiles: _Tiles, drive) -> bool:
        """Whether this loop's graph reads and writes the tensors of the
        call: the same state tensors and generators, the same tables,
        and a drive of the same kind (drawn or injected)."""
        return (tiles is self.tiles and (drive is not None) == self.injected
                and _same(self.key, _state_key(st["state"])))

    def rebind(self, st: dict, drive) -> None:
        self.st, self.state, self.drive = st, st["state"], drive

    def _one(self, drive, dst) -> None:
        self.st["t"] = self.state["t"].reshape(-1)
        self.sim.step(self.st, self.tiles, drive, dst)

    def _tier_tensors(self) -> list:
        return self.tiles.tier_tensors()

    def _bind(self) -> None:
        for v in self.tiles.tables:
            bind_tier_structures(tier_list(v), self.sim.spec,
                                 self.sim.e.d_ring)

    def _generators(self) -> list:
        return list(self.state["rng"])


def make_sim_fn(cfg: DistConfig, n_steps: int, record_rate: bool = True,
                recorder=None, storage: Optional[TableStorage] = None,
                device="cuda", recorder_copy: bool = True, mesh=None,
                transport: Union[str, Transport] = "gloo"):
    """The multi-shard simulation function of ``n_steps`` steps.

    Returns ``sim(state, inputs) -> (state, per_step (TY, TX, n_steps)
    float32[, recorder_state])``, ``inputs`` a ``SimInputs``.  The state
    is updated in place and returned (the counterpart of the reference's
    donation); each call continues where the last stopped (``t`` rides
    in the state).  ``storage``: the tables' storage descriptor
    (``tables.storage`` for compressed tables), which sizes the delivery
    plan.  ``record_rate=False`` returns None for ``per_step``.

    ``recorder``: an ``obs.record.RecorderSpec``; ``inputs.gids`` must
    then hold ``stacked_gid_maps`` and the return grows each tile's
    ``(step, gid)`` event buffer, ``count`` and ``dropped``, stacked on
    ``(TY, TX)``.  Recording is a pure observer.  The steps append to
    the sim's resident recorder, zeroed in place at the start of every
    call, and the call returns a copy of it (``obs.record.
    copy_recorder``, after the run, outside any graph).  With
    ``recorder_copy=False`` it returns the resident buffers themselves,
    which the next call overwrites: only for a caller that drains them
    first (``runtime.SimDriver``).

    Ensembles (``cfg.ensemble_seeds``, M members): the state leads with
    ``(TY, TX, M)`` (``init_dist_state``), ``per_step`` is ``(TY, TX, M,
    n_steps)`` and every recorder leaf gains the member axis after the
    tile axes; the tables, inverse index and gid maps stay member-free.

    Plastic engines (``cfg.engine.stdp``): ``state["plastic"]`` carries
    every tier's live weights and the pre/post traces
    (``init_dist_plastic_state``), ``inputs.tables`` the structure and
    int8 plastic mask (``fold_plastic_tables``), ``inputs.inv_slots`` the
    stacked inverse index (``build_dist_inverse_index``).  Each tile's
    halo pre-traces are the owners' local pre-traces at the start of the
    step, exchanged like the spikes, with a zero sink per band.

    On a CUDA ``device`` with ``use_kernels``, a static event-mode run
    (recorded or not) of at least ``2 * d_ring`` steps replays one CUDA
    graph of ``d_ring`` steps of all instances after ``d_ring`` eager
    steps, then steps an eager tail (``engine.GraphLoop``); plastic and
    shorter runs step eagerly.

    Ranks (``mesh``): the sim steps this rank's tile, its state and
    inputs the rank's blocks (``init_dist_state(mesh=)``,
    ``build_dist_tables(mesh=)``, ``rank_block``; a drive ``(n_steps, 1,
    1[, M], n_local)``), ``per_step`` ``(1, 1[, M], n_steps)``.  Every
    step sends the tile's excitatory spikes (plastic: and its local
    pre-trace) to its neighbours through ``transport`` (``"gloo"``,
    ``"nccl"`` or a ``halo.Transport``, made once for the sim; its
    ``bytes_sent`` and ``seconds`` count the run's exchange).  It steps
    eagerly."""
    dev = resolve_device(device)
    if mesh is not None and not isinstance(transport, Transport):
        transport = Transport(transport, dev)
    return _DistSim(cfg, n_steps, record_rate, recorder, storage, dev,
                    recorder_copy, mesh,
                    transport if mesh is not None else None)


def simulate(cfg: DistConfig, n_steps: int, timed: bool = False,
             device="cuda", mesh=None,
             transport: Union[str, Transport] = "gloo") -> dict:
    """Build, run, report (static engines).  ``timed=True`` runs a
    second segment of ``n_steps`` after the first and reports its host
    wall time (``elapsed_s``, CUDA-synchronised) and events.  With
    ``mesh`` each rank builds and runs its own tile; the metrics stay
    per tile in its state, and the reported keys are the stacked run's,
    reduced over every rank's tile (gathered, then summed as the stacked
    tensors are), the same on every rank; ``elapsed_s`` is the slowest
    rank's."""
    if cfg.engine.stdp is not None:
        raise ValueError("simulate() is the static convenience driver; "
                         "drive plastic runs through make_sim_fn")
    dev = resolve_device(device)
    state = init_dist_state(cfg, device=dev, mesh=mesh)
    tables, stats = build_dist_tables(cfg, device=dev, mesh=mesh)
    sim = make_sim_fn(cfg, n_steps, storage=tables.storage, device=dev,
                      mesh=mesh, transport=transport)
    inputs = SimInputs(tables=tables)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def whole(x):
        """A per-tile tensor of every tile (the stacked form's)."""
        if mesh is None:
            return x
        return gather_blocks(cfg, x, mesh, dst=None)

    state, per_step = sim(state, inputs)
    elapsed = before = None
    if timed:
        sync()
        before = float(whole(state["metrics"]["events"]).sum())
        t0 = time.perf_counter()
        state, per_step = sim(state, inputs)
        sync()
        elapsed = time.perf_counter() - t0
        if mesh is not None:
            elapsed = max(all_gather_host(elapsed))
    n_active = float(whole(state["active"]).sum())
    spikes = float(whole(state["metrics"]["spikes"]).sum())
    sim_sec = n_steps * (2 if timed else 1) * cfg.engine.lif.dt_ms * 1e-3
    out = {
        "state": state, "per_step_spikes": per_step, "stats": stats,
        "rate_hz": spikes / max(n_active, 1.0) / max(sim_sec, 1e-9),
        "events": float(whole(state["metrics"]["events"]).sum()),
        "dropped": float(whole(state["metrics"]["dropped"]).sum()),
    }
    if timed:
        out["elapsed_s"] = elapsed
        out["events_timed"] = out["events"] - before
    return out
