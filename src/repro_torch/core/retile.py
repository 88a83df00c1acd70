"""Elastic re-tiling of checkpointed distributed SNN state.

The port of ``repro.core.retile``: host-side numpy, bit for bit the
reference's on the same inputs, apart from the drive generators (see
``rng`` below).

A DPSNN-style job checkpointed on a ``tiles_y x tiles_x`` decomposition
must be able to come back on a *different* one (the MPI analogue:
resubmitting the same slab on a different process geometry).  The global
model is tiling-invariant -- a neuron is identified by its **global
column id** ``gy * W + gx`` plus its within-column index -- so restore
is a pure relayout:

  * ``v``, ``c``, ``refrac``, ``active``: permuted per neuron by global
    column id (padded slots of the new tiling get inert fill values);
  * ``i_ring``: the delay ring is *target*-indexed, so every in-flight
    delayed current moves with its target column; the slot axis is kept
    as-is and ``t`` is preserved, so the ``t % d_ring`` alignment
    survives the move exactly;
  * ``t``: broadcast unchanged to the new tile array;
  * ``metrics``: **zeroed**.  Cumulative run totals are global scalars,
    not relayout-able per-tile state: parking them on an arbitrary tile
    (the old behaviour put the whole history on tile (0, 0)) made
    per-tile metric reads tiling-dependent.  The totals accumulated
    before the retile travel in the checkpoint *manifest*
    (``SimDriver`` saves ``metric_base`` / ``metric_totals`` meta and
    re-adds the base to everything it reports), and the relaid state's
    metrics restart at zero -- post-retile per-tile metrics describe
    post-retile activity only;
  * ``rng``: per-tile streams are re-derived.  The reference folds the
    old (0, 0) key with each new tile index (``jax.random.fold_in``); a
    ``torch.Generator`` cannot fold, so the port's rule is its own:
    new tile ``i`` (row-major) draws from a generator seeded with
    ``retile_seed(state_seed, t, i)``, a 64-bit word of
    ``numpy.random.SeedSequence([state_seed, t, i])``.  Either way the
    resumed dynamics are a valid continuation, not a bitwise replay of
    the old tiling's stream (and not each other's).

Synapse tables of **static** runs are not relaid out: they are rebuilt
deterministically for the new decomposition from the same engine seed
(``build_dist_tables``), exactly like DPSNN re-deriving its connectivity
from the configuration on restart.

**Plastic** runs cannot re-sample: the weights ARE the learned state.
``retile_tables`` therefore relays the whole synapse realization across
tilings by global ``(pre, post)`` synapse identity -- every synapse is
gathered as a ``(pre_gid, post_gid, weight, delay)`` record, re-grouped
by the tile that owns its *target* under the new decomposition, and
re-packed into the new tiling's local/halo-band row structure in a
canonical order (sorted by ``(row, post_gid, dslot)``, input position
as the tie-break for duplicate pairs, so relays compose: born->A->B
lands bit-identically to born->B).  A synapse that cannot be placed
(new-tiling row capacity overflow, or a pre column below the new
tiling's halo-band fan-out floor) raises instead of being dropped --
silently discarding learned weights is exactly the failure mode this
path exists to prevent.  ``retile_plastic`` relays the plastic carry
(per-tier weights + STDP traces) alongside: pre-traces travel by pre
neuron id (halo copies are exact replicas of the home shard's trace, so
re-deriving them from the home value is lossless), post-traces by the
same per-neuron permutation as the membrane state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid import TileDecomposition, global_column_ids


def neuron_gather_map(old: TileDecomposition,
                      new: TileDecomposition) -> np.ndarray:
    """Per-neuron relayout map between two tilings of the same grid.

    Returns ``src`` of shape ``(new.tiles_y, new.tiles_x, new.n_local)``:
    for each neuron slot of the new layout, the flat index of the same
    global neuron in the old layout flattened to
    ``(old.tiles_y * old.tiles_x * old.n_local,)``, or -1 for slots in
    padded columns (no logical neuron lives there).
    """
    if old.grid != new.grid:
        raise ValueError(f"grid mismatch: {old.grid} != {new.grid}")
    n_per = old.grid.n_per_column
    # flat old column position of each global column id
    gid_old = global_column_ids(old).reshape(-1)
    src_col = np.full(old.grid.n_columns, -1, np.int64)
    pos = np.where(gid_old >= 0)[0]
    src_col[gid_old[pos]] = pos
    # new slot -> old flat column -> old flat neuron
    gid_new = global_column_ids(new)
    col_src = np.where(gid_new >= 0, src_col[np.maximum(gid_new, 0)], -1)
    src = col_src[..., None] * n_per + np.arange(n_per)
    src = np.where(col_src[..., None] >= 0, src, -1)
    return src.reshape(new.tiles_y, new.tiles_x, new.n_local)


def retile_config(cfg, tiles_y: int, tiles_x: int):
    """A DistConfig identical to ``cfg`` but on a different tiling."""
    decomp = dataclasses.replace(cfg.engine.decomp, tiles_y=tiles_y,
                                 tiles_x=tiles_x)
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, decomp=decomp))


def retile_seed(state_seed: int, t: int, tile: int) -> int:
    """The seed of new tile ``tile``'s drive generator after a retile at
    step ``t`` (module docstring)."""
    return int(np.random.SeedSequence(
        [int(state_seed), int(t), int(tile)]).generate_state(1, np.uint64)[0])


def retile_state(state: dict, old: TileDecomposition,
                 new: TileDecomposition, state_seed: int = 0) -> dict:
    """Relayout a (host-side) distributed sim state onto a new tiling.

    ``state`` is the tree ``dist_engine.state_tree`` makes (or
    ``restore_checkpoint`` returns) with every neuron, ring, ``t`` and
    metric leaf carrying leading ``(old.tiles_y, old.tiles_x)`` tile
    dims.  Returns the same tree shaped for ``new``, as numpy arrays,
    with ``rng`` the new tiles' generator seeds (``retile_seed``,
    row-major), which ``dist_engine.load_state`` seeds the generators
    with.  ``state_seed``: the engine's ``state_seed_value``.
    """
    src = neuron_gather_map(old, new)          # (TY2, TX2, n_local2)
    valid = src >= 0
    idx = np.maximum(src, 0)
    ty2, tx2 = new.tiles_y, new.tiles_x

    def permute(leaf, fill):
        flat = _host(leaf).reshape(-1)
        return np.where(valid, flat[idx], flat.dtype.type(fill))

    neuron = {
        "v": permute(state["neuron"]["v"], 0.0),
        "c": permute(state["neuron"]["c"], 0.0),
        "refrac": permute(state["neuron"]["refrac"], 0),
    }
    active = permute(state["active"], False)

    # delay ring: (TY1, TX1, D, n1) -> per-slot neuron permutation
    ring = _host(state["i_ring"])
    d_ring = ring.shape[2]
    ring_flat = np.moveaxis(ring, 2, 0).reshape(d_ring, -1)
    new_ring = np.where(valid[None], ring_flat[:, idx],
                        ring_flat.dtype.type(0))
    new_ring = np.moveaxis(new_ring, 0, 2)     # (TY2, TX2, D, n2)

    t_old = np.asarray(state["t"]).reshape(-1)[0]
    t = np.full((ty2, tx2), t_old, dtype=np.asarray(state["t"]).dtype)

    # cumulative metric totals are carried as global scalars in the
    # checkpoint manifest (see module docstring), not smeared over tiles
    metrics = {k: np.zeros((ty2, tx2), dtype=np.asarray(v).dtype)
               for k, v in state["metrics"].items()}

    rng = [retile_seed(state_seed, t_old, i) for i in range(ty2 * tx2)]

    return {"neuron": neuron, "i_ring": new_ring, "t": t, "rng": rng,
            "active": active, "metrics": metrics}


def _host(v) -> np.ndarray:
    """A state or table leaf as numpy (bfloat16 weights as their float32
    values, which is exact)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# Plastic-table relay: the synapse realization travels across tilings
# ---------------------------------------------------------------------------

def local_gid_map(d: TileDecomposition, ty: int, tx: int) -> np.ndarray:
    """(n_local,) global neuron id of each local slot; -1 in padded
    columns.  (No trailing compaction-sink slot -- cf. the observatory's
    ``obs.record.tile_gid_map``, which appends one.)"""
    gcol = global_column_ids(d)[ty, tx]
    n_per = d.grid.n_per_column
    g = gcol[:, None] * n_per + np.arange(n_per)[None, :]
    return np.where(gcol[:, None] >= 0, g, -1).ravel()


def band_gid_map(d: TileDecomposition, band_cols: np.ndarray,
                 ty: int, tx: int, n_exc: int) -> np.ndarray:
    """(n_cols_b * n_exc,) global neuron id of each halo-band source
    row (excitatory sources only); -1 for region columns outside the
    logical grid."""
    H, W = d.grid.height, d.grid.width
    oy, ox = d.tile_origin(ty, tx)
    ry, rx = band_cols // d.region_w, band_cols % d.region_w
    gy, gx = oy - d.radius + ry, ox - d.radius + rx
    ok = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    gcol = np.where(ok, gy * W + gx, -1)
    n_per = d.grid.n_per_column
    g = gcol[:, None] * n_per + np.arange(n_exc)[None, :]
    return np.where(gcol[:, None] >= 0, g, -1).ravel()


def gather_synapse_stream(tables: dict, d: TileDecomposition,
                          spec) -> dict:
    """Flatten stacked per-shard tables into one global synapse stream.

    Every stored synapse appears exactly once (it lives in its target's
    shard); iteration order is (shard-major, tier, row, slot), giving a
    deterministic input position used as the relay's duplicate-pair
    tie-break.  Returns 1-D arrays ``pre`` / ``post`` (global neuron
    ids), ``w``, ``dslot``.
    """
    bands = spec.halo_bands()
    n_exc = spec.n_exc_per_col
    host = {
        "local": {k: _host(v) for k, v in tables["local"].items()},
        "halo": [{k: _host(v) for k, v in t.items()}
                 for t in tables["halo"]],
    }
    pres, posts, ws, ds = [], [], [], []
    for ty in range(d.tiles_y):
        for tx in range(d.tiles_x):
            lmap = local_gid_map(d, ty, tx)
            pre_maps = [lmap] + [band_gid_map(d, b["cols"], ty, tx, n_exc)
                                 for b in bands]
            tiers = [host["local"]] + host["halo"]
            for tier, pmap in zip(tiers, pre_maps):
                tgt = tier["tgt"][ty, tx]
                nnz = tier["nnz"][ty, tx]
                cap = tgt.shape[1]
                valid = np.arange(cap)[None, :] < nnz[:, None]
                rr, kk = np.nonzero(valid)
                pres.append(pmap[rr])
                posts.append(lmap[tgt[rr, kk]])
                ws.append(tier["w"][ty, tx][rr, kk])
                ds.append(tier["dslot"][ty, tx][rr, kk])

    def cat(parts, dtype=None):
        out = (np.concatenate(parts) if parts
               else np.empty(0, dtype or np.int64))
        return out

    # weights travel as float32 regardless of the storage dtype (the
    # cast is value-exact under the v3 sampling-time quantization), so
    # canonical stream digests are storage-format invariant
    stream = {"pre": cat(pres), "post": cat(posts),
              "w": cat(ws, np.float32).astype(np.float32),
              "dslot": cat(ds, np.int8)}
    if len(stream["pre"]) and (stream["pre"].min() < 0
                               or stream["post"].min() < 0):
        raise ValueError("synapse stream references a padded (non-"
                         "logical) neuron slot -- corrupt tables")
    return stream


def pack_synapse_stream(stream: dict, d: TileDecomposition, spec,
                        storage=None):
    """Pack a global synapse stream into ``d``'s stacked table layout.

    ``storage``: target ``TableStorage``; defaults to the spec's
    analytic descriptor.  Pass a compressed descriptor to pack straight
    into truncated caps (safe whenever the stream is the relay of a
    realization those caps were derived from -- relaying preserves
    per-row occupancy exactly).

    Refuses (raises) rather than drops: a row whose relaid synapse
    count exceeds the target capacity, or a pre column falling below
    the new tiling's halo-band fan-out floor, would silently lose
    learned weights.  Returns the port's ``SynapseTables`` of CPU
    tensors in ``storage``'s dtypes (bfloat16 weights are packed as
    float32 and cast, which is exact for the stream of bfloat16
    tables).
    """
    from .synapses import TORCH_DTYPES, SynapseTables
    if storage is None:
        storage = spec.storage()
    H, W = d.grid.height, d.grid.width
    n_per = d.grid.n_per_column
    n_exc = spec.n_exc_per_col
    bands = spec.halo_bands()
    wdt = np.float32
    tdt = np.dtype(storage.tgt_dtype)
    band_of = np.full(d.region_cols, -1, np.int64)
    bandcol_of = np.full(d.region_cols, -1, np.int64)
    for bi, b in enumerate(bands):
        band_of[b["cols"]] = bi
        bandcol_of[b["cols"]] = np.arange(len(b["cols"]))

    pre, post = stream["pre"], stream["post"]
    w, dslot = stream["w"], stream["dslot"]
    idx = np.arange(len(pre))

    post_col, post_n = post // n_per, post % n_per
    gy, gx = post_col // W, post_col % W
    ty2, tx2 = gy // d.tile_h, gx // d.tile_w
    ly, lx = gy - ty2 * d.tile_h, gx - tx2 * d.tile_w
    tgt_local = (ly * d.tile_w + lx) * n_per + post_n

    pre_col, pre_n = pre // n_per, pre % n_per
    py, px = pre_col // W, pre_col % W
    ry = py - (ty2 * d.tile_h - d.radius)
    rx = px - (tx2 * d.tile_w - d.radius)
    if len(pre) and ((ry < 0).any() or (ry >= d.region_h).any()
                     or (rx < 0).any() or (rx >= d.region_w).any()):
        raise ValueError(
            "a relaid synapse reaches beyond the stencil radius of the "
            "new tiling -- the stream does not belong to this model")
    in_tile = ((ry >= d.radius) & (ry < d.radius + d.tile_h)
               & (rx >= d.radius) & (rx < d.radius + d.tile_w))
    row_local = ((ry - d.radius) * d.tile_w + (rx - d.radius)) * n_per \
        + pre_n
    rc = ry * d.region_w + rx
    bi = np.where(in_tile, -1, band_of[np.clip(rc, 0, d.region_cols - 1)])
    unplaced = ~in_tile & (bi < 0)
    if unplaced.any():
        raise ValueError(
            f"{int(unplaced.sum())} learned synapse(s) have no slot "
            f"under the {d.tiles_y}x{d.tiles_x} tiling: their pre "
            "columns fall below the new halo-band fan-out floor.  "
            "Retiling a plastic run must never drop weights; resume on "
            "a tiling whose halo bands cover every learned source "
            "column (usually: fewer, larger tiles)")
    if (~in_tile & (pre_n >= n_exc)).any():
        raise ValueError("inhibitory synapse stored across tiles -- "
                         "corrupt stream (inhibitory sources only "
                         "project within their own column)")
    row_band = bandcol_of[np.clip(rc, 0, d.region_cols - 1)] * n_exc + pre_n

    def pack(sel, n_rows, cap, rows_of, what):
        rows = rows_of[sel]
        counts = np.bincount(rows, minlength=n_rows) if len(rows) \
            else np.zeros(n_rows, np.int64)
        if (counts > cap).any():
            worst = int(counts.max())
            raise ValueError(
                f"{what}: {worst} relaid synapses in one source row "
                f"exceed the new tiling's row capacity {cap} -- "
                "refusing to drop learned weights")
        # canonical within-row order: (post, dslot, input position)
        order = np.lexsort((idx[sel], dslot[sel], post[sel], rows))
        rows_s = rows[order]
        within = np.arange(len(rows_s)) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        tgt_a = np.zeros((n_rows + 1, cap), tdt)
        w_a = np.zeros((n_rows + 1, cap), wdt)
        d_a = np.zeros((n_rows + 1, cap), np.int8)
        sidx = np.nonzero(sel)[0][order]
        tgt_a[rows_s, within] = tgt_local[sidx]
        w_a[rows_s, within] = w[sidx].astype(wdt)
        d_a[rows_s, within] = dslot[sidx]
        nnz = np.concatenate([counts, [0]]).astype(np.int32)
        return {"tgt": tgt_a, "w": w_a, "dslot": d_a, "nnz": nnz}

    band_caps = list(storage.halo_caps)
    out = {"local": [], "halo": [[] for _ in bands]}
    for y in range(d.tiles_y):
        row_out, halo_rows = [], [[] for _ in bands]
        for x in range(d.tiles_x):
            here = (ty2 == y) & (tx2 == x)
            row_out.append(pack(
                here & in_tile, spec.n_local, storage.cap_local,
                row_local, f"tile ({y},{x}) local tier"))
            for b_i, b in enumerate(bands):
                halo_rows[b_i].append(pack(
                    here & ~in_tile & (bi == b_i), b["rows"],
                    band_caps[b_i], row_band,
                    f"tile ({y},{x}) halo band {b_i}"))
        out["local"].append(row_out)
        for b_i in range(len(bands)):
            out["halo"][b_i].append(halo_rows[b_i])

    def stack(grid_of_tiers):
        out = {k: torch.from_numpy(np.stack(
            [np.stack([t[k] for t in row]) for row in grid_of_tiers]))
            for k in ("tgt", "w", "dslot", "nnz")}
        out["w"] = out["w"].to(TORCH_DTYPES[storage.weight_dtype])
        return out

    return SynapseTables(stack(out["local"]),
                         [stack(g) for g in out["halo"]], storage)


def retile_tables(tables, old_d: TileDecomposition, old_spec,
                  new_d: TileDecomposition, new_spec, storage=None):
    """Relay a (stacked) synapse realization onto a new tiling by
    global (pre, post) synapse identity -- weights travel, nothing is
    re-sampled.  Pure host-side; callers move the result to the
    device.
    ``storage`` selects the packed layout (default: ``new_spec``'s
    analytic descriptor)."""
    if old_d.grid != new_d.grid:
        raise ValueError(f"grid mismatch: {old_d.grid} != {new_d.grid}")
    stream = gather_synapse_stream(tables, old_d, old_spec)
    return pack_synapse_stream(stream, new_d, new_spec, storage)


def retile_plastic(plastic: dict, old_tables,
                   old_d: TileDecomposition, old_spec,
                   new_d: TileDecomposition, new_spec, storage=None):
    """Relay the plastic carry (per-tier weights + STDP traces).

    ``old_tables`` supplies the old tiling's realization *structure*
    (targets/delays/occupancy); the live weights come from
    ``plastic["w"]`` and override the structural weights entry-for-entry
    (same shapes by construction), so the relaid layout is identical to
    relaying the structure itself -- the canonical order never keys on
    the weight value.
    """
    carried = {
        "local": dict(old_tables["local"], w=_host(plastic["w"][0])),
        "halo": [dict(t, w=_host(pw)) for t, pw in
                 zip(old_tables["halo"], plastic["w"][1:])],
    }
    new_tabs = pack_synapse_stream(
        gather_synapse_stream(carried, old_d, old_spec), new_d, new_spec,
        storage)
    w_new = [_host(t["w"]) for t in new_tabs.tiers()]

    # pre-traces: per pre-neuron values, carried for the local tier only
    # (band replicas are exchanged per step, never stored -- see
    # ``dist_engine.make_sim_fn``); relaid like the membrane state, by
    # global neuron id
    n_per = old_d.grid.n_per_column
    trace = np.zeros((old_d.grid.n_neurons,), np.float32)
    xp_local = _host(plastic["x_pre"][0])
    for ty in range(old_d.tiles_y):
        for tx in range(old_d.tiles_x):
            lmap = local_gid_map(old_d, ty, tx)
            live = lmap >= 0
            trace[lmap[live]] = xp_local[ty, tx, :len(lmap)][live]

    def lift_traces(gid_map_fn, rows):
        out = np.zeros((new_d.tiles_y, new_d.tiles_x, rows + 1),
                       np.float32)
        for ty in range(new_d.tiles_y):
            for tx in range(new_d.tiles_x):
                g = gid_map_fn(ty, tx)
                out[ty, tx, :rows] = np.where(g >= 0,
                                              trace[np.maximum(g, 0)], 0.0)
        return out

    x_pre = [lift_traces(lambda y, x: local_gid_map(new_d, y, x),
                         new_spec.n_local)]

    # post-trace: a per-local-neuron quantity, same permutation as v
    src = neuron_gather_map(old_d, new_d)
    valid = src >= 0
    xpost_flat = _host(plastic["x_post"]).reshape(-1)
    x_post = np.where(valid, xpost_flat[np.maximum(src, 0)],
                      np.float32(0.0)).astype(np.float32)

    assert n_per == new_d.grid.n_per_column
    return {"w": w_new, "x_pre": x_pre, "x_post": x_post}
