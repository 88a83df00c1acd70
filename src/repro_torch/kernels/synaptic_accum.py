"""Event-driven synaptic delivery: the CUDA delivery kernels' wrappers.

Replaces the TPU pipeline ``repro/kernels/synaptic_accum.py``
(``event_delivery_banded`` -> ``_scatter_entries`` / ``_accum_kernel``).
Per tier (the local table, then each halo fan-out band):

  * **delivered rows**: a bitmap of the first ``active_cap`` spiking
    rows, the rows the reference's compaction delivers.  The engine's
    step hands the local tier's in (``tier_bits``), written by the
    step-head kernel (``kernels/neuron_step.py``); the multi-shard step
    hands the halo bands' in, packed for every tile at once; other
    tiers get it from ``ref.delivered_bits`` (plain PyTorch, a
    fixed-size cumsum -- no ``torch.nonzero``, which would synchronize
    the host every step);
  * **delivery** (``csrc/event_delivery.cu: deliver_columns_kernel``):
    one block (or a few splits) per target column accumulates that
    column's ring window in shared memory, walking the tier's **run
    descriptor** (``build_column_runs``): for each (source group ->
    target column, delay) pair and each row of the group, where the
    row's entries for that column start and how many there are.  The
    descriptor is static: it is built once per tier with torch ops on
    the tables' device and kept with the tables
    (``SynapseTables.column_runs``).

Bound: memory traffic, 6 B of table entries per synaptic event with
int32 ids (4 B with int16), plus the ring.  The adds land in no fixed
order, which is exact only for bfloat16 weights (every ring value a
multiple of 2^-9 far below 2^15): the kernels refuse float32 weights,
which take the fixed-order kernel of ``kernels/plastic_step.py``.
Tiers are one launch each.  Drop semantics match the reference exactly:
only the first ``active_cap`` spiking rows, in ascending order, are
delivered, and ``n_dropped = max(n_spikes - active_cap, 0)``.

The legacy ``synaptic_accum(idx, ...)`` entry, whose rows may come in
any order and repeat, keeps the warp-per-row kernel
(``deliver_rows_kernel``, one float atomic per event into the ring).

The ring is updated in place (the JAX reference returns a new one).
Wrappers launch a kernel for CUDA tensors and take the plain version
(``ref.deliver_rows_ref``: gather plus ``index_add_``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Sequence, Tuple

import torch

from . import _build
from .ref import (compact_events, deliver_rows_ref, delivered_bits,
                  synaptic_accum_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int

_TGT_BYTES = {torch.int16: 2, torch.int32: 4}
_W_BYTES = {torch.bfloat16: 2, torch.float32: 4}
# weights the atomic kernel may add in any order and still be exact
_ORDER_FREE_W = (torch.bfloat16,)
COLUMN_WARPS = 16       # warps of a column-kernel block (kColWarps)
# shared memory the column kernel declares statically (kColStaticSmem):
# what is left of a block's for the ring window
COLUMN_STATIC_SMEM = 4608


def _launcher(entry: str = "deliver_rows_launch"):
    lib = _build.library("event_delivery")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = (
            [_P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P]
            if entry == "deliver_rows_launch" else
            [_P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
             _I, ctypes.c_float, _P, _I, _I, _I, _P, _P])
        fn.restype = _I
    return fn


# ---------------------------------------------------------------------------
# The run descriptor
# ---------------------------------------------------------------------------

def column_width(n_per_col: int, d_ring: int) -> int:
    """Target-column width of the column kernel: ``n_per_col`` when its
    ring window (``d_ring x width`` float32) fits the shared memory a
    block has beside the kernel's static arrays, else the widest
    multiple of 4 that fits."""
    fit = _window_bytes() // (4 * d_ring)
    return n_per_col if n_per_col <= fit else fit - fit % 4


def _window_bytes() -> int:
    """The dynamic shared memory a column-kernel block may hold."""
    return _build.SMEM_BYTES - COLUMN_STATIC_SMEM


def _window_scale(w: torch.Tensor, tgt: torch.Tensor, n_local: int):
    """2^s, the least such that every weight times 2^s is a whole number
    (a bf16 weight ``m * 2^(e - 8)`` (frexp) needs ``s >= 8 - e``), or
    0.0 where s falls outside -100..30 (weights on no common grid: the
    float32 window).  With it the column kernel accumulates whole
    numbers in an int32 window (native shared-memory atomics) that
    convert back to float32 exactly.  Raises where a target's summed
    |weight| times 2^s reaches 2^24: the int32 window would lose bits,
    and so would float32 sums taken in no fixed order."""
    wa = w.to(torch.float32).abs()
    nz = wa > 0
    if not bool(nz.any()):
        return 1.0
    s = int((8 - torch.frexp(wa[nz]).exponent).max())
    if not -100 <= s <= 30:
        return 0.0
    # repro-lint: ignore[dtype-bounds] a host-side bound, not stored
    per_target = torch.zeros(n_local, dtype=torch.float64, device=w.device)
    per_target.index_add_(0, tgt.long(), wa.double())
    top = float(per_target.max())
    if top * 2.0 ** s >= 2 ** 24:
        raise ValueError(
            f"a target's summed |weight| {top} times 2^{s} reaches 2^24: "
            "the column kernel's window (and float32 sums in no fixed "
            "order) would not be exact")
    return 2.0 ** s


def _stamp(tensors) -> list:
    """Weak references to ``tensors`` and their version counters."""
    return [(weakref.ref(x), x._version) for x in tensors]


def _stamped(stamp: list, tensors) -> bool:
    """Whether ``tensors`` are the very tensors of ``stamp``, unedited."""
    for (ref, version), x in zip(stamp, tensors):
        if ref() is not x or x._version != version:
            return False
    return True


def bind_column_weights(runs: dict, tier: dict) -> dict:
    """Make the run descriptor ``runs`` deliver ``tier["w"]``, in place.

    The descriptor's structure (``pair_ptr``, ``pair_src``,
    ``pair_dslot``, ``runs``, ``tgt``, ``perm``) depends only on the
    tier's tgt, dslot and nnz.  Its weight-dependent fields -- ``w``
    (the tier's weights, or their row-sorted copy ``gather(w, 1, perm)``)
    and ``scale`` (``_window_scale``) -- are bound to the weight tensor
    they came from and its version counter: a replaced or in-place
    edited ``w`` refreshes them with torch ops on its device, and
    weights past the window limit raise as the build does.  Free when
    nothing changed.  Returns ``runs``."""
    w = tier["w"]
    if _stamped(runs["w_of"], (w,)):
        return runs
    tgt, perm = runs["tgt"], runs["perm"]
    if w.shape != tgt.shape or w.device != tgt.device:
        raise ValueError(f"weights {tuple(w.shape)} on {w.device} do not "
                         f"fit the descriptor's {tuple(tgt.shape)} entries "
                         f"on {tgt.device}")
    wr = w if perm is None else torch.gather(w, 1, perm.long())
    n_rows, cap = tgt.shape[0] - 1, tgt.shape[1]
    # a row-sorted copy keeps each row's valid entries first
    valid = (torch.arange(cap, device=w.device)[None, :]
             < tier["nnz"][:n_rows, None])
    scale = _window_scale(wr[:n_rows][valid], tgt[:n_rows][valid],
                          runs["n_local"])
    runs.update(w=wr, scale=scale, w_of=_stamp((w,)))
    return runs


def build_column_runs(tier: dict, row_group: int, col_width: int,
                      n_local: int) -> dict:
    """The run descriptor of one tier, built with torch ops on the
    tier's device.

    Rows are taken in groups of ``row_group`` (a source column: the
    local tier's ``n_per_col`` rows, a halo band's ``n_exc_per_col``),
    targets in columns of ``col_width``.  For every (source group S,
    target column T, delay d) that holds an entry -- a *pair* -- and
    every row r of S, ``runs[pair, r % row_group]`` (int64) packs the
    start and length of r's entries for (T, d) as ``start << 32 | len``
    (0 when r has none; ``ref.run_fields`` unpacks it).  Pairs are sorted by T (``pair_ptr``: T's pairs are
    ``pair_ptr[T]:pair_ptr[T + 1]``), then S, then d.

    That needs each row's entries for one (T, d) to be one contiguous
    run, which ``build_tables`` gives (one block of draws per stencil
    offset).  Tables that break it (made by hand, or a ``col_width``
    that cuts columns) get a copy of their entries with each row stably
    sorted by (T, d): ``perm`` (None otherwise) maps the copy's
    positions to the tier's.  Returns a dict of tensors plus the ints
    ``row_group``, ``col_width``, ``n_tcols``, ``max_pairs`` (the most
    pairs of one column), ``nbytes`` (what the descriptor adds) and
    ``scale`` (``_window_scale``: the kernel's int32 window, or 0.0 for
    a float32 one)."""
    tgt, w, dslot, nnz = tier["tgt"], tier["w"], tier["dslot"], tier["nnz"]
    dev = tgt.device
    n_rows, cap = tgt.shape[0] - 1, tgt.shape[1]
    n_tcols = -(-n_local // col_width)
    n_groups = max(-(-n_rows // row_group), 1)
    k = torch.arange(cap, device=dev)
    valid = k[None, :] < nnz[:n_rows, None]
    # run key (T, d); invalid slots sort after every key
    key = (torch.div(tgt[:n_rows].to(torch.int32), col_width,
                     rounding_mode="floor") * 256
           + (dslot[:n_rows].to(torch.int32) & 255))
    key = torch.where(valid, key, torch.full_like(key, n_tcols * 256))

    def run_starts(kk):
        new = torch.ones_like(valid)
        new[:, 1:] = kk[:, 1:] != kk[:, :-1]
        return valid & new

    starts = run_starts(key)
    skey, order = torch.sort(key, dim=1, stable=True)
    perm = None
    if int(starts.sum()) != int(run_starts(skey).sum()):
        # some (row, T, d) is split: deliver from a row-sorted copy
        key, starts = skey, run_starts(skey)
        sink = torch.arange(cap, device=dev)[None, :]
        perm = torch.cat([order, sink]).to(torch.int32)
        tgt = torch.gather(tgt, 1, perm.long())
        w = torch.gather(w, 1, perm.long())
    rr, kk = starts.nonzero(as_tuple=True)
    same_row = torch.zeros_like(rr, dtype=torch.bool)
    same_row[:-1] = rr[1:] == rr[:-1]
    nxt = torch.zeros_like(kk)
    nxt[:-1] = kk[1:]
    length = torch.where(same_row, nxt, nnz[rr].long()) - kk
    rkey = key[rr, kk].long()
    tcol, dbyte = rkey // 256, rkey % 256
    group = rr // row_group
    pkey = (tcol * n_groups + group) * 256 + dbyte
    upair, pid = torch.unique(pkey, return_inverse=True)
    n_pairs = upair.numel()
    p_tcol = upair // (n_groups * 256)
    p_src = (upair // 256) % n_groups
    p_d = upair % 256
    p_d = torch.where(p_d > 127, p_d - 256, p_d)   # dslot is int8
    per_col = torch.bincount(p_tcol, minlength=n_tcols)
    pair_ptr = torch.zeros((n_tcols + 1,), dtype=torch.int32, device=dev)
    pair_ptr[1:] = torch.cumsum(per_col, 0)
    runs = torch.zeros((max(n_pairs, 1), row_group), dtype=torch.int64,
                       device=dev)
    runs[pid, rr % row_group] = (kk << 32) | length
    out = {"pair_ptr": pair_ptr, "pair_src": p_src.to(torch.int32),
           "pair_dslot": p_d.to(torch.int32), "runs": runs,
           "tgt": tgt, "w": w, "perm": perm,
           # a row-sorted copy keeps each row's valid entries first
           "scale": _window_scale(w[:n_rows][valid], tgt[:n_rows][valid],
                                  n_local),
           "of": _stamp((tier["tgt"], dslot, nnz)),
           "w_of": _stamp((tier["w"],))}
    nbytes = sum(out[name].numel() * out[name].element_size()
                 for name in ("pair_ptr", "pair_src", "pair_dslot", "runs"))
    if perm is not None:
        nbytes += sum(x.numel() * x.element_size() for x in (perm, tgt, w))
    return dict(out, row_group=row_group, col_width=col_width,
                n_tcols=n_tcols, n_local=n_local,
                max_pairs=int(per_col.max()) if n_tcols else 0,
                nbytes=nbytes)


# ---------------------------------------------------------------------------
# The delivery kernel
# ---------------------------------------------------------------------------

def _check_tier(tables: dict, ring: torch.Tensor):
    """Validate one tier's tables (``nnz`` optional) against the ring."""
    tgt, w, dslot = tables["tgt"], tables["w"], tables["dslot"]
    nnz = tables.get("nnz")
    rows1, cap = tgt.shape
    arrays = [x for x in (tgt, w, dslot, nnz) if x is not None]
    ok = (tgt.dtype in _TGT_BYTES and w.dtype in _W_BYTES
          and dslot.dtype == torch.int8
          and w.shape == dslot.shape == (rows1, cap)
          and (nnz is None or (nnz.dtype == torch.int32
                               and nnz.shape == (rows1,)))
          and ring.dtype == torch.float32 and ring.dim() == 2
          and ring.is_contiguous()
          and all(x.is_contiguous() and x.device == ring.device
                  for x in arrays))
    if not ok:
        raise ValueError(
            "delivery takes contiguous tables on the ring's device: tgt "
            "int16/int32, w bfloat16/float32, dslot int8 (rows+1, cap), nnz "
            "int32 (rows+1,), and a float32 (d_ring, n_local) ring; got "
            + ", ".join(f"{k} {v.dtype} {tuple(v.shape)} on {v.device}"
                        for k, v in tables.items())
            + f", ring {ring.dtype} {tuple(ring.shape)}")


_SM_COUNT: dict = {}


def _sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNT[dev]


def deliver_columns_cuda(tables: dict, runs: dict, bits: torch.Tensor,
                         ring: torch.Tensor, t_slot: int,
                         events) -> torch.Tensor:
    """Launch the column kernel for one tier: the rows set in ``bits``
    (int32, ``ref.delivered_bits``) through the tier's run descriptor
    ``runs`` (``build_column_runs`` of these tables' tgt, dslot and nnz,
    bound to their weights first: ``bind_column_weights``).  ``events``:
    int32 (1,) counter (or None)."""
    _check_tier(tables, ring)
    w = tables["w"]
    if w.dtype not in _ORDER_FREE_W:
        raise ValueError(
            f"the column delivery kernel adds in no fixed order, which is "
            f"exact only for bfloat16 weights; {w.dtype} weights take the "
            "fixed-order kernel (kernels.plastic_step)")
    d_ring, n_local = ring.shape
    n_rows, cap = tables["tgt"].shape[0] - 1, tables["tgt"].shape[1]
    width = runs["col_width"]
    if 4 * d_ring * width > _window_bytes():
        raise ValueError(
            f"the ring window d_ring x col_width = {d_ring} x {width} "
            f"words exceeds the {_window_bytes()} B of shared memory a "
            f"block has beside the kernel's {COLUMN_STATIC_SMEM} B of "
            "static arrays")
    if (not _stamped(runs["of"], (tables["tgt"], tables["dslot"],
                                  tables["nnz"]))
            or runs["n_local"] != n_local):
        raise ValueError("the run descriptor was built for other (or since "
                         "edited) tables or another ring width")
    if (ring.device.type != "cuda" or bits.device != ring.device
            or bits.dtype != torch.int32
            or bits.shape != ((n_rows + 32) // 32,)):
        raise ValueError("deliver_columns_cuda takes a CUDA ring and an "
                         "int32 bitmap of ceil((rows + 1) / 32) words on "
                         "its device")
    if events is not None and (events.dtype != torch.int32
                               or events.device != ring.device):
        raise ValueError("events must be an int32 counter on the ring's "
                         "device")
    bind_column_weights(runs, tables)
    tgt = runs["tgt"]
    n_tcols = runs["n_tcols"]
    # enough blocks for a few waves, so that hot columns even out, and
    # at least a round of items (one per warp) for each
    items = runs["max_pairs"] * -(-runs["row_group"] // 32)
    splits = max(1, min(-(-16 * _sm_count(ring.device) // n_tcols),
                        -(-items // COLUMN_WARPS)))
    err = _launcher("deliver_columns_launch")(
        bits.data_ptr(), n_rows, tables["nnz"].data_ptr(), tgt.data_ptr(),
        _TGT_BYTES[tgt.dtype], runs["w"].data_ptr(), _W_BYTES[w.dtype], cap,
        runs["pair_ptr"].data_ptr(), runs["pair_src"].data_ptr(),
        runs["pair_dslot"].data_ptr(), runs["runs"].data_ptr(),
        runs["row_group"], width, n_tcols, splits, runs["scale"],
        ring.data_ptr(),
        n_local, d_ring, int(t_slot),
        events.data_ptr() if events is not None else None,
        _build.stream_ptr(ring))
    _build.check(err, "event_delivery")
    _build.count_launch("event_delivery")
    return ring


def deliver_rows_cuda(tables: dict, idx: torch.Tensor, ring: torch.Tensor,
                      t_slot: int, events) -> torch.Tensor:
    """Launch the delivery kernel over the compacted rows ``idx`` (int32)
    of one tier.  ``events``: int32 (1,) counter (or None); ``tables`` may
    omit ``nnz`` (every row is then read to its capacity)."""
    _check_tier(tables, ring)
    if tables["w"].dtype not in _ORDER_FREE_W:
        raise ValueError(
            f"the atomic delivery kernel adds in no fixed order, which is "
            f"exact only for bfloat16 weights; {tables['w'].dtype} weights "
            "take the fixed-order kernel (kernels.plastic_step)")
    nnz = tables.get("nnz")
    if ring.device.type != "cuda" or idx.device != ring.device \
            or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("deliver_rows_cuda takes a CUDA ring and a "
                         "contiguous int32 idx on its device")
    if events is not None and (events.dtype != torch.int32
                               or events.device != ring.device):
        raise ValueError("events must be an int32 counter on the ring's "
                         "device")
    tgt = tables["tgt"]
    d_ring, n_local = ring.shape
    err = _launcher()(
        idx.data_ptr(), idx.shape[0], tgt.data_ptr(), _TGT_BYTES[tgt.dtype],
        tables["w"].data_ptr(), _W_BYTES[tables["w"].dtype],
        tables["dslot"].data_ptr(),
        nnz.data_ptr() if nnz is not None else None, tgt.shape[1],
        tgt.shape[0] - 1, ring.data_ptr(), n_local, d_ring, int(t_slot),
        events.data_ptr() if events is not None else None,
        _build.stream_ptr(ring))
    _build.check(err, "event_delivery_rows")
    _build.count_launch("event_delivery_rows")
    return ring


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def event_delivery_banded(tiers: Sequence[Tuple[dict, torch.Tensor, int]],
                          i_ring: torch.Tensor, t_slot: int, d_ring: int, *,
                          plan=None, runs=None, tier_bits=None):
    """Multi-tier delivery: the local table plus every halo fan-out band.

    ``tiers``: sequence of (tables, spikes_src, active_cap).  ``plan``:
    optional per-tier ``TierPlan`` sequence from
    ``SynapseTableSpec.delivery_plan()`` the tables are validated
    against.  ``runs``: the tiers' run descriptors
    (``core.synapses.column_runs``), which a CUDA ring needs (the CPU's
    plain version delivers without them).  ``tier_bits``: per tier, its
    (bitmap, spike count) as ``neuron_step`` writes them for the local
    tier and ``delivered_bits`` for the halo bands, or None; a CUDA ring
    takes a given pair in place of ``delivered_bits`` (the CPU's plain
    version compacts the spikes itself).  Returns (ring, n_events
    int32, n_dropped) summed over tiers; the ring is updated in place.
    """
    if i_ring.shape[0] != d_ring:
        raise ValueError(f"ring has {i_ring.shape[0]} slots, d_ring is "
                         f"{d_ring}")
    if plan is not None and len(plan) != len(tiers):
        raise ValueError(f"delivery plan has {len(plan)} tiers, "
                         f"got {len(tiers)}")
    cuda = _build.on_cuda(i_ring)
    if cuda and runs is None:
        raise ValueError("the column delivery kernel needs the tiers' run "
                         "descriptors (core.synapses.column_runs)")
    if runs is not None and len(runs) != len(tiers):
        raise ValueError(f"{len(runs)} run descriptors for {len(tiers)} "
                         "tiers")
    events = torch.zeros((1,), dtype=torch.int32, device=i_ring.device)
    counts = []
    for ti, (tables, spikes_src, active_cap) in enumerate(tiers):
        n_rows, cap = tables["tgt"].shape[0] - 1, tables["tgt"].shape[1]
        if plan is not None:
            p = plan[ti]
            if (p.rows, p.cap, p.active_cap) != (n_rows, cap, active_cap):
                raise ValueError(
                    f"tier {ti} does not match its delivery plan: tables "
                    f"are rows={n_rows} cap={cap} active_cap={active_cap}, "
                    f"plan says rows={p.rows} cap={p.cap} "
                    f"active_cap={p.active_cap}")
        if cuda:
            given = tier_bits[ti] if tier_bits is not None else None
            bits, n_spk = (given if given is not None
                           else delivered_bits(spikes_src, n_rows,
                                               active_cap))
            deliver_columns_cuda(tables, runs[ti], bits, i_ring, t_slot,
                                 events)
        else:
            _check_tier(tables, i_ring)
            idx, n_spk = compact_events(spikes_src, n_rows, active_cap)
            deliver_rows_ref(tables, idx, i_ring, t_slot, events)
        counts.append(n_spk.to(torch.int32))
    # the drops of every tier in four launches, not three a tier
    caps = _caps(tuple(c for _, _, c in tiers), i_ring.device)
    n_dropped = torch.clamp(torch.stack(counts) - caps, min=0).sum(
        dtype=torch.int64)
    return i_ring, events[0], n_dropped


_CAPS: dict = {}


def _caps(caps: tuple, dev: torch.device) -> torch.Tensor:
    """The tiers' ``active_cap``s as an int32 tensor on ``dev``, made
    once (a captured step reads it at a fixed address)."""
    key = (caps, dev)
    if key not in _CAPS:
        _CAPS[key] = torch.tensor(caps, dtype=torch.int32, device=dev)
    return _CAPS[key]


def event_delivery(tables: dict, spikes_src, i_ring, t_slot: int,
                   d_ring: int, active_cap: int, runs=None):
    """Single-tier delivery.  Drop-in for ``core.synapses.deliver_events``
    on the CPU; a CUDA ring needs the tier's run descriptor ``runs``.
    Returns (ring, n_events, n_dropped)."""
    return event_delivery_banded([(tables, spikes_src, active_cap)],
                                 i_ring, t_slot, d_ring,
                                 runs=None if runs is None else [runs])


def synaptic_accum(idx, t_slot: int, tgt, w, dslot, ring):
    """Deliver the pre-compacted event rows ``idx`` (A,) through the
    tables into ``ring`` (in place; returned).  Every listed row is read
    to its capacity (no ``nnz``); rows equal to the sink row
    ``tgt.shape[0]-1`` are skipped.  Equivalent to
    ``ref.synaptic_accum_ref``."""
    idx = idx.to(torch.int32).contiguous()
    tables = {"tgt": tgt, "w": w, "dslot": dslot}
    if _build.on_cuda(ring):
        return deliver_rows_cuda(tables, idx, ring, t_slot, None)
    _check_tier(tables, ring)
    return synaptic_accum_ref(idx, t_slot, tgt, w, dslot, ring)
