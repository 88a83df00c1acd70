"""2-D halo exchange of spike blocks between the tiles of a slab.

The port of ``repro.core.halo``.  Each tile owns a ``tile_h x tile_w``
block of columns and must import the spikes of every column within the
stencil radius R around it.  The reference runs one tile per TPU shard
and moves the strips with ``ppermute``.  The port has two forms of the
same exchange:

* *stacked*: every tile of a tiling on one device, on two leading tile
  axes ``(TY, TX, ...)``; a shift along a tile axis is an index shift
  of the stacked tensor;
* *ranks* (``mesh=``): one tile per process, DPSNN's layout.  A shift
  is point-to-point sends along a mesh axis (``shift_ranks``, one
  ``batch_isend_irecv`` for every strip of a phase, one tag for each
  dim, hop and direction), through a ``Transport``.

Destinations with no source tile are zero-filled, exactly as
``ppermute`` leaves the shards that receive no message (the slab is
flat, not periodic).  The exchange runs y first, then x over the
y-extended block, so a corner arrives in two hops; a radius past the
tile takes several hops.

Two modes, as in the reference:

* ``strip`` (default): each hop moves only the rows/cols the halo
  needs, ``min(tile, R - (k-1)*tile)`` wide;
* ``block``: each hop moves whole neighbour tiles and the region window
  is sliced afterwards.

Both give the same region.  Payload layout per tile: ``(tile_h, tile_w,
F)`` with F the per-column feature width (``n_exc`` spike lanes, or
their bit-packed bytes, ``pack_bits``).  ``halo_import_bytes`` is the
per-tile import volume of one tile per process; a ``Transport`` counts
the bytes it really moves.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch


def shift(x: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Bring data from the tile ``k`` positions *before* along tile axis
    ``axis`` (0: TY, 1: TX) of a stacked ``(TY, TX, ...)`` tensor.

    After ``shift(x, axis, k)`` tile ``i`` holds what tile ``i - k`` had
    (zeros when ``i - k`` is outside the axis: a flat, non-periodic
    slab).  Returns a new tensor."""
    if k == 0:
        return x
    n = x.shape[axis]
    out = torch.zeros_like(x)
    m = n - abs(k)
    if m > 0:
        if k > 0:
            out.narrow(axis, k, m).copy_(x.narrow(axis, 0, m))
        else:
            out.narrow(axis, 0, m).copy_(x.narrow(axis, -k, m))
    return out


# ---------------------------------------------------------------------------
# Moving strips between ranks
# ---------------------------------------------------------------------------

class TransportError(RuntimeError):
    """A tensor that the transport cannot carry."""


class SharedCardError(RuntimeError):
    """Two ranks of an ``"nccl"`` group report the same card."""


def card_uuid(device) -> str:
    """The UUID of the CUDA card ``device`` names."""
    return str(torch.cuda.get_device_properties(torch.device(device)).uuid)


def check_distinct_cards(store, rank: int, world_size: int,
                         uuid: str) -> None:
    """Publish this rank's card ``uuid`` in the ``torch.distributed``
    store, read every rank's, and raise ``SharedCardError`` when another
    rank reports the same card (NCCL cannot run two ranks on one card).
    Every rank calls it before any communication; it waits for the
    others' keys."""
    store.set(f"card/{rank}", uuid)
    cards = [store.get(f"card/{r}").decode() for r in range(world_size)]
    same = [r for r in range(world_size) if r != rank and cards[r] == uuid]
    if same:
        raise SharedCardError(
            f"rank {rank} shares card {uuid} with rank(s) {same}: the "
            "'nccl' transport needs one card a rank (use 'gloo', which "
            "stages CUDA strips through host memory)")


class Transport:
    """How strips move between ranks: ``kind`` ``"gloo"`` or ``"nccl"``,
    for a run whose tensors live on ``device``.

    * ``"gloo"``: CPU tensors as they are; CUDA tensors through pinned
      host buffers, allocated once per shape and tag for the transport's
      life (one sim function's run);
    * ``"nccl"``: CUDA tensors, one card a rank (``check_distinct_cards``).

    A tensor on another device type than ``device`` raises
    ``TransportError``, as does a CPU tensor under ``"nccl"``: nothing
    is moved by another way.  ``bytes_sent`` / ``bytes_received`` count
    the payload bytes this rank put on and took off the wire;
    ``seconds`` the host time of the moves (staging and the wire, after
    the device finished the work queued before them).

    Besides the point-to-point ``move``, it runs the collectives of a
    process group (``all_reduce``, ``all_gather``) for
    ``parallel.collectives``: each is one synchronising call, staged
    like a move under ``"gloo"``.  An all-reduce counts its tensor's
    bytes sent and received; an all-gather its own block sent and the
    others' received."""

    def __init__(self, kind: str, device):
        if kind not in ("gloo", "nccl"):
            raise ValueError(f"transport {kind!r}: expected 'gloo' or "
                             "'nccl'")
        self.kind = kind
        self.device = torch.device(device)
        if kind == "nccl" and self.device.type != "cuda":
            raise TransportError("the 'nccl' transport carries CUDA "
                                 f"tensors; this run is on {self.device}")
        self.staged = kind == "gloo" and self.device.type == "cuda"
        self._host: dict = {}
        self._landed = None       # the event after the last uploads
        self.bytes_sent = self.bytes_received = 0
        self.seconds = 0.0

    def check(self, x) -> None:
        """Raise ``TransportError`` unless this transport carries ``x``."""
        dev = x.device
        if dev.type != self.device.type:
            raise TransportError(
                f"a {dev.type} tensor under the {self.kind!r} transport of "
                f"a {self.device.type} run")
        if self.kind == "nccl" and dev.type != "cuda":
            raise TransportError("the 'nccl' transport carries CUDA "
                                 f"tensors, not {dev.type} ones")

    def _pinned(self, key, shape, dtype) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def _begin(self) -> float:
        """Wait for the device work queued before a move (and the last
        move's uploads, whose pinned buffers it may reuse); the host
        clock after."""
        dev = self.device
        if dev.type == "cuda":
            if self._landed is not None:
                self._landed.synchronize()
            torch.cuda.current_stream(dev).synchronize()
        return time.perf_counter()

    def _stage_out(self, items) -> list:
        """``(tensor, key)`` pairs as the tensors that go on the wire:
        pinned host copies under staging, else contiguous tensors."""
        if not self.staged:
            return [x.contiguous() for x, _ in items]
        wire = []
        for x, key in items:
            buf = self._pinned(("send",) + key, x.shape, x.dtype)
            buf.copy_(x, non_blocking=True)
            wire.append(buf)
        torch.cuda.current_stream(self.device).synchronize()
        return wire

    def _into(self, key, shape, dtype) -> torch.Tensor:
        if self.staged:
            return self._pinned(("recv",) + key, shape, dtype)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _land(self, into: list, t0: float) -> list:
        """The received tensors on the device (uploaded under staging,
        the upload's event kept for the next move), and the clock."""
        if self.staged:
            into = [b.to(self.device, non_blocking=True) for b in into]
            self._landed = torch.cuda.Event()
            self._landed.record(torch.cuda.current_stream(self.device))
        self.seconds += time.perf_counter() - t0
        return into

    def move(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[tuple, torch.dtype, int, int]]
             ) -> List[torch.Tensor]:
        """Send each ``(tensor, dst rank, tag)`` and receive each
        ``(shape, dtype, src rank, tag)``, all in one
        ``batch_isend_irecv``; returns the received tensors on
        ``device``, in ``recvs``' order."""
        import torch.distributed as dist
        for x, _, _ in sends:
            self.check(x)
        t0 = self._begin()
        wire = self._stage_out([(x, (dst, tag)) for x, dst, tag in sends])
        into = [self._into((src, tag), shape, dtype)
                for shape, dtype, src, tag in recvs]
        ops = [dist.P2POp(dist.isend, w, dst, tag=tag)
               for w, (_, dst, tag) in zip(wire, sends)]
        ops += [dist.P2POp(dist.irecv, b, src, tag=tag)
                for b, (_, _, src, tag) in zip(into, recvs)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self.bytes_sent += sum(w.numel() * w.element_size() for w in wire)
        self.bytes_received += sum(b.numel() * b.element_size()
                                   for b in into)
        return self._land(into, t0)

    def all_reduce(self, x: torch.Tensor, group, op: str = "sum"
                   ) -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the ranks of
        ``group``, as a new tensor on ``device``; every rank of the
        group gets the same bits."""
        import torch.distributed as dist
        self.check(x)
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        t0 = self._begin()
        if self.staged:
            buf = self._stage_out([(x, ("ar", tuple(x.shape), x.dtype))])[0]
        else:
            buf = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=ops[op], group=group)
        n = buf.numel() * buf.element_size()
        self.bytes_sent += n
        self.bytes_received += n
        return self._land([buf], t0)[0]

    def all_gather(self, x: torch.Tensor, group, n: int
                   ) -> List[torch.Tensor]:
        """Every rank's ``x`` (all of one shape and dtype) in the group's
        rank order, on ``device``."""
        import torch.distributed as dist
        self.check(x)
        t0 = self._begin()
        key = ("ag", tuple(x.shape), x.dtype)
        wire = self._stage_out([(x, key)])[0]
        into = [self._into(key + (i,), tuple(x.shape), x.dtype)
                for i in range(n)]
        dist.all_gather(into, wire, group=group)
        size = wire.numel() * wire.element_size()
        self.bytes_sent += size
        self.bytes_received += (n - 1) * size
        return self._land(into, t0)


def _tag(channel: int, dim: int, k: int) -> int:
    """One tag for each payload channel, dim, hop and direction."""
    return (channel * 4 + dim) * 256 + 128 + k


def shift_ranks(pairs: Sequence[Tuple[torch.Tensor, int]], mesh, axis,
                transport: Transport, dim: int = 0,
                channel: int = 0) -> List[torch.Tensor]:
    """``shift`` between ranks, for several strips at once: for each
    ``(strip, k)`` this rank sends its strip to the rank ``k`` places on
    along mesh axis ``axis`` (a name, or a tuple of names folded into
    one axis) and receives, in its place, the strip of the rank ``k``
    places before; zeros where that rank is off the slab.  ``k == 0``
    returns the strip itself.  Every strip of the call goes in one
    ``transport.move``."""
    sends, recvs, slots = [], [], []
    out: List[Optional[torch.Tensor]] = []
    for x, k in pairs:
        if k == 0:
            out.append(x)
            continue
        tag = _tag(channel, dim, k)
        dst, src = mesh.neighbour(axis, k), mesh.neighbour(axis, -k)
        if dst is not None:
            sends.append((x, dst, tag))
        if src is not None:
            recvs.append((tuple(x.shape), x.dtype, src, tag))
            slots.append(len(out))
            out.append(None)
        else:
            out.append(torch.zeros_like(x))
    for i, got in zip(slots, transport.move(sends, recvs)):
        out[i] = got
    return out


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------

Move = Callable[[int, list], list]


def _strips(x: torch.Tensor, radius: int, tile: int, dim: int, which: int,
            move: Move) -> list:
    """The halo strips on both sides of ``dim`` and the block itself, in
    region order: neighbour i-k's *last* ``take`` rows for k = hops..1,
    the block, neighbour i+k's *first* ``take`` rows for k = 1..hops
    (``take = min(tile, R - (k-1)*tile)``), moved along tile axis
    ``which`` (0: y, 1: x)."""
    hops = int(math.ceil(radius / tile))
    pairs = []
    for k in range(hops, 0, -1):
        take = min(tile, radius - (k - 1) * tile)
        pairs.append((x.narrow(dim, tile - take, take), k))
    pairs.append((x, 0))
    for k in range(1, hops + 1):
        take = min(tile, radius - (k - 1) * tile)
        pairs.append((x.narrow(dim, 0, take), -k))
    return move(which, pairs)


def _region(x: torch.Tensor, radius: int, mode: str, dy: int, dx: int,
            move: Move) -> torch.Tensor:
    tile_h, tile_w = x.shape[dy], x.shape[dx]
    if mode == "strip":
        xy = torch.cat(_strips(x, radius, tile_h, dy, 0, move), dim=dy)
        return torch.cat(_strips(xy, radius, tile_w, dx, 1, move), dim=dx)
    if mode == "block":
        hy = int(math.ceil(radius / tile_h))
        hx = int(math.ceil(radius / tile_w))
        xy = torch.cat(move(0, [(x, k) for k in range(hy, -hy - 1, -1)]),
                       dim=dy)
        xy = xy.narrow(dy, hy * tile_h - radius, tile_h + 2 * radius)
        xx = torch.cat(move(1, [(xy, k) for k in range(hx, -hx - 1, -1)]),
                       dim=dx)
        return xx.narrow(dx, hx * tile_w - radius, tile_w + 2 * radius)
    raise ValueError(f"unknown halo mode {mode!r}")


def exchange_halo_2d(x: torch.Tensor, *, radius: int, mode: str = "strip",
                     mesh=None, axis_y="data", axis_x="model",
                     transport: Optional[Transport] = None,
                     channel: int = 0) -> torch.Tensor:
    """Assemble the dilated region block of every tile (stacked) or of
    this rank's tile (``mesh``).

    Args:
      x: stacked ``(TY, TX, tile_h, tile_w, ...)`` tiles; with ``mesh``,
        this rank's own ``(tile_h, tile_w, ...)`` block.
      radius: stencil radius R in columns.
      mode: "strip" (exact strips) or "block" (whole-tile hops).
      mesh: a ``launch.mesh.RankMesh``; ``axis_y`` / ``axis_x`` name its
        axes (or tuples of axes, folded pod-major) of the tile rows and
        columns, and ``transport`` moves the strips.  ``channel`` keeps
        the tags of two payloads of one step apart.

    Returns:
      ``(TY, TX, tile_h + 2R, tile_w + 2R, ...)`` region blocks (with
      ``mesh``: ``(tile_h + 2R, tile_w + 2R, ...)``); out-of-slab halo
      cells are zero.
    """
    if radius == 0:
        return x
    if mesh is None:
        def move(which, pairs):
            return [shift(s, which, k) for s, k in pairs]
        return _region(x, radius, mode, 2, 3, move)
    if transport is None:
        raise ValueError("an exchange between ranks needs a transport")
    axes = (axis_y, axis_x)

    def move_ranks(which, pairs):
        return shift_ranks(pairs, mesh, axes[which], transport, dim=which,
                           channel=channel)
    return _region(x, radius, mode, 0, 1, move_ranks)


# ---------------------------------------------------------------------------
# Spike payload bit-packing: 1 bit per neuron on the wire between ranks,
# in place of 4 bytes.  The regions are the same either way.
# ---------------------------------------------------------------------------

def packed_width(n: int) -> int:
    return (n + 7) // 8


_SHIFTS: dict = {}     # per device: 0..7 as uint8


def _shifts(dev: torch.device) -> torch.Tensor:
    if dev not in _SHIFTS:
        _SHIFTS[dev] = torch.arange(8, dtype=torch.uint8, device=dev)
    return _SHIFTS[dev]


def pack_bits(spikes: torch.Tensor) -> torch.Tensor:
    """Pack a trailing axis of {0,1} float/bool spikes into a uint8
    bitmap: (..., F) -> (..., ceil(F/8)); bit j of byte b = lane 8b+j."""
    f = spikes.shape[-1]
    pad = (-f) % 8
    bits = spikes.to(torch.uint8)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (packed_width(f), 8))
    # distinct powers of two: the sum is their bitwise or
    return (bits << _shifts(bits.device)).sum(-1, dtype=torch.int32).to(
        torch.uint8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (..., ceil(n/8)) uint8 -> (..., n) f32."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return flat[..., :n].to(torch.float32)


def halo_import_bytes(tile_h: int, tile_w: int, radius: int,
                      payload_bytes_per_col: int, mode: str = "strip",
                      tiles: Optional[Tuple[int, int]] = None,
                      at: Optional[Tuple[int, int]] = None) -> int:
    """Analytic per-tile import volume of one tile per process: the
    strips ``exchange_halo_2d`` moves into a tile whose every neighbour
    exists.  With ``tiles`` (TY, TX) and ``at`` (y, x), the import of
    that tile of that tiling: no strip comes from off the slab (the x
    strips still carry the y-extended block's zero rows)."""
    ty, tx = tiles if tiles is not None else (None, None)
    y, x = at if at is not None else (0, 0)

    def there(i, n, k):
        return n is None or 0 <= i + k < n

    rh = tile_h + 2 * radius
    cols = 0
    if mode == "strip":
        for k in range(1, int(math.ceil(radius / tile_h)) + 1):
            take = min(tile_h, radius - (k - 1) * tile_h)
            cols += take * tile_w * (there(y, ty, -k) + there(y, ty, k))
        for k in range(1, int(math.ceil(radius / tile_w)) + 1):
            take = min(tile_w, radius - (k - 1) * tile_w)
            cols += take * rh * (there(x, tx, -k) + there(x, tx, k))
    elif mode == "block":
        for k in range(1, int(math.ceil(radius / tile_h)) + 1):
            cols += tile_h * tile_w * (there(y, ty, -k) + there(y, ty, k))
        for k in range(1, int(math.ceil(radius / tile_w)) + 1):
            cols += tile_w * rh * (there(x, tx, -k) + there(x, tx, k))
    else:
        raise ValueError(f"unknown halo mode {mode!r}")
    return cols * payload_bytes_per_col
