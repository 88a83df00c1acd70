"""2-D halo exchange of spike blocks between the tiles of a slab.

The port of ``repro.core.halo``.  Each tile owns a ``tile_h x tile_w``
block of columns and must import the spikes of every column within the
stencil radius R around it.  The reference runs one tile per TPU shard
and moves the strips with ``ppermute``; here every tile of a tiling
lives on one device, stacked on two leading *tile* axes ``(TY, TX,
...)``, and a shift along a tile axis is an index shift of the stacked
tensor.  Destinations with no source tile are zero-filled, exactly as
``ppermute`` leaves the shards that receive no message (the slab is
flat, not periodic).

Two modes, as in the reference:

* ``strip`` (default): each hop moves only the rows/cols the halo
  needs, ``min(tile, R - (k-1)*tile)`` wide;
* ``block``: each hop moves whole neighbour tiles and the region window
  is sliced afterwards.

Both give the same region.  Payload layout per tile: ``(tile_h, tile_w,
F)`` with F the per-column feature width (``n_exc`` spike lanes, or
their bit-packed bytes, ``pack_bits``).  ``halo_import_bytes`` is the
per-tile import volume a tile-per-device layout moves.
"""

from __future__ import annotations

import math

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


def _halo_strips(x: torch.Tensor, radius: int, tile: int, dim: int,
                 axis: int, before: bool) -> list:
    """Strips assembling the halo on one side of ``dim``.

    ``before=True``: the halo rows/cols that precede the tile (imported
    from tiles with a smaller index along ``axis``), in region order."""
    hops = int(math.ceil(radius / tile))
    parts = []
    for k in range(hops, 0, -1) if before else range(1, hops + 1):
        take = min(tile, radius - (k - 1) * tile)
        if before:
            # neighbour i-k contributes its *last* ``take`` rows
            parts.append(shift(x.narrow(dim, tile - take, take), axis, k))
        else:
            # neighbour i+k contributes its *first* ``take`` rows
            parts.append(shift(x.narrow(dim, 0, take), axis, -k))
    return parts


def exchange_halo_2d(x: torch.Tensor, *, radius: int,
                     mode: str = "strip") -> torch.Tensor:
    """Assemble every tile's dilated region block.

    Args:
      x: stacked ``(TY, TX, tile_h, tile_w, ...)`` tiles.
      radius: stencil radius R in columns.
      mode: "strip" (exact strips) or "block" (whole-tile hops).

    Returns:
      ``(TY, TX, tile_h + 2R, tile_w + 2R, ...)`` region blocks;
      out-of-slab halo cells are zero.
    """
    if radius == 0:
        return x
    tile_h, tile_w = x.shape[2], x.shape[3]
    if mode == "strip":
        top = _halo_strips(x, radius, tile_h, 2, 0, before=True)
        bot = _halo_strips(x, radius, tile_h, 2, 0, before=False)
        xy = torch.cat(top + [x] + bot, dim=2)
        left = _halo_strips(xy, radius, tile_w, 3, 1, before=True)
        right = _halo_strips(xy, radius, tile_w, 3, 1, before=False)
        return torch.cat(left + [xy] + right, dim=3)
    if mode == "block":
        hy = int(math.ceil(radius / tile_h))
        hx = int(math.ceil(radius / tile_w))
        xy = torch.cat([shift(x, 0, k) for k in range(hy, -hy - 1, -1)],
                       dim=2)
        xy = xy.narrow(2, hy * tile_h - radius, tile_h + 2 * radius)
        xx = torch.cat([shift(xy, 1, k) for k in range(hx, -hx - 1, -1)],
                       dim=3)
        return xx.narrow(3, hx * tile_w - radius, tile_w + 2 * radius)
    raise ValueError(f"unknown halo mode {mode!r}")


# ---------------------------------------------------------------------------
# Spike payload bit-packing: 1 bit per neuron on a wire, in place of 4
# bytes.  One card has no wire; the regions are the same either way.
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
                      payload_bytes_per_col: int, mode: str = "strip") -> int:
    """Analytic per-tile import volume of a tile-per-device layout."""
    rh, rw = tile_h + 2 * radius, tile_w + 2 * radius
    if mode == "strip":
        halo_cols = rh * rw - tile_h * tile_w
        return halo_cols * payload_bytes_per_col
    hy = int(math.ceil(radius / tile_h))
    hx = int(math.ceil(radius / tile_w))
    y_cols = 2 * hy * tile_h * tile_w
    x_cols = 2 * hx * tile_w * (tile_h + 2 * radius)
    return (y_cols + x_cols) * payload_bytes_per_col
