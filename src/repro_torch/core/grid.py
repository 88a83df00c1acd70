"""Column grid geometry and spatial domain decomposition.

The cortical slab is a 2D grid of columns (H x W, ``n_per_column`` neurons
each).  For distributed simulation the grid is decomposed into a
``tiles_y x tiles_x`` array of rectangular tiles, one per mesh shard (the
DPSNN process <-> column-set mapping, adapted to a TPU mesh).

Each tile owns ``tile_h x tile_w`` columns and sees a *region* = tile
dilated by the stencil radius R on every side (the halo).  Grids that do
not divide evenly by the tile array are padded with *inactive* columns
(mask-carried; they hold no live neurons).

A verbatim copy of ``repro.core.grid``: the port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .connectivity import NEURONS_PER_COLUMN


@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """The global simulated slab."""

    height: int
    width: int
    n_per_column: int = NEURONS_PER_COLUMN

    @property
    def n_columns(self) -> int:
        return self.height * self.width

    @property
    def n_neurons(self) -> int:
        return self.n_columns * self.n_per_column


@dataclasses.dataclass(frozen=True)
class TileDecomposition:
    """Decomposition of a (possibly padded) grid into tiles + halo regions."""

    grid: ColumnGrid          # the *logical* (unpadded) grid
    tiles_y: int
    tiles_x: int
    radius: int               # stencil radius (halo width), in columns

    # ---- padded geometry -------------------------------------------------
    @property
    def padded_h(self) -> int:
        return self.tiles_y * self.tile_h

    @property
    def padded_w(self) -> int:
        return self.tiles_x * self.tile_w

    @property
    def tile_h(self) -> int:
        return int(math.ceil(self.grid.height / self.tiles_y))

    @property
    def tile_w(self) -> int:
        return int(math.ceil(self.grid.width / self.tiles_x))

    @property
    def tile_cols(self) -> int:
        return self.tile_h * self.tile_w

    @property
    def n_local(self) -> int:
        """Neuron slots owned by one tile (padded columns included)."""
        return self.tile_cols * self.grid.n_per_column

    # ---- halo / region geometry -------------------------------------------
    @property
    def region_h(self) -> int:
        return self.tile_h + 2 * self.radius

    @property
    def region_w(self) -> int:
        return self.tile_w + 2 * self.radius

    @property
    def region_cols(self) -> int:
        return self.region_h * self.region_w

    @property
    def n_region(self) -> int:
        return self.region_cols * self.grid.n_per_column

    @property
    def halo_hops_y(self) -> int:
        """ppermute hops needed along y to assemble the halo."""
        return int(math.ceil(self.radius / self.tile_h))

    @property
    def halo_hops_x(self) -> int:
        return int(math.ceil(self.radius / self.tile_w))

    # ---- indexing helpers --------------------------------------------------
    def tile_origin(self, ty: int, tx: int) -> tuple:
        """Global (y, x) of the tile's top-left column."""
        return ty * self.tile_h, tx * self.tile_w

    def active_mask(self, ty: int, tx: int) -> np.ndarray:
        """(tile_h, tile_w) bool mask of columns that exist in the logical grid."""
        oy, ox = self.tile_origin(ty, tx)
        ys = oy + np.arange(self.tile_h)[:, None]
        xs = ox + np.arange(self.tile_w)[None, :]
        return (ys < self.grid.height) & (xs < self.grid.width)

    def region_active_mask(self, ty: int, tx: int) -> np.ndarray:
        """(region_h, region_w) bool mask of region columns inside the grid."""
        oy, ox = self.tile_origin(ty, tx)
        ys = oy - self.radius + np.arange(self.region_h)[:, None]
        xs = ox - self.radius + np.arange(self.region_w)[None, :]
        return ((ys >= 0) & (ys < self.grid.height)
                & (xs >= 0) & (xs < self.grid.width))

    def region_col_index(self, ry: int, rx: int) -> int:
        """Flatten a region (row, col) to a region column index."""
        return ry * self.region_w + rx

    def local_to_region(self, ly: int, lx: int) -> int:
        """Region column index of a local tile column."""
        return self.region_col_index(ly + self.radius, lx + self.radius)

    def comm_volume_per_step_bytes(self, bytes_per_neuron: int = 1) -> int:
        """Bytes of spike payload a tile must import per step (halo area).

        This is the quantity the paper's connectivity comparison stresses:
        the halo area grows from (tile+2*3)^2 - tile^2 to (tile+2*10)^2 -
        tile^2 when switching Gaussian -> exponential.
        """
        halo_cols = self.region_cols - self.tile_cols
        return halo_cols * self.grid.n_per_column * bytes_per_neuron


def choose_tiling(n_shards_y: int, n_shards_x: int, grid: ColumnGrid,
                  radius: int) -> TileDecomposition:
    return TileDecomposition(grid=grid, tiles_y=n_shards_y, tiles_x=n_shards_x,
                             radius=radius)


def global_column_ids(d: TileDecomposition) -> np.ndarray:
    """(tiles_y, tiles_x, tile_cols) global column id; -1 for padded
    columns that lie outside the logical grid (``repro.core.retile``)."""
    H, W = d.grid.height, d.grid.width
    out = np.full((d.tiles_y, d.tiles_x, d.tile_cols), -1, np.int64)
    for ty in range(d.tiles_y):
        for tx in range(d.tiles_x):
            oy, ox = d.tile_origin(ty, tx)
            ys = oy + np.arange(d.tile_h)[:, None]
            xs = ox + np.arange(d.tile_w)[None, :]
            gid = np.where((ys < H) & (xs < W), ys * W + xs, -1)
            out[ty, tx] = gid.ravel()
    return out
