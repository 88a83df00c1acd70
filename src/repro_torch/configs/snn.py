"""The paper's own configurations: column grids x connectivity laws.

Table 1 problem sizes (grid, neurons, recurrent/total synapses):
  24x24  0.7M   0.9G/1.2G (gaussian)   1.5G/1.8G (exponential)
  48x48  2.9M   3.5G/5.0G              5.9G/7.4G
  96x96 11.4M  14.2G/20.4G            23.4G/29.6G
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.connectivity import (exponential_law, gaussian_law,
                                 NEURONS_PER_COLUMN)
from ..core.engine import EngineConfig
from ..core.grid import ColumnGrid, TileDecomposition


@dataclasses.dataclass(frozen=True)
class SNNCase:
    name: str
    grid: Tuple[int, int]
    law: str                        # "gaussian" | "exponential"
    n_per_column: int = NEURONS_PER_COLUMN

    def connectivity(self):
        return gaussian_law() if self.law == "gaussian" else \
            exponential_law()

    def engine_config(self, tiles_y: int, tiles_x: int,
                      **overrides) -> EngineConfig:
        law = self.connectivity()
        decomp = TileDecomposition(
            grid=ColumnGrid(self.grid[0], self.grid[1], self.n_per_column),
            tiles_y=tiles_y, tiles_x=tiles_x, radius=law.radius)
        return EngineConfig(decomp=decomp, law=law, **overrides)


GRIDS = ((24, 24), (48, 48), (96, 96))
LAWS = ("gaussian", "exponential")

CASES = {
    f"snn-{g[0]}x{g[1]}-{law}": SNNCase(f"snn-{g[0]}x{g[1]}-{law}", g, law)
    for g in GRIDS for law in LAWS
}


def reduced_case(law: str = "gaussian", grid: int = 8,
                 n_per_column: int = 60) -> SNNCase:
    """Reduced config (smaller grid and columns) for tests and the smoke
    run; ``n_per_column=NEURONS_PER_COLUMN`` keeps the paper's width."""
    return SNNCase(f"snn-{grid}x{grid}-{law}-reduced", (grid, grid), law,
                   n_per_column=n_per_column)
