"""Grid geometry: Yee staggering, domain decomposition, tile topology.

This module fixes the *behavioral contract* inherited from the reference
Mini-PIC code:

* Yee staggering map (reference ``Field_update.cpp:3-11``): for code index
  ``(i, j)`` (column ``i`` along x, row ``j`` along y),

  ======  ==========================
  field   physical location
  ======  ==========================
  Ex      ((i + 1/2) dx,  j dy)
  Ey      ( i dx,        (j + 1/2) dy)
  Ez      ( i dx,         j dy)
  Bx      ( i dx,        (j + 1/2) dy)
  By      ((i + 1/2) dx,  j dy)
  Bz      ((i + 1/2) dx, (j + 1/2) dy)
  ======  ==========================

* CFL timestep rule (reference ``PIC_2D.cpp:71-73``):
  ``dt = dt_factor / sqrt(1/dx^2 + 1/dy^2)``.

* Tile decomposition (reference ``Auxiliar_functions.cpp:16-52``): the global
  cell grid is divided into ``tile_rows x tile_cols`` equal rectangular tiles
  in row-major order; a tile's *global ID* is ``row * tile_cols + col`` and is
  stable under any placement of the tile (the reference's migration-stable
  GID invariant).

Arrays are indexed ``[j, i] == [y, x]`` throughout, matching the reference's
``grid[j * totalX + i]`` layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

# Staggering offsets (in cell units) of each field component, keyed by name.
# (x_offset, y_offset) — contract from Field_update.cpp:3-11.
STAGGER = {
    "ex": (0.5, 0.0),
    "ey": (0.0, 0.5),
    "ez": (0.0, 0.0),
    "bx": (0.0, 0.5),
    "by": (0.5, 0.0),
    "bz": (0.5, 0.5),
    # Currents live at the matching E-field points.
    "jx": (0.5, 0.0),
    "jy": (0.0, 0.5),
    "jz": (0.0, 0.0),
    # Charge density at integer points (same as Ez) so that the discrete
    # Gauss law div E = rho holds with the Yee divergence.
    "rho": (0.0, 0.0),
}


def find_best_grid(size: int) -> Tuple[int, int]:
    """Near-square factorization ``size = R * C`` with ``R <= C``.

    Mirrors the reference's rank-grid factorization
    (``Auxiliar_functions.cpp:16-22``): start from floor(sqrt(size)) and
    decrease R until it divides size.
    """
    r = int(math.isqrt(size))
    while r > 1 and size % r != 0:
        r -= 1
    return r, size // r


@dataclasses.dataclass(frozen=True)
class Domain:
    """Physical domain + cell grid (units of c/omega_p, reference PIC_2D.cpp:58-65)."""

    box_x: float
    box_y: float
    nx: int
    ny: int

    @property
    def dx(self) -> float:
        return self.box_x / self.nx

    @property
    def dy(self) -> float:
        return self.box_y / self.ny

    def dt_courant(self) -> float:
        """CFL limit, reference PIC_2D.cpp:71."""
        return 1.0 / math.sqrt(1.0 / self.dx**2 + 1.0 / self.dy**2)

    def cell_centers(self, stagger=(0.0, 0.0)):
        """Physical coordinates of every grid point for a stagger class.

        Returns (x[nx], y[ny]) 1-D arrays; reference init loop semantics
        (PIC_2D.cpp:111-118): coordinate = (index + offset) * d.
        """
        ox, oy = stagger
        x = (np.arange(self.nx) + ox) * self.dx
        y = (np.arange(self.ny) + oy) * self.dy
        return x, y


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Decomposition of the global cell grid into equal tiles.

    A *tile* is the unit of particle binning, of the batched deposition /
    gather kernels, and of load balancing — the TPU-native descendant of the
    reference's ``Tile`` struct (``Auxiliar_functions.h:37-42``). Tile
    identity is its (row, col) / global ID, never its storage slot
    (the reference's migration invariant).
    """

    tile_rows: int
    tile_cols: int
    tile_nx: int  # interior cells per tile along x
    tile_ny: int  # interior cells per tile along y

    @property
    def num_tiles(self) -> int:
        return self.tile_rows * self.tile_cols

    def tile_id(self, row, col):
        """Row-major global tile ID (Auxiliar_functions.cpp:44-46)."""
        return row * self.tile_cols + col

    def tile_row_col(self, gid):
        """Inverse of tile_id (Auxiliar_functions.cpp:49-52)."""
        return gid // self.tile_cols, gid % self.tile_cols

    def neighbor_id(self, gid, drow: int, dcol: int):
        """Neighbor tile GID with 2-D periodic wrap (Auxiliar_functions.cpp:55-65)."""
        row, col = self.tile_row_col(gid)
        return self.tile_id(
            (row + drow) % self.tile_rows, (col + dcol) % self.tile_cols
        )

    def tile_of_position(self, x_cell, y_cell):
        """Tile GID containing a position given in global *cell* units."""
        col = np.floor(x_cell / self.tile_nx).astype(np.int32) % self.tile_cols
        row = np.floor(y_cell / self.tile_ny).astype(np.int32) % self.tile_rows
        return self.tile_id(row, col)

    @staticmethod
    def for_domain(domain: Domain, tile_nx: int, tile_ny: int) -> "Tiling":
        if domain.nx % tile_nx or domain.ny % tile_ny:
            raise ValueError(
                f"tile size ({tile_ny}x{tile_nx}) must divide the grid "
                f"({domain.ny}x{domain.nx}) evenly"  # 'Read me.pdf' p.1 WARNING
            )
        return Tiling(
            tile_rows=domain.ny // tile_ny,
            tile_cols=domain.nx // tile_nx,
            tile_nx=tile_nx,
            tile_ny=tile_ny,
        )


# 8-neighbor direction tables (reference Auxiliar_functions.h:11-13):
# directions 0..7 = L, R, U, D, UL, UR, DL, DR; OPPOSITE[d] pairs each
# direction with its reverse.  Kept for the tile-topology tests and the
# owner-table load balancer; the field halo exchange itself uses the
# two-pass axis trick and never enumerates corners.
D_ROW = (0, 0, -1, 1, -1, -1, 1, 1)
D_COL = (-1, 1, 0, 0, -1, 1, -1, 1)
OPPOSITE = (1, 0, 3, 2, 7, 6, 5, 4)
