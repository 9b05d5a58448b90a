"""Tile windows and their additive fold — the intra-device half of the halo
machinery, with views and adds only.

* ``extract_tiles``: padded block (ny+2g, nx+2g) -> overlapping windows
  [tr, tc, nyt+2g, nxt+2g] (two ``unfold`` views).
* ``fold_tiles``: the additive inverse — per-tile deposit windows summed
  back into a padded block, guard overlaps accumulating into the
  neighbours' interiors, axis by axis in the JAX package's order.

Constraint: 2*guard <= tile edge (Deck.validate).
"""
from __future__ import annotations

import torch

from ..core.state import FieldState


def extract_tiles(padded: torch.Tensor, tile_rows: int, tile_cols: int,
                  tile_ny: int, tile_nx: int, g: int) -> torch.Tensor:
    """(ny+2g, nx+2g) -> [tile_rows, tile_cols, tile_ny+2g, tile_nx+2g]."""
    win = padded.unfold(0, tile_ny + 2 * g, tile_ny).unfold(
        1, tile_nx + 2 * g, tile_nx)
    if win.shape[:2] != (tile_rows, tile_cols):
        raise ValueError(f"padded block {tuple(padded.shape)} does not hold "
                         f"{tile_rows}x{tile_cols} tiles of {tile_ny}x"
                         f"{tile_nx} with guard {g}")
    return win


def _fold_axis(t: torch.Tensor, tile_n: int, g: int, tile_axis: int,
               cell_axis: int) -> torch.Tensor:
    """Merge the (n_tiles, tile_n+2g) axis pair into one axis of length
    n_tiles*tile_n + 2g (last), summing the window overlaps."""
    t = torch.movedim(t, (tile_axis, cell_axis), (-2, -1))
    lead = t.shape[:-2]
    n_tiles = t.shape[-2]
    main = t[..., :tile_n].reshape(*lead, n_tiles * tile_n)
    tail = t[..., tile_n:]
    pad = torch.zeros((*lead, n_tiles, tile_n - 2 * g), dtype=t.dtype,
                      device=t.device)
    over = torch.cat([tail, pad], dim=-1).reshape(*lead, n_tiles * tile_n)
    out = torch.zeros((*lead, n_tiles * tile_n + 2 * g), dtype=t.dtype,
                      device=t.device)
    out[..., : n_tiles * tile_n] += main
    valid = (n_tiles - 1) * tile_n + 2 * g
    out[..., tile_n:] += over[..., :valid]
    return out


def fold_tiles(tiles: torch.Tensor, tile_ny: int, tile_nx: int,
               g: int) -> torch.Tensor:
    """[tr, tc, nyt+2g, nxt+2g] -> padded block (ny+2g, nx+2g)."""
    x = _fold_axis(tiles, tile_nx, g, tile_axis=1, cell_axis=3)
    y = _fold_axis(x, tile_ny, g, tile_axis=0, cell_axis=1)
    return y.T


def extract_field_tiles(f: FieldState, tile_rows: int, tile_cols: int,
                        tile_ny: int, tile_nx: int, g: int) -> FieldState:
    """FieldState of padded blocks -> FieldState of contiguous tile stacks
    [T, nyt+2g, nxt+2g] (T in global-ID row-major order)."""
    def ex(a):
        t = extract_tiles(a, tile_rows, tile_cols, tile_ny, tile_nx, g)
        return t.reshape(tile_rows * tile_cols, tile_ny + 2 * g,
                         tile_nx + 2 * g).contiguous()

    return FieldState(*(ex(c) for c in f))
