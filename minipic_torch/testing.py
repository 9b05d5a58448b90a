"""Fixtures shared by the port's tests and ``chip_smoke.py``."""
from __future__ import annotations

import torch

# The eight ways out of a box: each wall, then each corner (sx, sy).
WALLS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1),
         (1, 1))


def push_out_through_walls(x, y, px, py, live, ox, oy, tile_nx: int,
                           tile_ny: int, nx: float, ny: float, near,
                           u: float = 3.0):
    """Leavers for the advance's open mode: in the tiles at each wall (tile
    origins `ox`, `oy`, shaped to broadcast against the ``[T, cap]``
    buckets), the live particles in slots ``3 + k`` modulo 40 are put
    `near` cells inside wall k of ``WALLS`` and given momentum `u` out
    through it (through both walls, diagonally, at a corner).  Returns the
    new (x, y, px, py)."""
    slot = torch.arange(x.shape[-1], device=x.device)[None, :]
    for k, (sx, sy) in enumerate(WALLS):
        pick = live & (slot % 40 == 3 + k)
        if sx:
            pick = pick & ((ox == 0) if sx < 0 else (ox + tile_nx == nx))
        if sy:
            pick = pick & ((oy == 0) if sy < 0 else (oy + tile_ny == ny))
        if sx:
            x = torch.where(pick, near if sx < 0 else nx - near, x)
            px = torch.where(pick, torch.full_like(px, u * sx), px)
        if sy:
            y = torch.where(pick, near if sy < 0 else ny - near, y)
            py = torch.where(pick, torch.full_like(py, u * sy), py)
    return x, y, px, py
