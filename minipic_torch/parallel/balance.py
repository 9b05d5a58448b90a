"""Load census and adaptive bucket capacity (torch port of
``minipic_tpu.parallel.balance``).

Per-tile work is proportional to a tile's live particles, and the bucket
capacity K must cover the most crowded tile.  ``census`` reads the
occupancy; ``CapacityManager`` decides, from it and the overflow count,
when the buckets grow (at once, geometrically) or shrink (after a calm
spell, with hysteresis); ``with_capacity`` resizes them.  Between re-bins a
drifted particle sits in a stale bucket, so a shrink checks the
*positional* census (``positional_tile_counts``), not bucket occupancy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.state import ParticleState
from ..trace import read


class LoadStats(NamedTuple):
    total: int  # live particles
    max_tile: int  # most crowded tile
    mean_tile: float
    capacity: int
    occupancy: float  # max_tile / capacity
    imbalance: float  # max_tile / mean_tile (1.0 = perfectly uniform)


def census(p: ParticleState) -> LoadStats:
    """Host-side load statistics of one species (reads two scalars)."""
    return census_of_counts((p.w > 0).sum(1, dtype=torch.int32), p.capacity)


def census_of_counts(counts: torch.Tensor, capacity: int) -> LoadStats:
    """``census`` from the live count of every tile (int32 [T]; the
    multi-device simulations gather their shards' counts)."""
    total, mx = (read(v, "census")
                 for v in torch.stack([counts.sum(), counts.max()]))
    mean = total / max(1, counts.numel())
    return LoadStats(total=total, max_tile=mx, mean_tile=mean,
                     capacity=capacity, occupancy=mx / capacity,
                     imbalance=mx / max(mean, 1e-9))


def positional_tile_counts(p: ParticleState, tiling, row0: int = 0,
                           col0: int = 0) -> torch.Tensor:
    """Live particles per destination tile (the tile each particle's
    position lies in now, clamped to the grid), int32 [T], on the device:
    a scatter-add, which reads nothing back (``torch.bincount`` would read
    its input's range)."""
    col = torch.clamp(torch.floor(p.x / tiling.tile_nx).to(torch.int64)
                      - col0, 0, tiling.tile_cols - 1)
    row = torch.clamp(torch.floor(p.y / tiling.tile_ny).to(torch.int64)
                      - row0, 0, tiling.tile_rows - 1)
    tid = (row * tiling.tile_cols + col).reshape(-1)
    alive = (p.w > 0).reshape(-1).to(torch.int32)
    return torch.zeros(tiling.num_tiles, dtype=torch.int32,
                       device=p.x.device).scatter_add_(0, tid, alive)


def with_capacity(p: ParticleState, new_cap: int,
                  tiling=None) -> ParticleState:
    """Grow or shrink bucket capacity.  Growth pads with dead slots; shrink
    re-bins the slot pool into the smaller buckets (needs `tiling`), and
    raises ValueError unless every tile's positional census fits: a shrink
    must lose nothing."""
    cap = p.capacity
    if new_cap == cap:
        return p
    if new_cap > cap:
        return ParticleState(*(torch.nn.functional.pad(a, (0, new_cap - cap))
                               for a in p))
    if tiling is None:
        raise ValueError("shrinking requires the tiling (to re-bin at the "
                         "new capacity)")
    from ..particles.binning import rebin_flat

    max_live = read(positional_tile_counts(p, tiling).max(), "shrink")
    if max_live > new_cap:
        raise ValueError(f"cannot shrink to {new_cap}: a tile holds "
                         f"{max_live} live particles")
    flat = ParticleState(*(a.reshape(-1) for a in p))
    out, ovf = rebin_flat(flat, tile_rows=tiling.tile_rows,
                          tile_cols=tiling.tile_cols,
                          tile_nx=tiling.tile_nx, tile_ny=tiling.tile_ny,
                          capacity=new_cap)
    if read(ovf, "shrink") != 0:
        raise RuntimeError("shrink overflow despite positional census check")
    return out


# CapacityManager's thresholds, the JAX package's defaults.
HIGH_WATER = 0.9  # grow at this occupancy
GROWTH = 1.5  # geometric growth factor
LOW_WATER = 0.35  # a check below this occupancy is calm
SHRINK_PATIENCE = 4  # consecutive calm checks before a shrink
SHRINK_HEADROOM = 1.4  # a shrink asks for the peak tile times this


class CapacityManager:
    """Grow-on-pressure policy over ``census`` and the overflow count.
    Growth is geometric, so a run changes shapes O(log(final / initial))
    times."""

    def __init__(self):
        self._calm = 0  # consecutive low-occupancy checks

    def plan(self, stats: LoadStats, overflow: int) -> Optional[int]:
        """A new capacity if a change is warranted, else None.  Growth fires
        at once on overflow or occupancy >= HIGH_WATER; a shrink waits out
        SHRINK_PATIENCE consecutive checks below LOW_WATER, then asks for
        the observed peak times SHRINK_HEADROOM (multiples of 8)."""
        if overflow > 0 or stats.occupancy >= HIGH_WATER:
            self._calm = 0
            need = max(stats.max_tile + overflow,
                       int(stats.capacity * GROWTH))
            return -(-need // 8) * 8
        if stats.occupancy < LOW_WATER:
            self._calm += 1
            if self._calm >= SHRINK_PATIENCE:
                self._calm = 0
                want = max(8, int(stats.max_tile * SHRINK_HEADROOM))
                want = -(-want // 8) * 8
                if want < stats.capacity:
                    return want
        else:
            self._calm = 0
        return None
