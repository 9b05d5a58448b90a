"""Particle re-binning into fixed-capacity tile buckets, and box wrap.

Two routes into the static (num_tiles, capacity) layout:

* ``rebin`` (the sort route, ``rebin_mode="sort"``): particles are sorted
  by destination tile.  The JAX package does this with one multi-operand
  filler-key sort because gathers are slow on a TPU; on a GPU a stable
  argsort of the tile ids plus one index gather per channel is the natural
  form.  Live particles come out first in each bucket, in flat-index
  order, as in the JAX package; the dead slots after them are zeroed
  (w == 0).  Overflow (more live particles for a tile than its capacity)
  is counted and the excess dropped: a bucket takes the first `capacity`
  arrivals by flat index.
* ``rebin_auto`` (``rebin_mode="auto"`` or ``"incremental"``): only the
  particles that left their tile move, through the kernels of
  ``ops/rebin.py``: the split, then the deal route (segment, then append
  or defrag) where the buckets hold eight segment runs plus 256 slots, else
  the sort route of the movers alone (``route_movers``, then
  append_incoming or the defrag).  Its buckets equal the JAX package's
  slot for slot, dead slots included.
* ``rebin_incremental``: extract (holes left behind), route the movers,
  append_incoming, with no deferral and no defrag.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.geometry import Tiling
from ..core.state import ParticleState
from ..trace import span


def wrap_positions(p: ParticleState, nx: int, ny: int,
                   periodic: bool) -> ParticleState:
    """Apply the box boundary to raw positions in cell units.

    f32: remainder(a, n) can round to exactly n for a just below 0; the
    == n edge is clamped to 0 so no live particle lands off the grid."""
    if periodic:
        x = torch.remainder(p.x, nx)
        y = torch.remainder(p.y, ny)
        x = torch.where(x >= nx, x - nx, x)
        y = torch.where(y >= ny, y - ny, y)
        return p._replace(x=x, y=y)
    inside = (p.x >= 0) & (p.x < nx) & (p.y >= 0) & (p.y < ny)
    return p._replace(
        w=torch.where(inside, p.w, torch.zeros_like(p.w)),
        x=torch.clamp(p.x, 0.0, nx - 1e-3),
        y=torch.clamp(p.y, 0.0, ny - 1e-3),
    )


def rebin_flat(flat: ParticleState, *, tile_rows: int, tile_cols: int,
               tile_nx: int, tile_ny: int, capacity: int, row0: int = 0,
               col0: int = 0) -> Tuple[ParticleState, torch.Tensor]:
    """Sort a flat slot pool into (tile_rows*tile_cols, capacity) buckets by
    the tile of each slot's position (minus the (row0, col0) offset).
    Returns the buckets and the count of dropped live particles."""
    col = torch.floor(flat.x / tile_nx).to(torch.int64) - col0
    row = torch.floor(flat.y / tile_ny).to(torch.int64) - row0
    in_grid = (col >= 0) & (col < tile_cols) & (row >= 0) & (row < tile_rows)
    tid = row * tile_cols + col
    return rebin_by_tid(flat, tid, in_grid, tile_rows * tile_cols, capacity)


def rebin_by_tid(flat: ParticleState, tid: torch.Tensor,
                 in_grid: torch.Tensor, num_tiles: int,
                 capacity: int) -> Tuple[ParticleState, torch.Tensor]:
    """Bucket a flat pool by caller-supplied tile indices `tid`; slots with
    w == 0 or ~in_grid are not placed.  Live slots off the grid are counted
    as dropped.  Reads nothing back to the host."""
    n = flat.x.shape[0]
    if n < num_tiles * capacity:
        raise ValueError(f"slot pool {n} smaller than bucket space "
                         f"{num_tiles * capacity}")
    dev = flat.x.device
    live_w = flat.w > 0
    alive = live_w & in_grid
    off_grid_live = (live_w & ~in_grid).sum()

    # int32 keys: half the radix passes of int64.  Bucket bounds come from
    # the sorted keys (bincount would read its input's range to the host).
    key = torch.where(alive, tid, torch.full_like(tid, num_tiles)).to(
        torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(sorted_key, torch.arange(
        num_tiles + 1, dtype=torch.int32, device=dev))
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    dropped = torch.clamp(counts - capacity, min=0).sum() + off_grid_live

    slot = torch.arange(capacity, device=dev)
    src = order[torch.clamp(starts[:, None] + slot[None, :], max=n - 1)]
    valid = slot[None, :] < counts[:, None]
    outs = [torch.where(valid, a[src], torch.zeros((), dtype=a.dtype,
                                                    device=dev))
            for a in flat]
    return ParticleState(*outs), dropped.to(torch.int32)


def rebin(p: ParticleState, tiling: Tiling) -> Tuple[ParticleState,
                                                       torch.Tensor]:
    """Single-device re-binning over the full tile grid."""
    flat = ParticleState(*(a.reshape(-1) for a in p))
    return rebin_flat(flat, tile_rows=tiling.tile_rows,
                      tile_cols=tiling.tile_cols, tile_nx=tiling.tile_nx,
                      tile_ny=tiling.tile_ny, capacity=p.capacity)


def route_movers(movers: ParticleState, tiling: Tiling, mover_cap: int
                 ) -> Tuple[ParticleState, torch.Tensor]:
    """The sort route of the movers (the JAX package's ``_route``): the
    flattened [T, mover_cap] mover buffer binned by destination tile into
    incoming rows of mover_cap slots, live slots first in flat buffer
    order (source tile, then buffer slot), the rest zero.  Returns the
    incoming rows and the count of arrivals beyond mover_cap (dropped)."""
    flat = ParticleState(*(a.reshape(-1) for a in movers))
    return rebin_flat(flat, tile_rows=tiling.tile_rows,
                      tile_cols=tiling.tile_cols, tile_nx=tiling.tile_nx,
                      tile_ny=tiling.tile_ny, capacity=mover_cap)


def rebin_auto(p: ParticleState, tiling: Tiling, mover_cap: int, *,
               force=False, seg_cap: int = 0, fused: bool = True
               ) -> Tuple[ParticleState, torch.Tensor, torch.Tensor]:
    """The incremental re-bin: split each bucket into stayers (compacted in
    place of the bucket) and movers, bring the movers to their destination
    tiles, and append each tile's arrivals at its watermark; when some
    bucket lacks 256 slots of headroom for that, the defrag compacts bucket
    and arrivals together instead.  The branch is chosen on the device
    (both kernels launch; the one not chosen returns at once), so nothing
    is read back to the host.

    The movers reach their tiles by the deal route when `seg_cap` > 0 and
    ``p.capacity >= 8 * seg_cap + 256``: binned by direction into runs of
    `seg_cap` and appended by the fused append, or, with ``fused=False``
    (the JAX package's unfused route, which the steps never take), rolled
    into each tile's own row first and appended by append_runs.  Otherwise
    by the sort route: ``route_movers``, then append_incoming.

    Returns (buckets, dropped, pending), int32 0-d:
    * dropped — particles lost: segment-run overflow and >1-hop kills, or
      the sort route's arrivals beyond mover_cap; an append's arrivals
      that do not fit; census overflow in the defrag; and a forced split's
      buffer overflow;
    * pending — movers left in their buckets because the tile's buffer was
      too small and `force` was not set (nothing lost).  The caller keeps
      its drift budget while pending > 0 and passes force once the budget
      is spent."""
    from ..ops.rebin import (append_incoming_, append_runs_,
                             append_segments_, defrag_buckets_,
                             roll_segments, seg_arrival_counts,
                             seg_neighbor_table, segment_movers,
                             split_buckets)

    cap = p.capacity
    t = tiling
    with span("rebin.split"):
        p1, movers, wm, pending = split_buckets(
            p, tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
            b_cap=mover_cap, force=force)
    if seg_cap > 0 and cap >= 8 * seg_cap + 256:
        with span("rebin.segment"):
            seg, seg_dropped = segment_movers(
                movers, tile_rows=t.tile_rows, tile_cols=t.tile_cols,
                tile_ny=t.tile_ny, tile_nx=t.tile_nx, b_seg=seg_cap)
            nbr = seg_neighbor_table(t.tile_rows, t.tile_cols, p.x.device)
            n_in = seg_arrival_counts(seg, nbr, seg_cap)
            headroom_ok = (wm + n_in <= cap - 256).all()
        with span("rebin.append"):
            if fused:
                app_dropped = append_segments_(p1, seg, wm, nbr,
                                               b_seg=seg_cap,
                                               active=headroom_ok)
            else:
                app_dropped = append_runs_(
                    p1, roll_segments(seg, nbr, seg_cap), wm, b_seg=seg_cap,
                    active=headroom_ok)
        with span("rebin.defrag"):
            _, def_dropped = defrag_buckets_(p1, seg, nbr, b_seg=seg_cap,
                                             active=~headroom_ok)
        route_dropped = seg_dropped.sum()
    else:
        with span("rebin.route"):
            incoming, route_dropped = route_movers(movers, t, mover_cap)
            n_in = (incoming.w > 0).sum(1, dtype=torch.int32)
            headroom_ok = (wm + n_in <= cap - 256).all()
        with span("rebin.append"):
            app_dropped = append_incoming_(p1, incoming, wm,
                                           active=headroom_ok)
        with span("rebin.defrag"):
            _, def_dropped = defrag_buckets_(p1, incoming,
                                             active=~headroom_ok)
    dropped = (route_dropped + app_dropped.sum()
               + def_dropped.sum()).to(torch.int32)
    return (p1, *finish_rebin(dropped, pending, force))


def finish_rebin(dropped: torch.Tensor, pending: torch.Tensor, force
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dropped, pending), int32 0-d, of a re-bin pass from its drops and
    its per-tile backlog `pending`: a forced pass (`force` a bool or a 0-d
    bool tensor) turns the backlog into counted drops."""
    pend = pending.sum().to(torch.int32)
    if isinstance(force, bool):
        return ((dropped + pend, torch.zeros_like(pend)) if force
                else (dropped, pend))
    zero = torch.zeros_like(pend)
    return (dropped + torch.where(force, pend, zero),
            torch.where(force, zero, pend))


def rebin_incremental(p: ParticleState, tiling: Tiling, mover_cap: int
                      ) -> Tuple[ParticleState, torch.Tensor, torch.Tensor]:
    """Movers-only re-bin, unconditional and forced (the JAX package's
    ``rebin_incremental``): extract the particles that left their tile
    (their slots stay behind as holes, w = 0), route them with
    ``route_movers``, and append them at each destination's watermark with
    append_incoming; no deferral, no defrag.  The result shares x, y, px,
    py and pz with `p` and is appended in place, so `p` is consumed.

    Returns (p2, dropped, max watermark after), int32 0-d: dropped counts
    the extract's buffer overflow, the route's and the append's."""
    from ..ops.rebin import append_incoming_, extract_movers

    t = tiling
    p1, movers, wm, dropped_a = extract_movers(
        p, tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
        b_cap=mover_cap, force=True)
    incoming, route_dropped = route_movers(movers, t, mover_cap)
    n_in = (incoming.w > 0).sum(1, dtype=torch.int32)
    dropped_b = append_incoming_(p1, incoming, wm)
    dropped = (dropped_a.sum() + route_dropped + dropped_b.sum()).to(
        torch.int32)
    return p1, dropped, (wm + n_in).max()


def tile_counts(p: ParticleState) -> torch.Tensor:
    """Alive particles per tile."""
    return (p.w > 0).sum(dim=1, dtype=torch.int32)
