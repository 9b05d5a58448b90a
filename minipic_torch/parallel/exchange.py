"""Cross-shard particle routing (torch port of
``minipic_tpu.parallel.exchange``).

Tile placement is static and the particles move: a particle whose position
has left its shard's block is packed into a fixed-capacity directional
buffer and shipped to the neighbour shard, then merged into that shard's
re-bin.  Diagonal routes compose from an x-hop and a y-hop, so eight
directions cost four shifts.  The drift bound of the sharded step
(``step.build_sharded_step``) keeps every destination a mesh neighbour.

``roll_segments_sharded`` is the deal route's form of the same routing: the
global static roll of the direction runs as a local roll plus seam
fix-ups, whose strips are exactly the cross-shard movers.

Both take and return one item per shard (``mesh.shift``'s convention).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.state import ParticleState
from ..ops.rebin import DIR_OFFSETS
from .mesh import Mesh, collective, on, shift

_NF = 6  # x, y, px, py, pz, w


def _pack(flat: ParticleState, dr: torch.Tensor, dc: torch.Tensor,
          cap: int):
    """Off-shard particles into [3, 3, 6, cap] directional buffers, in flat
    order within each direction; (0, 0) stays local.  Returns (buffers,
    stay mask, dropped: movers past `cap`)."""
    moving = ((dr != 0) | (dc != 0)) & (flat.w > 0)
    dir9 = torch.where(moving, (dr + 1) * 3 + (dc + 1),
                       torch.full_like(dr, 4))
    # Ranks along the contiguous axis of a [9, N] one-hot: a scan down the
    # outer axis of [N, 9] runs 9 lanes wide on a card (~0.4 s at 1e6).
    onehot = ((dir9[None, :] == torch.arange(9, device=dr.device)[:, None])
              & moving[None, :])
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    rank = torch.gather(rank, 0, dir9[None, :].long())[0]
    dropped = (moving & (rank >= cap)).sum(dtype=torch.int32)
    ok = moving & (rank < cap)
    dest = torch.where(ok, dir9 * cap + rank,
                       torch.full_like(rank, 9 * cap)).long()
    fields = torch.stack(tuple(flat))  # [6, N]
    buf = torch.zeros((_NF, 9 * cap + 1), dtype=fields.dtype,
                      device=fields.device)
    # Every kept destination is unique; the rest land on the spare slot.
    buf[:, dest] = torch.where(moving, fields, torch.zeros_like(fields))
    buf = buf[:, :9 * cap].reshape(_NF, 3, 3, cap).permute(1, 2, 0, 3)
    return buf, ~moving, dropped


def _route(bufs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Two-pass shift of each shard's [3, 3, 6, cap] buffers.  After it,
    entry (dr+1, dc+1) of a shard holds what the shard (-dr, -dc) away sent
    to it: everything belongs here."""
    to_left = shift([b[:, 0] for b in bufs], mesh, "rx", up=True)
    to_right = shift([b[:, 2] for b in bufs], mesh, "rx", up=False)
    bufs = [torch.stack([lt, b[:, 1], rt], dim=1)
            for lt, b, rt in zip(to_left, bufs, to_right)]
    to_up = shift([b[0] for b in bufs], mesh, "ry", up=True)
    to_down = shift([b[2] for b in bufs], mesh, "ry", up=False)
    return [torch.stack([u, b[1], d], dim=0)
            for u, b, d in zip(to_up, bufs, to_down)]


@collective
def exchange_particles(ps: Sequence[ParticleState], mesh: Mesh, *,
                       block_nx: int, block_ny: int, cap: int
                       ) -> Tuple[List[ParticleState], List[torch.Tensor]]:
    """Ship each shard's off-block particles to its neighbour shards.

    ps: one ParticleState per shard, [T_local, K] buffers, positions global
    (box-wrapped).  Returns per shard a flat local + received ParticleState
    of T_local*K + 9*cap slots (dead slots zero) and the count dropped
    (int32 0-d): buffer overflow, and live slots more than one shard-hop
    away, which are killed (w = 0), never shipped a clipped hop."""
    rows, cols = mesh.shape
    bufs, stays, flats, drops = [], [], [], []
    for s, p in enumerate(ps):
        r, c = mesh.coords(s)
        with on(mesh.devices[s]):
            flat = ParticleState(*(a.reshape(-1) for a in p))
            scol = torch.div(flat.x.to(torch.int32), block_nx,
                             rounding_mode="floor")
            srow = torch.div(flat.y.to(torch.int32), block_ny,
                             rounding_mode="floor")
            dc = scol - c
            dr = srow - r
            # Periodic minimal wrap (rint: half to even, as jnp.rint).
            dc = (dc - cols * torch.round(dc / cols).to(torch.int32)
                  if cols > 1 else torch.zeros_like(dc))
            dr = (dr - rows * torch.round(dr / rows).to(torch.int32)
                  if rows > 1 else torch.zeros_like(dr))
            too_far = (dc.abs() > 1) | (dr.abs() > 1)
            n_far = (too_far & (flat.w > 0)).sum(dtype=torch.int32)
            flat = flat._replace(w=torch.where(too_far,
                                               torch.zeros_like(flat.w),
                                               flat.w))
            buf, stay, dropped = _pack(flat, dr.clamp(-1, 1),
                                       dc.clamp(-1, 1), cap)
        bufs.append(buf)
        stays.append(stay)
        flats.append(flat)
        drops.append(dropped + n_far)
    routed = _route(bufs, mesh)
    merged = []
    for s, (flat, stay, rt) in enumerate(zip(flats, stays, routed)):
        with on(mesh.devices[s]):
            recv = rt.permute(2, 0, 1, 3).reshape(_NF, 9 * cap)
            merged.append(ParticleState(*(
                torch.cat([torch.where(stay, a, torch.zeros_like(a)), b])
                for a, b in zip(flat, recv))))
    return merged, drops


@collective
def roll_segments_sharded(segs: Sequence[ParticleState], mesh: Mesh, *,
                          ltr: int, ltc: int, b_seg: int
                          ) -> List[ParticleState]:
    """The deal route's global static roll under block sharding.

    On one device the arrivals at tile t from direction d are run d of t's
    (-d) neighbour: a roll of the tile grid (``ops.rebin.roll_segments``).
    Over contiguous blocks the same roll is a local roll plus a seam
    fix-up: after the local roll the seam column (row) holds the strip that
    wrapped around the block, which is exactly what the neighbour shard's
    seam needs; one shift per mesh axis and sign ships it (diagonal runs
    reach the corner shard in two hops).

    segs: per shard the segment runs [T_local, 8*b_seg] (run d at columns
    [d*b_seg, (d+1)*b_seg)).  Returns per shard the arrivals in the same
    layout, each run already at its destination tile, for the append with
    an identity neighbour table (``ops.rebin.identity_neighbor_table``)."""
    rows, cols = mesh.shape
    parts = []  # per shard, per direction: [6, ltr, ltc, b_seg]
    for s, seg in enumerate(segs):
        with on(mesh.devices[s]):
            ch = torch.stack(tuple(seg)).reshape(_NF, ltr, ltc, 8, b_seg)
            parts.append([torch.roll(ch[:, :, :, d], dc, dims=2) if dc
                          else ch[:, :, :, d]
                          for d, (_, dc) in enumerate(DIR_OFFSETS)])
    if cols > 1:
        for sign in (1, -1):
            ds = [d for d, (_, dc) in enumerate(DIR_OFFSETS) if dc == sign]
            seam = 0 if sign == 1 else ltc - 1
            edges = [torch.stack([pt[d][:, :, seam] for d in ds])
                     for pt in parts]
            recv = shift(edges, mesh, "rx", up=(sign == -1))
            for pt, rv in zip(parts, recv):
                for k, d in enumerate(ds):
                    pt[d][:, :, seam] = rv[k]
    # The row pass works on the column-corrected strips, so diagonal runs
    # cross the shard corner in two hops.
    parts = [[torch.roll(a, dr, dims=1) if dr else a
              for a, (dr, _) in zip(pt, DIR_OFFSETS)] for pt in parts]
    if rows > 1:
        for sign in (1, -1):
            ds = [d for d, (dr, _) in enumerate(DIR_OFFSETS) if dr == sign]
            seam = 0 if sign == 1 else ltr - 1
            edges = [torch.stack([pt[d][:, seam] for d in ds])
                     for pt in parts]
            recv = shift(edges, mesh, "ry", up=(sign == -1))
            for pt, rv in zip(parts, recv):
                for k, d in enumerate(ds):
                    pt[d][:, seam] = rv[k]
    out = []
    for s, pt in enumerate(parts):
        with on(mesh.devices[s]):
            a = torch.stack(pt, dim=3).reshape(_NF, ltr * ltc, 8 * b_seg)
            out.append(ParticleState(*a.unbind(0)))
    return out
