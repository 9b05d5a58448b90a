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


def float_deposit_terms(p, counts, out, *, qm, q, order, tile_ny, tile_nx,
                        origins, g, dt, dx, dy, grid, mode):
    """What each lane of csrc/advance.cu holds when its f32 or f64 deposit
    (``warp_deposit``) starts, from the plain version's own helpers: (live
    [T, cap], row0 and col0 of the particle's 4x4 union support in window
    cells [T, cap], and its terms v [T, cap, 3, 16] (jx, jy, jz at cell
    (row0 + k // 4, col0 + k % 4)), as numpy arrays in the particles'
    dtype, computed on `p`'s device.  `out`: ``advance_plain``'s new (x, y,
    px, py, pz) of `p`."""
    import numpy as np

    from .ops import advance as adv
    from .particles.shapes import shape_values

    T, cap = p.x.shape
    c = {n: adv._f(v, p.x) for n, v in adv._constants(
        qm=qm, q=q, order=order, tile_ny=tile_ny, tile_nx=tile_nx, dt=dt,
        dx=dx, dy=dy, grid=grid, mode=mode).items()}
    ox = origins[0].to(p.x.dtype)[:, None]
    oy = origins[1].to(p.x.dtype)[:, None]
    boxes = ((None, None) if grid is None else
             ((c["grid_nx"], c["half_x"], c["inv_nx"]),
              (c["grid_ny"], c["half_y"], c["inv_ny"])))
    four = torch.arange(4, dtype=p.x.dtype, device=p.x.device)

    def axis(p0, p1, origin, box, n_rows):
        a0, a1 = adv._local(p0, origin, box), adv._local(p1, origin, box)
        c0, _ = adv._support(a0, False, n_rows, g, order, False, c["S"])
        c1, _ = adv._support(a1, False, n_rows, g, order, False, c["S"])
        cells = (torch.minimum(c0, c1) - 1.0)[..., None] + four
        s0 = shape_values(a0[..., None] - cells, order)
        s1 = shape_values(a1[..., None] - cells, order)
        return cells[..., 0].long() + g, s0, s1 - s0

    row0, s0y, dsy = axis(p.y, out[1], oy, boxes[1], tile_ny + 2 * g)
    col0, s0x, dsx = axis(p.x, out[0], ox, boxes[0], tile_nx + 2 * g)
    pxn, pyn, pzn = out[2:5]
    gn = torch.reciprocal(torch.sqrt(1.0 + pxn * pxn + pyn * pyn + pzn * pzn))
    qw = c["q"] * p.w
    cz = (qw * (pzn * gn) * c["cz"])[..., None]
    a_y = (s0y + 0.5 * dsy) * (qw * c["cjx"])[..., None]
    r_y = dsy * (qw * c["cjy"])[..., None]
    r_x = s0x + 0.5 * dsx
    rz1 = 0.5 * s0x + (1.0 / 3.0) * dsx
    v = torch.stack([a_y[..., :, None] * dsx[..., None, :],
                     r_y[..., :, None] * r_x[..., None, :],
                     (s0y * cz)[..., :, None] * r_x[..., None, :]
                     + (dsy * cz)[..., :, None] * rz1[..., None, :]],
                    dim=2).reshape(T, cap, 3, 16)
    slot = torch.arange(cap, device=p.x.device)[None, :]
    live = (slot < counts[:, None].long()) & (p.w != 0)
    return tuple(a.cpu().numpy() for a in (live, row0, col0, v))


# csrc/advance.cu's block: warps, lanes, the bases a warp with shared J
# windows pre-reduces by shuffle trees (kMaxGroups), and the lanes of a
# base up to which a warp with its own windows adds in passes by rank
# (kMaxPasses).
WARPS, LANES, MAX_GROUPS, MAX_PASSES = 8, 32, 4, 3


def reduce16(v):
    """csrc/advance.cu's reduce16 over a warp: v [32 lanes, 16] -> [32],
    lane l holding the sum over all lanes of value (l >> 1) & 15, added in
    the kernel's order (v's dtype)."""
    import numpy as np

    v = v.copy()
    lane = np.arange(LANES)
    for half in (8, 4, 2, 1):
        up = ((lane & (2 * half)) != 0)[:, None]
        send = np.where(up, v[:, :half], v[:, half:2 * half])
        keep = np.where(up, v[:, half:2 * half], v[:, :half])
        v[:, :half] = keep + send[lane ^ (2 * half)]
    return v[:, 0] + v[lane ^ 1, 0]


def warp_adds(live, row0, col0, v, count: int, nyg: int, nxg: int,
              private: bool = True):
    """One tile of csrc/advance.cu's f32 / f64 deposit up to the windows:
    per warp, the adds it makes in order, each (rows, cols, values [3, n]);
    and how many slabs held at most MAX_GROUPS bases, and how many more
    (with shared sets: the shuffle trees, and lane by lane).  Warp w walks slabs w, w + 8, ... up to `count` rounded up to
    32; a slab's depositing lanes are grouped by their (clamped) 4x4 base.
    `private` (a set of J windows per warp): where no base holds more than
    MAX_PASSES lanes, the lanes add their own terms in passes by their
    rank within their base, term by term; else base by base, in the order
    of each base's first lane, the base's 48 sums (its lanes' terms added
    in lane order to a zero, as the warp's staging sums them) go to 16
    distinct cells of each window.  Shared sets: with at most MAX_GROUPS
    bases each, in the same order, is summed by reduce16 per component and
    its even lanes add the 16 sums; else each lane adds its own 48 terms
    (atomics, in an order of the hardware's: here lane by lane)."""
    import numpy as np

    cap = live.shape[0]
    count32 = min(cap, (count + 31) & ~31)
    lane = np.arange(LANES)
    idx = (lane >> 1) & 15
    k16 = np.arange(16)
    adds = [[] for _ in range(WARPS)]
    n_few = n_many = 0
    for w in range(WARPS):
        for sbase in range(w * LANES, count32, WARPS * LANES):
            s = np.minimum(sbase + lane, cap - 1)
            dep = (sbase + lane < count32) & live[s]
            if not dep.any():
                continue
            rk = np.clip(row0[s], -4, nyg) + 4
            ck = np.clip(col0[s], -4, nxg) + 4
            key = np.where(dep, (rk << 16) | ck, -1)
            leaders = [int(i) for i in np.nonzero(dep)[0]
                       if key[i] not in key[:i]]
            few = len(leaders) <= MAX_GROUPS
            n_few, n_many = n_few + few, n_many + (not few)
            rank = np.array([int((key[:i] == key[i]).sum())
                             for i in range(LANES)])
            if private and rank[dep].max() < MAX_PASSES:
                for pass_ in range(int(rank[dep].max()) + 1):
                    go = np.nonzero(dep & (rank == pass_))[0]
                    for k in range(16):
                        r = row0[s[go]] + (k >> 2)
                        c = col0[s[go]] + (k & 3)
                        ok = (r >= 0) & (r < nyg) & (c >= 0) & (c < nxg)
                        adds[w].append((r[ok], c[ok],
                                        v[s[go[ok]], :, k].T))
            elif private:
                for ld in leaders:
                    sums = np.zeros((3, 16), v.dtype)
                    for m in np.nonzero(key == key[ld])[0]:
                        sums = sums + v[s[m]]
                    r = rk[ld] - 4 + (k16 >> 2)
                    c = ck[ld] - 4 + (k16 & 3)
                    ok = (r >= 0) & (r < nyg) & (c >= 0) & (c < nxg)
                    adds[w].append((r[ok], c[ok], sums[:, ok]))
            elif few:
                for ld in leaders:
                    mine = (key == key[ld])[:, None]
                    sums = np.stack([reduce16(np.where(mine, v[s, n], 0))
                                     for n in range(3)])
                    r = rk[ld] - 4 + (idx >> 2)
                    c = ck[ld] - 4 + (idx & 3)
                    ok = (lane % 2 == 0) & (r >= 0) & (r < nyg) & (c >= 0) \
                        & (c < nxg)
                    adds[w].append((r[ok], c[ok], sums[:, ok]))
            else:
                for i in np.nonzero(dep)[0]:
                    r = row0[s[i]] + (k16 >> 2)
                    c = col0[s[i]] + (k16 & 3)
                    ok = (r >= 0) & (r < nyg) & (c >= 0) & (c < nxg)
                    adds[w].append((r[ok], c[ok], v[s[i]][:, ok]))
    return adds, n_few, n_many


def sum_warp_windows(adds, nyg: int, nxg: int, win_warps: int, dtype):
    """The J windows [3, nyg, nxg] of one tile from `warp_adds` (private
    for win_warps 1, shared else): warps w * win_warps .. (w + 1) *
    win_warps - 1 add to set w, in warp order (one order that the atomics
    of shared sets may take), then the sets are summed in a fixed order,
    set 0 first."""
    import numpy as np

    nsets = WARPS // win_warps
    sets = np.zeros((nsets, 3, nyg, nxg), dtype)
    for w, warp in enumerate(adds):
        win = sets[w // win_warps]
        for r, c, vals in warp:
            for n in range(3):
                np.add.at(win[n], (r, c), vals[n])
    out = sets[0].copy()
    for k in range(1, nsets):
        out = out + sets[k]
    return out
