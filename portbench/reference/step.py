"""The plain reference of one step of the port's ``Simulation.run_step``.

Plain torch, over flat lists of live particles and global field arrays; it
imports nothing of the program.  From a state it works out the state one
step later as the port's step order states it (``minipic_torch/
simulation.py``):

1. per species, gather E and B at each particle (the deck's B-spline
   shapes, or in the int8 deposit the matched quantized shapes round(S s),
   S = 83 TSC / 62 CIC, with 1/S^2 folded into the half kick), the
   relativistic Boris push, the move (wrapped on a periodic box), and the
   Esirkepov current of the move (the int8 deposit: integer products of the
   quantized shapes, scaled by q max(w); f32 and f64: the exact products);
2. B half step, E full step with J, B half step (Yee, periodic rolls), and
   between absorbing walls the cubic damping mask;
3. between absorbing walls, every particle that left the grid is killed
   (w = 0) and the positions are clamped into it;
4. the drift trigger: accumulated drift + this step's largest displacement
   against guard - shape reach - 2 CFL steps; on a re-bin every live
   particle belongs to the tile of floor(position / tile) (else to the
   bucket it came from); a deck without species never re-bins and keeps
   its drift;
5. the diagnostics: field energy after the update, each species' kinetic
   energy and momentum after the push (float64);
6. in a moving window, when the step shifts it (``window.py``; the shift
   also forces the re-bin), the fields and particles shifted and the
   leading tile column injected, after the diagnostics.

The gather, push and shape arithmetic is a frozen copy of the port's plain
advance (``advance_plain`` of ``minipic_torch/ops/advance.py``), in the same
order of operations, so the two agree to rounding; the current is summed in
float64 straight into the global grid, not through tile windows and their
fold.  `dtype` runs the whole step in another precision: the control that
must come out as not correct runs it in bfloat16.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

THIRD = 1.0 / 3.0
# Particles a block of the advance: bounds its temporaries at the
# headline's 1e8 particles.
BLOCK = 1 << 22


class Flat(NamedTuple):
    """One species' live particles: the bucket (tile id) each sits in and
    its six channels, all [N]."""

    tile: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    w: torch.Tensor


def flatten(buckets) -> Flat:
    """Flat live particles of one species' buckets (x, y, px, py, pz, w),
    each [tiles, capacity]."""
    live = buckets[5] > 0
    t_idx, s_idx = live.nonzero(as_tuple=True)
    return Flat(t_idx, *(a[t_idx, s_idx] for a in buckets))


class Geometry(NamedTuple):
    nx: int
    ny: int
    tile_nx: int
    tile_ny: int
    tile_cols: int
    guard: int
    dx: float
    dy: float
    dt: float
    periodic: bool
    absorb_width: int


def geometry(deck: dict) -> Geometry:
    nx, ny = deck["nx"], deck["ny"]
    dx, dy = deck["box_x"] / nx, deck["box_y"] / ny
    dt = deck["dt_factor"] / math.sqrt(1.0 / dx ** 2 + 1.0 / dy ** 2)
    return Geometry(nx, ny, deck["tile_nx"], deck["tile_ny"],
                    nx // deck["tile_nx"], deck["guard"], dx, dy, dt,
                    deck["boundary"] == "periodic", deck["absorb_width"])


def drift_threshold(deck: dict) -> float:
    """Accumulated drift (cells) past which the step re-bins."""
    geo = geometry(deck)
    order = max((sp["shape_order"] for sp in deck["species"]), default=1)
    reach = 1.0 if order == 1 else 1.5
    return geo.guard - reach - 2.0 * geo.dt / min(geo.dx, geo.dy)


def shape_values(u: torch.Tensor, order: int) -> torch.Tensor:
    au = torch.abs(u)
    if order == 1:
        return torch.clamp(1.0 - au, min=0.0)
    inner = 0.75 - au * au
    o = 1.5 - au
    outer = 0.5 * (o * o)
    zero = torch.zeros_like(au)
    return torch.where(au <= 0.5, inner, torch.where(au <= 1.5, outer, zero))


def _constants(*, qm, q, order, geo: Geometry, quant: bool) -> dict:
    S = 83.0 if order == 2 else 62.0
    h = qm * geo.dt * 0.5
    if quant:
        h = h * (1.0 / (S * S))
        inv2 = 1.0 / (2.0 * S * S)
        cjx, cjy = -inv2 / (geo.dt * geo.dy), -inv2 / (geo.dt * geo.dx)
    else:
        cjx, cjy = -1.0 / (geo.dt * geo.dy), -1.0 / (geo.dt * geo.dx)
    gnx, gny = geo.nx, geo.ny
    return dict(h=h, dtdx=geo.dt / geo.dx, dtdy=geo.dt / geo.dy, q=q,
                grid_nx=float(gnx), grid_ny=float(gny), inv_nx=1.0 / gnx,
                inv_ny=1.0 / gny, half_x=(gnx - geo.tile_nx) * 0.5,
                half_y=(gny - geo.tile_ny) * 0.5, cjx=cjx, cjy=cjy,
                cz=1.0 / (geo.dx * geo.dy), czq=1.0 / (S * S), S=S)


def _local(pos, origin, box):
    xi = pos - origin
    if box is None:
        return xi
    n, half, inv = box
    return xi - n * torch.floor((xi + half) * inv)


def _support(pos, half: bool, n_rows: int, g: int, order: int, quant: bool,
             S):
    """Centre cell and the 3 support values at cells c-1, c, c+1 (the
    quantized ones with the partition and window-edge folds)."""
    c = torch.floor(pos) if half else torch.floor(pos + 0.5)
    if quant:
        tm = pos - (c - 1.0)
        tp = pos - (c + 1.0)
        if half:
            tm = tm - 0.5
            tp = tp - 0.5
        qm = torch.round(shape_values(tm, order) * S)
        qp = torch.round(shape_values(tp, order) * S)
        qc = (S - qm) - qp
        cr = c + float(g)
        zero = torch.zeros_like(qc)
        qc = qc + torch.where(cr <= 0.0, qm, zero)
        qc = qc + torch.where(cr >= float(n_rows - 1), qp, zero)
        return c, (qm, qc, qp)
    vals = []
    for k in (-1.0, 0.0, 1.0):
        u = pos - (c + k)
        if half:
            u = u - 0.5
        vals.append(shape_values(u, order))
    return c, tuple(vals)


def _gather(f_flat, geo: Geometry, ox, oy, cy, sy, cx, sx):
    """sum_j sy[j] (sum_i F[cy + j - 1, cx + i - 1] sx[i]) on the periodic
    grid, in the port's order of additions."""
    e = None
    row0 = oy + cy.long() - 1
    col0 = ox + cx.long() - 1
    for j in range(3):
        r = torch.remainder(row0 + j, geo.ny) * geo.nx
        m = None
        for i in range(3):
            term = f_flat[r + torch.remainder(col0 + i, geo.nx)] * sx[i]
            m = term if m is None else m + term
        term = m * sy[j]
        e = term if e is None else e + term
    return e


def _place4(cells, c, vals):
    d = cells - c[:, None]
    z = torch.zeros_like(d)
    qm, qc, qp = (v[:, None] for v in vals)
    return torch.where(d == -1.0, qm, torch.where(
        d == 0.0, qc, torch.where(d == 1.0, qp, z)))


def _wrap(v, n, inv):
    vw = v - n * torch.floor(v * inv)
    vw = torch.where(vw < 0, vw + n, vw)
    return torch.where(vw >= n, vw - n, vw)


def advance(p: Flat, fields, sp: dict, geo: Geometry, quant: bool,
            dtype) -> Tuple[Flat, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Gather, push, move and deposit for one species.  Returns (the pushed
    particles, positions wrapped on a periodic grid and raw between walls;
    the (jx, jy, jz) it deposits, float64 (ny, nx); the largest
    displacement in cells)."""
    dev = p.x.device
    p = Flat(p.tile, *(a.to(dtype) for a in p[1:]))
    k = _constants(qm=sp["charge"] / sp["mass"], q=sp["charge"],
                   order=sp["shape_order"], geo=geo, quant=quant)
    c = {n: torch.tensor(v, dtype=dtype, device=dev) for n, v in k.items()}
    f_flat = [a.to(dtype).reshape(-1) for a in fields]
    j_out = [torch.zeros(geo.ny * geo.nx, dtype=torch.float64, device=dev)
             for _ in range(3)]
    qws = None
    if quant:
        qws = sp["charge"] * float(p.w.max()) if p.w.numel() else 0.0
    outs, disp = [], torch.zeros((), dtype=dtype, device=dev)
    for s in range(0, p.x.shape[0], BLOCK):
        blk = Flat(*(a[s:s + BLOCK] for a in p))
        out, d = _advance_block(blk, f_flat, j_out, c, sp["shape_order"],
                                geo, quant, qws)
        outs.append(out)
        disp = torch.maximum(disp, d)
    if outs:
        new = Flat(*(torch.cat(cs) for cs in zip(*outs)))
    else:
        new = p
    js = tuple(j.reshape(geo.ny, geo.nx) for j in j_out)
    return new, js, disp


def _advance_block(p: Flat, f_flat: List[torch.Tensor], j_out, c, order: int,
                   geo: Geometry, quant: bool, qws: Optional[float]):
    dev = p.x.device
    g = geo.guard
    nyg, nxg = geo.tile_ny + 2 * g, geo.tile_nx + 2 * g
    S = c["S"]
    tile = p.tile
    oxi = (tile % geo.tile_cols) * geo.tile_nx
    oyi = (tile // geo.tile_cols) * geo.tile_ny
    ox, oy = oxi.to(p.x.dtype), oyi.to(p.x.dtype)
    box_x = (c["grid_nx"], c["half_x"], c["inv_nx"]) if geo.periodic else None
    box_y = (c["grid_ny"], c["half_y"], c["inv_ny"]) if geo.periodic else None
    x, y, px, py, pz, w = p.x, p.y, p.px, p.py, p.pz, p.w
    xi = _local(x, ox, box_x)
    eta = _local(y, oy, box_y)
    cxi, sxi = _support(xi, False, nxg, g, order, quant, S)
    cxh, sxh = _support(xi, True, nxg, g, order, quant, S)
    cyi, syi = _support(eta, False, nyg, g, order, quant, S)
    cyh, syh = _support(eta, True, nyg, g, order, quant, S)

    def gat(fld, cy, sy, cx, sx):
        return _gather(fld, geo, oxi, oyi, cy, sy, cx, sx)

    ex, ey, ez, bx, by, bz = f_flat
    e1 = gat(ex, cyi, syi, cxh, sxh)
    e2 = gat(ey, cyh, syh, cxi, sxi)
    e3 = gat(ez, cyi, syi, cxi, sxi)
    b1 = gat(bx, cyh, syh, cxi, sxi)
    b2 = gat(by, cyi, syi, cxh, sxh)
    b3 = gat(bz, cyh, syh, cxh, sxh)

    h = c["h"]
    pxm = px + h * e1
    pym = py + h * e2
    pzm = pz + h * e3
    gi = torch.reciprocal(torch.sqrt(1.0 + pxm * pxm + pym * pym + pzm * pzm))
    tx, ty, tz = h * b1 * gi, h * b2 * gi, h * b3 * gi
    sf = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
    sxr, syr, szr = tx * sf, ty * sf, tz * sf
    ppx = pxm + (pym * tz - pzm * ty)
    ppy = pym + (pzm * tx - pxm * tz)
    ppz = pzm + (pxm * ty - pym * tx)
    pxn = pxm + (ppy * szr - ppz * syr) + h * e1
    pyn = pym + (ppz * sxr - ppx * szr) + h * e2
    pzn = pzm + (ppx * syr - ppy * sxr) + h * e3
    gn = torch.reciprocal(torch.sqrt(1.0 + pxn * pxn + pyn * pyn + pzn * pzn))
    xn = x + pxn * gn * c["dtdx"]
    yn = y + pyn * gn * c["dtdy"]
    if geo.periodic:
        x_out = _wrap(xn, c["grid_nx"], c["inv_nx"])
        y_out = _wrap(yn, c["grid_ny"], c["inv_ny"])
    else:
        x_out, y_out = xn, yn

    # Esirkepov over the union support: 4 cells from min(c0, c1) - 1.
    xi1 = _local(x_out, ox, box_x)
    eta1 = _local(y_out, oy, box_y)
    c1x, q1x3 = _support(xi1, False, nxg, g, order, quant, S)
    c1y, q1y3 = _support(eta1, False, nyg, g, order, quant, S)
    four = torch.arange(4, device=dev, dtype=p.x.dtype)
    cellx = (torch.minimum(cxi, c1x) - 1.0)[:, None] + four
    celly = (torch.minimum(cyi, c1y) - 1.0)[:, None] + four
    qw = c["q"] * w
    cz = qw * (pzn * gn) * c["cz"]
    f64 = torch.float64
    if quant:
        q0x, q1x = _place4(cellx, cxi, sxi), _place4(cellx, c1x, q1x3)
        q0y, q1y = _place4(celly, cyi, syi), _place4(celly, c1y, q1y3)
        # Integer products, exact in float64; the prefix sums too.
        jx_c = (q0y + q1y).to(f64)[:, :, None] * (q1x - q0x).to(f64)[:, None]
        jy_c = (q1y - q0y).to(f64)[:, :, None] * (q0x + q1x).to(f64)[:, None]
        czq = cz * c["czq"]
        lz0 = q0y * czq[:, None]
        lz1 = (q1y - q0y) * czq[:, None]
        rz0 = 0.5 * (q0x + q1x)
        rz1 = 0.5 * q0x + THIRD * (q1x - q0x)
        jx_c = torch.cumsum(jx_c, dim=2) * (float(c["cjx"]) * qws)
        jy_c = torch.cumsum(jy_c, dim=1) * (float(c["cjy"]) * qws)
    else:
        s0x = shape_values(xi[:, None] - cellx, order)
        s1x = shape_values(xi1[:, None] - cellx, order)
        s0y = shape_values(eta[:, None] - celly, order)
        s1y = shape_values(eta1[:, None] - celly, order)
        dsx, dsy = s1x - s0x, s1y - s0y
        by1 = (s0y + 0.5 * dsy) * (qw * c["cjx"])[:, None]
        ly1 = dsy * (qw * c["cjy"])[:, None]
        bx1 = s0x + 0.5 * dsx
        jx_c = torch.cumsum((by1[:, :, None] * dsx[:, None, :]).to(f64), 2)
        jy_c = torch.cumsum((ly1[:, :, None] * bx1[:, None, :]).to(f64), 1)
        lz0 = s0y * cz[:, None]
        lz1 = dsy * cz[:, None]
        rz0 = bx1
        rz1 = 0.5 * s0x + THIRD * dsx
    jz_c = (lz0[:, :, None] * rz0[:, None, :]
            + lz1[:, :, None] * rz1[:, None, :]).to(f64)
    rows = torch.remainder(oyi[:, None] + celly.long(), geo.ny)
    cols = torch.remainder(oxi[:, None] + cellx.long(), geo.nx)
    idx = (rows[:, :, None] * geo.nx + cols[:, None, :]).reshape(-1)
    for acc, contrib in zip(j_out, (jx_c, jy_c, jz_c)):
        acc.index_add_(0, idx, contrib.reshape(-1))
    disp = torch.maximum(torch.abs(xn - x), torch.abs(yn - y))
    dmax = disp.max() if disp.numel() else torch.zeros((), dtype=x.dtype,
                                                        device=dev)
    return Flat(tile, x_out, y_out, pxn, pyn, pzn, w), dmax


def _roll_x(a, s):
    return torch.roll(a, s, dims=1)


def _roll_y(a, s):
    return torch.roll(a, s, dims=0)


def yee(fields, js, geo: Geometry):
    """B half step, E full step with J, B half step; between absorbing walls
    the damping mask after them.  Periodic rolls, in the port's order."""
    ex, ey, ez, bx, by, bz = fields
    dt, dx, dy = geo.dt, geo.dx, geo.dy

    def b_half(ex, ey, ez, bx, by, bz):
        cx, cy = dt / (2.0 * dx), dt / (2.0 * dy)
        bx = bx - cy * (_roll_y(ez, -1) - ez)
        by = by + cx * (_roll_x(ez, -1) - ez)
        bz = bz - cx * (_roll_x(ey, -1) - ey) + cy * (_roll_y(ex, -1) - ex)
        return bx, by, bz

    bx, by, bz = b_half(ex, ey, ez, bx, by, bz)
    cx, cy = dt / dx, dt / dy
    ex2 = ex + cy * (bz - _roll_y(bz, 1))
    ey2 = ey - cx * (bz - _roll_x(bz, 1))
    ez2 = ez + cx * (by - _roll_x(by, 1)) - cy * (bx - _roll_y(bx, 1))
    if js is not None:
        jx, jy, jz = (j.to(ex.dtype) for j in js)
        ex2 = ex2 - dt * jx
        ey2 = ey2 - dt * jy
        ez2 = ez2 - dt * jz
    ex, ey, ez = ex2, ey2, ez2
    bx, by, bz = b_half(ex, ey, ez, bx, by, bz)
    out = (ex, ey, ez, bx, by, bz)
    if not geo.periodic:
        mask = damping_mask(geo, ex.dtype, ex.device)
        out = tuple(a * mask for a in out)
    return out


def damping_mask(geo: Geometry, dtype, device, strength: float = 0.02):
    def ramp(n):
        i = torch.arange(n, dtype=dtype, device=device)
        d = torch.minimum(i, n - 1 - i)
        u = torch.clamp((geo.absorb_width - d) / geo.absorb_width, 0.0, 1.0)
        return 1.0 - strength * u ** 3

    return ramp(geo.ny)[:, None] * ramp(geo.nx)[None, :]


def kill_at_walls(p: Flat, geo: Geometry) -> Flat:
    """Between absorbing walls: w = 0 for a particle off the grid, every
    position clamped into it; the killed ones leave the list."""
    inside = (p.x >= 0) & (p.x < geo.nx) & (p.y >= 0) & (p.y < geo.ny)
    x = torch.clamp(p.x, 0.0, geo.nx - 1e-3)
    y = torch.clamp(p.y, 0.0, geo.ny - 1e-3)
    return Flat(*(a[inside] for a in (p.tile, x, y, p.px, p.py, p.pz, p.w)))


def home_tile(x, y, geo: Geometry) -> torch.Tensor:
    """The tile of floor(pos * (1 / tile)), in the channels' type."""
    col = torch.floor(x * torch.tensor(1.0 / geo.tile_nx, dtype=x.dtype,
                                       device=x.device))
    row = torch.floor(y * torch.tensor(1.0 / geo.tile_ny, dtype=y.dtype,
                                       device=y.device))
    return row.long() * geo.tile_cols + col.long()


def kinetic_energy(p: Flat, mass: float) -> torch.Tensor:
    px, py, pz, w = (a.to(torch.float64) for a in (p.px, p.py, p.pz, p.w))
    p2 = px * px + py * py + pz * pz
    gamma = torch.sqrt(1.0 + p2)
    return (w * mass * (p2 / (gamma + 1.0))).sum()


def momentum(p: Flat, mass: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum w m u per axis, sum w m |u| per axis), float64 [3] each."""
    w = p.w.to(torch.float64) * mass
    us = [a.to(torch.float64) for a in (p.px, p.py, p.pz)]
    return (torch.stack([(w * u).sum() for u in us]),
            torch.stack([(w * u.abs()).sum() for u in us]))


def field_energy(fields, geo: Geometry) -> torch.Tensor:
    total = sum((c.to(torch.float64) ** 2).sum() for c in fields)
    return 0.5 * total * geo.dx * geo.dy


class Result(NamedTuple):
    """What a step produced: each species' live particles (``tile``: the
    bucket each came from), the fields and the diagnostics."""

    species: Tuple[Flat, ...]
    fields: Tuple[torch.Tensor, ...]
    field_energy: float
    kinetic: Tuple[float, ...]
    momentum: Tuple[Tuple[float, ...], ...]
    momentum_abs: Tuple[Tuple[float, ...], ...]
    live: int
    rebinned: bool
    drift: float  # accumulated drift after the step (0 after a re-bin)
    drift_now: float  # before the re-bin's reset


def step(species: Tuple[Flat, ...], fields, drift: float, deck: dict,
         modes: Tuple[str, ...], dtype=torch.float32,
         clock: Optional[Tuple[int, int]] = None) -> Result:
    """One reference step from the live particles of each species (with the
    buckets they sit in), the fields and the accumulated drift.  `modes` is
    each species' deposit ("int8", "f32" or "f64").  A moving window needs
    `clock`, the (step, window_x0) of the state stepped from."""
    from . import window  # window.py takes this module's Flat and tiles

    geo = geometry(deck)
    shifted = False
    if deck.get("moving_window"):
        if clock is None:
            raise ValueError("a moving window's step needs its clock")
        shifted = window.shift_now(clock[0], clock[1], deck)
    fields = tuple(f.to(dtype) for f in fields)
    pushed, jsum, disp = [], None, None
    for sp, mode, p in zip(deck["species"], modes, species):
        new, js, d = advance(p, fields, sp, geo, mode == "int8", dtype)
        pushed.append(new)
        jsum = js if jsum is None else tuple(a + b for a, b in zip(jsum, js))
        disp = d if disp is None else torch.maximum(disp, d)
    fields = yee(fields, jsum, geo)
    kin = tuple(float(kinetic_energy(p, sp["mass"]))
                for p, sp in zip(pushed, deck["species"]))
    moms = [momentum(p, sp["mass"]) for p, sp in zip(pushed, deck["species"])]
    if not geo.periodic:
        pushed = [kill_at_walls(p, geo) for p in pushed]
    if disp is None:
        drift_now, rebinned = float(drift), False
    else:
        # The program keeps the drift in float32 and adds each step's
        # displacement in its own type, so a float64 deck's drift is
        # float64.
        dtype_drift = torch.promote_types(torch.float32, disp.dtype)
        drift_now = (torch.tensor(drift, dtype=dtype_drift,
                                  device=disp.device) + disp.to(dtype_drift))
        thr = torch.tensor(drift_threshold(deck), dtype=dtype_drift)
        rebinned = shifted or bool(drift_now.cpu() > thr)
        drift_now = float(drift_now)
    energy = float(field_energy(fields, geo))
    live = sum(int(p.x.shape[0]) for p in pushed)
    if shifted:
        pushed, fields = window.shift(tuple(pushed), fields, deck, geo,
                                      clock[1] + geo.tile_nx, dtype)
    return Result(
        species=tuple(pushed), fields=fields, field_energy=energy,
        kinetic=kin,
        momentum=tuple(tuple(float(v) for v in m) for m, _ in moms),
        momentum_abs=tuple(tuple(float(v) for v in a) for _, a in moms),
        live=live, rebinned=rebinned,
        drift=0.0 if rebinned else drift_now, drift_now=drift_now)
