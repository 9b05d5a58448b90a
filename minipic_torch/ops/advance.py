"""The particle advance: gather + relativistic Boris push + move (+ periodic
wrap) + Esirkepov deposit, one pass over each tile's bucket.  ``grid=(nx,
ny)`` is the periodic box; ``grid=None`` the open mode of decks with
absorbing walls (raw tile-local offsets, the move stored unwrapped), as the
JAX kernel's ``wrap=None, grid=None``.

Port of ``minipic_tpu.ops.pallas.ppd_kernel.fused_push_deposit``.  Two
implementations of one function, ``advance_tiles``:

* ``csrc/advance.cu`` — the hand-written CUDA kernel, launched for CUDA
  tensors (one thread block per tile; the int8 deposit as products on the
  tensor cores, the f32 and f64 deposits into per-warp J windows, see the
  note in that file);
* ``advance_plain`` — the same arithmetic as plain torch ops, over each
  particle's 3-point support.  ``advance_tiles`` takes it only for CPU
  tensors; ``chip_smoke.py`` holds the kernel against it on the card.

Both evaluate, per live slot (slot < counts[t] and w != 0; every other slot
passes through untouched), with tile t's origin in global cells taken from
``origins = (ox, oy)``, int32 [T] (the TPU kernel's scalar-prefetch origins:
the row-major grid on one device, ``simulation.tile_origins``; a shard's
block or its striped tiles under the multi-device simulations):

1. tile-local coordinates: with the nearest-image fold on a periodic box
   (reciprocal multiply, as ``simulation.tile_local_coords``), the raw
   offset x - ox in the open mode;
2. shape values on the 3-cell support of both stagger classes — f32 and
   f64 modes evaluate the B-spline at each cell; int8 mode takes the quantized
   values round(S*s) with the partition fold into the centre cell and the
   window-edge fold (``_qsparse_vals``/``_edge_fold`` of the JAX kernel);
3. the six-component gather (in int8 mode 1/S^2 is folded into the push's
   half-kick coefficient h);
4. Boris, the move, and the two-edge periodic wrap of the stored position
   (the open mode stores the move as it is);
5. s1 shapes from the STORED position through the same ops as
   the next step's s0, so the shape chain telescopes bit-exactly;
6. the raw Esirkepov contractions over the union support (<= 4x4 cells):
   jx ~ (s0y + dsy/2) dsx and jy ~ dsy (s0x + dsx/2) before their prefix
   sums, jz complete.  In int8 mode jx/jy are sums of integer products
   (exact in any order) scaled by -1/(2 S^2 dt d{y,x}).

Both sides use one reciprocal-square-root expression, ``1/sqrt``, and the
CUDA build contracts no multiply-add.  On an H100 the kernel's particles
agree with the plain version's to 1-2 ulp of the momenta (<= 2e-8
absolute at the headline deck), int8 jx/jy cell for cell (integer sums,
exact in any order), int8 jz to its f32 summation order (the kernel's runs
on the tensor cores with each row factor in three bf16 words), and f32- and
f64-mode J to their summation order (shuffle trees, per-warp windows and a
fixed-order sum of them; atomics lane by lane and in shared windows).

Modes (``resolve_mode``): "int8" and "f32" take float32 particles and
fields; "f64", every deck of precision "f64", takes float64 ones and is the
f32 mode's arithmetic in double: the exact Esirkepov deposit that the JAX
package's f64 runs take (its XLA branch), whatever the deck's deposit.

``fused_push_deposit`` then applies, in torch, what the JAX wrapper applies
after its ``pallas_call``: the uniform q*max(w) scale of int8 jx/jy and the
x/y prefix sums.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.state import FieldState, ParticleState
from ..particles.shapes import shape_values

_THIRD = 1.0 / 3.0
# Slots per block of tiles in the plain version (see advance_plain).
_PLAIN_BLOCK_SLOTS = 1 << 22
# Shared memory one block of the kernel may use on Hopper (227 KB).
_SMEM_LIMIT = 232448


# Warps of a block of csrc/advance.cu, and the warps that may share one
# set of J windows in its f32 and f64 modes, fewest first; the staging of
# one warp's terms with private sets (48 terms x 33 values: kTerms x
# kStage).
_WARPS = 8
_WIN_WARPS = (1, 2, 4, 8)
_STAGE_VALUES = 48 * 33


def kernel_smem_bytes(nyg: int, nxg: int, mode: str,
                      win_warps: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of csrc/advance.cu: six field
    windows and, for each set of J windows, three more, of 4 bytes a cell
    (8 in f64 mode).  f32 and f64: one set for each `win_warps` warps
    (default: ``window_warps``'s choice), so 8 // win_warps sets, and at 1
    each warp's staging of its lanes' terms (6,336 bytes a warp in f32,
    12,672 in f64); int8: one set, and each of its 8 warps' operand
    staging (9 KB of rows, 3 KB per pair of 8-column tiles: 1, 2 or 4
    pairs)."""
    cells = nyg * nxg
    if mode == "int8":
        pairs = 1 if nxg <= 16 else (2 if nxg <= 32 else 4)
        return 36 * cells + _WARPS * (9216 + 3072 * pairs)
    if win_warps is None:
        win_warps = window_warps(nyg, nxg, mode)
    real = 8 if mode == "f64" else 4
    stage = _WARPS * _STAGE_VALUES if win_warps == 1 else 0
    return real * (cells * (6 + 3 * (_WARPS // win_warps)) + stage)


def window_warps(nyg: int, nxg: int, mode: str) -> int:
    """How many warps of a block share one set of J windows in the f32 and
    f64 modes: the fewest of 1, 2, 4, 8 whose layout fits a block's shared
    memory (8 where none does: the wrapper then refuses the window).  With
    1 each warp adds to its own windows without atomics (f32 up to 1,514
    cells, f64 up to 546: every deck's window with particles, 16^2 and
    20^2); shared sets add with atomics.  int8 keeps its one set (8)."""
    if mode == "int8":
        return _WARPS
    for w in _WIN_WARPS:
        if kernel_smem_bytes(nyg, nxg, mode, w) <= _SMEM_LIMIT:
            return w
    return _WARPS


def qshape_scale(order: int) -> float:
    """Shape-quantization scale S of the int8 deposit: the largest S with
    2*(round(S*smax) + 1) <= 127 — TSC (smax 0.75) 83, CIC (smax 1) 62."""
    return 83.0 if order == 2 else 62.0


def resolve_mode(deposit: str, qw0: float, tile_ny: int, tile_nx: int,
                 g: int, dtype: torch.dtype = torch.float32) -> str:
    """Deposit mode from the deck.  A float64 deck is "f64", whatever
    `deposit` asks: the JAX package runs every deck that is not f32 on its
    XLA branch (``minipic_tpu/simulation.py:297-305``), whose deposit is
    exact.  A float32 deck resolves as the JAX kernel does
    (ppd_kernel.py:1016-1038): "int8" needs a uniform-weight species (qw0
    != 0) and the window the JAX package's fused gather admits; else
    "f32"."""
    if deposit not in ("", "highest", "int8"):
        raise NotImplementedError(f"deposit mode {deposit!r}")
    if dtype == torch.float64:
        return "f64"
    if dtype != torch.float32:
        raise NotImplementedError(f"particles of {dtype}")
    nyg, nxg = tile_ny + 2 * g, tile_nx + 2 * g
    window_ok = 6 * nyg <= 128 and 2 * nxg <= 128 and nyg % 8 == 0
    if deposit == "int8" and qw0 != 0.0 and window_ok:
        return "int8"
    return "f32"


_INT_PARAMS = ("num_tiles", "capacity", "tile_nx", "tile_ny", "guard",
               "periodic", "win_warps")
_REAL_PARAMS = ("h", "dtdx", "dtdy", "q", "grid_nx", "grid_ny", "inv_nx",
                "inv_ny", "half_x", "half_y", "cjx", "cjy", "cz", "czq",
                "S")


class AdvanceParams(ctypes.Structure):
    """Mirror of ``AdvanceParams`` (``AdvanceParamsT<float>``) in
    csrc/advance.cu (passed by value).  Float constants are folded in
    double on the host and rounded once, as the JAX kernel's Python-float
    constants are."""

    _fields_ = ([(n, ctypes.c_int) for n in _INT_PARAMS]
                + [(n, ctypes.c_float) for n in _REAL_PARAMS])


class AdvanceParams64(ctypes.Structure):
    """Mirror of ``AdvanceParams64`` (``AdvanceParamsT<double>``): the f64
    mode's constants, in double."""

    _fields_ = ([(n, ctypes.c_int) for n in _INT_PARAMS]
                + [(n, ctypes.c_double) for n in _REAL_PARAMS])


# Each mode's real type, and its code in minipic_advance_blocks_per_sm.
MODE_DTYPES = {"f32": torch.float32, "int8": torch.float32,
               "f64": torch.float64}
_MODE_CODES = {"f32": 0, "int8": 1, "f64": 2}


def _constants(*, qm, q, order, tile_ny, tile_nx, dt, dx, dy, grid, mode):
    """Python-float constants shared by both implementations; the box
    constants are 0 in the open mode (grid None), where nothing reads
    them."""
    S = qshape_scale(order)
    h = qm * dt * 0.5
    if mode == "int8":
        h = h * (1.0 / (S * S))
        inv2 = 1.0 / (2.0 * S * S)
        cjx, cjy = -inv2 / (dt * dy), -inv2 / (dt * dx)
    else:
        cjx, cjy = -1.0 / (dt * dy), -1.0 / (dt * dx)
    if grid is None:
        box = dict(grid_nx=0.0, grid_ny=0.0, inv_nx=0.0, inv_ny=0.0,
                   half_x=0.0, half_y=0.0)
    else:
        gnx, gny = grid
        box = dict(grid_nx=float(gnx), grid_ny=float(gny),
                   inv_nx=1.0 / gnx, inv_ny=1.0 / gny,
                   half_x=(gnx - tile_nx) * 0.5, half_y=(gny - tile_ny) * 0.5)
    return dict(
        h=h, dtdx=dt / dx, dtdy=dt / dy, q=q, **box,
        cjx=cjx, cjy=cjy, cz=1.0 / (dx * dy), czq=1.0 / (S * S), S=S,
    )


# ----------------------------------------------------------------------
# Plain torch version.


def _f(v, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d tensor of `like`'s dtype, so it is rounded
    once (as the kernel's float parameter is)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _fold(pos, origin, gn, half, inv):
    xi = pos - origin
    return xi - gn * torch.floor((xi + half) * inv)


def _local(pos, origin, box):
    """Tile-local coordinate: the nearest-image fold with `box` = (n, (n -
    tile)/2, 1/n), or the raw offset for `box` None (the open mode)."""
    return pos - origin if box is None else _fold(pos, origin, *box)


def _support(pos, half: bool, n_rows: int, g: int, order: int, quant: bool,
             S):
    """Centre cell (float) and the 3 support values at cells c-1, c, c+1."""
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


def _gather(f_flat, base, cy, sy, cx, sx, g, nyg, nxg):
    """sum_j sy[j] * (sum_i F[row j, col i] * sx[i]), off-window cells
    adding exact zeros — the kernel's loop order."""
    e = None
    cyl, cxl = cy.long(), cx.long()
    for j in range(3):
        r = cyl + (j - 1 + g)
        rv = (r >= 0) & (r < nyg)
        m = None
        for i in range(3):
            col = cxl + (i - 1 + g)
            v = rv & (col >= 0) & (col < nxg)
            idx = base + r.clamp(0, nyg - 1) * nxg + col.clamp(0, nxg - 1)
            term = torch.where(v, f_flat[idx] * sx[i], torch.zeros_like(sx[i]))
            m = term if m is None else m + term
        term = m * sy[j]
        e = term if e is None else e + term
    return e


def _place4(cells, c, vals):
    """Sparse 3-point values at centre c, laid on the 4 cells `cells`."""
    d = cells - c[:, None]
    z = torch.zeros_like(d)
    qm, qc, qp = (v[:, None] for v in vals)
    return torch.where(d == -1.0, qm, torch.where(
        d == 0.0, qc, torch.where(d == 1.0, qp, z)))


def advance_plain(p: ParticleState, ftiles: FieldState, counts: torch.Tensor,
                  *, qm: float, q: float, order: int, tile_ny: int,
                  tile_nx: int, origins: Tuple[torch.Tensor, torch.Tensor],
                  g: int, dt: float, dx: float, dy: float,
                  grid: Optional[Tuple[int, int]], mode: str):
    """Plain torch version of the advance kernel (any device); `grid` None
    is the open mode.

    Returns (x, y, px, py, pz) new tensors [T, cap], the raw windows
    (jx, jy, jz) [T, nyg, nxg] before the int8 q*max(w) scale and the
    prefix sums, and the per-tile max displacement [T] (cells).  Tiles are
    independent, so it works through blocks of ~2^22 slots: that bounds
    its temporaries and lets it run at the headline size on the card."""
    T, cap = p.x.shape
    k = _constants(qm=qm, q=q, order=order, tile_ny=tile_ny, tile_nx=tile_nx,
                   dt=dt, dx=dx, dy=dy, grid=grid, mode=mode)
    c32 = {n: _f(v, p.x) for n, v in k.items()}
    step = max(1, _PLAIN_BLOCK_SLOTS // cap)
    ox, oy = origins
    parts = [
        _advance_block(ParticleState(*(a[t0:t0 + step] for a in p)),
                       FieldState(*(a[t0:t0 + step] for a in ftiles)),
                       counts[t0:t0 + step],
                       (ox[t0:t0 + step], oy[t0:t0 + step]), c32,
                       order=order, tile_ny=tile_ny, tile_nx=tile_nx, g=g,
                       quant=mode == "int8", periodic=grid is not None)
        for t0 in range(0, T, step)]
    if len(parts) == 1:
        return parts[0]
    outs = tuple(torch.cat(c) for c in zip(*(o for o, _, _ in parts)))
    js = tuple(torch.cat(c) for c in zip(*(j for _, j, _ in parts)))
    return outs, js, torch.cat([d for _, _, d in parts])


def _advance_block(p: ParticleState, ftiles: FieldState, counts: torch.Tensor,
                   origins, c32, *, order: int, tile_ny: int, tile_nx: int,
                   g: int, quant: bool, periodic: bool):
    """advance_plain on the block of tiles that `p` holds, with their
    origins."""
    T, cap = p.x.shape
    dev = p.x.device
    nyg, nxg = tile_ny + 2 * g, tile_nx + 2 * g
    nwin = nyg * nxg
    S = c32["S"]

    slot = torch.arange(cap, device=dev)
    live = (slot[None, :] < counts[:, None].to(torch.int64)) & (p.w != 0)
    t_idx, s_idx = live.nonzero(as_tuple=True)
    x, y, px, py, pz, w = (a[t_idx, s_idx] for a in p)
    ox = origins[0][t_idx].to(p.x.dtype)
    oy = origins[1][t_idx].to(p.x.dtype)
    box_x = (c32["grid_nx"], c32["half_x"], c32["inv_nx"]) if periodic \
        else None
    box_y = (c32["grid_ny"], c32["half_y"], c32["inv_ny"]) if periodic \
        else None
    xi = _local(x, ox, box_x)
    eta = _local(y, oy, box_y)

    cxi, sxi = _support(xi, False, nxg, g, order, quant, S)
    cxh, sxh = _support(xi, True, nxg, g, order, quant, S)
    cyi, syi = _support(eta, False, nyg, g, order, quant, S)
    cyh, syh = _support(eta, True, nyg, g, order, quant, S)
    base = t_idx * nwin

    def gat(fld, cy, sy, cx, sx):
        return _gather(fld.reshape(-1), base, cy, sy, cx, sx, g, nyg, nxg)

    e1 = gat(ftiles.ex, cyi, syi, cxh, sxh)
    e2 = gat(ftiles.ey, cyh, syh, cxi, sxi)
    e3 = gat(ftiles.ez, cyi, syi, cxi, sxi)
    b1 = gat(ftiles.bx, cyh, syh, cxi, sxi)
    b2 = gat(ftiles.by, cyi, syi, cxh, sxh)
    b3 = gat(ftiles.bz, cyh, syh, cxh, sxh)

    h = c32["h"]
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
    xn = x + pxn * gn * c32["dtdx"]
    yn = y + pyn * gn * c32["dtdy"]

    def wrap(v, n, inv):
        vw = v - n * torch.floor(v * inv)
        vw = torch.where(vw < 0, vw + n, vw)
        return torch.where(vw >= n, vw - n, vw)

    if periodic:
        x_out = wrap(xn, c32["grid_nx"], c32["inv_nx"])
        y_out = wrap(yn, c32["grid_ny"], c32["inv_ny"])
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
    qw = c32["q"] * w
    cz = qw * (pzn * gn) * c32["cz"]

    if quant:
        q0x, q1x = _place4(cellx, cxi, sxi), _place4(cellx, c1x, q1x3)
        q0y, q1y = _place4(celly, cyi, syi), _place4(celly, c1y, q1y3)
        # Integer-ring products, exact in float64 below 2^53.
        d = torch.float64
        jx_c = (q0y + q1y).to(d)[:, :, None] * (q1x - q0x).to(d)[:, None, :]
        jy_c = (q1y - q0y).to(d)[:, :, None] * (q0x + q1x).to(d)[:, None, :]
        czq = cz * c32["czq"]
        lz0 = q0y * czq[:, None]
        lz1 = (q1y - q0y) * czq[:, None]
        rz0 = 0.5 * (q0x + q1x)
        rz1 = 0.5 * q0x + _THIRD * (q1x - q0x)
    else:
        s0x = shape_values(xi[:, None] - cellx, order)
        s1x = shape_values(xi1[:, None] - cellx, order)
        s0y = shape_values(eta[:, None] - celly, order)
        s1y = shape_values(eta1[:, None] - celly, order)
        dsx, dsy = s1x - s0x, s1y - s0y
        by1 = (s0y + 0.5 * dsy) * (qw * c32["cjx"])[:, None]
        ly1 = dsy * (qw * c32["cjy"])[:, None]
        bx1 = s0x + 0.5 * dsx
        jx_c = by1[:, :, None] * dsx[:, None, :]
        jy_c = ly1[:, :, None] * bx1[:, None, :]
        lz0 = s0y * cz[:, None]
        lz1 = dsy * cz[:, None]
        rz0 = bx1
        rz1 = 0.5 * s0x + _THIRD * dsx
    jz_c = (lz0[:, :, None] * rz0[:, None, :]
            + lz1[:, :, None] * rz1[:, None, :])

    rows = celly.long() + g
    cols = cellx.long() + g
    ok = (((rows >= 0) & (rows < nyg))[:, :, None]
          & ((cols >= 0) & (cols < nxg))[:, None, :])
    idx = (base[:, None, None] + rows.clamp(0, nyg - 1)[:, :, None] * nxg
           + cols.clamp(0, nxg - 1)[:, None, :])
    idx = torch.where(ok, idx, torch.zeros_like(idx)).reshape(-1)

    def acc(contrib):
        contrib = torch.where(ok, contrib, torch.zeros_like(contrib))
        out = torch.zeros(T * nwin, dtype=contrib.dtype, device=dev)
        out.index_add_(0, idx, contrib.reshape(-1))
        return out.reshape(T, nyg, nxg)

    jx, jy, jz = acc(jx_c), acc(jy_c), acc(jz_c)
    if quant:
        jx = jx.to(p.x.dtype) * c32["cjx"]
        jy = jy.to(p.x.dtype) * c32["cjy"]

    disp = torch.maximum(torch.abs(xn - x), torch.abs(yn - y))
    dmax = torch.zeros(T, dtype=p.x.dtype, device=dev)
    dmax.scatter_reduce_(0, t_idx, disp, reduce="amax", include_self=True)

    outs = []
    for old, new in zip(p[:5], (x_out, y_out, pxn, pyn, pzn)):
        o = old.clone()
        o[t_idx, s_idx] = new
        outs.append(o)
    return tuple(outs), (jx, jy, jz), dmax


# ----------------------------------------------------------------------
# CUDA kernel wrapper.


class AdvanceKernel:
    """Launches csrc/advance.cu (or the copy at `src`); ``launches`` counts
    kernel launches."""

    def __init__(self, src=None):
        self.launches = 0
        self._src = src
        self._lib = None

    def _load(self):
        if self._lib is None:
            from ._build import build

            built = build("advance.cu" if self._src is None else self._src)
            lib = ctypes.CDLL(str(built.path))
            fn = lib.minipic_advance
            fn.argtypes = ([ctypes.c_int, ctypes.c_int, AdvanceParams]
                           + [ctypes.c_void_p] * 25)
            fn.restype = ctypes.c_int
            fn = lib.minipic_advance_f64
            fn.argtypes = ([ctypes.c_int, AdvanceParams64]
                           + [ctypes.c_void_p] * 25)
            fn.restype = ctypes.c_int
            occ = lib.minipic_advance_blocks_per_sm
            occ.argtypes = [ctypes.c_int] * 5
            occ.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def blocks_per_sm(self, order: int, mode: str, nyg: int,
                      nxg: int) -> int:
        """Resident blocks per SM of the periodic kernel launched for this
        window, at the J window sets it takes (``window_warps``): the CUDA
        occupancy calculator's answer, from registers and shared memory."""
        n = self._load().minipic_advance_blocks_per_sm(
            order, _MODE_CODES[mode], nyg, nxg, window_warps(nyg, nxg, mode))
        if n < 0:
            raise RuntimeError("advance kernel: occupancy query failed")
        return n

    def __call__(self, p: ParticleState, ftiles: FieldState,
                 counts: torch.Tensor, *, qm, q, order, tile_ny, tile_nx,
                 origins, g, dt, dx, dy, grid, mode):
        T, cap = p.x.shape
        nyg, nxg = tile_ny + 2 * g, tile_nx + 2 * g
        dev = p.x.device
        if order not in (1, 2) or mode not in MODE_DTYPES:
            raise ValueError(f"order {order} / mode {mode!r} not built")
        real = MODE_DTYPES[mode]
        for name, a in zip(ParticleState._fields, p):
            _check(a, name, real, (T, cap), dev)
        for name, a in zip(FieldState._fields, ftiles):
            _check(a, name, real, (T, nyg, nxg), dev)
        _check(counts, "counts", torch.int32, (T,), dev)
        ox, oy = origins
        _check(ox, "ox", torch.int32, (T,), dev)
        _check(oy, "oy", torch.int32, (T,), dev)
        if mode == "int8" and (nyg not in (8, 16) or nxg > 64):
            raise ValueError(f"int8 window {nyg}x{nxg}: the tensor-core "
                             "deposit takes nyg 8 or 16 and nxg <= 64")
        if kernel_smem_bytes(nyg, nxg, mode) > _SMEM_LIMIT:
            raise ValueError(f"window {nyg}x{nxg} needs more than the "
                             f"{_SMEM_LIMIT} bytes of shared memory a block "
                             "may use")
        lib = self._load()
        k = _constants(qm=qm, q=q, order=order, tile_ny=tile_ny,
                       tile_nx=tile_nx, dt=dt, dx=dx, dy=dy, grid=grid,
                       mode=mode)
        params = (AdvanceParams64 if mode == "f64" else AdvanceParams)(
            num_tiles=T, capacity=cap, tile_nx=tile_nx, tile_ny=tile_ny,
            guard=g, periodic=int(grid is not None),
            win_warps=window_warps(nyg, nxg, mode), **k)
        outs = tuple(torch.empty_like(a) for a in p[:5])
        js = tuple(torch.empty((T, nyg, nxg), dtype=real, device=dev)
                   for _ in range(3))
        dmax = torch.empty(T, dtype=real, device=dev)
        ptrs = ([a.data_ptr() for a in p]
                + [counts.data_ptr(), ox.data_ptr(), oy.data_ptr()]
                + [a.data_ptr() for a in ftiles]
                + [a.data_ptr() for a in outs + js] + [dmax.data_ptr()])
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "f64":
            err = lib.minipic_advance_f64(order, params, *ptrs, stream)
        else:
            err = lib.minipic_advance(order, int(mode == "int8"), params,
                                      *ptrs, stream)
        if err != 0:
            raise RuntimeError(f"advance kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return outs, js, dmax


def _check(a: torch.Tensor, name: str, dtype, shape, device):
    if a.device != device or a.dtype != dtype or tuple(a.shape) != shape \
            or not a.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {shape} on {device}, got "
            f"{a.dtype} {tuple(a.shape)} on {a.device} "
            f"(contiguous={a.is_contiguous()})")


advance_kernel = AdvanceKernel()


def advance_tiles(p: ParticleState, ftiles: FieldState, counts: torch.Tensor,
                  **kw):
    """The advance on whichever device `p` lies: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if p.x.is_cuda:
        return advance_kernel(p, ftiles, counts, **kw)
    if p.x.device.type != "cpu":
        raise ValueError(f"no advance for device {p.x.device}")
    return advance_plain(p, ftiles, counts, **kw)


def live_watermark(w: torch.Tensor) -> torch.Tensor:
    """Per-tile occupancy watermark: highest live slot + 1 (int32 [T])."""
    slot = torch.arange(1, w.shape[1] + 1, device=w.device, dtype=torch.int32)
    return (slot[None, :] * (w > 0).to(torch.int32)).amax(dim=1)


def fused_push_deposit(p: ParticleState, ftiles: FieldState,
                       counts: torch.Tensor, *, qm: float, q: float,
                       order: int, tile_ny: int, tile_nx: int,
                       origins: Tuple[torch.Tensor, torch.Tensor], g: int,
                       dt: float, dx: float, dy: float,
                       grid: Optional[Tuple[int, int]], mode: str):
    """The advance with the JAX wrapper's epilogue.  Returns (pushed
    ParticleState, its positions wrapped on a periodic `grid` and unwrapped
    in the open mode (grid None), (jx, jy, jz) [T, nyg, nxg], max
    displacement this step in cells as a 0-d tensor)."""
    (xo, yo, pxo, pyo, pzo), (jx, jy, jz), dmax = advance_tiles(
        p, ftiles, counts, qm=qm, q=q, order=order, tile_ny=tile_ny,
        tile_nx=tile_nx, origins=origins, g=g, dt=dt, dx=dx, dy=dy,
        grid=grid, mode=mode)
    if mode == "int8":
        qws = _f(q, p.w) * p.w.max()
        jx = jx * qws
        jy = jy * qws
    jx = torch.cumsum(jx, dim=-1)
    jy = torch.cumsum(jy, dim=-2)
    return ParticleState(xo, yo, pxo, pyo, pzo, p.w), (jx, jy, jz), dmax.max()
