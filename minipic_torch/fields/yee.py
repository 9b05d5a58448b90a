"""2-D Yee FDTD updates on global periodic (ny, nx) tensors, and on one
shard's guard-padded block (``update_*_block``).

``update_b_half_periodic`` — B^n -> B^{n+1/2} with coefficient dt/2:

    Bx -= (dt/2dy) (Ez[j+1,i] - Ez[j,i])
    By += (dt/2dx) (Ez[j,i+1] - Ez[j,i])
    Bz += -(dt/2dx)(Ey[j,i+1] - Ey[j,i]) + (dt/2dy)(Ex[j+1,i] - Ex[j,i])

``update_e_full_periodic`` — E^n -> E^{n+1} with B^{n+1/2} and J^{n+1/2}:

    Ex += (dt/dy)(Bz[j,i] - Bz[j-1,i])                          - dt Jx
    Ey -= (dt/dx)(Bz[j,i] - Bz[j,i-1])                          - dt Jy
    Ez += (dt/dx)(By[j,i] - By[j,i-1]) - (dt/dy)(Bx - Bx[j-1,i]) - dt Jz
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.state import CurrentState, FieldState


def _xp(a):  # value at (i+1)
    return torch.roll(a, -1, dims=1)


def _xm(a):  # value at (i-1)
    return torch.roll(a, 1, dims=1)


def _yp(a):  # value at (j+1)
    return torch.roll(a, -1, dims=0)


def _ym(a):  # value at (j-1)
    return torch.roll(a, 1, dims=0)


def update_b_half_periodic(f: FieldState, dt: float, dx: float,
                           dy: float) -> FieldState:
    cx = dt / (2.0 * dx)
    cy = dt / (2.0 * dy)
    bx = f.bx - cy * (_yp(f.ez) - f.ez)
    by = f.by + cx * (_xp(f.ez) - f.ez)
    bz = f.bz - cx * (_xp(f.ey) - f.ey) + cy * (_yp(f.ex) - f.ex)
    return FieldState(f.ex, f.ey, f.ez, bx, by, bz)


def update_e_full_periodic(f: FieldState, dt: float, dx: float, dy: float,
                           j: Optional[CurrentState] = None) -> FieldState:
    cx = dt / dx
    cy = dt / dy
    ex = f.ex + cy * (f.bz - _ym(f.bz))
    ey = f.ey - cx * (f.bz - _xm(f.bz))
    ez = f.ez + cx * (f.by - _xm(f.by)) - cy * (f.bx - _ym(f.bx))
    if j is not None:
        ex = ex - dt * j.jx
        ey = ey - dt * j.jy
        ez = ez - dt * j.jz
    return FieldState(ex, ey, ez, f.bx, f.by, f.bz)


# ----------------------------------------------------------------------
# Block form: the same updates on one shard's padded block (ny+2g, nx+2g),
# reading the neighbours' cells from the guard ring (parallel/step.py
# refreshes the ring between the phases).


def _int(a, g):  # the interior of a padded block
    return a[g:-g, g:-g]


def _sh(a, g, dj, di):  # the interior shifted by (dj, di), into the ring
    ny, nx = a.shape[0] - 2 * g, a.shape[1] - 2 * g
    return a[g + dj:g + dj + ny, g + di:g + di + nx]


def _set_int(a, v, g):
    out = a.clone()
    out[g:-g, g:-g] = v
    return out


def update_b_half_block(f: FieldState, g: int, dt: float, dx: float,
                        dy: float) -> FieldState:
    """B half-step on a padded block: the B interiors updated, the rings
    left stale (refresh them with an exchange)."""
    cx = dt / (2.0 * dx)
    cy = dt / (2.0 * dy)
    bx = _int(f.bx, g) - cy * (_sh(f.ez, g, 1, 0) - _int(f.ez, g))
    by = _int(f.by, g) + cx * (_sh(f.ez, g, 0, 1) - _int(f.ez, g))
    bz = (_int(f.bz, g) - cx * (_sh(f.ey, g, 0, 1) - _int(f.ey, g))
          + cy * (_sh(f.ex, g, 1, 0) - _int(f.ex, g)))
    return FieldState(f.ex, f.ey, f.ez, _set_int(f.bx, bx, g),
                      _set_int(f.by, by, g), _set_int(f.bz, bz, g))


def update_e_full_block(f: FieldState, g: int, dt: float, dx: float,
                        dy: float,
                        j: Optional[CurrentState] = None) -> FieldState:
    """E full step on a padded block with J^{n+1/2} (interior-shaped, its
    guard contributions already folded in): the E interiors updated."""
    cx = dt / dx
    cy = dt / dy
    ex = _int(f.ex, g) + cy * (_int(f.bz, g) - _sh(f.bz, g, -1, 0))
    ey = _int(f.ey, g) - cx * (_int(f.bz, g) - _sh(f.bz, g, 0, -1))
    ez = (_int(f.ez, g) + cx * (_int(f.by, g) - _sh(f.by, g, 0, -1))
          - cy * (_int(f.bx, g) - _sh(f.bx, g, -1, 0)))
    if j is not None:
        ex = ex - dt * j.jx
        ey = ey - dt * j.jy
        ez = ez - dt * j.jz
    return FieldState(_set_int(f.ex, ex, g), _set_int(f.ey, ey, g),
                      _set_int(f.ez, ez, g), f.bx, f.by, f.bz)
