"""2-D Yee FDTD updates on global periodic (ny, nx) tensors.

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
