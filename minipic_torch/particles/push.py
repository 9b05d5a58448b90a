"""Relativistic Boris push and position advance (elementwise, any shape).

    du/dt = (q/m) (E + (u/gamma) x B),   gamma = sqrt(1 + |u|^2)
    dx/dt = u_x / gamma,  dy/dt = u_y / gamma

Positions are in global cell units; momenta in m_e c.
"""
from __future__ import annotations

from typing import Tuple

import torch


def boris_push(px, py, pz, ex, ey, ez, bx, by, bz, qm: float, dt: float):
    """u^{n-1/2} -> u^{n+1/2} with fields at time n; qm = charge/mass."""
    h = qm * dt * 0.5
    pxm = px + h * ex
    pym = py + h * ey
    pzm = pz + h * ez
    gamma_inv = 1.0 / torch.sqrt(1.0 + pxm * pxm + pym * pym + pzm * pzm)
    tx = h * bx * gamma_inv
    ty = h * by * gamma_inv
    tz = h * bz * gamma_inv
    sfac = 2.0 / (1.0 + (tx * tx + ty * ty + tz * tz))
    sx, sy, sz = tx * sfac, ty * sfac, tz * sfac
    ppx = pxm + (pym * tz - pzm * ty)
    ppy = pym + (pzm * tx - pxm * tz)
    ppz = pzm + (pxm * ty - pym * tx)
    pxp = pxm + (ppy * sz - ppz * sy)
    pyp = pym + (ppz * sx - ppx * sz)
    pzp = pzm + (ppx * sy - ppy * sx)
    return pxp + h * ex, pyp + h * ey, pzp + h * ez


def velocities(px, py, pz):
    gamma_inv = 1.0 / torch.sqrt(1.0 + px * px + py * py + pz * pz)
    return px * gamma_inv, py * gamma_inv, pz * gamma_inv


def advance_positions(x, y, px, py, pz, dt: float, dx: float,
                      dy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x^n -> x^{n+1} with u^{n+1/2}; no wrap."""
    vx, vy, _ = velocities(px, py, pz)
    return x + vx * (dt / dx), y + vy * (dt / dy)
