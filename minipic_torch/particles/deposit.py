"""Esirkepov charge-conserving current deposition, dense reference form.

With old/new 1-D shape vectors S0, S1 on one index window and DS = S1 - S0:

    Wx[i,j] = DSx[i] (S0y[j] + DSy[j]/2)
    Wy[i,j] = DSy[j] (S0x[i] + DSx[i]/2)
    Wz[i,j] = S0y[j](S0x + DSx/2)[i] + DSy[j](S0x/2 + DSx/3)[i]

    Jx = -(q w / (dt dy)) cumsum_x Wx,  Jy = -(q w / (dt dx)) cumsum_y Wy,
    Jz = (q w vz / (dx dy)) Wz

so that (rho^{n+1} - rho^n)/dt + div_Yee J^{n+1/2} = 0 exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .shapes import shape_matrix


def deposit_chunk(xi0, eta0, xi1, eta1, vz, qw, tile_ny: int, tile_nx: int,
                  g: int, order: int, dt: float, dx: float,
                  dy: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T, kc] positions before/after the move (tile-local, unwrapped), vz
    and q*w (0 = dead) -> (jx, jy, jz) windows, each [T, nyg, nxg]."""
    s0x = shape_matrix(xi0, tile_nx, g, 0.0, order)
    s1x = shape_matrix(xi1, tile_nx, g, 0.0, order)
    s0y = shape_matrix(eta0, tile_ny, g, 0.0, order)
    s1y = shape_matrix(eta1, tile_ny, g, 0.0, order)
    dsx = s1x - s0x
    dsy = s1y - s0y

    ax = torch.cumsum(dsx, dim=-1)
    by1 = s0y + 0.5 * dsy
    coef_x = (-qw / (dt * dy))[..., None]
    jx = torch.einsum("tkj,tki->tji", by1 * coef_x, ax)

    ay = torch.cumsum(dsy, dim=-1)
    bx1 = s0x + 0.5 * dsx
    coef_y = (-qw / (dt * dx))[..., None]
    jy = torch.einsum("tkj,tki->tji", ay * coef_y, bx1)

    coef_z = (qw * vz / (dx * dy))[..., None]
    jz = (torch.einsum("tkj,tki->tji", s0y * coef_z, s0x + 0.5 * dsx)
          + torch.einsum("tkj,tki->tji", dsy * coef_z,
                         0.5 * s0x + (1.0 / 3.0) * dsx))
    return jx, jy, jz


def deposit_rho_chunk(xi, eta, qw, tile_ny: int, tile_nx: int, g: int,
                      order: int, dx: float, dy: float,
                      quantize: float = 0.0) -> torch.Tensor:
    """Charge density windows [T, nyg, nxg] at integer points.

    quantize > 0: each shape weight snaps to round(quantize*S)/quantize with
    the partition-of-unity defect folded into the centre (|u| < 0.5) cell —
    the assignment function of the int8 deposit, so continuity against an
    int8-deposited J is checked in its own ring."""
    sx = shape_matrix(xi, tile_nx, g, 0.0, order)
    sy = shape_matrix(eta, tile_ny, g, 0.0, order)
    if quantize > 0:
        def quant(s, pos, n):
            coords = torch.arange(n + 2 * g, dtype=pos.dtype,
                                  device=pos.device) - g
            u = pos[..., None] - coords
            q = torch.round(s * quantize)
            defect = quantize - q.sum(dim=-1, keepdim=True)
            center = (u >= -0.5) & (u < 0.5)
            return (q + torch.where(center, defect, torch.zeros_like(q))) \
                * (1.0 / quantize)

        sx = quant(sx, xi, tile_nx)
        sy = quant(sy, eta, tile_ny)
    coef = (qw / (dx * dy))[..., None]
    return torch.einsum("tkj,tki->tji", sy * coef, sx)
