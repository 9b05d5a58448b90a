"""Field gather (interpolation to particle positions), dense reference form.

With separable shapes S(x,y) = Sx(x) Sy(y), the value of field F at
particle k is  sum_{j,i} Sy_k[j] F[j,i] Sx_k[i].

Yee stagger classes (core/geometry.STAGGER):
  ex, by : x half,    y integer
  bz     : x half,    y half
  ey, bx : x integer, y half
  ez     : x integer, y integer
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import FieldState
from .shapes import shape_matrix


class GatheredFields(NamedTuple):
    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor


def gather_chunk(ftiles: FieldState, xi: torch.Tensor, eta: torch.Tensor,
                 tile_ny: int, tile_nx: int, g: int,
                 order: int) -> GatheredFields:
    """ftiles: [T, nyg, nxg] windows; xi, eta: [T, kc] tile-local cell
    coordinates.  Returns six [T, kc] tensors."""
    sx_h = shape_matrix(xi, tile_nx, g, 0.5, order)  # [T, kc, nxg]
    sx_i = shape_matrix(xi, tile_nx, g, 0.0, order)
    sy_h = shape_matrix(eta, tile_ny, g, 0.5, order)  # [T, kc, nyg]
    sy_i = shape_matrix(eta, tile_ny, g, 0.0, order)

    def comp(f, sx, sy):
        m = torch.einsum("tki,tji->tkj", sx, f)  # [T, kc, nyg]
        return (m * sy).sum(dim=-1)

    return GatheredFields(
        ex=comp(ftiles.ex, sx_h, sy_i),
        ey=comp(ftiles.ey, sx_i, sy_h),
        ez=comp(ftiles.ez, sx_i, sy_i),
        bx=comp(ftiles.bx, sx_i, sy_h),
        by=comp(ftiles.by, sx_h, sy_i),
        bz=comp(ftiles.bz, sx_h, sy_h),
    )
