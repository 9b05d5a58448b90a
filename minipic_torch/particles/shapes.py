"""Particle shape functions, and their dense form over a tile axis.

The dense [..., K, n] shape matrices serve the reference functions
(``gather_chunk``, ``deposit_chunk``, ``deposit_rho_chunk``) that the tests
hold against the JAX package; the advance itself works on the 3-point
support (``ops/advance.py``).
"""
from __future__ import annotations

import torch


def shape_values(u: torch.Tensor, order: int) -> torch.Tensor:
    """B-spline shape S(u), u = particle-to-gridpoint distance in cells.
    order 1: linear (CIC, support 2); order 2: quadratic (TSC, support 3)."""
    au = torch.abs(u)
    if order == 1:
        return torch.clamp(1.0 - au, min=0.0)
    if order == 2:
        inner = 0.75 - au * au
        o = 1.5 - au
        outer = 0.5 * (o * o)
        zero = torch.zeros_like(au)
        return torch.where(au <= 0.5, inner,
                           torch.where(au <= 1.5, outer, zero))
    raise ValueError(f"unsupported shape order {order}")


def shape_matrix(pos: torch.Tensor, n: int, guard: int, offset: float,
                 order: int) -> torch.Tensor:
    """[..., K] local positions -> [..., K, n + 2*guard] with entry (k, a) =
    S(pos_k - (a - guard + offset))."""
    coords = (torch.arange(n + 2 * guard, dtype=pos.dtype, device=pos.device)
              - guard + offset)
    return shape_values(pos[..., None] - coords, order)
