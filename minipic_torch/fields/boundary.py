"""Absorbing field boundaries: a damping layer (torch form of
``minipic_tpu.fields.boundary``).

Each step multiplies the fields by a mask that ramps from 1 in the interior
to 1 - strength at the wall, over `width` cells (a cubic ramp), absorbing
outgoing waves.  The mask is built once per run; applying it is one
elementwise product per component.
"""
from __future__ import annotations

import torch

from ..core.state import FieldState


def ramp(global_idx: torch.Tensor, n: int, width: int,
         strength: float) -> torch.Tensor:
    """1-D damping ramp at (possibly offset) global cell indices."""
    d = torch.minimum(global_idx, n - 1 - global_idx)  # to the nearest wall
    u = torch.clamp((width - d) / width, 0.0, 1.0)
    return 1.0 - strength * u ** 3


def damping_mask(ny: int, nx: int, width: int, strength: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device = "cuda") -> torch.Tensor:
    """(ny, nx) multiplicative mask over the whole grid."""
    ry = ramp(torch.arange(ny, dtype=dtype, device=device), ny, width,
              strength)
    rx = ramp(torch.arange(nx, dtype=dtype, device=device), nx, width,
              strength)
    return ry[:, None] * rx[None, :]


def local_damping_mask(y0: int, x0: int, ny_l: int, nx_l: int, ny: int,
                       nx: int, width: int, strength: float = 0.02,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device = "cuda") -> torch.Tensor:
    """The (ny_l, nx_l) block of the global mask whose first cell is (y0,
    x0), from the ramp at those global indices: a shard's own mask."""
    ry = ramp(y0 + torch.arange(ny_l, dtype=dtype, device=device), ny, width,
              strength)
    rx = ramp(x0 + torch.arange(nx_l, dtype=dtype, device=device), nx, width,
              strength)
    return ry[:, None] * rx[None, :]


def apply_damping(f: FieldState, mask: torch.Tensor) -> FieldState:
    return FieldState(*(c * mask for c in f))
