"""Single-device halo padding and its additive adjoint (periodic wrap)."""
from __future__ import annotations

import torch

from ..core.state import FieldState


def pad_block_periodic(a: torch.Tensor, g: int) -> torch.Tensor:
    """(ny, nx) -> (ny+2g, nx+2g) with periodic wrap."""
    a = torch.cat([a[:, -g:], a, a[:, :g]], dim=1)
    return torch.cat([a[-g:], a, a[:g]], dim=0)


def pad_fields_periodic(f: FieldState, g: int) -> FieldState:
    return FieldState(*(pad_block_periodic(c, g) for c in f))


def fold_block_periodic(p: torch.Tensor, g: int) -> torch.Tensor:
    """Additive adjoint of pad_block_periodic: (ny+2g, nx+2g) -> (ny, nx),
    guard-ring values wrap-added into the opposite interior edge (x first,
    then y, in the same order of additions as the JAX package)."""
    mid = p[:, g:-g].clone()
    mid[:, -g:] += p[:, :g]
    mid[:, :g] += p[:, -g:]
    out = mid[g:-g, :].clone()
    out[-g:, :] += mid[:g, :]
    out[:g, :] += mid[-g:, :]
    return out
