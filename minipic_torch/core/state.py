"""Simulation state as NamedTuples of torch tensors.

Same layout as ``minipic_tpu.core.state``:

* ``FieldState`` — six global ``(ny, nx)`` tensors (row ``j`` = y, col
  ``i`` = x).  Guard cells are not state; halos are built per step.
* ``ParticleState`` — fixed-capacity ``(num_tiles, capacity)`` buffers per
  species.  Positions are in global cell units (x in [0, nx)); a slot is
  dead iff ``w == 0``.

The diagnostics accumulate in float64 whatever the state's dtype; CUDA
tensors take the kernels of ``ops/diag.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

FIELD_NAMES = ("ex", "ey", "ez", "bx", "by", "bz")


class FieldState(NamedTuple):
    """E and B on the Yee grid, both at the same integer time level."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor

    @classmethod
    def zeros(cls, ny: int, nx: int, dtype: torch.dtype,
              device: torch.device) -> "FieldState":
        return cls(*(torch.zeros((ny, nx), dtype=dtype, device=device)
                     for _ in range(6)))


class CurrentState(NamedTuple):
    """Current density J at the half time step (Yee E-point staggering)."""

    jx: torch.Tensor
    jy: torch.Tensor
    jz: torch.Tensor


class ParticleState(NamedTuple):
    """One species' particles in tile-bucketed, fixed-capacity layout.

    All tensors are ``(num_tiles, capacity)``, tile axis in row-major
    global tile-ID order.  ``w == 0`` marks an empty slot."""

    x: torch.Tensor
    y: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    w: torch.Tensor

    @property
    def num_tiles(self) -> int:
        return self.x.shape[0]

    @property
    def capacity(self) -> int:
        return self.x.shape[1]

    def alive_count(self) -> torch.Tensor:
        return (self.w > 0).sum(dtype=torch.int64)


class SimState(NamedTuple):
    """Fields + one ParticleState per species + the step counter, the drift
    accumulated since the last re-bin (cells, float32 0-d tensor) and, for
    a moving-window deck, the window's origin in absolute cells (int32 0-d,
    a multiple of tile_nx; None for every other deck)."""

    fields: FieldState
    species: tuple
    step: torch.Tensor
    drift: Optional[torch.Tensor] = None
    window_x0: Optional[torch.Tensor] = None


def field_energy(f: FieldState, dx: float, dy: float) -> torch.Tensor:
    """Total EM energy (1/2) ∫ (E² + B²) dA, accumulated in float64: on the
    card the census kernel (``ops/diag.py``), elsewhere
    ``field_energy_plain``."""
    if f.ex.is_cuda:
        from ..ops.diag import census_kernel

        return census_kernel((), fields=f, dx=dx, dy=dy).field_energy
    return field_energy_plain(f, dx, dy)


def kinetic_energy(p: ParticleState, mass: float) -> torch.Tensor:
    """Total kinetic energy Σ w m (γ - 1), in float64: on the card the
    moments kernel (``ops/diag.py``), elsewhere ``kinetic_energy_plain``."""
    if p.w.is_cuda:
        from ..ops.diag import moments_kernel

        return moments_kernel(p, mass)[0]
    return kinetic_energy_plain(p, mass)


def momentum_sum(p: ParticleState, mass: float) -> torch.Tensor:
    """Total momentum Σ w m u per axis, float64 [3]: on the card the moments
    kernel (``ops/diag.py``), elsewhere ``momentum_sum_plain``."""
    if p.w.is_cuda:
        from ..ops.diag import moments_kernel

        return moments_kernel(p, mass)[1]
    return momentum_sum_plain(p, mass)


def field_energy_plain(f: FieldState, dx: float, dy: float) -> torch.Tensor:
    """``field_energy`` in plain torch, on any device."""
    total = sum((c.to(torch.float64) ** 2).sum() for c in f)
    return 0.5 * total * dx * dy


def kinetic_energy_plain(p: ParticleState, mass: float) -> torch.Tensor:
    """``kinetic_energy`` in plain torch, on any device, with γ - 1 taken as
    p²/(γ+1): the naive form loses ~3 digits at thermal momenta."""
    px, py, pz, w = (a.to(torch.float64) for a in (p.px, p.py, p.pz, p.w))
    p2 = px * px + py * py + pz * pz
    gamma = torch.sqrt(1.0 + p2)
    return (w * mass * (p2 / (gamma + 1.0))).sum()


def momentum_sum_plain(p: ParticleState, mass: float) -> torch.Tensor:
    """``momentum_sum`` in plain torch, on any device."""
    w = p.w.to(torch.float64) * mass
    return torch.stack([(w * a.to(torch.float64)).sum()
                        for a in (p.px, p.py, p.pz)])
