"""On-device diagnostics: phase-space histograms, energy and field
spectra, charge density and current moments (the port's own copy of
``minipic_tpu.diag.device``).  Each is computed where the particles are,
so a diagnostic ships a few KB to the host instead of the particle state.

Histograms are scatter-adds into a zero tensor of fixed size: no
``torch.bincount``, which reads its input's range to the host on CUDA.
Dead slots (w == 0) add zero weight to bin 0.  Bin indices truncate
toward zero, as the JAX package's ``astype(int32)`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.state import ParticleState

_AXES = {"x": 0, "y": 1, "px": 2, "py": 3, "pz": 4}


def _component(p: ParticleState, name: str) -> torch.Tensor:
    return p[_AXES[name]]


def _scatter(n: int, idx: torch.Tensor, live: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """[n] weighted histogram of flat bin indices; dead slots add zero to
    bin 0."""
    idx = torch.where(live, idx, torch.zeros_like(idx)).to(torch.int64)
    return torch.zeros(n, dtype=w.dtype, device=w.device).scatter_add_(
        0, idx, torch.where(live, w, torch.zeros_like(w)))


def _bin(a, lo, hi, n: int) -> torch.Tensor:
    return torch.clamp(((a - lo) / (hi - lo) * n).to(torch.int32), 0, n - 1)


def phase_space_hist(
    p: ParticleState,
    ax0: str = "x",
    ax1: str = "px",
    bins: Tuple[int, int] = (64, 64),
    range0: Optional[Tuple[float, float]] = None,
    range1: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted 2-D phase-space histogram, e.g. (x, px) for two-stream
    vortices.  Axis names: x, y (cell units), px, py, pz (m_e c).  Returns
    (hist [bins0, bins1], edges0, edges1).  A range left None is the live
    particles' extent, padded by 1e-6 of it (computed on the device)."""
    a0 = _component(p, ax0).reshape(-1)
    a1 = _component(p, ax1).reshape(-1)
    w = p.w.reshape(-1)
    live = w > 0

    def _range(a, rng):
        if rng is not None:
            return (torch.tensor(rng[0], dtype=a.dtype, device=a.device),
                    torch.tensor(rng[1], dtype=a.dtype, device=a.device))
        big = torch.finfo(a.dtype).max
        lo = torch.where(live, a, torch.full_like(a, big)).min()
        hi = torch.where(live, a, torch.full_like(a, -big)).max()
        pad = 1e-6 * (hi - lo) + 1e-12
        return lo - pad, hi + pad

    lo0, hi0 = _range(a0, range0)
    lo1, hi1 = _range(a1, range1)
    n0, n1 = bins
    flat = _bin(a0, lo0, hi0, n0) * n1 + _bin(a1, lo1, hi1, n1)
    hist = _scatter(n0 * n1, flat, live, w)
    edges0 = lo0 + (hi0 - lo0) * torch.arange(n0 + 1, device=w.device) / n0
    edges1 = lo1 + (hi1 - lo1) * torch.arange(n1 + 1, device=w.device) / n1
    return hist.reshape(n0, n1), edges0, edges1


def energy_spectrum(
    p: ParticleState, mass: float, bins: int = 64,
    emax: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted kinetic-energy spectrum dN/dE over m(gamma - 1) in
    [0, emax] (the live particles' largest energy by default).

    gamma is the square root taken in float64 and rounded back to the
    particles' type, which is the correctly rounded root (double rounding
    is innocuous for a square root), so that every device puts a particle
    in the same bin: PyTorch's float32 sqrt on the CPU is not correctly
    rounded (an ulp off numpy's for some inputs), and its CUDA sqrt
    differs from it there."""
    u2 = p.px ** 2 + p.py ** 2 + p.pz ** 2
    gamma = torch.sqrt((1.0 + u2).double()).to(u2.dtype)
    ke = (mass * (gamma - 1.0)).reshape(-1)
    w = p.w.reshape(-1)
    live = w > 0
    if emax is None:
        top = torch.where(live, ke, torch.zeros_like(ke)).max() + 1e-12
    else:
        top = torch.tensor(emax, dtype=ke.dtype, device=ke.device)
    idx = torch.clamp((ke / top * bins).to(torch.int32), 0, bins - 1)
    edges = top * torch.arange(bins + 1, device=w.device) / bins
    return _scatter(bins, idx, live, w), edges


def field_spectrum_2d(comp: torch.Tensor) -> torch.Tensor:
    """|FFT2|^2 mode power of one field component (instability mode maps)."""
    return torch.fft.rfft2(comp).abs() ** 2


def charge_density(p: ParticleState, q: float, ny: int,
                   nx: int) -> torch.Tensor:
    """Nearest-cell charge density rho on the grid (diagnostic fidelity;
    the deposit owns the physics-grade shapes)."""
    ix = torch.clamp(p.x.reshape(-1).to(torch.int32), 0, nx - 1)
    iy = torch.clamp(p.y.reshape(-1).to(torch.int32), 0, ny - 1)
    w = p.w.reshape(-1)
    return _scatter(ny * nx, iy * nx + ix, w > 0, q * w).reshape(ny, nx)


def current_moments(p: ParticleState, q: float) -> torch.Tensor:
    """Sum of q w v per axis (the bulk current), [3]."""
    gi = torch.rsqrt(1.0 + p.px ** 2 + p.py ** 2 + p.pz ** 2)
    w = q * p.w
    return torch.stack([(w * p.px * gi).sum(), (w * p.py * gi).sum(),
                        (w * p.pz * gi).sum()])
