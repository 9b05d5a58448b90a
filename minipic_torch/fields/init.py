"""Analytic field initializations: the reference's validation waveforms and
the laser decks' pulse (torch form of ``minipic_tpu.fields.init``).

* ``plane_wave_y`` (Test 1), ``oblique_wave`` (Test 2), ``plane_wave_x``;
* ``pulse_x`` (Test 3, the reference's active init): an x-propagating
  pulse with a cos^2 envelope of hard support,
  Ey = Bz = A sin(kx x) cos^2(((x-xc)/tau)(pi/2)) H(1 - |x-xc|/tau);
* ``gaussian_laser_x``: the linearly polarized (Ey, Bz) Gaussian pulse of
  the laser decks.

Each component is evaluated at its Yee-staggered coordinates
(``geometry.STAGGER``) over the whole grid, in `dtype` on `device`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..core.geometry import STAGGER, Domain
from ..core.state import FIELD_NAMES, FieldState


def _coords(domain: Domain, name: str, dtype: torch.dtype,
            device: torch.device):
    """Broadcastable staggered (x [1, nx], y [ny, 1]) physical
    coordinates."""
    ox, oy = STAGGER[name]
    x = (torch.arange(domain.nx, dtype=dtype, device=device) + ox) * domain.dx
    y = (torch.arange(domain.ny, dtype=dtype, device=device) + oy) * domain.dy
    return x[None, :], y[:, None]


def from_expressions(domain: Domain, exprs: Dict[str, Callable],
                     dtype: torch.dtype = torch.float32,
                     device: torch.device = "cuda") -> FieldState:
    """FieldState from {component: f(x, y)}; `f` takes broadcastable torch
    coordinates at that component's stagger.  Components not listed are
    zero."""
    out = {}
    for name in FIELD_NAMES:
        fn = exprs.get(name)
        if fn is None:
            out[name] = torch.zeros((domain.ny, domain.nx), dtype=dtype,
                                    device=device)
            continue
        x, y = _coords(domain, name, dtype, device)
        v = torch.as_tensor(fn(x, y), dtype=dtype, device=device)
        out[name] = v.expand(domain.ny, domain.nx).contiguous()
    return FieldState(**out)


def plane_wave_y(domain: Domain, amplitude: float = 0.1, modes: int = 5,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device = "cuda") -> FieldState:
    """Test 1: y-propagating plane wave."""
    ky = modes * 2.0 * math.pi / domain.box_y
    return from_expressions(domain, {
        "ex": lambda x, y: amplitude * torch.sin(ky * y),
        "bz": lambda x, y: -amplitude * torch.sin(ky * y),
    }, dtype, device)


def plane_wave_x(domain: Domain, amplitude: float = 0.1, modes: int = 5,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device = "cuda") -> FieldState:
    """x-propagating plane wave."""
    kx = modes * 2.0 * math.pi / domain.box_x
    return from_expressions(domain, {
        "ey": lambda x, y: amplitude * torch.sin(kx * x),
        "bz": lambda x, y: amplitude * torch.sin(kx * x),
    }, dtype, device)


def oblique_wave(domain: Domain, amplitude: float = 0.1, modes: int = 5,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device = "cuda") -> FieldState:
    """Test 2: oblique sine wave."""
    kx = modes * 2.0 * math.pi / domain.box_x
    ky = modes * 2.0 * math.pi / domain.box_y
    a = amplitude / math.sqrt(2.0)
    return from_expressions(domain, {
        "ex": lambda x, y: a * torch.sin(kx * x + ky * y),
        "ey": lambda x, y: -a * torch.sin(kx * x + ky * y),
        "bz": lambda x, y: -amplitude * torch.sin(kx * x + ky * y),
    }, dtype, device)


def pulse_x(domain: Domain, amplitude: float = 0.1, modes: int = 5,
            center: float = 3.5, tau: float = 3.0,
            dtype: torch.dtype = torch.float32,
            device: torch.device = "cuda") -> FieldState:
    """Test 3: x-propagating pulse with a cos^2 envelope of hard support."""
    kx = modes * 2.0 * math.pi / domain.box_x

    def ey(x, y):
        u = (x - center) / tau
        env = torch.where(torch.abs(u) <= 1.0,
                          torch.cos(u * math.pi * 0.5) ** 2,
                          torch.zeros_like(u))
        return amplitude * torch.sin(kx * x) * env

    return from_expressions(domain, {"ey": ey, "bz": ey}, dtype, device)


def gaussian_laser_x(domain: Domain, a0: float = 1.0, k0: float = 10.0,
                     x_center: float = 2.0, length: float = 1.0,
                     waist: float = 2.0, dtype: torch.dtype = torch.float32,
                     device: torch.device = "cuda") -> FieldState:
    """Linearly polarized (Ey, Bz) Gaussian laser pulse moving along +x."""

    def prof(x, y):
        yc = domain.box_y / 2.0
        env = torch.exp(-(((x - x_center) / length) ** 2)
                        - (((y - yc) / waist) ** 2))
        return a0 * torch.sin(k0 * x) * env

    return from_expressions(domain, {"ey": prof, "bz": prof}, dtype, device)
