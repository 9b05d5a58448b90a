"""Numerical diagnostics of the physics decks, numpy only (the port's own
copy of ``minipic_tpu.diag.analysis``'s growth-rate, energy-drift and
spectrum helpers)."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np


def growth_rate(times: Sequence[float], energies: Sequence[float],
                window: Optional[Tuple[int, int]] = None) -> float:
    """Exponential growth rate gamma of an energy history, fit over the
    linear-instability window (E ~ e^{2 gamma t} for field energy)."""
    t = np.asarray(times, np.float64)
    e = np.asarray(energies, np.float64)
    if window is not None:
        t, e = t[window[0]:window[1]], e[window[0]:window[1]]
    ok = e > 0
    slope = np.polyfit(t[ok], np.log(e[ok]), 1)[0]
    return float(slope / 2.0)


def energy_drift(history: Sequence[Tuple[float, float]]) -> float:
    """max |E_total(t) - E_total(0)| / E_total(0) over (field, kinetic)
    pairs."""
    tot = np.asarray([f + k for f, k in history], np.float64)
    return float(np.abs(tot - tot[0]).max() / abs(tot[0]))


def field_spectrum_x(field: np.ndarray) -> np.ndarray:
    """Mode power |FFT_x|^2 averaged over y."""
    f = np.fft.rfft(np.asarray(field), axis=1)
    return (np.abs(f) ** 2).mean(axis=0)


def two_stream_growth_theory(k: float, v0: float, wp_beam: float) -> float:
    """Cold symmetric two-stream linear growth rate of mode k, from
    w^2 = wb^2 + k^2 v0^2 - wb sqrt(wb^2 + 4 k^2 v0^2) (negative: growth)."""
    a = k * k * v0 * v0
    w2 = wp_beam ** 2 + a - wp_beam * math.sqrt(wp_beam ** 2 + 4 * a)
    return math.sqrt(-w2) if w2 < 0 else 0.0
