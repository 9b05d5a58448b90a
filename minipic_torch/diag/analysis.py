"""Numerical diagnostics, numpy and scipy only: the port's own copy of
``minipic_tpu.diag.analysis``.

* the pulse's bars (the reference's validation, report §4): ``lineout``,
  ``find_peaks_1d``, ``find_peaks_periodic``, ``peak_amplitudes``,
  ``fit_pulse_speed``, ``track_peak_speed``, and
  ``fdtd_dispersion_velocity``, the Yee scheme's theory value;
* the physics decks': ``growth_rate``, ``energy_drift``,
  ``field_spectrum_x``, ``two_stream_growth_theory``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np


def lineout(field: np.ndarray, y_index: Optional[int] = None) -> np.ndarray:
    """Horizontal slice at fixed y (the middle row by default)."""
    if y_index is None:
        y_index = field.shape[0] // 2
    return np.asarray(field)[y_index, :]


def find_peaks_1d(line: np.ndarray, distance: int = 10) -> np.ndarray:
    """Local-maxima indices at least `distance` apart (scipy's
    find_peaks)."""
    from scipy.signal import find_peaks

    peaks, _ = find_peaks(line, distance=distance)
    return peaks


def find_peaks_periodic(line: np.ndarray, distance: int = 10) -> np.ndarray:
    """Peak indices of a periodic signal: a crest split across the box edge
    is found in a circularly padded copy."""
    from scipy.signal import find_peaks

    n = len(line)
    pad = max(distance * 2, 16)
    ext = np.concatenate([line[-pad:], line, line[:pad]])
    peaks, _ = find_peaks(ext, distance=distance)
    peaks = (peaks - pad) % n
    return np.unique(peaks[(peaks >= 0) & (peaks < n)])


def peak_amplitudes(line: np.ndarray, distance: int = 10,
                    top: int = 2) -> list:
    """Amplitudes of the `top` strongest local maxima, strongest first
    (zeros where there are fewer)."""
    peaks = find_peaks_1d(line, distance)
    vals = sorted((float(line[p]) for p in peaks), reverse=True)[:top]
    while len(vals) < top:
        vals.append(0.0)
    return vals


def fit_pulse_speed(times: Sequence[float], lines: Sequence[np.ndarray],
                    dx: float, distance: int = 10) -> float:
    """Propagation speed from a linear fit of the strongest peak's position
    against time, periodic jumps unwrapped (the report's Fig. 10)."""
    pos = []
    nx = len(lines[0])
    for line in lines:
        peaks = find_peaks_1d(np.asarray(line), distance)
        if len(peaks) == 0:
            pos.append(np.nan)
            continue
        best = peaks[np.argmax(np.asarray(line)[peaks])]
        pos.append(best * dx)
    pos = np.unwrap(np.asarray(pos), period=nx * dx)
    t = np.asarray(times)
    ok = np.isfinite(pos)
    return float(np.polyfit(t[ok], pos[ok], 1)[0])


def track_peak_speed(times: Sequence[float], lines: Sequence[np.ndarray],
                     dx: float, distance: int = 10) -> float:
    """Carrier-crest speed by continuity tracking: follow the peak nearest
    to its advected last position (prior speed c) rather than the
    strongest one, which hops by a wavelength as the envelope slides over
    the carrier."""
    nx = len(lines[0])
    box = nx * dx
    t = np.asarray(times, np.float64)

    line0 = np.asarray(lines[0])
    peaks0 = find_peaks_periodic(line0, distance)
    pos = float(peaks0[np.argmax(line0[peaks0])]) * dx
    positions = [pos]
    unwrapped = [pos]
    v_est = 1.0
    for i in range(1, len(lines)):
        line = np.asarray(lines[i])
        peaks = find_peaks_periodic(line, distance) * dx
        if len(peaks) == 0:
            positions.append(positions[-1])
            unwrapped.append(unwrapped[-1])
            continue
        pred = (positions[-1] + v_est * (t[i] - t[i - 1])) % box
        d = np.abs((peaks - pred + box / 2) % box - box / 2)
        new = float(peaks[np.argmin(d)])
        step = (new - positions[-1] + box / 2) % box - box / 2
        positions.append(new)
        unwrapped.append(unwrapped[-1] + step)
    return float(np.polyfit(t, np.asarray(unwrapped), 1)[0])


def fdtd_dispersion_velocity(k: float, dt: float, dx: float) -> float:
    """Phase velocity of the 1-D Yee scheme: sin(w dt/2) = (dt/dx)
    sin(k dx/2) (the report's Eq. 4)."""
    s = (dt / dx) * math.sin(k * dx / 2.0)
    omega = 2.0 / dt * math.asin(min(1.0, s))
    return omega / k


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
