"""The port's field initializations (minipic_torch/fields/init.py), damping
layer (fields/boundary.py) and pulse diagnostics (diag/analysis.py) against
the JAX package's, and the fields-only decks (reference_pulse, the
absorbing box) stepped on both sides."""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from minipic_tpu.core.geometry import Domain  # noqa: E402
from minipic_tpu.decks import standard as jstd  # noqa: E402
from minipic_tpu.diag import analysis as jan  # noqa: E402
from minipic_tpu.fields import boundary as jbnd  # noqa: E402
from minipic_tpu.fields import init as jinit  # noqa: E402
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_torch.core.state import FieldState, field_energy  # noqa: E402
from minipic_torch.decks import standard as tstd  # noqa: E402
from minipic_torch.diag import analysis as tan  # noqa: E402
from minipic_torch.fields import boundary as tbnd  # noqa: E402
from minipic_torch.fields import init as tinit  # noqa: E402
from minipic_torch.fields.yee import (  # noqa: E402
    update_b_half_periodic, update_e_full_periodic)
from minipic_torch.simulation import Simulation  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64
# The same f64 expressions on both sides: 1e-12.
TOL = dict(rtol=1e-12, atol=1e-12)
ROOT = Path(__file__).resolve().parents[1]


def _same_fields(t, j):
    for name, a, b in zip(FieldState._fields, t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("name,kw", [
    ("plane_wave_x", dict(amplitude=0.2, modes=3)),
    ("plane_wave_y", dict(amplitude=0.2, modes=2)),
    ("oblique_wave", dict(amplitude=0.3)),
    ("pulse_x", dict(center=2.5, tau=1.5)),
    ("gaussian_laser_x", dict(a0=2.0, k0=5.0, x_center=3.0, length=1.0,
                              waist=1.5)),
])
def test_field_inits_match_jax(name, kw):
    dom = Domain(6.4, 4.8, 64, 48)
    want = getattr(jinit, name)(dom, dtype=jnp.float64, **kw)
    got = getattr(tinit, name)(dom, dtype=F64, device=CPU, **kw)
    assert all(a.dtype == F64 and a.shape == (48, 64) for a in got)
    _same_fields(got, want)
    assert any(float(a.abs().max()) > 0.05 for a in got)


def test_from_expressions_staggers_each_component():
    dom = Domain(3.2, 1.6, 32, 16)
    exprs = {"ex": lambda x, y: x + 10 * y, "by": lambda x, y: x * y}
    got = tinit.from_expressions(dom, exprs, F64, CPU)
    want = jinit.from_expressions(dom, exprs, jnp.float64)
    _same_fields(got, want)
    assert float(got.ez.abs().max()) == 0.0


@pytest.mark.parametrize("width,strength", [(8, 0.02), (16, 0.05)])
def test_damping_mask_matches_jax(width, strength):
    ny, nx = 40, 56
    want = jbnd.damping_mask(ny, nx, width, strength, dtype=jnp.float64)
    got = tbnd.damping_mask(ny, nx, width, strength, dtype=F64, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # A shard's block of the mask is that block of the global mask.
    blk = tbnd.local_damping_mask(8, 24, 16, 16, ny, nx, width, strength,
                                  dtype=F64, device=CPU)
    np.testing.assert_allclose(blk.numpy(), got[8:24, 24:40].numpy(), **TOL)
    jblk = jbnd.local_damping_mask(8, 24, 16, 16, ny, nx, width, strength,
                                   dtype=jnp.float64)
    np.testing.assert_allclose(blk.numpy(), np.asarray(jblk), **TOL)
    f = tinit.oblique_wave(Domain(5.6, 4.0, nx, ny), dtype=F64, device=CPU)
    jf = jinit.oblique_wave(Domain(5.6, 4.0, nx, ny), dtype=jnp.float64)
    _same_fields(tbnd.apply_damping(f, got), jbnd.apply_damping(jf, want))


def test_absorbing_boundary_damps_outgoing_pulse():
    """The mirror of tests/test_fields.py's absorbing test on the port:
    the pulse leaves a 128^2 box through a 16-cell layer, > 95% of its
    energy absorbed over 1500 steps."""
    d = Domain(10.0, 10.0, 128, 128)
    dt = 0.5 * d.dt_courant()
    f = tinit.pulse_x(d, dtype=F64, device=CPU)
    mask = tbnd.damping_mask(d.ny, d.nx, width=16, strength=0.05, dtype=F64,
                             device=CPU)
    e0 = float(field_energy(f, d.dx, d.dy))
    for _ in range(1500):
        f = update_b_half_periodic(f, dt, d.dx, d.dy)
        f = update_e_full_periodic(f, dt, d.dx, d.dy)
        f = update_b_half_periodic(f, dt, d.dx, d.dy)
        f = tbnd.apply_damping(f, mask)
    assert float(field_energy(f, d.dx, d.dy)) / e0 < 0.05


@pytest.mark.parametrize("boundary", ["periodic", "absorbing"])
def test_pulse_deck_twin_over_300_steps(boundary):
    """reference_pulse's deck at 90^2 in f64 (and the same box between
    absorbing walls), from its init_fields, through Simulation on both
    sides: 300 steps to 1e-12."""
    kw = dict(nx=90, ny=90)
    jd = dataclasses.replace(jstd.make("reference_pulse", **kw).deck,
                             precision="f64", boundary=boundary)
    tcase = tstd.make("reference_pulse", **kw)
    td = dataclasses.replace(tcase.deck, precision="f64", boundary=boundary)
    jsim = JSimulation(jd, fields=jstd.make("reference_pulse", **kw)
                       .init_fields(jd))
    tsim = Simulation(td, fields=tcase.init_fields(td, device=CPU),
                      device=CPU)
    _same_fields(tsim.state.fields, jsim.state.fields)
    e0 = float(field_energy(tsim.state.fields, td.dx, td.dy))
    for _ in range(300):
        dj, dt_ = jsim.step(), tsim.step()
    _same_fields(tsim.state.fields, jsim.state.fields)
    np.testing.assert_allclose(float(dt_.field_energy),
                               float(dj.field_energy), rtol=1e-12)
    assert int(tsim.state.step) == 300
    assert dt_.kinetic_energy.shape == (0,) and not dt_.rebinned
    ratio = float(dt_.field_energy) / e0
    assert (ratio < 0.99) == (boundary == "absorbing"), ratio


def _saved_lineouts():
    """The JAX engine's mid-y Bz lineouts of reference_pulse at 450^2 over
    the full span (docs/validation_450.npz)."""
    d = np.load(ROOT / "docs" / "validation_450.npz")
    return d["times"], d["lines"].astype(np.float64)


def test_pulse_speed_fits_match_jax():
    times, lines = _saved_lineouts()
    dx = 10.0 / 450
    for n in (15, len(times)):
        assert (tan.fit_pulse_speed(times[:n], lines[:n], dx)
                == jan.fit_pulse_speed(times[:n], lines[:n], dx))
        assert (tan.track_peak_speed(times[:n], lines[:n], dx)
                == jan.track_peak_speed(times[:n], lines[:n], dx))
    # The saved run's own numbers (docs/VALIDATION.md).
    assert abs(tan.fit_pulse_speed(times, lines, dx) - 0.99977) < 1e-5
    for line in (lines[0], lines[-1], lines[len(lines) // 2]):
        assert tan.peak_amplitudes(line) == jan.peak_amplitudes(line)
        np.testing.assert_array_equal(tan.find_peaks_periodic(line),
                                      jan.find_peaks_periodic(line))
        np.testing.assert_array_equal(tan.find_peaks_1d(line, 5),
                                      jan.find_peaks_1d(line, 5))
    p1, p2 = tan.peak_amplitudes(lines[-1])
    assert abs(p1 - 0.0833) < 1e-4 and abs(p2 - 0.0683) < 1e-4
    f = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(tan.lineout(f), jan.lineout(f))
    np.testing.assert_array_equal(tan.lineout(f, 0), jan.lineout(f, 0))
    k = 5 * 2 * math.pi / 10.0
    dt = 0.5 * Domain(10.0, 10.0, 450, 450).dt_courant()
    assert (tan.fdtd_dispersion_velocity(k, dt, dx)
            == jan.fdtd_dispersion_velocity(k, dt, dx))


def test_reference_pulse_deck_has_no_species_and_reads_nothing():
    """A fields-only Simulation: no buckets, no re-bin, run() completes
    without a census."""
    case = tstd.make("reference_pulse", nx=50, ny=50)
    sim = case.simulation(device=CPU)
    assert sim.state.species == () and sim.state.window_x0 is None
    diag = sim.run(60, save_every=1000)
    assert int(sim.state.step) == 60 and sim.overflow_total == 0
    assert int(diag.shard_live[0]) == 0 and int(diag.overflow) == 0
    assert not sim.ensure_capacity()
    assert math.isfinite(float(diag.field_energy))
