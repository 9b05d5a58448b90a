"""The port's on-device diagnostics (minipic_torch/diag/device.py) and run
history (minipic_torch/diag/history.py) against the JAX package's, on the
same numpy particle state: histogram counts exactly (inputs kept off the
bin edges, where (a - lo) / (hi - lo) * n may round either way), weights
and spectra to 1e-6 relative in f32; the history's JSON equal, read from
the device once per record."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core.state import ParticleState as JParticles  # noqa: E402
from minipic_tpu.diag import device as jdev  # noqa: E402
from minipic_tpu.diag import history as jhist  # noqa: E402
from minipic_torch.core.state import ParticleState  # noqa: E402
from minipic_torch.diag import device as tdev  # noqa: E402
from minipic_torch.diag import history as thist  # noqa: E402
from minipic_torch.simulation import StepDiag  # noqa: E402

RTOL = 1e-6
BINS = (16, 12)


def _off_edges(rng, n, lo, hi, bins):
    """`n` values in [lo, hi] at least 0.2 bin from every edge of `bins`
    equal bins over [lo, hi]."""
    k = rng.integers(0, bins, n)
    return (lo + (k + rng.uniform(0.2, 0.8, n)) * (hi - lo) / bins).astype(
        np.float32)


def _state(seed=7, tiles=6, cap=64, dead=0.25, unit_weights=False):
    """A [tiles, cap] f32 particle state: positions and momenta off the
    edges of BINS over the ranges the tests give, a quarter of the slots
    dead (w == 0, their channels left as they are)."""
    rng = np.random.default_rng(seed)
    n = tiles * cap
    ch = {
        "x": _off_edges(rng, n, 0.0, 32.0, BINS[0]),
        "y": _off_edges(rng, n, 0.0, 24.0, 24),
        "px": _off_edges(rng, n, -0.3, 0.3, BINS[1]),
        "py": rng.normal(0, 0.1, n).astype(np.float32),
        "pz": rng.normal(0, 0.05, n).astype(np.float32),
        "w": (np.ones(n) if unit_weights else rng.uniform(0.5, 2.0, n)
              ).astype(np.float32),
    }
    ch["w"][rng.uniform(size=n) < dead] = 0.0
    ch = {k: v.reshape(tiles, cap) for k, v in ch.items()}
    return (ParticleState(*(torch.from_numpy(ch[k]) for k in ParticleState._fields)),
            JParticles(*(jnp.asarray(ch[k]) for k in ParticleState._fields)))


@pytest.mark.parametrize("unit", [True, False])
def test_phase_space_hist_given_ranges(unit):
    tp, jp = _state(unit_weights=unit)
    kw = dict(bins=BINS, range0=(0.0, 32.0), range1=(-0.3, 0.3))
    got = tdev.phase_space_hist(tp, "x", "px", **kw)
    want = jdev.phase_space_hist(jp, "x", "px", **kw)
    if unit:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert float(got[0].sum()) == float((tp.w > 0).sum())
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_phase_space_hist_live_extent():
    """Ranges from the live particles' extent: the same edges, every live
    particle counted, the extremes in the first and last bins."""
    tp, jp = _state(seed=11, unit_weights=True)
    got = tdev.phase_space_hist(tp, "y", "px", bins=(24, 12))
    want = jdev.phase_space_hist(jp, "y", "px", bins=(24, 12))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    live = tp.w > 0
    assert float(got[1][0]) < float(tp.y[live].min())
    assert float(got[1][-1]) > float(tp.y[live].max())
    # Counts exactly where no live particle lies within 1e-5 of a bin of
    # an edge (the extent's edges are not the ones _state avoids).
    e0 = got[1].double().numpy()
    y = tp.y[live].double().numpy()
    frac = (y - e0[0]) / (e0[-1] - e0[0]) * 24
    assert np.abs(frac - np.round(frac)).min() > 1e-5
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("emax", [None, 0.08])
def test_energy_spectrum(emax):
    tp, jp = _state(seed=3)
    g, ge = tdev.energy_spectrum(tp, mass=1.0, bins=16, emax=emax)
    w, we = jdev.energy_spectrum(jp, mass=1.0, bins=16, emax=emax)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=RTOL)
    if emax is None:
        np.testing.assert_allclose(float(g.sum()), float(tp.w.sum()),
                                   rtol=RTOL)
    ut, uj = _state(seed=3, unit_weights=True)
    np.testing.assert_array_equal(
        tdev.energy_spectrum(ut, 1.0, 16, emax)[0].numpy(),
        np.asarray(jdev.energy_spectrum(uj, 1.0, 16, emax)[0]))


def test_energy_spectrum_bins_by_the_correctly_rounded_gamma():
    """PyTorch's float32 sqrt on the CPU is an ulp off the correctly
    rounded root for some inputs, where its CUDA sqrt differs from it, so
    a particle at a bin edge fell into other bins on the card and on the
    CPU.  The spectrum takes gamma as the correctly rounded root (numpy's
    float32 sqrt, JAX's): one particle whose two roots differ, with a bin
    edge between its two energies, lands in the bin of the correct one."""
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.uniform(0.0, 3.0, (3, 4096)).astype(np.float32))
    s1 = (1.0 + (u[0] ** 2 + u[1] ** 2 + u[2] ** 2)).numpy()
    ieee = np.sqrt(s1)
    off = np.flatnonzero(torch.sqrt(torch.from_numpy(s1)).numpy() != ieee)
    assert off.size > 0
    i = int(off[0])
    ke = ieee[i] - np.float32(1.0)
    ke_off = torch.sqrt(torch.from_numpy(s1[i:i + 1])).numpy()[0] - 1.0
    # Two bins whose edge is the larger energy: that one lands in bin 1.
    emax = float(2 * max(ke, ke_off))
    w = np.zeros(4096, np.float32)
    w[i] = 1.0
    p = ParticleState(*(torch.zeros(1, 4096) for _ in range(2)),
                      *(c[None, :] for c in u), torch.from_numpy(w)[None, :])
    hist = tdev.energy_spectrum(p, 1.0, bins=2, emax=emax)[0].numpy()
    want = np.zeros(2, np.float32)
    want[int(ke >= ke_off)] = 1.0
    np.testing.assert_array_equal(hist, want)


def test_field_spectrum_2d():
    a = np.random.default_rng(1).standard_normal((24, 32)).astype(np.float32)
    got = tdev.field_spectrum_2d(torch.from_numpy(a))
    want = jdev.field_spectrum_2d(jnp.asarray(a))
    assert got.shape == (24, 17)
    # Two f32 FFTs by other algorithms: within 4.1e-7 of the largest value
    # (bins down to 8e-4 of it differ by up to 4.7e-6 of their own).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RTOL * float(np.asarray(want).max()))


@pytest.mark.parametrize("unit", [True, False])
def test_charge_density(unit):
    tp, jp = _state(seed=5, unit_weights=unit)
    got = tdev.charge_density(tp, -1.0, 24, 32)
    want = jdev.charge_density(jp, -1.0, 24, 32)
    assert got.shape == (24, 32)
    if unit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(float(got.sum()), -float(tp.w.sum()),
                               rtol=RTOL)


def test_current_moments():
    tp, jp = _state(seed=9)
    got = tdev.current_moments(tp, -1.0)
    want = jdev.current_moments(jp, -1.0)
    scale = float((tp.w * (tp.px.abs() + tp.py.abs() + tp.pz.abs())).sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RTOL * scale)


def _diag(fe, ke, ovf, bad=0, live=100):
    return StepDiag(
        field_energy=torch.tensor(fe, dtype=torch.float64),
        kinetic_energy=torch.tensor(ke, dtype=torch.float64),
        overflow=torch.tensor(ovf, dtype=torch.int32),
        momentum=torch.zeros((len(ke), 3), dtype=torch.float64),
        shard_live=torch.tensor([live], dtype=torch.int32),
        weight_nonuniform=torch.tensor(bad, dtype=torch.int32),
        rebinned=bool(ovf))


class _JaxDiag:
    """The JAX package's StepDiag fields its RunHistory reads."""

    def __init__(self, fe, ke, ovf, bad=0, live=100):
        self.field_energy = jnp.asarray(fe)
        self.kinetic_energy = jnp.asarray(ke)
        self.overflow = jnp.asarray(ovf, jnp.int32)
        self.weight_nonuniform = jnp.asarray(bad, jnp.int32)
        self.shard_live = jnp.asarray([live], jnp.int32)


RECORDS = [(1, 1.5, [0.25, 0.125, 2.0], 0), (2, 1.25, [0.5, 0.125, 2.0], 3),
           (5, 1.0, [0.75, 0.25, 2.0], 0)]


def test_history_equals_jax():
    th, jh = thist.RunHistory(), jhist.RunHistory()
    for step, fe, ke, ovf in RECORDS:
        th.record(step, 0.1, _diag(fe, ke, ovf))
        jh.record(step, 0.1, _JaxDiag(fe, ke, ovf))
    got, want = json.loads(th.to_json()), json.loads(jh.to_json())
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "wall":
            assert got[k] == want[k], k
    assert len(got["wall"]) == len(RECORDS)
    assert th.total_energy() == jh.total_energy()
    assert th.energy_drift() == jh.energy_drift()
    assert th.steps_per_sec() is not None


def test_history_reads_the_device_once_a_record(monkeypatch):
    """One record, one device-to-host copy: every scalar of the StepDiag
    comes back in a single .cpu() (the JAX package reads each)."""
    calls = {}

    def counting(name):
        real = getattr(torch.Tensor, name)

        def f(self, *a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(self, *a, **k)
        return f

    names = ("cpu", "item", "tolist", "numpy", "__float__", "__int__",
             "__bool__", "__index__")
    diags = [_diag(fe, ke, ovf) for _, fe, ke, ovf in RECORDS]
    h = thist.RunHistory()
    for name in names:
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    for (step, *_), d in zip(RECORDS, diags):
        h.record(step, 0.1, d)
    monkeypatch.undo()
    assert calls == {"cpu": len(RECORDS), "numpy": len(RECORDS)}
    assert h.overflow == [0, 3, 0] and h.live_skew == [1.0] * 3


def test_history_raises_on_nonuniform_int8_weights():
    h, jh = thist.RunHistory(), jhist.RunHistory()
    with pytest.raises(RuntimeError, match="NON-UNIFORM") as got:
        h.record(4, 0.1, _diag(1.0, [0.5], 0, bad=1))
    with pytest.raises(RuntimeError) as want:
        jh.record(4, 0.1, _JaxDiag(1.0, [0.5], 0, bad=1))
    assert str(got.value) == str(want.value)
    assert h.steps == []
