"""The port's moving window (minipic_torch/simulation.py: window_shift_now,
shift_window; particles/species.py: inject_column) against the JAX
package's: the shift schedule step for step, one shift slot for slot from
a handed-over state, and the injected plasma's statistics and
determinism."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from minipic_tpu.decks import standard as jstd  # noqa: E402
from minipic_tpu.particles.species import inject_column as jinject  # noqa
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_tpu.simulation import window_injection_key as jkey  # noqa
from minipic_tpu.simulation import window_shift_now as jshift  # noqa: E402
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core.config import Deck, SpeciesSpec  # noqa: E402
from minipic_torch.core.state import (  # noqa: E402
    ParticleState, field_energy, kinetic_energy)
from minipic_torch.decks import standard as tstd  # noqa: E402
from minipic_torch.fields import init as tinit  # noqa: E402
from minipic_torch.particles import species as tsp  # noqa: E402
from minipic_torch.simulation import (  # noqa: E402
    Simulation, window_injection_key, window_shift_now)

CPU = torch.device("cpu")
SMALL = dict(nx=64, ny=32, ppc=2)


def _pulse_deck(**kw):
    """tests/test_moving_window.py's window deck."""
    base = dict(box_x=12.8, box_y=6.4, nx=128, ny=64, tile_nx=8, tile_ny=8,
                guard=2, boundary="absorbing", absorb_width=8,
                moving_window=True, species=(), precision="f32")
    base.update(kw)
    return Deck(**base)


@pytest.mark.parametrize("deck", [
    tstd.laser_wakefield_window().deck, _pulse_deck()],
    ids=["laser_wakefield_window", "pulse"])
def test_window_shift_now_matches_jax_every_step(deck):
    """The port's float32 predicate drives the schedule for 200,001 steps;
    JAX's predicate agrees at every (step, window_x0) of it, and one tile
    column either side of it."""
    n = 200_001
    dt, dx, tnx = deck.dt, deck.dx, deck.tile_nx
    w0s = np.zeros(n, np.int32)
    w0 = 0
    for s in range(n):
        w0s[s] = w0
        if window_shift_now(s, w0, dt, tnx, dx):
            w0 += tnx
    steps = np.arange(n, dtype=np.int32)
    for off in (0, -tnx, tnx):
        w = np.maximum(w0s + off, 0).astype(np.int32)
        want = np.asarray(jshift(jnp.asarray(steps), jnp.asarray(w), dt, tnx,
                                 dx))
        got = window_shift_now(steps, w, dt, tnx, dx)
        np.testing.assert_array_equal(got, want)
    # Each shift follows the light front: floor(steps dt/dx / tile_nx).
    assert w0 // tnx == int(n * dt / dx / tnx)


def _jax_inject(jdeck, i, capacity, x0):
    """The JAX package's injected buckets of species i at column x0, jitted
    as in its step (eager evaluation of the profile can differ by an ulp)."""
    def f(w0n):
        return jinject(jdeck.species[i], jdeck.domain, jdeck.tiling,
                       capacity, jkey(i, w0n), w0n, jnp.float32)
    return jax.jit(f)(jnp.int32(x0))


def _jax_injector(jdeck, names):
    """A stand-in for the port's inject_column that returns the JAX
    package's injected buckets for the same species and column."""
    def inject(spec, domain, tiling, capacity, key, x0, dtype, device,
               row_ids=None):
        inj = _jax_inject(jdeck, names.index(spec.name), capacity, x0)
        return ParticleState(*(torch.from_numpy(np.array(a)) for a in inj))
    return inject


def _handed_over_window(monkeypatch, step):
    jcase = jstd.make("laser_wakefield_window", **SMALL)
    jdeck = dataclasses.replace(jcase.deck, use_pallas="on")
    jsim = JSimulation(jdeck, fields=jcase.init_fields(jdeck), seed=3)
    jsim.state = jsim.state._replace(step=jnp.int32(step))
    tsim = Simulation(tstd.make("laser_wakefield_window", **SMALL).deck,
                      device=CPU)
    tsim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), CPU)
    names = [s.name for s in tsim.deck.species]
    monkeypatch.setattr(tsp, "inject_column", _jax_injector(jdeck, names))
    return jdeck, jsim, tsim


def test_one_shift_matches_jax_slot_for_slot(monkeypatch):
    """A handed-over state one step before the first shift, stepped once on
    both sides with JAX's injected buckets fed to the port: the re-bin is
    forced, the buckets roll, and every slot agrees (w exactly, the pushed
    channels to the advance's 2e-6; the injected column bit for bit)."""
    deck = tstd.make("laser_wakefield_window", **SMALL).deck
    first = next(s for s in range(100)
                 if window_shift_now(s, 0, deck.dt, deck.tile_nx, deck.dx))
    jdeck, jsim, tsim = _handed_over_window(monkeypatch, first)
    assert float(tsim.state.drift) < deck.drift_threshold()
    dj, dt_ = jsim.step(), tsim.step()
    assert dt_.rebinned
    assert int(tsim.state.window_x0) == int(jsim.state.window_x0) == 8
    assert int(tsim.state.step) == int(jsim.state.step) == first + 1
    t = deck.tiling
    for i, (p, jp) in enumerate(zip(tsim.state.species, jsim.state.species)):
        w = p.w.numpy()
        np.testing.assert_array_equal(w, np.asarray(jp.w))
        live = w > 0
        for name in ("x", "y", "px", "py", "pz"):
            a, b = getattr(p, name).numpy(), np.asarray(getattr(jp, name))
            np.testing.assert_allclose(a[live], b[live], rtol=2e-6,
                                       atol=2e-6, err_msg=name)
        last = [a.numpy().reshape(t.tile_rows, t.tile_cols, -1)[:, -1]
                for a in p]
        want = _jax_inject(jdeck, i, p.capacity, 8)
        for a, b in zip(last, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tsim.state.fields, jsim.state.fields):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
        # The leading tile column entered empty: it is zeroed after this
        # step's field update.
        assert float(a[:, -deck.tile_nx:].abs().max()) == 0.0
    np.testing.assert_allclose(float(dt_.field_energy),
                               float(dj.field_energy), rtol=1e-4)
    assert int(dt_.shard_live[0]) == int(dj.shard_live[0])


def _inject(spec, deck, x0, key=1234, rows=None, cap=512):
    return tsp.inject_column(spec, deck.domain, deck.tiling, cap, key, x0,
                             torch.float32, CPU, row_ids=rows)


def test_inject_column_statistics():
    """The default window deck's electrons injected at window_x0 = 40: ppc
    live particles in every cell of the last tile column, weights equal to
    the profile at absolute x (rtol 1e-6), thermal momenta at uth."""
    deck = tstd.laser_wakefield_window().deck
    spec = deck.species[0]
    t = deck.tiling
    inj = _inject(spec, deck, 40)
    per_tile = spec.ppc * t.tile_nx * t.tile_ny
    assert inj.x.shape == (t.tile_rows, 512)
    w = inj.w.numpy()
    assert (w[:, :per_tile] > 0).all() and (w[:, per_tile:] == 0).all()
    x = inj.x.numpy()[:, :per_tile].astype(np.float64)
    y = inj.y.numpy()[:, :per_tile].astype(np.float64)
    x0 = (t.tile_cols - 1) * t.tile_nx
    assert x.min() > x0 and x.max() < deck.nx
    cell = (np.floor(y) * deck.nx + np.floor(x)).astype(np.int64)
    _, counts = np.unique(cell, return_counts=True)
    assert len(counts) == deck.ny * t.tile_nx and (counts == spec.ppc).all()
    n = 0.3 * 0.5 * (1.0 + np.tanh(((x + 40) * deck.dx - 40.0) / 4.0))
    np.testing.assert_allclose(w[:, :per_tile],
                               n * deck.dx * deck.dy / spec.ppc, rtol=1e-6)
    for a in (inj.px, inj.py, inj.pz):
        a = a.numpy()[:, :per_tile].astype(np.float64)
        assert abs(a.mean()) < 4 * 0.01 / np.sqrt(a.size)
        assert abs(a.std() / 0.01 - 1.0) < 0.05
    # Cold ions: no noise drawn, momenta exactly the drift.
    ion = _inject(deck.species[1], deck, 40)
    assert float(ion.px.abs().max()) == 0.0


def test_inject_column_is_deterministic_in_its_key_and_rows():
    deck = tstd.laser_wakefield_window().deck
    ele, ion = deck.species
    hot_ion = dataclasses.replace(ion, uth=0.01)
    a = _inject(ele, deck, 40, key=window_injection_key(0, 40))
    b = _inject(ele, deck, 40, key=window_injection_key(0, 40))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # Another species (same spec, its own key) or another column: other
    # noise.
    c = _inject(ele, deck, 40, key=window_injection_key(1, 40))
    d = _inject(ele, deck, 48, key=window_injection_key(0, 48))
    assert not torch.equal(a.px, c.px) and not torch.equal(a.px, d.px)
    e = _inject(hot_ion, deck, 40, key=window_injection_key(1, 40))
    assert not torch.equal(a.px, e.px)
    assert window_injection_key(0, 40) != window_injection_key(1, 40)
    # A caller that injects rows 5, 6 and 17 alone gets those rows of the
    # whole column: the noise is keyed per global tile row.
    part = _inject(ele, deck, 40, key=window_injection_key(0, 40),
                   rows=[5, 6, 17])
    for u, v in zip(part, a):
        assert torch.equal(u, v[[5, 6, 17]])


def _bz_centroid_x(f):
    w = f.bz.double().numpy() ** 2
    return float((w.sum(axis=0) * np.arange(w.shape[1])).sum() / w.sum())


def test_pulse_stays_in_window():
    """The mirror of tests/test_moving_window.py's pulse test on the port:
    a rightward pulse stays put in the window while it shifts."""
    deck = _pulse_deck()
    fields = tinit.pulse_x(deck.domain, amplitude=0.1, center=6.4, tau=1.5,
                           dtype=torch.float32, device=CPU)
    sim = Simulation(deck, fields=fields, device=CPU)
    x0 = _bz_centroid_x(sim.state.fields)
    n = 90
    sim.step(n)
    x1 = _bz_centroid_x(sim.state.fields)
    shifts = int(sim.state.window_x0) // deck.tile_nx
    lab_cells = n * deck.dt / deck.dx
    assert shifts == int(lab_cells // deck.tile_nx), (shifts, lab_cells)
    resid = lab_cells - int(sim.state.window_x0)
    assert 0.0 <= resid < deck.tile_nx
    assert abs((x1 - x0) - resid) < 1.0, (x0, x1, resid)


def test_plasma_injection_balances_outflow():
    """The mirror of tests/test_moving_window.py's uniform-plasma test on
    the port: ~4 shifts of a neutral thermal plasma keep the live count
    steady to a tenth of a column, the injected column carries the
    loader's weight, and the fields stay quiet."""
    deck = _pulse_deck(species=(
        SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4, uth=0.01),
        SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=4, uth=0.0)))
    sim = Simulation(deck, device=CPU)
    n_start = int(sim.state.species[0].alive_count())
    sim.step(120)
    assert int(sim.state.window_x0) > 2 * deck.tile_nx
    p = sim.state.species[0]
    col = deck.ny * deck.tile_nx * 4
    assert abs(int(p.alive_count()) - n_start) < 0.1 * col
    t = deck.tiling
    wlast = p.w.numpy().reshape(t.tile_rows, t.tile_cols, -1)[:, -1, :]
    np.testing.assert_allclose(wlast[wlast > 0], deck.dx * deck.dy / 4,
                               rtol=1e-6)
    fe = float(field_energy(sim.state.fields, deck.dx, deck.dy))
    ke = float(kinetic_energy(p, 1.0))
    assert fe < 0.1 * ke, (fe, ke)

