"""The port's named decks (minipic_torch/decks/standard.py) against the JAX
package's: every Deck field and derived size (the three load_balance_*
decks of the device mesh too), the field inits and the seeders on a
handed-over state, and step twins: two_stream on the small-bucket re-bin
route, laser_plasma between absorbing walls and laser_wakefield_window
through two window shifts."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.decks import standard as jstd  # noqa: E402
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.decks import standard as tstd  # noqa: E402
from minipic_torch.diag import analysis as tan  # noqa: E402
from minipic_torch.ops import rebin as rb  # noqa: E402
from minipic_torch.core.state import FieldState  # noqa: E402
from minipic_torch.particles import species as tsp  # noqa: E402
from minipic_torch.simulation import Simulation, bucket_capacity  # noqa

CPU = torch.device("cpu")
PORTED = ("reference_pulse", "two_stream", "weibel", "landau",
          "laser_plasma", "laser_wakefield_window")
SEEDED = ("two_stream", "weibel", "landau")
FIELD_INITS = ("reference_pulse", "laser_plasma", "laser_wakefield_window")


def _same_density(ts, js):
    """The port's torch density and JAX's jnp density of a species agree
    in f64 over the deck's box and past it (absolute window x)."""
    assert (ts.density is None) == (js.density is None)
    if ts.density is None:
        return
    x, y = np.meshgrid(np.linspace(-5.0, 120.0, 301),
                       np.linspace(0.0, 60.0, 7))
    got = ts.density(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(js.density(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert got.max() > 0.01


@pytest.mark.parametrize("name", PORTED)
def test_deck_matches_jax(name):
    jd, td = jstd.make(name).deck, tstd.make(name).deck
    for f in dataclasses.fields(tcfg.Deck):
        if f.name == "species":
            continue
        assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert len(td.species) == len(jd.species)
    for ts, js in zip(td.species, jd.species):
        for f in dataclasses.fields(tcfg.SpeciesSpec):
            if f.name == "density":
                _same_density(ts, js)
                continue
            assert getattr(ts, f.name) == getattr(js, f.name), f.name
    cap = td.capacity()
    assert cap == jd.capacity()
    mc = td.mover_cap(cap)
    assert mc == jd.mover_cap(cap)
    assert td.mover_seg_cap(mc) == jd.mover_seg_cap(mc)
    assert td.drift_threshold() == jd.drift_threshold()
    assert td.total_steps == jd.total_steps
    assert td.params_txt() == jd.params_txt()
    # Every particle deck takes the small-bucket route of rebin_auto.
    bc = bucket_capacity(td)
    assert not td.species or bc < 8 * td.mover_seg_cap(td.mover_cap(bc)) + 256


@pytest.mark.parametrize("name", FIELD_INITS)
def test_init_fields_matches_jax(name):
    """Each deck's initial fields from the port's init_fields against the
    JAX package's, in f64 at a cut grid (the widths of the box and pulse
    kept), to 1e-12."""
    kw = dict(nx=90, ny=90) if name == "reference_pulse" else dict(
        nx=64, ny=32 if name == "laser_wakefield_window" else 64)
    jcase, tcase = jstd.make(name, **kw), tstd.make(name, **kw)
    jd = dataclasses.replace(jcase.deck, precision="f64")
    td = dataclasses.replace(tcase.deck, precision="f64")
    want = jcase.init_fields(jd)
    got = tcase.init_fields(td, device=CPU)
    assert isinstance(got, FieldState)
    for n, a, b in zip(FieldState._fields, got, want):
        assert a.dtype == torch.float64 and a.shape == (td.ny, td.nx)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=n)
    assert float(got.ey.abs().max()) > 0.05
    assert tcase.seed_state is None


@pytest.mark.parametrize("name", SEEDED)
def test_seed_state_matches_jax(name):
    """The seeder on the JAX package's loaded state, handed over, in f32:
    the perturbation to 2 ulps (sin may round 1 ulp differently, and the
    product by its amplitude rounds once more), plus the 1-ulp rounding of
    the sum it is added into."""
    kw = dict(nx=32, ny=32)
    jcase, tcase = jstd.make(name, **kw), tstd.make(name, **kw)
    jsim = JSimulation(jcase.deck, seed=2)
    before = bridge.sim_state_to_numpy(jsim.state)
    state = bridge.sim_state_from_numpy(before, CPU)
    want = bridge.sim_state_to_numpy(jcase.seed_state(jsim.state,
                                                      jcase.deck))
    got = bridge.sim_state_to_numpy(tcase.seed_state(state, tcase.deck))
    assert sorted(got) == sorted(want)
    changed = 0
    for k in want:
        if not k.startswith("s"):
            continue
        delta = np.abs(want[k] - before[k])
        tol = 2 * np.spacing(delta) + np.spacing(np.abs(want[k]))
        assert (np.abs(got[k] - want[k]) <= tol).all(), k
        changed += int((delta > 0).any())
    assert changed >= 1


LOAD_BALANCE = ("load_balance_stress", "load_balance_stress_counts",
                "load_balance_bunching")


@pytest.mark.parametrize("name", LOAD_BALANCE)
def test_load_balance_deck_matches_jax(name):
    """Every Deck and species field (the torch densities against JAX's),
    the derived sizes and params.txt; the two stress decks' buckets take
    the deal route, load_balance_bunching's the small-bucket route."""
    jd, td = jstd.make(name).deck, tstd.make(name).deck
    for f in dataclasses.fields(tcfg.Deck):
        if f.name != "species":
            assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert td.mesh_shape == (2, 4) and td.mesh_dims(1) == jd.mesh_dims(1)
    for ts, js in zip(td.species, jd.species):
        for f in dataclasses.fields(tcfg.SpeciesSpec):
            if f.name == "density":
                _same_density(ts, js)
            else:
                assert getattr(ts, f.name) == getattr(js, f.name), f.name
    cap = td.capacity()
    assert cap == jd.capacity()
    mc = td.mover_cap(cap)
    assert mc == jd.mover_cap(cap)
    assert td.mover_seg_cap(mc) == jd.mover_seg_cap(mc)
    assert td.exchange_cap(512, 256) == jd.exchange_cap(512, 256)
    assert td.drift_threshold() == jd.drift_threshold()
    assert td.total_steps == jd.total_steps
    assert td.params_txt() == jd.params_txt()
    bc = bucket_capacity(td)
    deal = bc >= 8 * td.mover_seg_cap(td.mover_cap(bc)) + 256
    assert deal == (name != "load_balance_bunching")


def test_unknown_deck_is_a_key_error():
    with pytest.raises(KeyError):
        tstd.make("no_such_deck")


def test_analysis_matches_jax():
    from minipic_tpu.diag import analysis as jan

    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 10.0, 40)
    e = np.exp(0.6 * t) * (1 + 0.01 * rng.random(40))
    assert tan.growth_rate(t, e) == jan.growth_rate(t, e)
    assert tan.growth_rate(t, e, (5, 30)) == jan.growth_rate(t, e, (5, 30))
    hist = [(float(a), float(b)) for a, b in rng.random((20, 2))]
    assert tan.energy_drift(hist) == jan.energy_drift(hist)
    f = rng.random((8, 16))
    np.testing.assert_array_equal(tan.field_spectrum_x(f),
                                  jan.field_spectrum_x(f))
    for k in (0.5, 2.0, 9.0):
        assert (tan.two_stream_growth_theory(k, 0.2, 0.7)
                == jan.two_stream_growth_theory(k, 0.2, 0.7))


def test_two_stream_step_twin_with_a_forced_rebin():
    """two_stream at 32^2 (buckets 1536, mover buffer 640, runs 512: the
    sort route of the movers and append_incoming) against JAX's
    use_pallas="on" step (interpreted kernels) from the handed-over seeded
    state, 15 steps, all three species.  The cold beams move ~0.035 cells a
    step, far from the 1.79-cell trigger, so step 7 sets the drift past the
    force line on both sides: a forced re-bin, whose buckets must agree."""
    jcase = jstd.make("two_stream", nx=32, ny=32)
    tcase = tstd.make("two_stream", nx=32, ny=32)
    jdeck = dataclasses.replace(jcase.deck, use_pallas="on")
    jsim = JSimulation(jdeck, seed=1)
    jsim.state = jcase.seed_state(jsim.state, jdeck)
    tsim = Simulation(tcase.deck, device="cpu")
    tsim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), CPU)
    deck = tsim.deck
    p0 = tsim.state.species[0]
    mc = deck.mover_cap(p0.capacity)
    assert p0.capacity < 8 * deck.mover_seg_cap(mc) + 256
    n_live0 = int(sum((p.w > 0).sum() for p in tsim.state.species))
    for k in rb.KERNELS.values():
        k.reset()
    rebins = 0
    for i in range(15):
        if i == 7:
            far = deck.force_threshold() + 0.01
            jsim.state = jsim.state._replace(drift=jnp.float32(far))
            tsim.state = tsim.state._replace(
                drift=torch.tensor(far, dtype=torch.float32))
        dj, dt_ = jsim.step(), tsim.step()
        np.testing.assert_allclose(float(dt_.field_energy),
                                   float(dj.field_energy), rtol=1e-4,
                                   atol=1e-12, err_msg=f"step {i}")
        np.testing.assert_allclose(dt_.kinetic_energy.numpy(),
                                   np.asarray(dj.kinetic_energy), rtol=1e-5,
                                   err_msg=f"step {i}")
        # Momentum to 1e-5 of the system's summed |w u|: the cold ions'
        # total (~1e-13 of their own ~1e-8 sum at step 2) is round-off of
        # the field's push, so their own sum is no scale for it.
        mscale = sum(float((p.w.double() * (p.px.abs() + p.py.abs()
                                            + p.pz.abs()).double()).sum())
                     for p in tsim.state.species)
        np.testing.assert_allclose(dt_.momentum.numpy(),
                                   np.asarray(dj.momentum), rtol=0,
                                   atol=1e-5 * mscale, err_msg=f"step {i}")
        assert int(dt_.overflow) == 0 and int(dj.overflow) == 0
        assert int(dt_.shard_live[0]) == n_live0
        reset_t = float(tsim.state.drift) == 0.0
        assert reset_t == (float(jsim.state.drift) == 0.0), f"step {i}"
        if reset_t:
            rebins += 1
            for p, jp in zip(tsim.state.species, jsim.state.species):
                w = p.w.numpy()
                np.testing.assert_array_equal(w, np.asarray(jp.w))
                np.testing.assert_allclose(p.x.numpy()[w > 0],
                                           np.asarray(jp.x)[w > 0], rtol=0,
                                           atol=1e-4)
        np.testing.assert_allclose(float(tsim.state.drift),
                                   float(jsim.state.drift), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i}")
    assert rebins == 1
    # The plain versions stood in for the kernels: nothing was launched.
    assert all(k.launches == 0 for k in rb.KERNELS.values())


def _jax_twin(name, kw, monkeypatch, seed=1):
    """JAX's use_pallas="on" simulation of a deck (interpreted kernels) from
    its init_fields, and the port's on the CPU from the handed-over state;
    a window deck's port injects JAX's plasma (monkeypatched)."""
    jcase = jstd.make(name, **kw)
    jdeck = dataclasses.replace(jcase.deck, use_pallas="on")
    jsim = JSimulation(jdeck, fields=jcase.init_fields(jdeck), seed=seed)
    tsim = Simulation(tstd.make(name, **kw).deck, device=CPU)
    tsim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), CPU)
    if jdeck.moving_window:
        import jax

        from minipic_tpu.particles.species import inject_column
        from minipic_tpu.simulation import window_injection_key

        names = [s.name for s in jdeck.species]

        def inject(spec, domain, tiling, capacity, key, x0, dtype, device,
                   row_ids=None):
            i = names.index(spec.name)

            def f(w0n):
                return inject_column(jdeck.species[i], jdeck.domain,
                                     jdeck.tiling, capacity,
                                     window_injection_key(i, w0n), w0n,
                                     jnp.float32)
            inj = jax.jit(f)(jnp.int32(x0))
            return tsp.ParticleState(*(torch.from_numpy(np.array(a))
                                       for a in inj))

        monkeypatch.setattr(tsp, "inject_column", inject)
    return jsim, tsim


def _wall_census(monkeypatch, n_species):
    """Live particles killed at each wall (x < 0, x >= nx, y < 0, y >= ny)
    per species, counted on both sides: JAX's through a host callback from
    its traced step, the port's as it steps.  Each step kills species by
    species in order, so the calls take turns."""
    import jax

    import minipic_tpu.simulation as jmod
    import minipic_torch.simulation as tmod

    counts = {k: np.zeros((n_species, 4), np.int64) for k in ("jax", "port")}

    def census(xp, real, side):
        calls = [0]

        def wrap(p, nx, ny, periodic):
            k = calls[0] % n_species
            calls[0] += 1
            live = p.w > 0
            out = xp.stack([(live & c).sum() for c in (
                p.x < 0, p.x >= nx, p.y < 0, p.y >= ny)])
            if side == "jax":
                jax.debug.callback(
                    lambda o, k=k: counts["jax"].__setitem__(
                        k, counts["jax"][k] + np.asarray(o)), out)
            else:
                counts["port"][k] += out.numpy()
            return real(p, nx, ny, periodic)
        return wrap

    monkeypatch.setattr(jmod, "wrap_positions",
                        census(jnp, jmod.wrap_positions, "jax"))
    monkeypatch.setattr(tmod, "wrap_positions",
                        census(torch, tmod.wrap_positions, "port"))
    return counts


@pytest.mark.parametrize("name,kw,steps", [
    ("laser_plasma", dict(nx=32, ny=32, ppc=2), 12),
    ("laser_wakefield_window", dict(nx=64, ny=32, ppc=2), 47),
], ids=["laser_plasma", "laser_wakefield_window"])
def test_open_deck_step_twin(name, kw, steps, monkeypatch):
    """The open decks against JAX's use_pallas="on" step from one state:
    laser_plasma at 32^2 (1536 -> 768-slot buckets: the small-bucket
    route) and the window deck at 64x32 through its first two shifts, with
    the bars of the two_stream twin (field energy 1e-4, kinetic 1e-5,
    momentum 1e-5 of the summed |w u|); the re-bin steps, the live counts
    and the window's origin agree, and so do the kills at each wall,
    species by species: the electrons' thermal leak through the y walls
    is JAX's as well as the port's."""
    walls = _wall_census(monkeypatch, 2)
    jsim, tsim = _jax_twin(name, kw, monkeypatch)
    deck = tsim.deck
    for k in rb.KERNELS.values():
        k.reset()
    rebins, lives, first_shift = 0, [], None
    n_live0 = sum(int((p.w > 0).sum()) for p in tsim.state.species)
    for i in range(steps):
        dj, dt_ = jsim.step(), tsim.step()
        lives.append(int(dt_.shard_live[0]))
        if deck.moving_window and first_shift is None \
                and int(tsim.state.window_x0) > 0:
            first_shift = i
        np.testing.assert_allclose(float(dt_.field_energy),
                                   float(dj.field_energy), rtol=1e-4,
                                   atol=1e-12, err_msg=f"step {i}")
        np.testing.assert_allclose(dt_.kinetic_energy.numpy(),
                                   np.asarray(dj.kinetic_energy), rtol=1e-5,
                                   err_msg=f"step {i}")
        mscale = sum(float((p.w.double() * (p.px.abs() + p.py.abs()
                                            + p.pz.abs()).double()).sum())
                     for p in tsim.state.species)
        np.testing.assert_allclose(dt_.momentum.numpy(),
                                   np.asarray(dj.momentum), rtol=0,
                                   atol=1e-5 * mscale, err_msg=f"step {i}")
        assert int(dt_.overflow) == 0 and int(dj.overflow) == 0
        assert int(dt_.shard_live[0]) == int(dj.shard_live[0]), f"step {i}"
        reset_t = float(tsim.state.drift) == 0.0
        assert reset_t == (float(jsim.state.drift) == 0.0), f"step {i}"
        assert dt_.rebinned == reset_t
        rebins += reset_t
        if reset_t:
            for p, jp in zip(tsim.state.species, jsim.state.species):
                w = p.w.numpy()
                np.testing.assert_array_equal(w, np.asarray(jp.w))
                np.testing.assert_allclose(p.x.numpy()[w > 0],
                                           np.asarray(jp.x)[w > 0], rtol=0,
                                           atol=1e-4)
        if deck.moving_window:
            assert int(tsim.state.window_x0) == int(jsim.state.window_x0)
    assert rebins >= 3
    if deck.moving_window:
        assert int(tsim.state.window_x0) == 2 * deck.tile_nx
        # Before its first shift, the window deck lost particles through
        # its walls, on both sides alike.
        assert min(lives[:first_shift]) < n_live0
    np.testing.assert_array_equal(walls["port"], walls["jax"])
    if deck.moving_window:
        # The electrons leak through both y walls; the cold ions do not.
        assert walls["port"][0, 2:].min() > 0, walls["port"]
        assert walls["port"][1].sum() == 0, walls["port"]
    assert all(k.launches == 0 for k in rb.KERNELS.values())
