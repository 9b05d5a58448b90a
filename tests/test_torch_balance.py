"""Load census and adaptive capacity (minipic_torch/parallel/balance.py)
against the JAX package's, and ``Simulation.run`` growing the buckets of a
deck that overflows."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core.geometry import Tiling as JTiling  # noqa: E402
from minipic_tpu.core.state import ParticleState as JP  # noqa: E402
from minipic_tpu.parallel import balance as jbal  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.geometry import Tiling  # noqa: E402
from minipic_torch.core.state import ParticleState  # noqa: E402
from minipic_torch.parallel import balance as tbal  # noqa: E402
from minipic_torch.simulation import CAPACITY_CHECK_EVERY, Simulation  # noqa

T, CAP = 16, 512
JT = JTiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
TT = Tiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)


def _state(seed=0, n_max=400):
    """Stale buckets with a different live count per tile, particles up to
    1.5 cells off their tile on a 32^2 periodic grid."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = np.arange(T)[:, None]
    n = rng.integers(n_max // 4, n_max, T)[:, None]
    live = np.arange(CAP)[None, :] < n

    def pos(origin):
        v = (origin + rng.random((T, CAP)) * 11 - 1.5).astype(f32)
        v = np.mod(v, f32(32)).astype(f32)
        return np.where(v >= 32, v - f32(32), v).astype(f32)

    chans = [pos((t % 4) * 8), pos((t // 4) * 8)]
    chans += [rng.normal(0, 0.1, (T, CAP)).astype(f32) for _ in range(3)]
    chans.append(np.full((T, CAP), 0.004, f32))
    chans = [np.where(live, c, f32(0)) for c in chans]
    return (JP(*(jnp.asarray(c) for c in chans)),
            ParticleState(*(torch.tensor(c) for c in chans)))


def test_census_and_positional_counts_match_jax():
    jp, tp = _state()
    assert tuple(tbal.census(tp)) == tuple(jbal.census(jp))
    np.testing.assert_array_equal(
        tbal.positional_tile_counts(tp, TT).numpy(),
        np.asarray(jbal.positional_tile_counts(jp, JT)))


def test_with_capacity_matches_jax():
    """Growth pads with dead slots; a shrink re-bins (live slots agree slot
    for slot; the port's dead slots are zero, JAX's filler sort leaves them
    as it found them, ROADMAP C); a shrink below the positional census
    raises in both."""
    jp, tp = _state(seed=1)
    for a, b in zip(jbal.with_capacity(jp, 1024), tbal.with_capacity(tp, 1024)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    need = int(tbal.positional_tile_counts(tp, TT).max())
    new = -(-need // 8) * 8
    j = jbal.with_capacity(jp, new, JT)
    t = tbal.with_capacity(tp, new, TT)
    live = t.w.numpy() > 0
    np.testing.assert_array_equal(np.asarray(j.w) > 0, live)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a)[live], b.numpy()[live])
        assert not b.numpy()[~live].any()
    for mod, p, tiling in ((jbal, jp, JT), (tbal, tp, TT)):
        with pytest.raises(ValueError):
            mod.with_capacity(p, need - 8, tiling)
        with pytest.raises(ValueError):
            mod.with_capacity(p, need - 8)


def test_capacity_manager_matches_jax():
    """The same decisions on the same census history: growth on overflow
    and on high occupancy, a shrink after four calm checks, hysteresis."""
    jm, tm = jbal.CapacityManager(), tbal.CapacityManager()
    history = [(500, 512, 0), (100, 512, 3), (100, 768, 0), (200, 768, 0),
               (100, 768, 0), (100, 768, 0), (100, 768, 0), (100, 768, 0),
               (260, 768, 0), (100, 768, 0), (100, 768, 0), (100, 768, 0),
               (100, 768, 0), (700, 768, 0)]
    plans = []
    for mx, cap, ovf in history:
        kw = dict(total=mx * T, max_tile=mx, mean_tile=mx / 2, capacity=cap,
                  occupancy=mx / cap, imbalance=2.0)
        a = jm.plan(jbal.LoadStats(**kw), ovf)
        b = tm.plan(tbal.LoadStats(**kw), ovf)
        assert a == b
        plans.append(b)
    assert plans[0] == 768 and plans[1] == 768 and plans[-1] == 1152
    assert 144 in plans  # the calm spell's shrink: 100 * 1.4 -> 144


def _tight_deck():
    """A 32^2 thermal deck whose 512-slot buckets start exactly full (ppc
    8): the first re-bins overflow, and the mover buffer (256) and runs
    (256) put it on the small-bucket route."""
    return tcfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(tcfg.SpeciesSpec("ele", -1.0, 1.0, ppc=8, uth=0.1,
                                  ux=0.05, shape_order=2),),
        tile_capacity=512, kchunk=0, deposit="int8", save_frequency=20)


def _jax_tight_sim():
    """The JAX package's Simulation of the tight deck on its interpreted
    kernels (the route the port takes), and the port's from its state."""
    from minipic_tpu.core import config as jcfg
    from minipic_tpu.simulation import Simulation as JSimulation
    from minipic_torch import bridge

    td = _tight_deck()
    jd = jcfg.Deck(
        **{f.name: getattr(td, f.name) for f in dataclasses.fields(tcfg.Deck)
           if f.name != "species"},
        species=tuple(jcfg.SpeciesSpec(**dataclasses.asdict(s))
                      for s in td.species),
        use_pallas="on")
    jsim = JSimulation(jd, seed=3)
    sim = Simulation(td, device="cpu")
    sim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), torch.device("cpu"))
    return jsim, sim


def test_run_grows_capacity_as_jax_run_does():
    """``run`` on the tight deck against the JAX package's ``run`` from the
    same state: the buckets grow on the same step (the first that
    overflows) to the same capacity, and the live count agrees after every
    step, so both dropped the same particles and nothing after the
    growth."""
    jsim, sim = _jax_tight_sim()
    p = sim.state.species[0]
    assert p.capacity == 512 and int((p.w > 0).sum(1).max()) == 512
    assert p.capacity < 8 * sim.deck.mover_seg_cap(
        sim.deck.mover_cap(512)) + 256
    n0 = int((p.w > 0).sum())
    seen = {"jax": [], "torch": []}

    def saver(key):
        return lambda state, i: seen[key].append(
            (i, state.species[0].w.shape[1],
             int((state.species[0].w > 0).sum())))

    jsim.run(2 * CAPACITY_CHECK_EVERY, save_every=1, saver=saver("jax"))
    sim.run(2 * CAPACITY_CHECK_EVERY, save_every=1, saver=saver("torch"))
    assert seen["torch"] == seen["jax"]
    caps = [c for _, c, _ in seen["torch"]]
    grew = caps.index(1024)  # 1.5 x 512, aligned to 512 slots
    assert 0 < grew < CAPACITY_CHECK_EVERY and set(caps[grew:]) == {1024}
    live = [n for _, _, n in seen["torch"]]
    # The step that overflowed dropped, and grew the buckets before the
    # saver saw it; nothing was lost after.
    assert live[grew - 1] == n0 > live[grew]
    assert set(live[grew:]) == {live[-1]}
    assert sim.overflow_total == n0 - live[-1] > 0
    assert sim.capacity_changes == 1


def test_run_calls_the_saver_and_keeps_everything_after_growth():
    sim = Simulation(_tight_deck(), seed=3, device="cpu")
    saved = []
    sim.run(CAPACITY_CHECK_EVERY,
            saver=lambda state, i: saved.append((i, int(state.step))))
    assert saved == [(0, 0), (20, 20), (40, 40)]
    assert sim.overflow_total > 0 and sim.capacity_changes == 1
    p = sim.state.species[0]
    n_live, lost = int((p.w > 0).sum()), sim.overflow_total
    sim.run(CAPACITY_CHECK_EVERY, save_every=1000)
    p = sim.state.species[0]
    assert sim.overflow_total == lost
    assert int((p.w > 0).sum()) == n_live
    assert sim.capacity_changes == 1
    assert int(sim.state.step) == 2 * CAPACITY_CHECK_EVERY


def test_run_reads_the_overflow_only_on_rebin_steps(monkeypatch):
    """``run`` reads a step's overflow only when the step re-binned (no
    other step can drop), and checks the census on the 50-step cadence."""
    sim = Simulation(dataclasses.replace(_tight_deck(), tile_capacity=1024),
                     seed=3, device="cpu")
    checks, rebinned, reads = [], [], []
    real_check, real_step = sim.ensure_capacity, sim._step

    class Diag:
        def __init__(self, d):
            self._d = d

        def __getattr__(self, name):
            if name == "overflow":
                reads.append(int(sim.state.step))
            return getattr(self._d, name)

    def step(state):
        state, d = real_step(state)
        rebinned.append(d.rebinned)
        return state, Diag(d)

    def check(overflow=0):
        checks.append((int(sim.state.step), overflow))
        return real_check(overflow)

    monkeypatch.setattr(sim, "_step", step)
    monkeypatch.setattr(sim, "ensure_capacity", check)
    sim.run(2 * CAPACITY_CHECK_EVERY + 7)
    assert checks == [(CAPACITY_CHECK_EVERY, 0), (2 * CAPACITY_CHECK_EVERY, 0)]
    assert reads == [i + 1 for i, r in enumerate(rebinned) if r]
    assert 0 < len(reads) < len(rebinned)
    assert sim.overflow_total == 0
