"""The port's one driver and one re-bin decision on the CPU:
``simulation.Schedule`` taken alike by ``Simulation``, ``ShardedSimulation``
and ``BalancedSimulation``; the host reads of the one-card step on the
interval schedule, counted by hand; ``binning.finish_rebin``, the tail of
every incremental re-bin; and the surface that ``simulation.Driver`` gives
the three simulations (``run``, ``run_step``, ``force_rebin``, the
capacity policy's ``_capmgrs``)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core.geometry import Tiling as JTiling  # noqa: E402
from minipic_tpu.core.state import ParticleState as JP  # noqa: E402
from minipic_tpu.particles import binning as jb  # noqa: E402
from minipic_torch import trace  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.geometry import Tiling  # noqa: E402
from minipic_torch.core.state import (FieldState, ParticleState,  # noqa
                                      SimState)
from minipic_torch.parallel.balanced import BalancedSimulation  # noqa: E402
from minipic_torch.parallel.step import ShardedSimulation  # noqa: E402
from minipic_torch.particles.binning import (finish_rebin,  # noqa: E402
                                             rebin_auto)
from minipic_torch.simulation import Schedule, Simulation  # noqa: E402

from test_torch_parallel import CPU, _deck  # noqa: E402
from test_torch_rebin_small import _state  # noqa: E402

LAYOUTS = ("single", "sharded", "balanced")
GRID = dict(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
STEPS = 14


def _decks():
    """tests/test_parallel.py:84's deck in f32 on the (2, 2) mesh with the
    incremental re-bin (768-slot buckets, the sort route of the movers):
    the drift trigger (guard 3: a re-bin at step 8), the interval schedule
    every 3 steps with its grace (guard 4; 16-slot mover buffers leave a
    backlog that re-bins on the next step), and every 2 steps without it
    (guard 2 leaves no room for a deferred step)."""
    base = dict(mesh_shape=(2, 2), precision="f32", rebin_mode="incremental",
                capacity_headroom=3.0, kchunk=64)
    return {
        "drift": _deck(tcfg, guard=3, **base),
        "grace": _deck(tcfg, guard=4, rebin_trigger="interval",
                       rebin_interval=3, mover_capacity=16, **base),
        "plain": _deck(tcfg, guard=2, rebin_trigger="interval",
                       rebin_interval=2, **base),
    }


def _make(layout, deck):
    if layout == "single":
        return Simulation(deck, seed=7, device="cpu")
    if layout == "sharded":
        return ShardedSimulation(deck, seed=7, device="cpu")
    return BalancedSimulation(deck, seed=7, devices=[CPU] * 4)


@pytest.mark.parametrize("name", ["drift", "grace", "plain"])
def test_rebin_steps_agree_over_the_drivers(name):
    """The three simulations re-bin on the same steps, each deck's
    schedule as its kind makes it."""
    deck = _decks()[name]
    sched = Schedule(deck)
    assert sched.trigger_drift == (name == "drift")
    assert sched.interval_grace == (name != "plain")
    sims = [_make(layout, deck) for layout in LAYOUTS]
    steps = [[s.step().rebinned for s in sims] for _ in range(STEPS)]
    assert all(len(set(r)) == 1 for r in steps), steps
    rebinned = [r[0] for r in steps]
    k = deck.rebin_interval
    if name == "drift":
        assert 0 < sum(rebinned) < STEPS
    elif name == "grace":
        assert all(r for n, r in enumerate(rebinned) if n % k == 0)
        assert any(r for n, r in enumerate(rebinned) if n % k)
    else:
        assert rebinned == [n % k == 0 for n in range(STEPS)]
    drifts = {float(s.state.drift) for s in sims}
    assert len(drifts) == 1


@pytest.mark.parametrize("name", ["grace", "plain"])
def test_interval_host_reads_equal_a_hand_count(name):
    """On the interval schedule the one-card step counts its steps on the
    host: the counter is read once for the state the constructor made and
    once for a state set from outside; under the grace a step the interval
    does not fire reads the backlog flag; run_step reads the overflow of
    each step that re-binned and takes the census after a drop (the
    grace's forced pass drops what the small buffers cannot take)."""
    deck = _decks()[name]
    k = deck.rebin_interval
    sim = Simulation(deck, seed=7, device="cpu")
    trace.drain()
    trace.enable()
    try:
        diags = [sim.run_step(i) for i in range(1, 7)]
        sim.state = sim.state._replace(step=sim.state.step.clone())
        diags += [sim.run_step(i) for i in range(7, STEPS + 1)]
    finally:
        trace.disable()
    _, counters = trace.drain()
    rebins = sum(d.rebinned for d in diags)
    off = sum(n % k != 0 for n in range(len(diags)))
    census = sum(d.rebinned and int(d.overflow) > 0 for d in diags)
    want = {"host_reads.clock": 2,
            "host_reads.schedule": off if name == "grace" else 0,
            "host_reads.overflow": rebins,
            "host_reads.census": 2 * len(deck.species) * census}
    want["host_reads"] = sum(want.values())
    assert counters == {s: v for s, v in want.items() if v}
    # A re-bin off the interval is the grace's, and the grace deck takes
    # one.
    assert (rebins > len(diags) - off) == (name == "grace")


def _pending_state():
    """test_torch_rebin_small.py's stale 1536-slot buckets, 1400 live
    displaced by 2 cells: 512-slot mover buffers leave a backlog."""
    chans = _state(n_live=1400, sigma=2.0, seed=5)
    return (JP(*(jnp.asarray(c) for c in chans)),
            ParticleState(*(torch.tensor(c) for c in chans)))


@pytest.mark.parametrize("force", ["true", "false", "tensor"])
def test_finish_rebin_is_the_forced_pass(force):
    """finish_rebin: a forced pass (a bool or a 0-d bool tensor) adds the
    backlog to the drops and leaves none; an unforced one keeps it.
    rebin_auto, which ends in it, returns what JAX's returns."""
    dropped = torch.tensor(3, dtype=torch.int32)
    pending = torch.tensor([0, 2, 5, 0], dtype=torch.int32)
    flags = {"true": [True], "false": [False],
             "tensor": [torch.tensor(True), torch.tensor(False)]}[force]
    for f in flags:
        d, p = finish_rebin(dropped, pending, f)
        assert d.dtype == p.dtype == torch.int32
        assert d.shape == p.shape == ()
        assert (int(d), int(p)) == ((10, 0) if bool(f) else (3, 7))
    jp, tp = _pending_state()
    f = flags[0]
    j, jd, jpend = jb.rebin_auto(jp, JTiling(**GRID), 512, interpret=True,
                                 seg_cap=256, force=bool(f))
    t, td, tpend = rebin_auto(tp, Tiling(**GRID), 512, seg_cap=256,
                              force=f)
    for name, a, b in zip(ParticleState._fields, j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert (int(td), int(tpend)) == (int(jd), int(jpend))
    assert (int(tpend) == 0) == bool(f)
    # The state leaves a backlog when not forced.
    _, _, upend = rebin_auto(_pending_state()[1], Tiling(**GRID), 512,
                             seg_cap=256)
    assert int(upend) > 0


def _clone(st: SimState) -> SimState:
    return SimState(
        fields=FieldState(*(a.clone() for a in st.fields)),
        species=tuple(ParticleState(*(a.clone() for a in p))
                      for p in st.species),
        step=st.step.clone(), drift=st.drift.clone(),
        window_x0=None if st.window_x0 is None else st.window_x0.clone())


def _equal(a: SimState, b: SimState) -> None:
    for x, y in zip(a.fields, b.fields):
        assert torch.equal(x, y)
    for p, q in zip(a.species, b.species):
        for x, y in zip(p, q):
            assert torch.equal(x, y)
    assert int(a.step) == int(b.step)
    assert float(a.drift) == float(b.drift)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_driver_surface(layout):
    """On each simulation: run(n) is n run_steps from a copy of the state;
    force_rebin makes the next run_step re-bin; the capacity policy's
    managers exist from construction, and setting them to None restarts
    the policy (the calm checks count from zero again)."""
    deck = _decks()["drift"]
    a, b = _make(layout, deck), _make(layout, deck)
    assert a._capmgrs is None
    b.state = _clone(a.state)
    a.run(3)
    for i in range(1, 4):
        b.run_step(i)
    _equal(a.state, b.state)
    assert a.overflow_total == b.overflow_total == 0
    assert a.capacity_changes == b.capacity_changes == 0
    # The drift trigger first fires at step 8.
    assert not b.run_step(4).rebinned
    b.force_rebin()
    assert b.run_step(5).rebinned and float(b.state.drift) == 0.0
    assert not b.run_step(6).rebinned

    def calm(sim):
        return [m._calm for m in sim._capmgrs]

    a.run_step(50)
    first = calm(a)
    assert len(first) == len(deck.species) and min(first) >= 1
    a.run_step(100)
    assert calm(a) == [c + 1 for c in first]
    a._capmgrs = None
    a.run_step(150)
    assert calm(a) == first
