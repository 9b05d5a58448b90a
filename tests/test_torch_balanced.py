"""The port's striped (balanced) simulation
(minipic_torch/parallel/balanced.py) against the JAX package's
BalancedSimulation and the port's own single-device Simulation, and the
load-balance claim of tests/test_balanced.py: under a count-contrast blob
the striped placement keeps the per-shard live counts near uniform where
the block placement is skewed.  Every shard of the port sits on the
CPU."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.parallel import balanced as jbal  # noqa: E402
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.parallel import balanced as tbal  # noqa: E402
from minipic_torch.parallel.balanced import BalancedSimulation  # noqa
from minipic_torch.parallel.step import ShardedSimulation  # noqa: E402
from minipic_torch.simulation import Simulation  # noqa: E402

from test_torch_parallel import (  # noqa: E402
    CPU, N_STEPS, _canon, _deck, _same_particles, _species_of,
    _window_deck)


@pytest.mark.parametrize("tr,tc,s", [(8, 8, 8), (16, 16, 8), (8, 8, 4),
                                     (6, 10, 4), (64, 64, 8)])
def test_stripe_map_equals_jax(tr, tc, s):
    np.testing.assert_array_equal(tbal.shard_of_tile(tr, tc, s),
                                  jbal.shard_of_tile(tr, tc, s))
    np.testing.assert_array_equal(tbal.stripe_gids(tr, tc, s),
                                  jbal.stripe_gids(tr, tc, s))
    np.testing.assert_array_equal(
        tbal.balanced_permutation(tr * tc, s, tr, tc),
        jbal.balanced_permutation(tr * tc, s, tr, tc))
    assert (np.bincount(tbal.shard_of_tile(tr, tc, s), minlength=s)
            == tr * tc // s).all()


def _perm(deck, n):
    t = deck.tiling
    return tbal.balanced_permutation(t.num_tiles, n, t.tile_rows,
                                     t.tile_cols)


@pytest.fixture(scope="module")
def jax_balanced_run():
    """JAX's BalancedSimulation over 4 devices: its initial state, and its
    state and diag after N_STEPS."""
    jsim = jbal.BalancedSimulation(_deck(jcfg), seed=7,
                                   devices=jax.devices()[:4])
    init = bridge.sim_state_to_numpy(jsim.state)
    diag = jsim.step(N_STEPS)
    return init, bridge.sim_state_to_numpy(jsim.state), diag


def test_balanced_matches_jax_balanced(jax_balanced_run):
    """From JAX's initial state, the port's striped step over 4 shards
    against JAX's (f64): fields to round-off, energies, per-shard live
    counts and each tile's live multiset."""
    init, want, jdiag = jax_balanced_run
    deck = _deck(tcfg)
    sim = BalancedSimulation(deck, devices=[CPU] * 4)
    sim.state = bridge.sim_state_from_numpy(init, CPU)
    diag = sim.step(N_STEPS)
    got = bridge.sim_state_to_numpy(sim.state)
    assert int(diag.overflow) == 0 and int(jdiag.overflow) == 0
    for name in ("ex", "ey", "ez", "bx", "by", "bz"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-10,
                                   atol=1e-13, err_msg=name)
    np.testing.assert_allclose(float(diag.field_energy),
                               float(jdiag.field_energy), rtol=1e-10)
    np.testing.assert_allclose(diag.kinetic_energy.numpy(),
                               np.asarray(jdiag.kinetic_energy), rtol=1e-10)
    np.testing.assert_array_equal(diag.shard_live.numpy(),
                                  np.asarray(jdiag.shard_live))
    perm = _perm(deck, 4)
    _same_particles(_canon(_species_of(want), perm),
                    _canon(_species_of(got), perm), 1e-10, 1e-12)


@pytest.mark.parametrize("rebin_mode", ["auto", "sort"])
def test_balanced_matches_single_device(rebin_mode):
    """Same deck and seed over 8 shards: the striped run reproduces the
    port's Simulation (the mover gather and route, or the sort fallback)."""
    deck = _deck(tcfg, rebin_mode=rebin_mode)
    ref = Simulation(deck, seed=7, device="cpu")
    ba = BalancedSimulation(deck, seed=7, devices=[CPU] * 8)
    dref, dba = ref.step(N_STEPS), ba.step(N_STEPS)
    assert int(dref.overflow) == 0 and int(dba.overflow) == 0
    st = ba.state
    for a, b in zip(ref.state.fields, st.fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-13)
    np.testing.assert_allclose(dba.kinetic_energy.numpy(),
                               dref.kinetic_energy.numpy(), rtol=1e-10)
    T = deck.tiling.num_tiles
    _same_particles(_canon(ref.state.species, np.arange(T)),
                    _canon(st.species, _perm(deck, 8)), 1e-10, 1e-12)


def test_balanced_incremental_rebin_matches_single_device():
    """The split with striped gids (tile_ids) and the appends, f32
    (tests/test_balanced.py:99): energies and the live count conserved."""
    deck = _deck(tcfg, rebin_mode="incremental", precision="f32",
                 kchunk=64, capacity_headroom=3.0, mover_capacity=256)
    ref = Simulation(deck, seed=7, device="cpu")
    ba = BalancedSimulation(deck, seed=7, devices=[CPU] * 4)
    dref, dba = ref.step(10), ba.step(10)
    assert int(dref.overflow) == 0 and int(dba.overflow) == 0
    np.testing.assert_allclose(float(dba.field_energy),
                               float(dref.field_energy), rtol=1e-4)
    np.testing.assert_allclose(dba.kinetic_energy.numpy(),
                               dref.kinetic_energy.numpy(), rtol=1e-5)
    n0 = sum(s.ppc * deck.nx * deck.ny for s in deck.species)
    assert (sum(int(p.alive_count()) for p in ref.state.species)
            == sum(int(p.alive_count()) for p in ba.state.species) == n0)
    T = deck.tiling.num_tiles
    a = _canon(ref.state.species, np.arange(T))
    b = _canon(ba.state.species, _perm(deck, 4))
    assert [len(t) for t in a[0]] == [len(t) for t in b[0]]


def test_balanced_beam_sweep_no_losses():
    """A fast beam crosses many stripe boundaries (every mover's
    destination is any shard): the live count is conserved exactly."""
    deck = _deck(tcfg, species=(tcfg.SpeciesSpec(
        "beam", charge=-1.0, mass=1e12, ppc=2, ux=0.9, uy=0.45),))
    ba = BalancedSimulation(deck, seed=1, devices=[CPU] * 8)
    n0 = int(ba.state.species[0].alive_count())
    for _ in range(3):
        d = ba.step(10)
        assert int(d.overflow) == 0 and int(d.shard_live.sum()) == n0


def _blob_deck(cfg):
    """tests/test_balanced.py:145's count-contrast blob at 128^2."""
    def blob(x, y):
        r2 = (x - 8.0) ** 2 + (y - 8.0) ** 2
        return 0.1 + 4.0 * torch.exp(-r2 / (2.0 * 1.6 ** 2))

    return _deck(cfg, box_x=16.0, box_y=16.0, nx=128, ny=128, species=(
        cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=8, uth=0.05,
                        density=blob, load_mode="count"),),
        precision="f32")


def test_striped_placement_bounds_count_skew():
    """The bars of tests/test_balanced.py:184-187: block placement over
    the (2, 4) mesh skews the per-shard live count past 1.5 (max/mean),
    striped placement holds it under 1.10; the same physics either way;
    RunHistory.live_skew reads the same skew from the diag."""
    from minipic_torch.diag.history import RunHistory

    deck = _blob_deck(tcfg)
    sh = ShardedSimulation(deck, seed=3, devices=[CPU] * 8)
    ba = BalancedSimulation(deck, seed=3, devices=[CPU] * 8)
    dsh, dba = sh.step(2), ba.step(2)

    def skew(d):
        live = d.shard_live.numpy().astype(np.float64)
        assert live.shape == (8,) and live.sum() > 0
        return float(live.max() / live.mean())

    s_block, s_stripe = skew(dsh), skew(dba)
    assert s_block > 1.5, s_block
    assert s_stripe < 1.10, s_stripe
    np.testing.assert_allclose(float(dba.field_energy),
                               float(dsh.field_energy), rtol=1e-4)
    hist = RunHistory()
    hist.record(2, deck.dt, dsh)
    hist.record(2, deck.dt, dba)
    np.testing.assert_allclose(hist.live_skew, [s_block, s_stripe],
                               rtol=1e-12)


def test_balanced_window_matches_single_device():
    """The striped moving window (the gid <-> storage map rotated by the
    shift count, the trailing storage column injected) equals the
    single-device window over two shifts (tests/test_moving_window.py:187);
    the storage -> window-gid unpick applies the same rotation."""
    deck = _window_deck(tcfg)
    ref = Simulation(deck, seed=7, device="cpu")
    ba = BalancedSimulation(deck, seed=7, devices=[CPU] * 4)
    ref.step(50)
    ba.step(50)
    st = ba.state
    assert int(ref.state.window_x0) == int(st.window_x0) > 8
    for a, b in zip(ref.state.fields, st.fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-12)
    t = deck.tiling
    static = _perm(deck, 4)
    k = int(st.window_x0) // deck.tile_nx
    r, c = static // t.tile_cols, static % t.tile_cols
    perm = r * t.tile_cols + (c - k) % t.tile_cols
    _same_particles(_canon(ref.state.species, np.arange(t.num_tiles)),
                    _canon(st.species, perm), 1e-10, 1e-12)
