"""The slice as a whole: the port's Simulation.step against the JAX
package's (advance kernel interpreted) on small headline-shaped decks,
from the same handed-over state: the sort re-bin, and the deal route
("auto", the default) against JAX's Pallas "auto" route."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.particles.binning import tile_counts as j_tile_counts  # noqa
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.particles.binning import tile_counts  # noqa: E402
from minipic_torch.simulation import Simulation, build_step  # noqa: E402

STEPS = 30


def _deck(cfg, **kw):
    """bench.py's headline deck at 32^2: 8x8 tiles, guard 4, TSC, int8,
    whole-bucket chunks, sort re-bin.  uth 0.1 drives the drift trigger
    every ~8 steps."""
    base = dict(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=8,
                                 uth=0.1, ux=0.05, shape_order=2),),
        precision="f32", capacity_headroom=1.1, kchunk=0, deposit="int8",
        rebin_mode="sort")
    base.update(kw)
    return cfg.Deck(**base)


def test_step_matches_jax_over_30_steps():
    jdeck = _deck(jcfg, use_pallas="on")
    jsim = JSimulation(jdeck, seed=1)
    tsim = Simulation(_deck(tcfg), device="cpu")
    tsim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), torch.device("cpu"))
    assert tsim.backend == "plain"

    n_live0 = int((tsim.state.species[0].w > 0).sum())
    rebins = 0
    for i in range(STEPS):
        dj = jsim.step()
        dt_ = tsim.step()
        # Energies as test_pallas_kernel.py:87-92 holds the interpreted
        # kernel against the XLA path.
        np.testing.assert_allclose(float(dt_.field_energy),
                                   float(dj.field_energy), rtol=1e-4,
                                   atol=1e-12, err_msg=f"step {i}")
        np.testing.assert_allclose(dt_.kinetic_energy.numpy(),
                                   np.asarray(dj.kinetic_energy), rtol=1e-5,
                                   err_msg=f"step {i}")
        # Total momentum of a thermal plasma nearly cancels; hold it to
        # 1e-5 of the summed |w u| (f32 pushes that agree to ~1e-7 each).
        p = tsim.state.species[0]
        mscale = float((p.w.double() * (p.px.abs() + p.py.abs()
                                        + p.pz.abs()).double()).sum())
        np.testing.assert_allclose(dt_.momentum.numpy(),
                                   np.asarray(dj.momentum), rtol=0,
                                   atol=1e-5 * mscale, err_msg=f"step {i}")
        assert int(dt_.overflow) == 0 and int(dj.overflow) == 0
        assert int(dt_.weight_nonuniform) == 0
        assert int(dt_.shard_live[0]) == n_live0
        reset_t = float(tsim.state.drift) == 0.0
        reset_j = float(jsim.state.drift) == 0.0
        assert reset_t == reset_j, f"step {i}: drift resets differ"
        if reset_t:
            rebins += 1
            np.testing.assert_array_equal(
                tile_counts(tsim.state.species[0]).numpy(),
                np.asarray(j_tile_counts(jsim.state.species[0])),
                err_msg=f"step {i}")
        np.testing.assert_allclose(float(tsim.state.drift),
                                   float(jsim.state.drift), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i}")
    assert rebins >= 1
    assert int(tsim.state.step) == STEPS


@pytest.mark.parametrize("trigger", ["drift", "interval"])
def test_auto_step_matches_jax_through_a_rebin(trigger, monkeypatch):
    """The default "auto" deck (the deal route; plain versions on the CPU)
    against JAX's use_pallas="on" "auto" step (interpreted kernels) on the
    32^2 ppc-40 deck, the smallest headline-shaped deck whose 3072-slot
    buckets take the deal route.  On the drift trigger its drift reaches
    the 1.79-cell threshold at step 12; on the interval schedule (every 4
    steps, with the grace of one deferred step) it re-bins at steps 0, 4,
    8, 12.  JAX runs with 256-slot segment chunks, a multiple of the
    deck's 256-slot runs: at its default 512 its segment kernel drops
    every run's tail short of a whole chunk (ROADMAP C)."""
    monkeypatch.setenv("MINIPIC_SEG_KC", "256")
    kw = dict(species=(jcfg.SpeciesSpec("ele", charge=-1.0, mass=1.0,
                                        ppc=40, uth=0.1, ux=0.05,
                                        shape_order=2),),
              rebin_mode="auto")
    if trigger == "interval":
        kw.update(rebin_trigger="interval", rebin_interval=4)
    jsim = JSimulation(_deck(jcfg, use_pallas="on", **kw), seed=1)
    kw["species"] = (tcfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=40,
                                      uth=0.1, ux=0.05, shape_order=2),)
    tsim = Simulation(_deck(tcfg, **kw), device="cpu")
    assert tsim.deck.uses_drift_trigger() == (trigger == "drift")
    p0 = tsim.state.species[0]
    mc = tsim.deck.mover_cap(p0.capacity)
    assert p0.capacity >= 8 * tsim.deck.mover_seg_cap(mc) + 256 and mc > 0
    tsim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), torch.device("cpu"))
    n_live0 = int((tsim.state.species[0].w > 0).sum())
    rebins = 0
    for i in range(15):
        dj, dt_ = jsim.step(), tsim.step()
        np.testing.assert_allclose(float(dt_.field_energy),
                                   float(dj.field_energy), rtol=1e-4,
                                   atol=1e-12, err_msg=f"step {i}")
        np.testing.assert_allclose(dt_.kinetic_energy.numpy(),
                                   np.asarray(dj.kinetic_energy), rtol=1e-5,
                                   err_msg=f"step {i}")
        p = tsim.state.species[0]
        mscale = float((p.w.double() * (p.px.abs() + p.py.abs()
                                        + p.pz.abs()).double()).sum())
        np.testing.assert_allclose(dt_.momentum.numpy(),
                                   np.asarray(dj.momentum), rtol=0,
                                   atol=1e-5 * mscale, err_msg=f"step {i}")
        assert int(dt_.overflow) == 0 and int(dj.overflow) == 0
        assert int(dt_.shard_live[0]) == n_live0
        reset_t = float(tsim.state.drift) == 0.0
        assert reset_t == (float(jsim.state.drift) == 0.0), f"step {i}"
        if reset_t:
            rebins += 1
            jp = jsim.state.species[0]
            np.testing.assert_array_equal(
                tile_counts(p).numpy(), np.asarray(j_tile_counts(jp)),
                err_msg=f"step {i}")
            # The same particles in the same slots: the weights slot for
            # slot, the live positions to the pushes' f32 agreement (JAX's
            # advance also moves dead slots, ROADMAP C).
            w = p.w.numpy()
            np.testing.assert_array_equal(w, np.asarray(jp.w))
            np.testing.assert_allclose(p.x.numpy()[w > 0],
                                       np.asarray(jp.x)[w > 0], rtol=0,
                                       atol=1e-4)
        np.testing.assert_allclose(float(tsim.state.drift),
                                   float(jsim.state.drift), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i}")
    assert rebins >= 1


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(_deck(tcfg), device="cuda")


def test_the_card_is_the_default_device(monkeypatch):
    """Simulation runs on the card unless asked for the CPU, and never
    falls back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(_deck(tcfg))


@pytest.mark.parametrize("kw", [
    dict(deposit="", gather_precision="fast"),
    dict(deposit="", gather_precision="f32x3"),
])
def test_unported_options_raise(kw):
    """The JAX package's TPU gather modes are not ported (ROADMAP A10);
    absorbing walls and the moving window are (test_torch_window.py)."""
    with pytest.raises(NotImplementedError):
        build_step(_deck(tcfg, **kw), torch.device("cpu"))
