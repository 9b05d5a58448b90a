"""The port's deck, state and bridge against the JAX package."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.core import state as jstate  # noqa: E402
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core import state as tstate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _decks(cfg):
    """The headline deck (bench.py:58-102) and two small ones."""
    headline = cfg.Deck(
        box_x=51.2, box_y=51.2, nx=512, ny=512, tile_nx=8, tile_ny=8,
        guard=4, species=(cfg.SpeciesSpec("ele", -1.0, 1.0, ppc=381,
                                          uth=0.05, shape_order=2),),
        precision="f32", rebin_interval=8, capacity_headroom=1.1, kchunk=0,
        deposit="int8", rebin_mode="sort")
    small_tsc = cfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(cfg.SpeciesSpec("e", -1.0, 1.0, ppc=8, ux=0.1, uth=0.1,
                                 shape_order=2),),
        kchunk=0, deposit="int8", rebin_mode="sort")
    small_cic = cfg.Deck(
        box_x=4.0, box_y=2.0, nx=32, ny=16, tile_nx=8, tile_ny=8, guard=2,
        species=(cfg.SpeciesSpec("e", -1.0, 1.0, ppc=4, uth=0.2,
                                 shape_order=1),
                 cfg.SpeciesSpec("i", 1.0, 100.0, ppc=2, uth=0.01,
                                 shape_order=1)),
        rebin_trigger="interval", rebin_interval=2, precision="f64")
    return headline, small_tsc, small_cic


def _derived(deck):
    cap = deck.capacity()
    t = deck.tiling
    return dict(
        capacity=cap, mover_cap=deck.mover_cap(cap),
        mover_seg_cap=deck.mover_seg_cap(deck.mover_cap(cap)),
        drift_threshold=deck.drift_threshold(),
        force_threshold=deck.force_threshold(),
        uses_drift_trigger=deck.uses_drift_trigger(),
        cfl_step_cells=deck.cfl_step_cells(), shape_reach=deck.shape_reach(),
        params_txt=deck.params_txt(), dt=deck.dt, dx=deck.dx, dy=deck.dy,
        total_steps=deck.total_steps,
        tiling=(t.tile_rows, t.tile_cols, t.num_tiles),
    )


@pytest.mark.parametrize("which", [0, 1, 2])
def test_deck_derived_quantities_match_jax(which):
    jd = _decks(jcfg)[which]
    td = _decks(tcfg)[which]
    jd.validate()
    td.validate()
    # Pure Python arithmetic on the same fields: equal, not close.
    assert _derived(td) == _derived(jd)
    assert td.dtype == (torch.float64 if jd.dtype == jnp.float64
                        else torch.float32)


def test_deck_validate_rejects_what_jax_rejects():
    for kw in (dict(guard=5), dict(dt_factor=1.0), dict(guard=1)):
        d = tcfg.Deck(nx=32, ny=32, tile_nx=8, tile_ny=8,
                      species=(tcfg.SpeciesSpec("e", shape_order=2),), **kw)
        with pytest.raises(ValueError):
            d.validate()


def test_bridge_round_trips_a_jax_state_bit_for_bit():
    jdeck = _decks(jcfg)[1]
    jsim = JSimulation(jdeck, seed=2)
    d = bridge.sim_state_to_numpy(jsim.state)
    st = bridge.sim_state_from_numpy(d, torch.device("cpu"))
    back = bridge.sim_state_to_numpy(st)
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    # The same particles, as the JAX arrays hold them.
    np.testing.assert_array_equal(st.species[0].x.numpy(),
                                  np.asarray(jsim.state.species[0].x))


def test_energy_and_momentum_match_jax_in_f64():
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=(16, 64)) * s for s in (10, 10, .1, .1, .1)]
    w = np.where(rng.random((16, 64)) < 0.8, 0.25, 0.0)
    pj = jstate.ParticleState(*(jnp.asarray(a) for a in arrs + [w]))
    pt = tstate.ParticleState(*(torch.from_numpy(a) for a in arrs + [w]))
    fld = [rng.normal(size=(8, 12)) for _ in range(6)]
    fj = jstate.FieldState(*(jnp.asarray(a) for a in fld))
    ft = tstate.FieldState(*(torch.from_numpy(a) for a in fld))
    # f64 sums over the same values in another order: 1e-12 relative.
    np.testing.assert_allclose(
        float(tstate.field_energy(ft, 0.1, 0.2)),
        float(jstate.field_energy(fj, 0.1, 0.2)), rtol=1e-12)
    np.testing.assert_allclose(
        float(tstate.kinetic_energy(pt, 2.0)),
        float(jstate.kinetic_energy(pj, 2.0)), rtol=1e-12)
    np.testing.assert_allclose(
        tstate.momentum_sum(pt, 2.0).numpy(),
        np.asarray(jstate.momentum_sum(pj, 2.0)), rtol=1e-12)


def test_package_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import minipic_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "minipic_torch.__path__, 'minipic_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k.startswith('minipic_tpu') for k in sys.modules)\n"
        "print(len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15
    src = "\n".join(p.read_text() for p in (ROOT / "minipic_torch").rglob(
        "*.py") if "_build" not in p.parts)
    assert "import jax" not in src and "from jax" not in src
