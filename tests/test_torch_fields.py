"""The port's halo, tile and Yee field code against the JAX package, in
float64 on the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from minipic_tpu.core.geometry import Domain  # noqa: E402
from minipic_tpu.core.state import CurrentState as JCurrent  # noqa: E402
from minipic_tpu.core.state import FieldState as JFields  # noqa: E402
from minipic_tpu.core.state import field_energy as j_energy  # noqa: E402
from minipic_tpu.fields import halo as jhalo  # noqa: E402
from minipic_tpu.fields import init as finit  # noqa: E402
from minipic_tpu.fields import tiles as jtiles  # noqa: E402
from minipic_tpu.fields import yee as jyee  # noqa: E402
from minipic_torch.core.state import CurrentState, FieldState  # noqa: E402
from minipic_torch.core.state import field_energy  # noqa: E402
from minipic_torch.fields import halo, tiles, yee  # noqa: E402
from minipic_torch.fields import init as tinit  # noqa: E402

# Same f64 values through the same adds in (nearly) the same order: 1e-12.
TOL = dict(rtol=1e-12, atol=1e-12)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("g", [2, 4])
def test_pad_extract_and_folds_match_jax(g):
    ny, nx, tny, tnx = 24, 32, 8, 8
    tr, tc = ny // tny, nx // tnx
    a = _rand((ny, nx))
    pj = jhalo.pad_block_periodic(jnp.asarray(a), g)
    pt = halo.pad_block_periodic(torch.from_numpy(a), g)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))

    fj = JFields(*(jnp.asarray(_rand((ny, nx), s)) for s in range(6)))
    ft = FieldState(*(torch.from_numpy(_rand((ny, nx), s)) for s in range(6)))
    tj = jtiles.extract_field_tiles(jhalo.pad_fields_periodic(fj, g), tr, tc,
                                    tny, tnx, g)
    tt = tiles.extract_field_tiles(halo.pad_fields_periodic(ft, g), tr, tc,
                                   tny, tnx, g)
    for u, v in zip(tt, tj):
        assert u.is_contiguous()
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))

    w = _rand((tr, tc, tny + 2 * g, tnx + 2 * g), 9)
    fold_j = jhalo.fold_block_periodic(
        jtiles.fold_tiles(jnp.asarray(w), tny, tnx, g), g)
    fold_t = halo.fold_block_periodic(
        tiles.fold_tiles(torch.from_numpy(w), tny, tnx, g), g)
    np.testing.assert_allclose(fold_t.numpy(), np.asarray(fold_j), **TOL)
    # The fold is the adjoint of pad + extract: <fold(w), a> = <w, E(a)>.
    ea = tiles.extract_tiles(pt, tr, tc, tny, tnx, g)
    np.testing.assert_allclose(float((fold_t * torch.from_numpy(a)).sum()),
                               float((torch.from_numpy(w) * ea).sum()),
                               rtol=1e-12)


def test_yee_updates_match_jax():
    ny, nx = 24, 32
    dt, dx, dy = 0.03, 0.1, 0.07
    f = [_rand((ny, nx), s) for s in range(6)]
    j = [_rand((ny, nx), 10 + s) for s in range(3)]
    fj = JFields(*(jnp.asarray(a) for a in f))
    ft = FieldState(*(torch.from_numpy(a) for a in f))
    jj = JCurrent(*(jnp.asarray(a) for a in j))
    jt = CurrentState(*(torch.from_numpy(a) for a in j))
    for u, v in zip(yee.update_b_half_periodic(ft, dt, dx, dy),
                    jyee.update_b_half_periodic(fj, dt, dx, dy)):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), **TOL)
    for u, v in zip(yee.update_e_full_periodic(ft, dt, dx, dy, jt),
                    jyee.update_e_full_periodic(fj, dt, dx, dy, jj)):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), **TOL)


def test_fields_only_run_matches_jax_over_300_steps():
    dom = Domain(6.4, 4.8, 64, 48)
    dt = 0.5 * dom.dt_courant()
    dx, dy = dom.dx, dom.dy
    fj = finit.oblique_wave(dom, amplitude=0.3, dtype=jnp.float64)
    ft = tinit.oblique_wave(dom, amplitude=0.3, dtype=torch.float64,
                            device=torch.device("cpu"))
    for u, v in zip(ft, fj):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), **TOL)
    e0 = float(field_energy(ft, dx, dy))

    def jstep(f):
        f = jyee.update_b_half_periodic(f, dt, dx, dy)
        f = jyee.update_e_full_periodic(f, dt, dx, dy)
        return jyee.update_b_half_periodic(f, dt, dx, dy)

    def tstep(f):
        f = yee.update_b_half_periodic(f, dt, dx, dy)
        f = yee.update_e_full_periodic(f, dt, dx, dy)
        return yee.update_b_half_periodic(f, dt, dx, dy)

    for _ in range(300):
        fj = jstep(fj)
        ft = tstep(ft)
    for u, v in zip(ft, fj):
        # Round-off of identical stencils compounds over 300 steps; the
        # fields stay O(0.3), so 1e-12 absolute still bounds it.
        np.testing.assert_allclose(u.numpy(), np.asarray(v), **TOL)
    np.testing.assert_allclose(float(field_energy(ft, dx, dy)),
                               float(j_energy(fj, dx, dy)), rtol=1e-12)
    # The vacuum wave keeps its energy: Yee is non-dissipative; the
    # continuous initial wave is not the discrete mode, so the energy
    # sampled at integer steps breathes by ~3e-4.
    np.testing.assert_allclose(float(field_energy(ft, dx, dy)), e0,
                               rtol=1e-3)
