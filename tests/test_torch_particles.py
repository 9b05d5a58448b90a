"""The port's particle modules (gather, push, deposit, binning, loading)
against the JAX package's XLA functions on the same inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.core.state import FieldState as JFields  # noqa: E402
from minipic_tpu.core.state import ParticleState as JParticles  # noqa: E402
from minipic_tpu.particles import binning as jbin  # noqa: E402
from minipic_tpu.particles import deposit as jdep  # noqa: E402
from minipic_tpu.particles import gather as jgat  # noqa: E402
from minipic_tpu.particles import push as jpush  # noqa: E402
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.particles import binning, deposit, gather, push  # noqa
from minipic_torch.particles.species import load_species  # noqa: E402

T, K, NT, G = 6, 40, 8, 4  # tiles, slots, tile edge, guard
NG = NT + 2 * G


def _f32(a):
    return np.asarray(a, np.float32)


def _pair(a):
    a = _f32(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **kw)


def _positions(seed):
    """Tile-local positions inside the valid window band [-1.5, NT+1.5)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5, NT + 1.5, (T, K)), rng.uniform(-1.5, NT + 1.5,
                                                            (T, K))


@pytest.mark.parametrize("order", [1, 2])
def test_gather_push_and_move_match_jax(order):
    rng = np.random.default_rng(order)
    xi, eta = _positions(order)
    f = [rng.normal(size=(T, NG, NG)) * 0.3 for _ in range(6)]
    fj = JFields(*(_pair(a)[0] for a in f))
    ft = FieldState(*(_pair(a)[1] for a in f))
    (xj, xt), (ej, et) = _pair(xi), _pair(eta)
    gj = jgat.gather_chunk(fj, xj, ej, NT, NT, G, order)
    gt = gather.gather_chunk(ft, xt, et, NT, NT, G, order)
    # f32 sums over the window in another order (test_pallas_kernel.py:66).
    for u, v in zip(gt, gj):
        _close(u, v, rtol=2e-6, atol=2e-6)

    mom = [rng.normal(size=(T, K)) * 0.3 for _ in range(3)]
    pj = [_pair(a)[0] for a in mom]
    pt = [_pair(a)[1] for a in mom]
    ej6 = [_pair(np.asarray(a))[0] for a in gj]
    et6 = [_pair(np.asarray(a))[1] for a in gj]
    uj = jpush.boris_push(*pj, *ej6, -1.0, 0.05)
    ut = push.boris_push(*pt, *et6, -1.0, 0.05)
    for u, v in zip(ut, uj):
        _close(u, v, rtol=2e-6, atol=2e-6)
    x0 = rng.uniform(0, 32, (T, K))
    y0 = rng.uniform(0, 32, (T, K))
    mj = jpush.advance_positions(*_pair(x0)[:1], _pair(y0)[0], *pj, 0.05,
                                 0.1, 0.1)
    mt = push.advance_positions(_pair(x0)[1], _pair(y0)[1], *pt, 0.05, 0.1,
                                0.1)
    for u, v in zip(mt, mj):
        _close(u, v, rtol=2e-6, atol=2e-6)
    for u, v in zip(push.velocities(*pt), jpush.velocities(*pj)):
        _close(u, v, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("order", [1, 2])
def test_deposit_and_quantized_rho_match_jax(order):
    rng = np.random.default_rng(10 + order)
    xi0, eta0 = _positions(10 + order)
    xi1 = xi0 + rng.uniform(-0.4, 0.4, (T, K))
    eta1 = eta0 + rng.uniform(-0.4, 0.4, (T, K))
    vz = rng.normal(size=(T, K)) * 0.2
    qw = np.where(rng.random((T, K)) < 0.8, -0.01, 0.0)
    args = [_pair(a) for a in (xi0, eta0, xi1, eta1, vz, qw)]
    dj = jdep.deposit_chunk(*(a[0] for a in args), NT, NT, G, order, 0.05,
                            0.1, 0.1)
    dt_ = deposit.deposit_chunk(*(a[1] for a in args), NT, NT, G, order,
                                0.05, 0.1, 0.1)
    for u, v in zip(dt_, dj):
        # f32 contraction over the slots in another order, relative to the
        # window's peak (test_pallas_kernel.py:67-71).
        scale = float(np.abs(np.asarray(v)).max())
        _close(u, v, rtol=0, atol=3e-6 * scale)
    for quantize in (0.0, 83.0 if order == 2 else 62.0):
        rj = jdep.deposit_rho_chunk(args[0][0], args[1][0], args[5][0], NT,
                                    NT, G, order, 0.1, 0.1, quantize)
        rt = deposit.deposit_rho_chunk(args[0][1], args[1][1], args[5][1],
                                       NT, NT, G, order, 0.1, 0.1, quantize)
        scale = float(np.abs(np.asarray(rj)).max())
        _close(rt, rj, rtol=0, atol=3e-6 * scale)


def test_wrap_positions_edges():
    n = 32.0
    # Just below 0 rounds to exactly n in f32 and must come back as 0.
    # (Denormals are left out: XLA's CPU backend flushes them to zero.)
    x = np.array([n, np.nextafter(n, 0), -1e-8, -1e-30, -n, 2 * n + 0.5,
                  0.0, 5.25], np.float32)
    y = x[::-1].copy()
    w = np.ones_like(x)
    z = np.zeros_like(x)
    pj = JParticles(*(jnp.asarray(a) for a in (x, y, z, z, z, w)))
    pt = ParticleState(*(torch.from_numpy(a.copy())
                         for a in (x, y, z, z, z, w)))
    for periodic in (True, False):
        oj = jbin.wrap_positions(pj, 32, 32, periodic)
        ot = binning.wrap_positions(pt, 32, 32, periodic)
        for name in ParticleState._fields:
            np.testing.assert_array_equal(getattr(ot, name).numpy(),
                                          np.asarray(getattr(oj, name)),
                                          err_msg=f"{name} {periodic}")
        if periodic:
            # Never exactly n, never negative: no live particle off-grid.
            assert float(ot.x.max()) < n and float(ot.x.min()) >= 0.0
            assert float(ot.y.max()) < n and float(ot.y.min()) >= 0.0


def _canon(q):
    """Per-bucket live rows sorted by (x, y, px) (test_deal_route.py:47)."""
    out = []
    for arrs in zip(*(np.asarray(g) for g in q)):
        rows = np.stack(arrs, -1)
        live = rows[rows[:, 5] > 0]
        out.append(live[np.lexsort((live[:, 2], live[:, 1], live[:, 0]))])
    return out


def _scattered_state(sigma, crowd=0.0, seed=0):
    deck = jcfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(jcfg.SpeciesSpec("e", -1.0, 1.0, ppc=12, uth=0.05,
                                  shape_order=2),),
        capacity_headroom=1.25, kchunk=0)
    p = JSimulation(deck).state.species[0]
    a = {k: np.array(getattr(p, k)) for k in JParticles._fields}
    rng = np.random.default_rng(seed)
    live = a["w"] > 0
    a["x"] = np.where(live, a["x"] + rng.normal(size=a["x"].shape) * sigma,
                      a["x"]).astype(np.float32)
    a["y"] = np.where(live, a["y"] + rng.normal(size=a["y"].shape) * sigma,
                      a["y"]).astype(np.float32)
    if crowd:
        # Herd a fraction of everyone into tile 0 to overflow its bucket.
        herd = live & (rng.random(a["x"].shape) < crowd)
        a["x"] = np.where(herd, rng.uniform(0, 8, a["x"].shape),
                          a["x"]).astype(np.float32)
        a["y"] = np.where(herd, rng.uniform(0, 8, a["y"].shape),
                          a["y"]).astype(np.float32)
    a["px"] = rng.normal(size=a["x"].shape).astype(np.float32)  # tags
    pj = jbin.wrap_positions(JParticles(*(jnp.asarray(a[k]) for k in
                                          JParticles._fields)), 32, 32, True)
    return deck, pj


@pytest.mark.parametrize("crowd", [0.0, 0.05])
def test_rebin_matches_jax_slot_for_slot(crowd):
    deck, pj = _scattered_state(sigma=3.0, crowd=crowd)
    pt = ParticleState(*(torch.from_numpy(np.array(a)) for a in pj))
    tiling = deck.tiling
    bj, oj = jbin.rebin(pj, tiling)
    bt, ot = binning.rebin(pt, tiling)
    assert int(ot) == int(oj)
    assert (int(ot) > 0) == (crowd > 0)
    # Same stable order, live first: every live slot equal; the dead slots
    # (whose contents the JAX package's filler sort leaves as it found
    # them) are zeroed here.
    live = (bt.w > 0).numpy()
    np.testing.assert_array_equal(live, np.asarray(bj.w) > 0)
    for name in ParticleState._fields:
        a = getattr(bt, name).numpy()
        np.testing.assert_array_equal(a[live],
                                      np.asarray(getattr(bj, name))[live],
                                      err_msg=name)
        assert np.all(a[~live] == 0), name
    for u, v in zip(_canon(bt), _canon(bj)):
        np.testing.assert_array_equal(u, v)
    counts = binning.tile_counts(bt)
    # Live-compacted: the first counts[t] slots are live, the rest dead.
    slot = np.arange(bt.capacity)[None, :]
    np.testing.assert_array_equal(live, slot < counts.numpy()[:, None])
    # Every particle lands in the tile its position names.
    col = np.floor(bt.x.numpy() / 8).astype(int)
    row = np.floor(bt.y.numpy() / 8).astype(int)
    tid = np.broadcast_to(np.arange(bt.num_tiles)[:, None], col.shape)
    assert np.all((row * 4 + col)[live] == tid[live])

    flat = ParticleState(*(a.reshape(-1) for a in pt))
    ft, of = binning.rebin_flat(flat, tile_rows=2, tile_cols=2, tile_nx=8,
                                tile_ny=8, capacity=bt.capacity, row0=1,
                                col0=1)
    fj, ofj = jbin.rebin_flat(JParticles(*(a.reshape(-1) for a in pj)),
                              tile_rows=2, tile_cols=2, tile_nx=8, tile_ny=8,
                              capacity=bt.capacity, row0=1, col0=1)
    assert int(of) == int(ofj)
    flive = (ft.w > 0).numpy()
    np.testing.assert_array_equal(flive, np.asarray(fj.w) > 0)
    for u, v in zip(ft, fj):
        np.testing.assert_array_equal(u.numpy()[flive], np.asarray(v)[flive])


@pytest.mark.parametrize("order", [1, 2])
def test_load_species_statistics(order):
    spec = tcfg.SpeciesSpec("e", -1.0, 1.0, ppc=16, ux=0.1, uy=-0.05,
                            uth=0.08, uth_z=0.02, shape_order=order)
    deck = tcfg.Deck(box_x=6.4, box_y=3.2, nx=64, ny=32, tile_nx=8,
                     tile_ny=8, guard=4, species=(spec,))
    gen = torch.Generator().manual_seed(4)
    cap = deck.capacity()
    p = load_species(spec, deck.domain, deck.tiling, cap, gen, torch.float32,
                     torch.device("cpu"))
    assert p.x.shape == (deck.tiling.num_tiles, cap)
    assert all(a.dtype == torch.float32 for a in p)
    counts = binning.tile_counts(p)
    assert torch.all(counts == 16 * 64)
    live = p.w > 0
    slot = torch.arange(cap)[None, :]
    assert torch.equal(live, slot < counts[:, None])  # live-compacted
    np.testing.assert_allclose(float(p.w[live].mean()),
                               deck.dx * deck.dy / 16, rtol=1e-6)
    # Every particle sits in its own tile (quiet-start lattice).
    col = torch.floor(p.x / 8).long()
    row = torch.floor(p.y / 8).long()
    tid = torch.arange(p.num_tiles)[:, None].expand_as(col)
    assert torch.equal((row * 8 + col)[live], tid[live])
    n = int(live.sum())
    for a, mean, sd in ((p.px, 0.1, 0.08), (p.py, -0.05, 0.08),
                        (p.pz, 0.0, 0.02)):
        v = a[live].double()
        # 32768 normal draws: mean within 5 sigma/sqrt(n), sd within 2%.
        assert abs(float(v.mean()) - mean) < 5 * sd / n ** 0.5
        assert abs(float(v.std()) / sd - 1) < 0.02


def test_counter_streaming_pair_halves_two_opposite_beams():
    """counter_streaming_pair (the JAX package's two-stream fixture): two
    loads of the lattice at +-drift along x, each at half the weight,
    their thermal noise drawn one after the other from one generator."""
    from minipic_torch.particles.species import counter_streaming_pair

    spec = tcfg.SpeciesSpec("e", -1.0, 1.0, ppc=4, uth=0.01)
    deck = tcfg.Deck(box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8,
                     tile_ny=8, guard=4, species=(spec,))
    cap = deck.capacity()
    a, b = counter_streaming_pair(spec, 0.2, deck.domain, deck.tiling, cap,
                                  torch.Generator().manual_seed(1),
                                  torch.float32, torch.device("cpu"))
    one = load_species(spec, deck.domain, deck.tiling, cap,
                       torch.Generator().manual_seed(1), torch.float32,
                       torch.device("cpu"))
    live = one.w > 0
    for p, drift in ((a, 0.2), (b, -0.2)):
        assert torch.equal(p.x, one.x) and torch.equal(p.y, one.y)
        assert torch.equal(p.w, one.w * 0.5)
        v = p.px[live].double()
        assert abs(float(v.mean()) - drift) < 5 * 0.01 / v.numel() ** 0.5
        assert abs(float(v.std()) / 0.01 - 1) < 0.05
    # The first beam's noise is the single load's, shifted by the drift.
    torch.testing.assert_close(a.px[live], one.px[live] + 0.2, rtol=0,
                               atol=1e-7)
    assert not torch.equal(a.py, b.py)
