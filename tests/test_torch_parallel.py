"""The port's block-sharded simulation (minipic_torch/parallel/: mesh, halo,
exchange, step) and the advance, split and segment in global tile
coordinates, against the JAX package: its collectives under shard_map on
the 8 virtual CPU devices, its interpreted Pallas kernels, and its
ShardedSimulation; and against the port's own single-device Simulation.
Every shard of the port sits on the CPU (a mesh's devices may repeat)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, PartitionSpec as P

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.core.state import ParticleState as JP  # noqa: E402
from minipic_tpu.fields.halo import pad_fields_periodic as jpad  # noqa
from minipic_tpu.fields.init import oblique_wave  # noqa: E402
from minipic_tpu.fields.tiles import extract_field_tiles as jtiles  # noqa
from minipic_tpu.ops.pallas import rebin_kernels as jrk  # noqa: E402
from minipic_tpu.parallel import exchange as jex  # noqa: E402
from minipic_tpu.parallel import halo as jhalo  # noqa: E402
from minipic_tpu.parallel.step import ShardedSimulation as JSharded  # noqa
from minipic_tpu.particles.species import load_species as jload  # noqa
from minipic_tpu.simulation import advance_species_tiles as jadvance  # noqa
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.ops import rebin as rb  # noqa: E402
from minipic_torch.ops.advance import fused_push_deposit  # noqa: E402
from minipic_torch.parallel import exchange, halo  # noqa: E402
from minipic_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from minipic_torch.parallel.step import (  # noqa: E402
    ShardedSimulation, shard_major_permutation)
from minipic_torch.simulation import Simulation, bucket_capacity  # noqa

CPU = torch.device("cpu")
CHANNELS = ("x", "y", "px", "py", "pz", "w")


def _jmesh(r, c):
    return JMesh(np.array(jax.devices()[: r * c]).reshape(r, c), ("ry", "rx"))


def _tmesh(r, c):
    return Mesh([CPU] * (r * c), r, c)


def _shard_blocks(a, r, c):
    """Global [r*n, c*m] -> per-shard blocks, row-major."""
    ny, nx = a.shape[-2] // r, a.shape[-1] // c
    return [a[..., i * ny:(i + 1) * ny, j * nx:(j + 1) * nx]
            for i in range(r) for j in range(c)]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)])
def test_halo_exchange_and_fold_equal_jax(shape):
    """The port's exchange_halo and fold_halo on per-shard blocks equal
    JAX's under shard_map (f64, exactly), and fold is the adjoint of the
    exchange (tests/test_parallel.py:61)."""
    r, c = shape
    g, ny_l, nx_l = 2, 8, 8
    rng = np.random.default_rng(2)
    blocks = rng.standard_normal((3, r * ny_l, c * nx_l))
    padded = rng.standard_normal((3, r * (ny_l + 2 * g), c * (nx_l + 2 * g)))
    spec = P(None, "ry", "rx")
    mesh = _jmesh(r, c)
    jex_ = jax.jit(jax.shard_map(lambda b: jhalo.exchange_halo(b, g, r, c),
                                 mesh=mesh, in_specs=spec, out_specs=spec))
    jfo = jax.jit(jax.shard_map(lambda p: jhalo.fold_halo(p, g, r, c),
                                mesh=mesh, in_specs=spec, out_specs=spec))
    want_ex = _shard_blocks(np.asarray(jex_(jnp.asarray(blocks))), r, c)
    want_fo = _shard_blocks(np.asarray(jfo(jnp.asarray(padded))), r, c)
    tm = _tmesh(r, c)
    got_ex = halo.exchange_halo(
        [torch.from_numpy(b.copy()) for b in _shard_blocks(blocks, r, c)],
        g, tm)
    got_fo = halo.fold_halo(
        [torch.from_numpy(p.copy()) for p in _shard_blocks(padded, r, c)],
        g, tm)
    for a, b in zip(want_ex, got_ex):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(want_fo, got_fo):
        np.testing.assert_array_equal(b.numpy(), a)
    lhs = sum(float((e * torch.from_numpy(p.copy())).sum())
              for e, p in zip(got_ex, _shard_blocks(padded, r, c)))
    rhs = sum(float((torch.from_numpy(b.copy()) * f).sum())
              for b, f in zip(_shard_blocks(blocks, r, c), got_fo))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def _exchange_input(r, c, t_local, cap, seed=5):
    """Per-shard buckets (shard-major global arrays) of particles around
    each shard's block, some one block away, on a 64^2 periodic grid."""
    nx = ny = 64
    nx_l, ny_l = nx // c, ny // r
    rng = np.random.default_rng(seed)
    n = r * c * t_local
    x = np.empty((n, cap))
    y = np.empty((n, cap))
    for s in range(r * c):
        i, j = divmod(s, c)
        rows = slice(s * t_local, (s + 1) * t_local)
        x[rows] = np.mod(j * nx_l + rng.uniform(-0.6, 1.6, (t_local, cap))
                         * nx_l, nx)
        y[rows] = np.mod(i * ny_l + rng.uniform(-0.6, 1.6, (t_local, cap))
                         * ny_l, ny)
    mom = [rng.normal(0, 0.1, (n, cap)) for _ in range(3)]
    w = (rng.random((n, cap)) < 0.8) * 0.01
    return [x, y, *mom, w], nx_l, ny_l


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_exchange_particles_equals_jax_slot_for_slot(shape):
    r, c = shape
    t_local, cap, xcap = 2, 24, 40
    chans, nx_l, ny_l = _exchange_input(r, c, t_local, cap)
    mesh = _jmesh(r, c)

    def local(*a):
        p = JP(*a)
        x0 = jax.lax.axis_index("rx") * nx_l
        y0 = jax.lax.axis_index("ry") * ny_l
        merged, dropped = jex.exchange_particles(
            p, block_x0=x0, block_y0=y0, block_nx=nx_l, block_ny=ny_l,
            nx=64, ny=64, rows=r, cols=c, cap=xcap)
        return tuple(merged) + (dropped.reshape(1),)

    spec = P(("ry", "rx"), None)
    out = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,) * 6,
        out_specs=(P(("ry", "rx")),) * 7))(*(jnp.asarray(a) for a in chans))
    n_m = t_local * cap + 9 * xcap
    ps = [ParticleState(*(torch.from_numpy(a[s * t_local:(s + 1) * t_local]
                                           .copy()) for a in chans))
          for s in range(r * c)]
    merged, dropped = exchange.exchange_particles(
        ps, _tmesh(r, c), block_nx=nx_l, block_ny=ny_l, cap=xcap)
    for s in range(r * c):
        for k, name in enumerate(CHANNELS):
            np.testing.assert_array_equal(
                getattr(merged[s], name).numpy(),
                np.asarray(out[k])[s * n_m:(s + 1) * n_m], err_msg=name)
        assert int(dropped[s]) == int(np.asarray(out[6])[s])
    assert sum(int((m.w > 0).sum()) for m in merged) + sum(
        int(d) for d in dropped) == int((chans[5] > 0).sum())


def test_exchange_kills_multi_hop_particles():
    """A live slot two blocks away is killed and counted, never shipped a
    clipped hop (tests/test_parallel.py:186)."""
    r, c = 2, 4
    nx = ny = 64
    nx_l, ny_l = nx // c, ny // r
    t_local, cap = 2, 8
    ps = []
    for s in range(r * c):
        i, j = divmod(s, c)
        x = torch.zeros(t_local, cap, dtype=torch.float64)
        x[0, 0] = (j * nx_l + 5.0) % nx
        x[0, 1] = (j * nx_l + nx_l + 5.0) % nx
        x[0, 2] = (j * nx_l + 2 * nx_l + 5.0) % nx
        y = torch.zeros_like(x) + i * ny_l + 3.0
        w = torch.zeros_like(x)
        w[0, :3] = 1.0
        z = torch.zeros_like(x)
        ps.append(ParticleState(x, y, z, z, z, w))
    merged, dropped = exchange.exchange_particles(
        ps, _tmesh(r, c), block_nx=nx_l, block_ny=ny_l, cap=8)
    assert sum(int(d) for d in dropped) == r * c
    assert sum(int((m.w > 0).sum()) for m in merged) == 2 * r * c
    for s, m in enumerate(merged):
        j = s % c
        live = m.w > 0
        assert bool(((m.x[live] // nx_l) == j).all())


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)])
def test_roll_segments_sharded_equals_jax(shape):
    r, c = shape
    ltr, ltc, b_seg = 2, 2, 128
    t_local = ltr * ltc
    rng = np.random.default_rng(7)
    n = r * c * t_local
    # Packed [T, 8ch, 8*b_seg]: six channels, the stats and spare rows.
    packed = rng.standard_normal((n, 8, 8 * b_seg)).astype(np.float32)
    packed[:, 6:] = 0.0
    mesh = _jmesh(r, c)
    spec = P(("ry", "rx"), None, None)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda a: jex.roll_segments_sharded(a, ltr=ltr, ltc=ltc, rows=r,
                                            cols=c, b_seg=b_seg),
        mesh=mesh, in_specs=spec, out_specs=spec))(jnp.asarray(packed)))
    segs = [ParticleState(*(torch.from_numpy(
        packed[s * t_local:(s + 1) * t_local, k].copy()) for k in range(6)))
        for s in range(r * c)]
    got = exchange.roll_segments_sharded(segs, _tmesh(r, c), ltr=ltr,
                                         ltc=ltc, b_seg=b_seg)
    for s, g in enumerate(got):
        for k, name in enumerate(CHANNELS):
            np.testing.assert_array_equal(
                getattr(g, name).numpy(),
                want[s * t_local:(s + 1) * t_local, k], err_msg=name)


# ----------------------------------------------------------------------
# The kernels' plain versions in global tile coordinates.

def _advance_fixture():
    """64^2 grid, 8x8 tiles, guard 4, TSC, a drifting thermal species and
    an oblique wave; every tile's bucket and window."""
    deck = jcfg.Deck(
        box_x=8.0, box_y=8.0, nx=64, ny=64, tile_nx=8, tile_ny=8, guard=4,
        species=(jcfg.SpeciesSpec("e", -1.0, 1.0, ppc=4, ux=0.2, uth=0.1,
                                  shape_order=2),),
        precision="f32", kchunk=0)
    t = deck.tiling
    p = jload(deck.species[0], deck.domain, t, 384, jax.random.PRNGKey(3),
              jnp.float32)
    f = oblique_wave(deck.domain, amplitude=0.3, dtype=jnp.float32)
    ft = jtiles(jpad(f, deck.guard), t.tile_rows, t.tile_cols, t.tile_ny,
                t.tile_nx, deck.guard)
    return deck, p, ft


@pytest.mark.parametrize("mode", ["int8", "f32"])
@pytest.mark.parametrize("layout", ["block", "gids"])
def test_plain_advance_with_global_origins_matches_pallas(layout, mode):
    """The plain advance on a subset of tiles whose origins are offset: a
    shard's block (rows 4-7, cols 4-7 of the 8x8 grid: row0 = col0 = 4)
    or a shard's striped gids; against JAX's interpreted kernel with the
    same origins, at tests/test_pallas_kernel.py:66's 2e-6."""
    deck, p, ft = _advance_fixture()
    t = deck.tiling
    if layout == "block":
        gids = np.array([(4 + i) * 8 + 4 + j for i in range(4)
                         for j in range(4)])
    else:
        gids = np.sort(np.random.default_rng(11).choice(64, 16,
                                                         replace=False))
    sub = JP(*(a[gids] for a in p))
    fsub = type(ft)(*(a[gids] for a in ft))
    ox = (gids % 8) * 8
    oy = (gids // 8) * 8
    qw0 = -deck.dx * deck.dy / deck.species[0].ppc
    pj, jj, _ = jadvance(
        sub, fsub, qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
        origins=(jnp.asarray(ox, jnp.float32)[:, None],
                 jnp.asarray(oy, jnp.float32)[:, None]),
        g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy, kchunk=0,
        backend="pallas", interpret=True,
        deposit_mode="highest" if mode == "f32" else "int8", qw0=qw0,
        wrap=(64, 64), grid=(64, 64), return_disp=True)
    pt = ParticleState(*(torch.from_numpy(np.array(a)) for a in sub))
    ftt = FieldState(*(torch.from_numpy(np.array(a)) for a in fsub))
    origins = (torch.tensor(ox, dtype=torch.int32),
               torch.tensor(oy, dtype=torch.int32))
    po, jt, _ = fused_push_deposit(
        pt, ftt, qm=-1.0, q=-1.0, order=2, tile_ny=8,
        tile_nx=8, origins=origins, g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy,
        grid=(64, 64), mode=mode)
    alive = np.asarray(sub.w) > 0
    assert alive.sum() > 1000
    for name in ("x", "y", "px", "py", "pz"):
        a = np.where(alive, np.asarray(getattr(pj, name)), 0)
        b = np.where(alive, getattr(po, name).numpy(), 0)
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-6, err_msg=name)
    jtol = 3e-6 if mode == "int8" else 2e-5
    for name, a, b in zip(("jx", "jy", "jz"), jj, jt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=jtol * float(np.abs(a).max()),
                                   err_msg=name)


def _stale(gids, cap=1024, n_live=700, sigma=1.1, seed=0, nx=64):
    """Live-compacted buckets of the tiles `gids` (of an 8x8 grid of 8x8
    tiles, 64^2 periodic), their particles displaced N(0, sigma) cells
    off the tile, so movers cross every seam and corner."""
    rng = np.random.default_rng(seed)
    T = len(gids)
    f32 = np.float32
    col, row = (gids % 8)[:, None] * 8, (gids // 8)[:, None] * 8

    def pos(o):
        v = (o + rng.random((T, cap)) * 8
             + rng.normal(0.0, sigma, (T, cap))).astype(f32)
        v = np.mod(v, f32(nx)).astype(f32)
        return np.where(v >= nx, v - f32(nx), v).astype(f32)

    live = np.broadcast_to(np.arange(cap)[None, :] < n_live, (T, cap))
    chans = [pos(col), pos(row)]
    chans += [rng.normal(0.0, 0.1, (T, cap)).astype(f32) for _ in range(3)]
    chans.append(np.full((T, cap), 0.004, f32))
    return [np.where(live, c, f32(0)) for c in chans]


def _eq(j, t, what):
    for name, a, b in zip(CHANNELS, j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{what}.{name}")


# Shard (1, 1) of a (2, 2) mesh on the 8x8 tile grid, and shard 3 of 8
# striped shards.
BLOCK = np.array([(4 + i) * 8 + 4 + j for i in range(4) for j in range(4)])
STRIPE = np.array([3, 12, 17, 26, 35, 44, 49, 58])


@pytest.mark.parametrize("layout", ["block", "gids"])
def test_plain_split_in_global_coordinates_matches_jax(layout):
    gids = BLOCK if layout == "block" else STRIPE
    chans = _stale(gids, seed=1)
    jp = JP(*(jnp.asarray(c) for c in chans))
    tp = ParticleState(*(torch.tensor(c) for c in chans))
    if layout == "block":
        jkw = dict(tile_rows=4, tile_cols=4, row0=4, col0=4)
        tkw = dict(tile_cols=4, row0=4, col0=4)
    else:
        jkw = dict(tile_rows=8, tile_cols=8,
                   tile_ids=jnp.asarray(gids, jnp.int32))
        tkw = dict(tile_cols=8, tile_ids=torch.tensor(gids,
                                                      dtype=torch.int32))
    j = jrk.split_buckets(jp, tile_ny=8, tile_nx=8, b_cap=512,
                          interpret=True, **jkw)
    t = rb.split_buckets_plain(tp, tile_ny=8, tile_nx=8, b_cap=512, **tkw)
    _eq(j[0], t[0], "buckets")
    _eq(j[1], t[1], "movers")
    np.testing.assert_array_equal(np.asarray(j[2]), t[2].numpy())
    np.testing.assert_array_equal(np.asarray(j[3]), t[3].numpy())
    assert int((t[1].w > 0).sum()) > 1000


@pytest.mark.parametrize("origin", [(4, 4), (0, 0)])
def test_plain_segment_in_global_coordinates_matches_jax(origin,
                                                         monkeypatch):
    """Movers of a shard's block at (row0, col0) (the far corner, whose
    east and south movers wrap the global grid, and the origin corner,
    whose west and north ones do), binned with the global grid's fold; a
    fold by the block's own 4x4 grid would kill them as >1-hop."""
    monkeypatch.setenv("MINIPIC_SEG_KC", "256")
    r0, c0 = origin
    gids = np.array([(r0 + i) * 8 + c0 + j for i in range(4)
                     for j in range(4)])
    tp = ParticleState(*(torch.tensor(c) for c in _stale(gids, seed=2)))
    _, movers, _, _ = rb.split_buckets_plain(tp, tile_cols=4, tile_ny=8,
                                             tile_nx=8, b_cap=512,
                                             row0=r0, col0=c0)
    jm = JP(*(jnp.asarray(a.numpy()) for a in movers))
    js, jd = jrk.segment_movers(jm, tile_rows=4, tile_cols=4, tile_ny=8,
                                tile_nx=8, b_seg=256, interpret=True,
                                row0=r0, col0=c0, grid_rows=8, grid_cols=8)
    ts, td = rb.segment_movers_plain(movers, tile_rows=4, tile_cols=4,
                                     tile_ny=8, tile_nx=8, b_seg=256,
                                     row0=r0, col0=c0, grid_rows=8,
                                     grid_cols=8)
    _eq(js, ts, "segments")
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert int(td.sum()) == 0 and int((ts.w > 0).sum()) > 1000
    _, local = rb.segment_movers_plain(movers, tile_rows=4, tile_cols=4,
                                       tile_ny=8, tile_nx=8, b_seg=256,
                                       row0=r0, col0=c0)
    assert int(local.sum()) > 0


# ----------------------------------------------------------------------
# The sharded step.

def _deck(cfg, **kw):
    """tests/test_parallel.py:84's deck."""
    base = dict(
        box_x=8.0, box_y=8.0, nx=64, ny=64, tile_nx=8, tile_ny=8,
        species=(
            cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4, ux=0.3,
                            uy=0.2, uth=0.05),
            cfg.SpeciesSpec("ion", charge=+1.0, mass=5.0, ppc=4, ux=-0.1,
                            uth=0.02),
        ),
        precision="f64", rebin_interval=1)
    base.update(kw)
    return cfg.Deck(**base)


def _canon(species, perm):
    """Per gid tile, the live rows (x, y, px, py, pz, w) sorted by (x, y,
    px): order-insensitive (tests/test_deal_route.py:47)."""
    out = []
    for p in species:
        arr = np.stack([np.asarray(getattr(p, n)) for n in CHANNELS], -1)
        g = np.empty_like(arr)
        g[perm] = arr
        tiles = []
        for t in g:
            live = t[t[:, 5] > 0]
            tiles.append(live[np.lexsort((live[:, 2], live[:, 1],
                                          live[:, 0]))])
        out.append(tiles)
    return out


def _same_particles(a, b, rtol, atol):
    for sa, sb in zip(a, b):
        for ta, tb in zip(sa, sb):
            assert ta.shape == tb.shape
            np.testing.assert_allclose(tb, ta, rtol=rtol, atol=atol)


N_STEPS = 12


@pytest.fixture(scope="module")
def jax_sharded_run():
    """JAX's ShardedSimulation on the (2, 2) mesh: its initial state and
    its state and diag after N_STEPS."""
    jsim = JSharded(_deck(jcfg, mesh_shape=(2, 2)), seed=7,
                    devices=jax.devices()[:4])
    init = bridge.sim_state_to_numpy(jsim.state)
    diag = jsim.step(N_STEPS)
    return init, bridge.sim_state_to_numpy(jsim.state), diag


def _species_of(d):
    n = len({k.split(".")[0] for k in d if k.startswith("s") and "." in k})
    return [JP(*(d[f"s{i}.{c}"] for c in CHANNELS)) for i in range(n)]


def test_sharded_matches_jax_sharded(jax_sharded_run):
    """From JAX's initial state, 12 steps of the port's ShardedSimulation at
    (2, 2) against JAX's (f64): fields to round-off, energies, and each
    tile's live multiset."""
    init, want, jdiag = jax_sharded_run
    deck = _deck(tcfg, mesh_shape=(2, 2))
    sim = ShardedSimulation(deck, device="cpu")
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
    perm = shard_major_permutation(deck, sim.mesh)
    _same_particles(_canon(_species_of(want), perm),
                    _canon(_species_of(got), perm), 1e-10, 1e-12)


def test_sharded_matches_single_device():
    """The same deck and seed: ShardedSimulation at (2, 2) reproduces the
    port's Simulation (tests/test_parallel.py:105)."""
    deck = _deck(tcfg, mesh_shape=(2, 2))
    ref = Simulation(deck, seed=7, device="cpu")
    sh = ShardedSimulation(deck, seed=7, device="cpu")
    dref, dsh = ref.step(N_STEPS), sh.step(N_STEPS)
    assert int(dref.overflow) == 0 and int(dsh.overflow) == 0
    st = sh.state
    for a, b in zip(ref.state.fields, st.fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-13)
    np.testing.assert_allclose(float(dsh.field_energy),
                               float(dref.field_energy), rtol=1e-10)
    np.testing.assert_allclose(dsh.kinetic_energy.numpy(),
                               dref.kinetic_energy.numpy(), rtol=1e-10)
    assert int(dsh.shard_live.sum()) == int(dref.shard_live.sum())
    T = deck.tiling.num_tiles
    _same_particles(_canon(ref.state.species, np.arange(T)),
                    _canon(st.species, shard_major_permutation(deck,
                                                               sh.mesh)),
                    1e-10, 1e-12)


def test_sharded_deal_route_matches_single_device():
    """The sharded deal route (segment in global coordinates, the seam
    roll, the fused append through the identity table) against the
    single-device deal route: per-tile counts exact, values to f32 ulps
    (the sharded J fold sums in another order)."""
    deck = _deck(tcfg, mesh_shape=(2, 2), rebin_mode="incremental",
                 precision="f32", kchunk=64, capacity_headroom=3.0,
                 species=(tcfg.SpeciesSpec("ele", charge=-1.0, mass=1.0,
                                           ppc=12, ux=0.3, uy=0.2,
                                           uth=0.05),))
    cap = bucket_capacity(deck)
    sc = deck.mover_seg_cap(deck.mover_cap(cap))
    assert sc > 0 and cap >= 8 * sc + 256, "the deal route must engage"
    ref = Simulation(deck, seed=7, device="cpu")
    sh = ShardedSimulation(deck, seed=7, device="cpu")
    dref, dsh = ref.step(N_STEPS), sh.step(N_STEPS)
    assert int(dref.overflow) == 0 and int(dsh.overflow) == 0
    np.testing.assert_allclose(float(dsh.field_energy),
                               float(dref.field_energy), rtol=1e-5)
    np.testing.assert_allclose(dsh.kinetic_energy.numpy(),
                               dref.kinetic_energy.numpy(), rtol=1e-6)
    perm = shard_major_permutation(deck, sh.mesh)
    T = deck.tiling.num_tiles
    a = _canon(ref.state.species, np.arange(T))
    b = _canon(sh.state.species, perm)
    assert [len(t) for t in a[0]] == [len(t) for t in b[0]]
    _same_particles(a, b, 1e-6, 1e-6)


def test_cross_shard_migration_no_losses():
    """A fast beam sweeps across every shard seam on the (2, 4) mesh; the
    live count is conserved exactly (tests/test_parallel.py:140)."""
    deck = _deck(tcfg, mesh_shape=(2, 4), species=(
        tcfg.SpeciesSpec("beam", charge=-1.0, mass=1e12, ppc=2, ux=0.9,
                         uy=0.45),))
    sh = ShardedSimulation(deck, seed=1, device="cpu")
    n0 = int(sh.state.species[0].alive_count())
    for _ in range(3):
        d = sh.step(10)
        assert int(d.overflow) == 0
        assert int(d.shard_live.sum()) == n0
    assert int(sh.state.species[0].alive_count()) == n0


def _window_deck(cfg, **kw):
    """tests/test_moving_window.py's window deck with plasma, f64."""
    return cfg.Deck(
        box_x=12.8, box_y=6.4, nx=128, ny=64, tile_nx=8, tile_ny=8,
        guard=2, boundary="absorbing", absorb_width=8, moving_window=True,
        species=(cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4,
                                 uth=0.01),
                 cfg.SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=4,
                                 uth=0.0)),
        precision="f64", **kw)


def test_sharded_window_matches_single_device():
    """The sharded moving window (the field strip and the bucket column
    handed to the left neighbour, injection keyed per global tile row)
    equals the single-device window over two shifts
    (tests/test_moving_window.py:138)."""
    deck = _window_deck(tcfg, mesh_shape=(2, 2))
    ref = Simulation(deck, seed=7, device="cpu")
    sh = ShardedSimulation(deck, seed=7, device="cpu")
    ref.step(50)
    sh.step(50)
    st = sh.state
    assert int(ref.state.window_x0) == int(st.window_x0) > 8
    for a, b in zip(ref.state.fields, st.fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-12)
    T = deck.tiling.num_tiles
    _same_particles(_canon(ref.state.species, np.arange(T)),
                    _canon(st.species, shard_major_permutation(deck,
                                                               sh.mesh)),
                    1e-10, 1e-12)


def test_make_mesh_checks_the_grid():
    deck = _deck(tcfg, mesh_shape=(2, 4))
    m = make_mesh(deck, device="cpu")
    assert m.shape == (2, 4) and m.distinct() == [CPU]
    with pytest.raises(ValueError):
        make_mesh(dataclasses.replace(deck, mesh_shape=(3, 4)),
                  devices=[CPU] * 12)
    with pytest.raises(ValueError):
        make_mesh(deck, devices=[CPU] * 6)


def test_state_round_trips_the_shard_split():
    """Setting the global state and reading it back is the identity (the
    split into shard blocks and the assembly), drift and step included."""
    deck = _deck(tcfg, mesh_shape=(2, 4))
    sh = ShardedSimulation(deck, seed=3, device="cpu")
    a = bridge.sim_state_to_numpy(sh.state)
    a["step"] = np.asarray(5, np.int32)
    a["drift"] = np.asarray(0.25, np.float32)
    a["ex"] = np.random.default_rng(0).standard_normal(a["ex"].shape)
    sh.state = bridge.sim_state_from_numpy(a, CPU)
    b = bridge.sim_state_to_numpy(sh.state)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
