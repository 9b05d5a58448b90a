"""Decks of precision "f64" in the port, on the CPU, against the JAX
package's f64 path: every f64 deck resolves to the advance's "f64" mode
(the exact Esirkepov deposit of JAX's XLA branch, whatever the deck's
deposit asks), the plain f64 advance against that branch, the port's f64
"auto" step against its f64 "sort" step, and the re-bin kernels' plain
versions over float64 channels against the same calls on float32 ones.
States are handed over from JAX through ``bridge``; inputs are made from
seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core import config as jcfg  # noqa: E402
from minipic_tpu.fields import init as finit  # noqa: E402
from minipic_tpu.fields.halo import pad_fields_periodic  # noqa: E402
from minipic_tpu.fields.tiles import extract_field_tiles  # noqa: E402
from minipic_tpu.particles.binning import wrap_positions  # noqa: E402
from minipic_tpu.particles.species import load_species  # noqa: E402
from minipic_tpu.simulation import Simulation as JSimulation  # noqa: E402
from minipic_tpu.simulation import (  # noqa: E402
    _tile_origins, advance_species_tiles)
from minipic_torch import bridge  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.ops import rebin as rb  # noqa: E402
from minipic_torch.ops.advance import (  # noqa: E402
    fused_push_deposit, live_watermark, resolve_mode)
from minipic_torch.particles.binning import route_movers  # noqa: E402
from minipic_torch.simulation import (  # noqa: E402
    Simulation, deposit_modes, tile_origins)
from minipic_torch.testing import push_out_through_walls  # noqa: E402

CPU = torch.device("cpu")


def _deck(cfg, **kw):
    """tests/test_torch_step.py's 32^2 deck (bench.py's headline shape: 8x8
    tiles, guard 4, TSC, the int8 deposit asked for, whole-bucket chunks,
    the sort re-bin) in f64."""
    base = dict(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(cfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=8,
                                 uth=0.1, ux=0.05, shape_order=2),),
        precision="f64", capacity_headroom=1.1, kchunk=0, deposit="int8",
        rebin_mode="sort")
    base.update(kw)
    return cfg.Deck(**base)


def _canon(q):
    """Per-bucket live rows sorted by (x, y, px): order-insensitive
    (tests/test_deal_route.py:47)."""
    out = []
    for arrs in zip(*(np.asarray(g) for g in q)):
        rows = np.stack(arrs, -1)
        live = rows[rows[:, 5] > 0]
        idx = np.lexsort((live[:, 2], live[:, 1], live[:, 0]))
        out.append(live[idx])
    return out


def _same_buckets(a, b, rtol, what):
    ca, cb = _canon(a), _canon(b)
    for t, (u, v) in enumerate(zip(ca, cb)):
        assert u.shape == v.shape, f"{what}: tile {t} {u.shape} {v.shape}"
        np.testing.assert_allclose(u, v, rtol=rtol, atol=rtol,
                                   err_msg=f"{what}: tile {t}")


def test_f64_int8_deck_matches_jax():
    """An f64 deck that asks for the int8 deposit takes the exact deposit,
    as in JAX (its f64 runs take the XLA branch, whose deposit is exact);
    when resolve_mode ignored the dtype, the port quantized it and the
    field energy was 6.1e-3 off JAX's after one step.  The 32^2 deck, 10
    steps from JAX's state, both sides sorting: fields within 1e-12 of
    their peak, energies 1e-12 relative, the same live particles in each
    bucket."""
    jsim = JSimulation(_deck(jcfg), seed=1)
    tsim = Simulation(_deck(tcfg), device="cpu")
    tsim.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(jsim.state), CPU)
    assert tsim.state.species[0].x.dtype == torch.float64
    assert deposit_modes(tsim.deck) == ["f64"]
    for i in range(10):
        dj, dt_ = jsim.step(), tsim.step()
        np.testing.assert_allclose(float(dt_.field_energy),
                                   float(dj.field_energy), rtol=1e-12,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(dt_.kinetic_energy.numpy(),
                                   np.asarray(dj.kinetic_energy), rtol=1e-12,
                                   err_msg=f"step {i}")
        assert int(dt_.overflow) == 0 and int(dj.overflow) == 0
    for name in FieldState._fields:
        a = np.asarray(getattr(jsim.state.fields, name))
        b = getattr(tsim.state.fields, name).numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)
    _same_buckets(tsim.state.species[0], jsim.state.species[0], 1e-12,
                  "buckets")


@pytest.mark.parametrize("deposit", ["", "highest", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resolve_mode_follows_the_dtype(dtype, deposit):
    """A float64 deck is "f64" whatever its deposit; a float32 deck
    resolves as before (int8 where asked and admitted, else f32)."""
    mode = resolve_mode(deposit, -0.01, 8, 8, 4, dtype)
    if dtype == torch.float64:
        assert mode == "f64"
    else:
        assert mode == ("int8" if deposit == "int8" else "f32")
    deck = _deck(tcfg, deposit=deposit,
                 precision="f64" if dtype == torch.float64 else "f32")
    assert deposit_modes(deck) == [mode]


def _periodic_fixture(order):
    """32^2 box of 8x8 tiles, guard 4: a drifting thermal species displaced
    up to 0.6 cells (stale buckets, some across the box edge), every 7th
    slot dead, and an oblique wave; all in f64."""
    deck = jcfg.Deck(
        box_x=4.0, box_y=4.0, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(jcfg.SpeciesSpec("e", -1.0, 1.0, ppc=4, ux=0.2, uth=0.1,
                                  shape_order=order),),
        precision="f64", kchunk=0)
    tiling = deck.tiling
    cap = -(-deck.capacity() // 128) * 128
    p = load_species(deck.species[0], deck.domain, tiling, cap,
                     jax.random.PRNGKey(3), jnp.float64)
    x, y, px, py, pz, w = (np.array(a) for a in p)
    rng = np.random.default_rng(11)
    live = w > 0
    x = np.where(live, np.mod(x + rng.uniform(-0.6, 0.6, x.shape), 32.0), x)
    y = np.where(live, np.mod(y + rng.uniform(-0.6, 0.6, y.shape), 32.0), y)
    w = np.where(np.arange(cap)[None, :] % 7 == 5, 0.0, w)
    p = type(p)(*(jnp.asarray(a, jnp.float64)
                  for a in (x, y, px, py, pz, w)))
    return deck, tiling, p, (deck.nx, deck.ny)


def _open_fixture(order):
    """The open mode's fixture at f64: thermal particles in stale buckets,
    every 7th slot dead, and by each wall particles moving out at ~0.95 c
    (``minipic_torch.testing.push_out_through_walls``)."""
    tile, guard = (16, 2) if order == 1 else (8, 4)
    deck = jcfg.Deck(
        box_x=4.0, box_y=4.0, nx=32, ny=32, tile_nx=tile, tile_ny=tile,
        guard=guard, species=(jcfg.SpeciesSpec("e", -1.0, 1.0, ppc=4,
                                               uth=0.1, shape_order=order),),
        precision="f64", kchunk=0)
    tiling = deck.tiling
    cap = -(-deck.capacity() // 128) * 128
    p = load_species(deck.species[0], deck.domain, tiling, cap,
                     jax.random.PRNGKey(5), jnp.float64)
    x, y, px, py, pz, w = (np.array(a) for a in p)
    rng = np.random.default_rng(7)
    live = w > 0
    x = np.where(live, np.clip(x + rng.uniform(-0.3, 0.3, x.shape), 0.01,
                               31.99), x)
    y = np.where(live, np.clip(y + rng.uniform(-0.3, 0.3, y.shape), 0.01,
                               31.99), y)
    ox = (np.arange(tiling.num_tiles) % tiling.tile_cols * tile)[:, None]
    oy = (np.arange(tiling.num_tiles) // tiling.tile_cols * tile)[:, None]
    near = rng.uniform(0.0, 0.2, x.shape)
    x, y, px, py = (a.numpy() for a in push_out_through_walls(
        *(torch.from_numpy(a) for a in (x, y, px, py, live, ox, oy)),
        tile, tile, 32.0, 32.0, torch.from_numpy(near)))
    w = np.where(np.arange(cap)[None, :] % 7 == 5, 0.0, w)
    p = type(p)(*(jnp.asarray(a, jnp.float64)
                  for a in (x, y, px, py, pz, w)))
    return deck, tiling, p, None


def _ulps(a, b):
    """max |a - b| in ulps of the channel's scale (the spacing of f64 at
    max |b|): the push's sums cancel near zero (a half kick can take a
    momentum of 0.1 to 1e-5), so the error of a value is that of its
    operands, an ulp or two of the channel's magnitude, not of its own."""
    return np.abs(a - b).max() / np.spacing(np.abs(b).max())


@pytest.mark.parametrize("boundary", ["periodic", "open"])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_f64_advance_matches_jax_xla_branch(order, boundary):
    """The port's advance in f64 mode (plain version) against JAX's f64
    XLA branch (``advance_species_tiles(..., backend="xla")``, its dense
    gather and deposit): positions and momenta within 2 ulp of each
    channel's scale (JAX's stored positions wrapped as its step wraps
    them), J within 1e-12 of its peak."""
    fixture = _periodic_fixture if boundary == "periodic" else _open_fixture
    deck, tiling, p, grid = fixture(order)
    f = finit.oblique_wave(deck.domain, amplitude=0.3, dtype=jnp.float64)
    ftiles = extract_field_tiles(
        pad_fields_periodic(f, deck.guard), tiling.tile_rows,
        tiling.tile_cols, tiling.tile_ny, tiling.tile_nx, deck.guard)
    pj, jj = advance_species_tiles(
        p, ftiles, qm=-1.0, q=-1.0, order=order, tile_ny=tiling.tile_ny,
        tile_nx=tiling.tile_nx, origins=_tile_origins(tiling, jnp.float64),
        g=deck.guard, dt=deck.dt, dx=deck.dx, dy=deck.dy, kchunk=0,
        backend="xla", grid=grid)
    if grid is not None:
        pj = wrap_positions(pj, deck.nx, deck.ny, True)
    pt = ParticleState(*(torch.from_numpy(np.array(a)) for a in p))
    ft = FieldState(*(torch.from_numpy(np.array(a)) for a in ftiles))
    mode = resolve_mode("int8", -0.01, tiling.tile_ny, tiling.tile_nx,
                        deck.guard, torch.float64)
    assert mode == "f64"
    out, jt, _ = fused_push_deposit(
        pt, ft, qm=-1.0, q=-1.0, order=order,
        tile_ny=tiling.tile_ny, tile_nx=tiling.tile_nx,
        origins=tile_origins(tiling, CPU), g=deck.guard, dt=deck.dt,
        dx=deck.dx, dy=deck.dy, grid=grid, mode=mode)
    alive = np.asarray(p.w) > 0
    for name in ("x", "y", "px", "py", "pz"):
        a = np.asarray(getattr(pj, name))[alive]
        b = getattr(out, name).numpy()[alive]
        assert b.dtype == np.float64
        assert _ulps(b, a) <= 2, name
    for name, a, b in zip(("jx", "jy", "jz"), jj, jt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)


@pytest.mark.parametrize("route,ppc", [("deal", 40), ("small", 16)])
def test_f64_auto_step_matches_the_f64_sort_step(route, ppc):
    """The port's f64 "auto" step (``rebin_auto``: the deal route at ppc 40,
    whose 3072-slot buckets hold eight runs + 256, the small-bucket route
    at ppc 16's 1536) against its f64 "sort" step from one state, through a
    forced re-bin and two steps after it: the same live particles in each
    bucket (slot order is the route's), fields within 1e-12 of their peak.
    JAX's f64 "auto" sorts (its XLA backend), so the deal route is held to
    the sort route, as tests/test_deal_route.py holds JAX's."""
    spec = tcfg.SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.1,
                            ux=0.05, shape_order=2)
    auto = Simulation(_deck(tcfg, species=(spec,), rebin_mode="auto"),
                      device="cpu")
    sort = Simulation(_deck(tcfg, species=(spec,)), device="cpu")
    cap = auto.state.species[0].capacity
    mc, sc = auto.deck.mover_cap(cap), auto.deck.mover_seg_cap(
        auto.deck.mover_cap(cap))
    assert mc > 0 and (cap >= 8 * sc + 256) == (route == "deal")
    sort.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(auto.state), CPU)
    force = torch.tensor(auto.deck.force_threshold() + 1.0,
                         dtype=torch.float32)
    for sim in (auto, sort):
        sim.state = sim.state._replace(drift=force)
    for i in range(3):
        da, ds = auto.step(), sort.step()
        if i == 0:
            assert da.rebinned and ds.rebinned
        assert int(da.overflow) == 0 and int(ds.overflow) == 0
        _same_buckets(auto.state.species[0], sort.state.species[0], 1e-12,
                      f"step {i}")
        for name in FieldState._fields:
            a = getattr(sort.state.fields, name).numpy()
            b = getattr(auto.state.fields, name).numpy()
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-12 * np.abs(a).max(),
                                       err_msg=f"{name} at step {i}")


def _stale_f32(ppc=40, seed=21):
    """The 32^2 deck's buckets (3072 slots) loaded in float32 and displaced
    by a Gaussian of 0.35 cells: stale buckets whose values are exact in
    both float32 and float64."""
    deck = _deck(tcfg, species=(tcfg.SpeciesSpec(
        "ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.1, shape_order=2),),
        precision="f32", rebin_mode="auto")
    sim = Simulation(deck, seed=seed, device="cpu")
    p = sim.state.species[0]
    gen = torch.Generator().manual_seed(seed)
    live = p.w > 0

    def shifted(a, n):
        d = torch.randn(a.shape, generator=gen) * 0.35
        v = torch.remainder(a + torch.clamp(d, -2.0, 2.0), n)
        return torch.where(live, torch.where(v >= n, v - n, v), a)

    return deck, p._replace(x=shifted(p.x, 32.0), y=shifted(p.y, 32.0))


def _rebin_calls(deck, p):
    """Each re-bin kernel's plain version as the main path calls it on `p`,
    by name: the split, the segment, the append, the defrag, append_runs,
    append_incoming (after the sort route of the movers) and the
    extract."""
    t = deck.tiling
    grid = dict(tile_cols=t.tile_cols, tile_ny=t.tile_ny, tile_nx=t.tile_nx)
    mc = deck.mover_cap(p.capacity)
    sc = deck.mover_seg_cap(mc)
    nbr = rb.seg_neighbor_table(t.tile_rows, t.tile_cols, CPU)
    p1, movers, wm, pending = rb.split_buckets_plain(p, **grid, b_cap=mc)
    seg, dropped = rb.segment_movers_plain(movers, tile_rows=t.tile_rows,
                                           **grid, b_seg=sc)
    inc, _ = route_movers(movers, t, mc)
    return {
        "split": lambda: (p1, movers, wm, pending),
        "segment": lambda: (seg, dropped),
        "append": lambda: rb.append_segments_plain(p1, seg, wm, nbr,
                                                   b_seg=sc),
        "defrag": lambda: rb.defrag_buckets_plain(
            p1, rb.roll_segments(seg, nbr, sc)),
        "append_runs": lambda: rb.append_runs_plain(
            p1, rb.roll_segments(seg, nbr, sc), wm, b_seg=sc),
        "append_incoming": lambda: rb.append_incoming_plain(p1, inc, wm),
        "extract": lambda: rb.extract_movers_plain(p, **grid, b_cap=mc,
                                                   force=True),
    }


def _flat(out):
    """The tensors of a call's output, in order."""
    for o in out:
        if isinstance(o, tuple):
            yield from o
        else:
            yield o


@pytest.mark.parametrize("kernel", ["split", "segment", "append", "defrag",
                                    "append_runs", "append_incoming",
                                    "extract"])
def test_rebin_plain_versions_on_f64_channels(kernel):
    """B2-B8's plain versions on a float64 state equal the same call on
    its float32 cast slot for slot, channel values and counts, where every
    value is exact in float32 (the state is made in float32) and the tile
    predicates agree (1/8 is exact in both types); the f64 outputs keep
    float64 channels."""
    deck, p32 = _stale_f32()
    p64 = ParticleState(*(a.double() for a in p32))
    got = list(_flat(_rebin_calls(deck, p64)[kernel]()))
    want = list(_flat(_rebin_calls(deck, p32)[kernel]()))
    assert len(got) == len(want)
    moved = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if b.is_floating_point():
            assert a.dtype == torch.float64, i
            assert torch.equal(a, b.double()), f"{kernel} output {i}"
            moved += int((a != 0).sum())
        else:
            assert torch.equal(a, b), f"{kernel} output {i}"
    assert moved > 0


@pytest.mark.parametrize("boundary", ["periodic", "open"])
@pytest.mark.parametrize("order", [1, 2])
def test_f64_warp_window_deposit_matches_plain(order, boundary):
    """The f64 mode's deposit as csrc/advance.cu decomposes it (emulated by
    ``minipic_torch.testing``: 32-slot slabs, lanes grouped by base, the
    staged sums per base into a J window set per warp, or shuffle trees
    and lane-by-lane adds into shared sets, the sets summed in a fixed
    order) on this file's f64 fixtures (stale
    buckets across the box edge; leavers through every wall), within
    1e-12 of the plain version's peak at 1, 2, 4 and 8 warps to a set."""
    from minipic_torch.ops.advance import advance_plain
    from minipic_torch.testing import (float_deposit_terms, sum_warp_windows,
                                       warp_adds)

    fixture = _periodic_fixture if boundary == "periodic" else _open_fixture
    deck, tiling, p, grid = fixture(order)
    f = finit.oblique_wave(deck.domain, amplitude=0.3, dtype=jnp.float64)
    ftiles = extract_field_tiles(
        pad_fields_periodic(f, deck.guard), tiling.tile_rows,
        tiling.tile_cols, tiling.tile_ny, tiling.tile_nx, deck.guard)
    pt = ParticleState(*(torch.from_numpy(np.array(a)) for a in p))
    ft = FieldState(*(torch.from_numpy(np.array(a)) for a in ftiles))
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=tiling.tile_ny,
              tile_nx=tiling.tile_nx, origins=tile_origins(tiling, CPU),
              g=deck.guard, dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=grid,
              mode="f64")
    out, jp, _ = advance_plain(pt, ft, counts, **kw)
    live, row0, col0, v = float_deposit_terms(pt, counts, out, **kw)
    assert v.dtype == np.float64
    nyg = tiling.tile_ny + 2 * deck.guard
    nxg = tiling.tile_nx + 2 * deck.guard
    tiles = {private: [warp_adds(live[t], row0[t], col0[t], v[t],
                                 int(counts[t]), nyg, nxg, private)[0]
                       for t in range(live.shape[0])]
             for private in (True, False)}
    for win_warps in (1, 2, 4, 8):
        got = np.stack([sum_warp_windows(a, nyg, nxg, win_warps, np.float64)
                        for a in tiles[win_warps == 1]])
        for n, name in enumerate(("jx", "jy", "jz")):
            want = jp[n].numpy()
            np.testing.assert_allclose(got[:, n], want, rtol=0,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"{name}, {win_warps}")
