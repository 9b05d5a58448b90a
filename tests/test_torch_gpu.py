"""The CUDA kernels (advance, and the deal-route re-bin) against their plain
torch versions, on the card, and the command line's I/O there.

Marked ``gpu``: each test skips without CUDA.  On a machine with a card
(which need not have JAX) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from minipic_torch.core.geometry import Tiling  # noqa: E402
from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.ops.advance import (  # noqa: E402
    AdvanceKernel, advance_kernel, advance_plain, advance_tiles,
    live_watermark)
from minipic_torch.probe_atomics import no_deposit_source  # noqa: E402
from minipic_torch.simulation import tile_origins  # noqa: E402
from minipic_torch.testing import push_out_through_walls  # noqa: E402

pytestmark = pytest.mark.gpu


def _origins(dev, rows, cols, ny=8, nx=8):
    """Tile origins (int32 [T]) of a rows x cols grid of ny x nx tiles."""
    return tile_origins(Tiling(tile_rows=rows, tile_cols=cols, tile_ny=ny,
                               tile_nx=nx), dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, g=4, cap=1024, seed=0):
    """4x4 tiles of 8x8 cells on a 32^2 periodic grid, ~700 live particles
    per bucket, up to 1 cell off their tile, and random fields."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    T, n_live = 16, 700

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    t = torch.arange(T, device=dev)[:, None]
    x = torch.remainder((t % 4) * 8 + rnd(T, cap) * 10 - 1, 32)
    y = torch.remainder((t // 4) * 8 + rnd(T, cap) * 10 - 1, 32)
    mom = [(rnd(T, cap) - 0.5) * 0.4 for _ in range(3)]
    w = (torch.arange(cap, device=dev)[None, :] < n_live).float() * 0.004
    w = w.expand(T, cap).contiguous()
    p = ParticleState(x, y, *mom, w)
    nw = 8 + 2 * g
    ft = FieldState(*((rnd(T, nw, nw) - 0.5) * 0.2 for _ in range(6)))
    return p, ft


@pytest.mark.parametrize("mode", ["int8", "f32"])
@pytest.mark.parametrize("order", [1, 2])
def test_kernel_matches_plain_on_the_card(cuda, order, mode):
    p, ft = _inputs(cuda)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=8, tile_nx=8,
              origins=_origins(cuda, 4, 4), g=4, dt=0.035, dx=0.1, dy=0.1,
              grid=(32, 32), mode=mode)
    n0 = advance_kernel.launches
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    assert advance_kernel.launches == n0 + 1
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pk, pp):
        # Same f32 ops on one card, no contraction: bit-equal in practice;
        # the CPU tests' 2e-6 as the bar.
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    for name, a, b in zip(("jx", "jy", "jz"), jk, jp):
        if mode == "int8" and name != "jz":
            # Integer sums, exact in any atomic order.
            assert torch.equal(a, b), name
        else:
            # f32 atomics in another order: 1e-5 of the window's peak.
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0)


def _lattice(p, every=0):
    """`p` with its 700 live particles per tile put in lattice order (11 to
    a cell, consecutive slots in one cell, so a warp's lanes share few
    bases); with `every`, each every-th of them moved 3.6-3.9 cells below
    and left of its tile, into the window-edge fold (centre cell at guard
    row and column 0), where q0+q1 leaves int8."""
    dev = p.x.device
    T, cap = p.x.shape
    s = torch.arange(cap, device=dev)[None, :].expand(T, cap)
    t = torch.arange(T, device=dev)[:, None]
    cell = s // 11
    x = (t % 4) * 8 + (cell % 8) + ((s % 11) + 0.5) / 11
    y = (t // 4) * 8 + (cell // 8) % 8 + 0.5
    if every:
        edge = (s % every == 0)
        x = torch.where(edge, (t % 4) * 8 - 3.9 + 0.3 * p.x / 32, x)
        y = torch.where(edge, (t // 4) * 8 - 3.9 + 0.3 * p.y / 32, y)
    live = p.w > 0
    return p._replace(
        x=torch.where(live, torch.remainder(x.float(), 32), p.x),
        y=torch.where(live, torch.remainder(y.float(), 32), p.y))


@pytest.mark.parametrize("mode", ["int8", "f32"])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("every", [0, 16])
def test_kernel_matches_plain_in_lattice_order_and_the_edge_fold(
        cuda, every, order, mode):
    """Lattice order takes the warp pre-reduction of jz (and of f32 J); the
    edge fold sends int8 jx/jy through the scatter beside the product."""
    p, ft = _inputs(cuda)
    p = _lattice(p, every)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=8, tile_nx=8,
              origins=_origins(cuda, 4, 4), g=4, dt=0.035, dx=0.1, dy=0.1,
              grid=(32, 32), mode=mode)
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pk, pp):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    for name, a, b in zip(("jx", "jy", "jz"), jk, jp):
        if mode == "int8" and name != "jz":
            assert torch.equal(a, b), name
        else:
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0)


@pytest.mark.parametrize("tile_nx", [16, 32])
def test_int8_kernel_matches_plain_on_wider_windows(cuda, tile_nx):
    """Windows 16 x 24 and 16 x 40 (2 and 4 pairs of column tiles in the
    tensor-core products; the headline's are 16 x 16)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    T, cap, g = 4, 1024, 4
    nx, ny = 2 * tile_nx, 16

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    t = torch.arange(T, device=cuda)[:, None]
    x = torch.remainder((t % 2) * tile_nx + rnd(T, cap) * (tile_nx + 2) - 1,
                        nx)
    y = torch.remainder((t // 2) * 8 + rnd(T, cap) * 10 - 1, ny)
    mom = [(rnd(T, cap) - 0.5) * 0.4 for _ in range(3)]
    w = ((torch.arange(cap, device=cuda)[None, :] < 900).float()
         * 0.004).expand(T, cap).contiguous()
    p = ParticleState(x, y, *mom, w)
    ft = FieldState(*((rnd(T, 16, tile_nx + 2 * g) - 0.5) * 0.2
                      for _ in range(6)))
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=tile_nx,
              origins=_origins(cuda, 2, 2, 8, tile_nx), g=g, dt=0.035,
              dx=0.1, dy=0.1, grid=(nx, ny), mode="int8")
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pk, pp):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    assert torch.equal(jk[0], jp[0]) and torch.equal(jk[1], jp[1])
    torch.testing.assert_close(jk[2], jp[2], rtol=0,
                               atol=1e-5 * float(jp[2].abs().max()))
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0)


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    p, ft = _inputs(cuda)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
              origins=_origins(cuda, 4, 4), g=4, dt=0.035, dx=0.1, dy=0.1,
              grid=(32, 32), mode="int8")
    with pytest.raises(ValueError):
        advance_kernel(p._replace(x=p.x.double()), ft, counts, **kw)
    with pytest.raises(ValueError):
        advance_kernel(p._replace(y=p.y.t().contiguous().t()), ft, counts,
                       **kw)
    with pytest.raises(ValueError):
        advance_kernel(p, ft, counts.long(), **kw)
    with pytest.raises(ValueError):
        advance_kernel(p, ft._replace(ex=ft.ex.cpu()), counts, **kw)


@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_no_atomics_probe_pushes_alike_and_deposits_nothing(cuda, tmp_path,
                                                            mode):
    """The probe's variant (probe_atomics) differs from the kernel only in
    the deposit: same particles and displacements, all-zero J."""
    src = tmp_path / "advance_nodeposit.cu"
    src.write_text(no_deposit_source())
    p, ft = _inputs(cuda)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
              origins=_origins(cuda, 4, 4), g=4, dt=0.035, dx=0.1, dy=0.1,
              grid=(32, 32), mode=mode)
    pv, jv, dv = AdvanceKernel(src)(p, ft, counts, **kw)
    pk, _, dk = advance_kernel(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pv, pk):
        assert torch.equal(a, b)
    assert torch.equal(dv, dk)
    for j in jv:
        assert not bool(j.any())


# ----------------------------------------------------------------------
# The advance's open mode (grid None): decks between absorbing walls.

def _open_inputs(dev, tile, g, cap, seed=4):
    """A 32^2 box of tile^2 tiles: ~60% of each bucket live, up to 0.3
    cells off its tile (inside the box), every 7th slot dead; in the tiles
    at each wall, particles within 0.2 cells of it moving out at |u| = 3
    (through each wall and, diagonally, each corner); random fields."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = 32 // tile
    T = cols * cols

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    t = torch.arange(T, device=dev)[:, None]
    ox, oy = (t % cols) * tile, (t // cols) * tile
    x = (ox + rnd(T, cap) * (tile + 0.6) - 0.3).clamp(0.01, 31.99)
    y = (oy + rnd(T, cap) * (tile + 0.6) - 0.3).clamp(0.01, 31.99)
    px, py, pz = ((rnd(T, cap) - 0.5) * 0.4 for _ in range(3))
    slot = torch.arange(cap, device=dev)[None, :]
    live = (slot < int(0.6 * cap)) & (slot % 7 != 5)
    x, y, px, py = push_out_through_walls(x, y, px, py, live, ox, oy, tile,
                                          tile, 32, 32, rnd(T, cap) * 0.2)
    w = live.float() * 0.004 * (1.0 + rnd(T, cap))  # graded weights
    p = ParticleState(x, y, px, py, pz, w)
    nw = tile + 2 * g
    ft = FieldState(*((rnd(T, nw, nw) - 0.5) * 0.2 for _ in range(6)))
    return p, ft


@pytest.mark.parametrize("order,tile,g,cap", [(1, 16, 2, 1536),
                                              (2, 8, 4, 512)],
                         ids=["laser_plasma", "laser_wakefield_window"])
def test_open_mode_kernel_matches_plain_on_the_card(cuda, order, tile, g,
                                                    cap):
    """The open mode at the laser decks' shapes (CIC 20x20 windows of 1536
    slots; TSC 16x16 of 512), f32: live particles' positions and momenta
    equal to the plain version's, leavers through every wall and corner
    stored unwrapped, dead slots untouched, J to 2e-5 of its peak (f32
    atomics in another order); the periodic mode on the same subset as
    before."""
    p, ft = _open_inputs(cuda, tile, g, cap)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=tile, tile_nx=tile,
              origins=_origins(cuda, 32 // tile, 32 // tile, tile, tile),
              g=g, dt=0.035, dx=0.1, dy=0.1,
              grid=None, mode="f32")
    n0 = advance_kernel.launches
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    assert advance_kernel.launches == n0 + 1
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    live = p.w > 0
    for name, a, b, old in zip("x y px py pz".split(), pk, pp, p):
        d = (a - b)[live].abs()
        assert torch.equal(a[live], b[live]), (
            name, int((d > 0).sum()), float(d.max()))
        assert torch.equal(a[~live], old[~live]), name
    x1, y1 = pk[0][live], pk[1][live]
    for out in (x1 < 0, x1 >= 32, y1 < 0, y1 >= 32,
                ((x1 < 0) | (x1 >= 32)) & ((y1 < 0) | (y1 >= 32))):
        assert int(out.sum()) >= 4
    for a, b in zip(jk, jp):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2e-5 * float(b.abs().max()))
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0)
    kw["grid"] = (32, 32)
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pk, pp):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    for a, b in zip(jk, jp):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("name,kw,steps", [
    ("reference_pulse", dict(nx=64, ny=64), 40),
    ("laser_plasma", dict(nx=64, ny=64, ppc=2), 12),
    ("laser_wakefield_window", dict(nx=64, ny=32, ppc=2), 26)])
def test_open_deck_steps_on_the_card_match_the_cpu(cuda, name, kw, steps):
    """Each deck with open walls (and the fields-only pulse) a few steps on
    the card against the same state stepped on the CPU; the window deck
    through its first shift."""
    from minipic_torch import bridge
    from minipic_torch.decks import standard

    case = standard.make(name, **kw)
    cpu = case.simulation(seed=1, device="cpu")
    gpu = case.simulation(seed=1, device=cuda)
    gpu.state = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(cpu.state), cuda)
    for i in range(steps):
        dc, dg = cpu.step(), gpu.step()
        torch.testing.assert_close(dg.field_energy.cpu(), dc.field_energy,
                                   rtol=1e-4, atol=1e-12)
        torch.testing.assert_close(dg.kinetic_energy.cpu(),
                                   dc.kinetic_energy, rtol=1e-5, atol=0)
        assert int(dg.shard_live[0]) == int(dc.shard_live[0]), i
        assert dg.rebinned == dc.rebinned and int(dg.overflow) == 0
    if case.deck.moving_window:
        assert int(gpu.state.window_x0) == int(cpu.state.window_x0) == 8
    for a, b in zip(gpu.state.fields, cpu.state.fields):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


# ----------------------------------------------------------------------
# The deal-route re-bin kernels (csrc/rebin.cu) against their plain
# versions: pure copies, so every channel of every slot must be equal.

def _stale(dev, cap=3072, n_live=2000, spread=2.0, seed=1):
    """4x4 tiles of 8x8 cells on a 32^2 periodic grid: live-compacted
    buckets of n_live particles displaced up to `spread` cells off their
    tile, as after a few steps without a re-bin."""
    from minipic_torch.core.state import ParticleState as P

    gen = torch.Generator(device=dev).manual_seed(seed)
    T = 16

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    t = torch.arange(T, device=dev)[:, None]
    live = torch.arange(cap, device=dev)[None, :] < n_live
    x = (t % 4) * 8 + rnd(T, cap) * (8 + 2 * spread) - spread
    y = (t // 4) * 8 + rnd(T, cap) * (8 + 2 * spread) - spread
    x, y = torch.remainder(x, 32), torch.remainder(y, 32)
    x = torch.where(x >= 32, x - 32, x)
    y = torch.where(y >= 32, y - 32, y)
    mom = [(rnd(T, cap) - 0.5) * 0.2 for _ in range(3)]
    w = live.float().expand(T, cap) * 0.004
    p = P(x, y, *mom, w)
    return P(*(torch.where(live, a, torch.zeros_like(a)).contiguous()
               for a in p))


def _equal(a, b, what):
    for name, u, v in zip(("x", "y", "px", "py", "pz", "w"), a, b):
        assert torch.equal(u, v), f"{what}.{name}"


_GRID = dict(tile_cols=4, tile_ny=8, tile_nx=8)


@pytest.mark.parametrize("case", ["normal", "pending", "forced"])
def test_split_kernel_matches_plain(cuda, case):
    from minipic_torch.ops import rebin as rb

    p = _stale(cuda)
    b_cap = 1536 if case == "normal" else 512
    kw = dict(_GRID, b_cap=b_cap, force=case == "forced")
    n0 = rb.split_kernel.launches
    got = rb.split_buckets(p, **kw)
    assert rb.split_kernel.launches == n0 + 1
    want = rb.split_buckets_plain(p, **kw)
    _equal(got[0], want[0], "buckets")
    _equal(got[1], want[1], "movers")
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    if case != "normal":
        assert int(want[3].sum()) > 0


def _movers(dev):
    from minipic_torch.ops import rebin as rb

    p = _stale(dev)
    _, movers, _, _ = rb.split_buckets_plain(p, **_GRID, b_cap=1536)
    # A mover of tile 5 (row 1, col 1) in column 3, two tiles from home:
    # killed and counted.
    x, y = movers.x.clone(), movers.y.clone()
    x[5, 0], y[5, 0] = 28.5, 12.0
    return movers._replace(x=x, y=y)


@pytest.mark.parametrize("b_seg", [512, 128])
def test_segment_kernel_matches_plain(cuda, b_seg):
    from minipic_torch.ops import rebin as rb

    movers = _movers(cuda)
    kw = dict(tile_rows=4, **_GRID, b_seg=b_seg)
    seg, dropped = rb.segment_movers(movers, **kw)
    seg_p, dropped_p = rb.segment_movers_plain(movers, **kw)
    _equal(seg, seg_p, "seg")
    assert torch.equal(dropped, dropped_p) and int(dropped_p[5]) >= 1


@pytest.mark.parametrize("crowded", [False, True])
def test_append_and_defrag_kernels_match_plain(cuda, crowded):
    """Crowded: the append lands above a raised watermark and overflows,
    and the defrag merges the arrivals into the unsplit buckets (census
    overflow).  Also the defrag of hole-ridden buckets alone."""
    from minipic_torch.ops import rebin as rb

    p = _stale(cuda)
    p1, movers, wm, _ = rb.split_buckets_plain(p, **_GRID, b_cap=3072)
    seg, _ = rb.segment_movers_plain(movers, tile_rows=4, **_GRID,
                                     b_seg=256)
    nbr = rb.seg_neighbor_table(4, 4, cuda)
    if crowded:
        wm = wm + 1500
    want, want_d = rb.append_segments_plain(p1, seg, wm, nbr, b_seg=256)
    got = rb.ParticleState(*(a.clone() for a in p1))
    got_d = rb.append_kernel(got, seg, wm, nbr, b_seg=256)
    _equal(got, want, "append")
    assert torch.equal(got_d, want_d)
    assert bool((want_d > 0).any()) == crowded
    holes = torch.rand(p.w.shape, device=cuda) < 0.3
    ridden = p._replace(w=torch.where(holes, torch.zeros_like(p.w), p.w))
    for q, merge in ((p if crowded else p1, True), (ridden, False)):
        inc = rb.roll_segments(seg, nbr, 256) if merge else None
        want, want_c, want_d = rb.defrag_buckets_plain(q, inc)
        got = rb.ParticleState(*(a.clone() for a in q))
        got_c, got_d = rb.defrag_kernel(got, seg if merge else None,
                                        nbr if merge else None, b_seg=256)
        _equal(got, want, f"defrag merge={merge}")
        assert torch.equal(got_c, want_c) and torch.equal(got_d, want_d)
        assert bool((want_d > 0).any()) == (crowded and merge)


@pytest.mark.parametrize("crowded", [False, True])
def test_rebin_auto_on_the_card_matches_the_cpu(cuda, crowded):
    """The whole deal route through the kernels against the plain versions
    on the CPU; a crowded state takes the defrag branch on the device."""
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import rebin_auto

    p = _stale(cuda, n_live=2810 if crowded else 2000, spread=1.0)
    tiling = Tiling(tile_rows=4, tile_cols=4, tile_ny=8, tile_nx=8)
    for k in rb.KERNELS.values():
        k.reset()
    got, dropped, pending = rebin_auto(p, tiling, 1536, seg_cap=256)
    cpu = rb.ParticleState(*(a.cpu() for a in p))
    want, dropped_p, pending_p = rebin_auto(cpu, tiling, 1536, seg_cap=256)
    _equal(rb.ParticleState(*(a.cpu() for a in got)), want, "rebin_auto")
    assert int(dropped) == int(dropped_p) and int(pending) == int(pending_p)
    deal = ("split", "segment", "append", "defrag")
    assert all(rb.KERNELS[n].launches == 1 for n in deal)
    assert all(k.launches == 0 for n, k in rb.KERNELS.items()
               if n not in deal)
    assert rb.defrag_kernel.taken_count() == int(crowded)
    assert rb.append_kernel.taken_count() == int(not crowded)


def test_rebin_wrappers_reject_bad_inputs(cuda):
    from minipic_torch.ops import rebin as rb

    p = _stale(cuda)
    with pytest.raises(ValueError):
        rb.split_kernel(p._replace(x=p.x.double()), **_GRID, b_cap=512)
    with pytest.raises(ValueError):
        rb.split_kernel(p._replace(w=p.w[:, :-1]), **_GRID, b_cap=512)
    with pytest.raises(ValueError):
        rb.segment_kernel(p, tile_rows=3, **_GRID, b_seg=128)
    nbr = rb.seg_neighbor_table(4, 4, cuda)
    wm = torch.zeros(16, dtype=torch.int32, device=cuda)
    seg = rb.ParticleState(*(torch.zeros(16, 8 * 128, device=cuda)
                             for _ in range(6)))
    with pytest.raises(ValueError):
        rb.append_kernel(p, seg, wm.long(), nbr, b_seg=128)
    with pytest.raises(ValueError):
        rb.defrag_kernel(p, seg, nbr.cpu(), b_seg=128)


# ----------------------------------------------------------------------
# append_incoming, append_runs and extract (csrc/rebin.cu) against their
# plain versions, and the small-bucket rebin_auto and rebin_incremental
# through the kernels against the CPU.

_TILING = dict(tile_rows=4, tile_cols=4, tile_ny=8, tile_nx=8)


@pytest.mark.parametrize("case", ["normal", "crowded", "inactive"])
def test_append_incoming_kernel_matches_plain(cuda, case):
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import route_movers

    p = _stale(cuda, cap=1536, n_live=1000, spread=1.0)
    p1, movers, wm, _ = rb.split_buckets_plain(p, **_GRID, b_cap=512)
    inc, _ = route_movers(movers, Tiling(**_TILING), 512)
    if case == "crowded":
        wm = torch.where(torch.arange(16, device=cuda) % 2 == 1,
                         wm + 600, wm).to(torch.int32)
    want, want_d = rb.append_incoming_plain(p1, inc, wm)
    got = rb.ParticleState(*(a.clone() for a in p1))
    rb.append_incoming_kernel.reset()
    got_d = rb.append_incoming_kernel(got, inc, wm,
                                      active=case != "inactive")
    if case == "inactive":
        _equal(got, p1, "inactive")
        assert not bool(got_d.any())
        assert rb.append_incoming_kernel.taken_count() == 0
        return
    _equal(got, want, "append_incoming")
    assert torch.equal(got_d, want_d)
    assert bool((want_d > 0).any()) == (case == "crowded")
    assert rb.append_incoming_kernel.taken_count() == 1


def test_append_runs_kernel_matches_plain_and_the_fused_append(cuda):
    from minipic_torch.ops import rebin as rb

    p = _stale(cuda)
    p1, movers, wm, _ = rb.split_buckets_plain(p, **_GRID, b_cap=1536)
    seg, _ = rb.segment_movers_plain(movers, tile_rows=4, **_GRID,
                                     b_seg=256)
    nbr = rb.seg_neighbor_table(4, 4, cuda)
    inc = rb.roll_segments(seg, nbr, 256)
    want, want_d = rb.append_runs_plain(p1, inc, wm, b_seg=256)
    got = rb.ParticleState(*(a.clone() for a in p1))
    got_d = rb.append_runs_kernel(got, inc, wm, b_seg=256)
    fused = rb.ParticleState(*(a.clone() for a in p1))
    fused_d = rb.append_kernel(fused, seg, wm, nbr, b_seg=256)
    _equal(got, want, "append_runs")
    _equal(got, fused, "append_runs vs append")
    assert torch.equal(got_d, want_d) and torch.equal(got_d, fused_d)


def test_dense_defrag_kernel_matches_plain(cuda):
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import route_movers

    p = _stale(cuda, cap=1536, n_live=1400, spread=1.0)
    _, movers, _, _ = rb.split_buckets_plain(p, **_GRID, b_cap=512)
    inc, _ = route_movers(movers, Tiling(**_TILING), 512)
    want, want_c, want_d = rb.defrag_buckets_plain(p, inc)
    got = rb.ParticleState(*(a.clone() for a in p))
    got_c, got_d = rb.defrag_kernel(got, inc)
    _equal(got, want, "dense defrag")
    assert torch.equal(got_c, want_c) and torch.equal(got_d, want_d)
    assert bool((want_d > 0).any())


@pytest.mark.parametrize("case", ["normal", "pending", "forced", "holes"])
def test_extract_kernel_matches_plain(cuda, case):
    from minipic_torch.ops import rebin as rb

    p = _stale(cuda, cap=1536, n_live=1400,
               spread=3.0 if case in ("pending", "forced") else 0.5)
    if case == "holes":
        holes = torch.rand(p.w.shape, device=cuda) < 0.3
        p = p._replace(w=torch.where(holes, torch.zeros_like(p.w), p.w))
    kw = dict(_GRID, b_cap=640, force=case == "forced")
    n0 = rb.extract_kernel.launches
    got = rb.extract_movers(p, **kw)
    assert rb.extract_kernel.launches == n0 + 1
    want = rb.extract_movers_plain(p, **kw)
    _equal(got[0], want[0], "buckets")
    _equal(got[1], want[1], "movers")
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert (int(want[3].sum()) > 0) == (case in ("pending", "forced"))


@pytest.mark.parametrize("crowded", [False, True])
def test_small_bucket_rebin_auto_on_the_card_matches_the_cpu(cuda, crowded):
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import rebin_auto

    p = _stale(cuda, cap=1536, n_live=1400 if crowded else 1000, spread=1.0)
    tiling = Tiling(**_TILING)
    for k in rb.KERNELS.values():
        k.reset()
    got, dropped, pending = rebin_auto(p, tiling, 512, seg_cap=256)
    cpu = rb.ParticleState(*(a.cpu() for a in p))
    want, dropped_p, pending_p = rebin_auto(cpu, tiling, 512, seg_cap=256)
    _equal(rb.ParticleState(*(a.cpu() for a in got)), want, "rebin_auto")
    assert int(dropped) == int(dropped_p) and int(pending) == int(pending_p)
    assert rb.segment_kernel.launches == 0
    assert rb.append_incoming_kernel.launches == 1
    assert rb.defrag_kernel.taken_count() == int(crowded)
    assert rb.append_incoming_kernel.taken_count() == int(not crowded)


def test_rebin_incremental_on_the_card_matches_the_cpu(cuda):
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import rebin_incremental

    p = _stale(cuda, cap=1536, n_live=1000, spread=1.0)
    cpu = rb.ParticleState(*(a.cpu() for a in p))
    tiling = Tiling(**_TILING)
    got, dropped, wm = rebin_incremental(p, tiling, 512)
    want, dropped_p, wm_p = rebin_incremental(cpu, tiling, 512)
    _equal(rb.ParticleState(*(a.cpu() for a in got)), want,
           "rebin_incremental")
    assert int(dropped) == int(dropped_p) and int(wm) == int(wm_p)


_EXTRACT_EDGES = {
    # name: (cap, live slots, spread, b_cap, force)
    "ragged cap": (1000, 900, 0.5, 1000, False),
    "ragged cap forced": (1000, 900, 3.0, 256, True),
    # Tiles 1, 6 and 11 moved a tile east: all their particles are movers,
    # over the buffer, so they do not extract and their w is put back.
    "restore": (1536, 1400, 0.5, 512, False),
    # 12,504 ballot words: 50 KB of shared memory, past the 48 KB default.
    "past 48 KB": (400_128, 390_000, 0.05, 16384, False),
    "past 48 KB forced": (400_128, 390_000, 0.05, 4096, True),
}


@pytest.mark.parametrize("case", list(_EXTRACT_EDGES))
def test_extract_kernel_edge_cases_match_plain(cuda, case):
    from minipic_torch.ops import rebin as rb

    cap, n_live, spread, b_cap, force = _EXTRACT_EDGES[case]
    p = _stale(cuda, cap=cap, n_live=n_live, spread=spread)
    if case == "restore":
        east = torch.zeros(16, 1, dtype=torch.bool, device=cuda)
        east[[1, 6, 11]] = True
        x = torch.remainder(p.x + 8.0, 32.0)
        p = p._replace(x=torch.where(east & (p.w > 0), x, p.x))
    kw = dict(_GRID, b_cap=b_cap, force=force)
    got = rb.extract_movers(p, **kw)
    want = rb.extract_movers_plain(p, **kw)
    torch.cuda.synchronize()
    _equal(got[0], want[0], "buckets")
    _equal(got[1], want[1], "movers")
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    kept = (want[1].w > 0).sum(1)
    assert int(kept.sum()) > 0
    if case == "restore":
        # The tiles that did not extract keep their w as it was.
        deferred = (kept == 0) & (want[3] > 0)
        assert deferred.nonzero().flatten().tolist() == [1, 6, 11]
        assert torch.equal(got[0].w[deferred], p.w[deferred])
    assert (int(want[3].sum()) > 0) == force or case == "restore"
    if case.startswith("ragged"):
        assert cap % 32
    if case.startswith("past"):
        assert rb.extract_smem_bytes(cap) > 48 * 1024


def test_extract_wrapper_raises_past_shared_memory(cuda):
    """Buckets whose ballot words do not fit a block's 227 KB raise; nothing
    falls back or launches."""
    from minipic_torch.ops import rebin as rb

    cap = 32 * (rb.SMEM_LIMIT // 4 - rb._EXTRACT_RED) + 1
    p = rb.ParticleState(*(torch.zeros((4, cap), device=cuda)
                           for _ in range(6)))
    n0 = rb.extract_kernel.launches
    with pytest.raises(ValueError, match="ballot words"):
        rb.extract_movers(p, **_GRID, b_cap=512)
    assert rb.extract_kernel.launches == n0


@pytest.mark.parametrize("empty", [(0, 3, 7), tuple(range(8))])
def test_append_runs_kernel_with_empty_runs_matches_plain(cuda, empty):
    """Runs 0, 3 and 7 of every tile empty (the flat copy steps over
    them), or all eight (nothing to copy)."""
    from minipic_torch.ops import rebin as rb

    p = _stale(cuda)
    p1, movers, wm, _ = rb.split_buckets_plain(p, **_GRID, b_cap=1536)
    seg, _ = rb.segment_movers_plain(movers, tile_rows=4, **_GRID,
                                     b_seg=256)
    inc = rb.roll_segments(seg, rb.seg_neighbor_table(4, 4, cuda), 256)
    gone = torch.zeros(8, dtype=torch.bool, device=cuda)
    gone[list(empty)] = True
    gone = gone.repeat_interleave(256)[None, :]
    inc = rb.ParticleState(*(torch.where(gone, torch.zeros_like(a), a)
                             for a in inc))
    want, want_d = rb.append_runs_plain(p1, inc, wm, b_seg=256)
    got = rb.ParticleState(*(a.clone() for a in p1))
    got_d = rb.append_runs_kernel(got, inc, wm, b_seg=256)
    _equal(got, want, "append_runs")
    assert torch.equal(got_d, want_d)
    n_in = int((inc.w > 0).sum())
    assert (n_in == 0) == (len(empty) == 8)


# ----------------------------------------------------------------------
# The command line and its I/O on the card.

def test_cli_runs_on_the_card_and_resumes_a_fields_deck_bit_for_bit(
        cuda, tmp_path):
    """The CLI's default device is the card; fields alone, its steps are
    deterministic, so a run resumed half way equals the straight one."""
    import numpy as np

    from minipic_torch import cli

    args = ["--deck", "reference_pulse", "--nx", "64", "--ny", "64",
            "--save-every", "10", "--no-save"]
    assert cli.main(args + ["--steps", "40", "--out", str(tmp_path / "a")]) \
        == 0
    for extra in (["--steps", "20"], ["--steps", "40", "--resume"]):
        assert cli.main(args + extra + ["--out", str(tmp_path / "b")]) == 0
    za, zb = (np.load(tmp_path / d / "checkpoint.npz") for d in "ab")
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert np.array_equal(za[k], zb[k]), k
    assert int(za["step"]) == 40


def test_snapshot_buffers_match_the_cpu(cuda):
    """io.hdf5's tile windows and particle buffer on the card equal the same
    calls on a CPU copy (diag/device.py is held to the CPU in
    chip_smoke.py's cli phase, at laser_plasma's full size)."""
    from minipic_torch.decks import standard
    from minipic_torch.io import hdf5

    case = standard.make("laser_plasma", nx=64, ny=64, ppc=2)
    gpu = case.simulation(seed=1, device=cuda)
    gpu.step(6)
    st, d = gpu.state, case.deck
    cpu = [ParticleState(*(a.cpu() for a in p)) for p in st.species]
    fcpu = FieldState(*(c.cpu() for c in st.fields))
    assert (hdf5.tile_windows(st.fields, d.tiling, d.guard)
            == hdf5.tile_windows(fcpu, d.tiling, d.guard)).all()
    cg, bg = hdf5.particle_buffer(st.species)
    cc, bc = hdf5.particle_buffer(cpu)
    assert cg == cc and (bg == bc).all()


# ----------------------------------------------------------------------
# The advance, split and segment in global tile coordinates (the
# multi-device simulations' modes) against their plain versions, and a (2, 2)
# sharded twin with every shard on the card.

def _relocate(p, gids, nx=64, tiles=8):
    """Buckets of the 4x4 grid of 32^2 fixtures moved to the tiles `gids` of
    an 8x8 grid on a 64^2 box (their positions shifted with their tile)."""
    dev = p.x.device
    t = torch.arange(16, device=dev)[:, None]
    g = torch.as_tensor(gids, device=dev)[:, None]

    def move(v, old, new):
        # The offset from the old tile's origin, unwrapped on the 32^2 box.
        off = torch.remainder(v - old * 8 + 16, 32) - 16
        v = torch.remainder(new.float() * 8 + off, nx)
        return torch.where(v >= nx, v - nx, v)

    return p._replace(
        x=torch.where(p.w > 0, move(p.x, t % 4, g % tiles), p.x),
        y=torch.where(p.w > 0, move(p.y, t // 4, g // tiles), p.y))


# Shard (1, 1) of a (2, 2) mesh on the 8x8 grid; the stripe of shard 3 of
# 8 extended to 16 tiles.
_BLOCK = [(4 + i) * 8 + 4 + j for i in range(4) for j in range(4)]
_GIDS = [3, 12, 17, 26, 35, 44, 49, 58, 7, 8, 21, 30, 39, 40, 53, 62]


@pytest.mark.parametrize("mode", ["int8", "f32"])
@pytest.mark.parametrize("layout", ["block", "gids"])
def test_kernel_with_global_origins_matches_plain(cuda, layout, mode):
    gids = _BLOCK if layout == "block" else _GIDS
    p, ft = _inputs(cuda)
    p = _relocate(p, gids)
    g = torch.tensor(gids, device=cuda, dtype=torch.int32)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
              origins=((g % 8) * 8, (g // 8) * 8), g=4, dt=0.035, dx=0.1,
              dy=0.1, grid=(64, 64), mode=mode)
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pk, pp):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    if mode == "int8":
        assert torch.equal(jk[0], jp[0]) and torch.equal(jk[1], jp[1])
    for a, b in zip(jk, jp):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("layout", ["block", "gids"])
def test_split_kernel_in_global_coordinates_matches_plain(cuda, layout):
    from minipic_torch.ops import rebin as rb

    gids = _BLOCK if layout == "block" else _GIDS
    p = _relocate(_stale(cuda), gids)
    if layout == "block":
        kw = dict(tile_cols=4, row0=4, col0=4)
    else:
        kw = dict(tile_cols=8, tile_ids=torch.tensor(gids, device=cuda,
                                                     dtype=torch.int32))
    kw.update(tile_ny=8, tile_nx=8, b_cap=1536)
    got = rb.split_buckets(p, **kw)
    want = rb.split_buckets_plain(p, **kw)
    _equal(got[0], want[0], "buckets")
    _equal(got[1], want[1], "movers")
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert int((want[1].w > 0).sum()) > 1000


@pytest.mark.parametrize("origin", [(4, 4), (0, 0)])
def test_segment_kernel_in_global_coordinates_matches_plain(cuda, origin):
    from minipic_torch.ops import rebin as rb

    r0, c0 = origin
    gids = [(r0 + i) * 8 + c0 + j for i in range(4) for j in range(4)]
    p = _relocate(_stale(cuda), gids)
    kw = dict(tile_cols=4, tile_ny=8, tile_nx=8, row0=r0, col0=c0)
    _, movers, _, _ = rb.split_buckets_plain(p, b_cap=1536, **kw)
    kw.update(tile_rows=4, b_seg=512, grid_rows=8, grid_cols=8)
    seg, dropped = rb.segment_movers(movers, **kw)
    seg_p, dropped_p = rb.segment_movers_plain(movers, **kw)
    _equal(seg, seg_p, "seg")
    assert torch.equal(dropped, dropped_p) and int(dropped_p.sum()) == 0


def test_sharded_twin_on_the_card(cuda):
    """ShardedSimulation at (2, 2), every shard on the card, against
    Simulation there (tests/test_parallel.py:293-299's f32 bars, int8 and
    guard 4): energies, live counts exact, overflow 0."""
    from minipic_torch.core.config import Deck, SpeciesSpec
    from minipic_torch.parallel.step import ShardedSimulation
    from minipic_torch.simulation import Simulation

    deck = Deck(box_x=8.0, box_y=8.0, nx=64, ny=64, tile_nx=8, tile_ny=8,
                guard=4, deposit="int8", mesh_shape=(2, 2),
                species=(SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4,
                                     ux=0.3, uy=0.2, uth=0.05),
                         SpeciesSpec("ion", charge=+1.0, mass=5.0, ppc=4,
                                     ux=-0.1, uth=0.02)))
    ref = Simulation(deck, seed=7, device=cuda)
    sh = ShardedSimulation(deck, seed=7)
    assert sh.mesh.devices == [cuda] * 4
    dref, dsh = ref.step(12), sh.step(12)
    assert int(dref.overflow) == 0 and int(dsh.overflow) == 0
    torch.testing.assert_close(dsh.field_energy, dref.field_energy,
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(dsh.kinetic_energy, dref.kinetic_energy,
                               rtol=1e-6, atol=0)
    assert int(dsh.shard_live.sum()) == int(dref.shard_live[0])


# ----------------------------------------------------------------------
# Decks of precision "f64": the advance's f64 mode and the re-bin kernels
# over float64 channels against their plain versions.

def _double(t):
    return type(t)(*(a.double() for a in t))


def _ulps(a, b):
    """max |a - b| in ulps of the channel's scale (the spacing of f64 at
    max |b|): sums that cancel near zero carry their operands' error."""
    return float((a - b).abs().max() / torch.finfo(torch.float64).eps
                 / b.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("boundary", ["periodic", "open"])
@pytest.mark.parametrize("order", [1, 2])
def test_f64_kernel_matches_plain_on_the_card(cuda, order, boundary):
    """B1's f64 mode (double particles, windows and constants) against its
    plain version: positions and momenta within 2 ulp of each channel's
    scale, dead slots untouched, J within 1e-12 of its peak (double
    atomics in another order), the displacements to 1e-12."""
    if boundary == "periodic":
        tile, g, grid = 8, 4, (32, 32)
        p, ft = _inputs(cuda)
    else:
        tile, g, cap = (16, 2, 1536) if order == 1 else (8, 4, 512)
        grid = None
        p, ft = _open_inputs(cuda, tile, g, cap)
    p, ft = _double(p), _double(ft)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=tile, tile_nx=tile,
              origins=_origins(cuda, 32 // tile, 32 // tile, tile, tile),
              g=g, dt=0.035, dx=0.1, dy=0.1, grid=grid, mode="f64")
    n0 = advance_kernel.launches
    pk, jk, dk = advance_tiles(p, ft, counts, **kw)
    assert advance_kernel.launches == n0 + 1
    pp, jp, dp = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    live = p.w > 0
    for name, a, b, old in zip("x y px py pz".split(), pk, pp, p):
        assert a.dtype == torch.float64
        assert _ulps(a[live], b[live]) <= 2, name
        assert torch.equal(a[~live], old[~live]), name
    for name, a, b in zip(("jx", "jy", "jz"), jk, jp):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-12 * float(b.abs().max()))
    torch.testing.assert_close(dk, dp, rtol=1e-12, atol=0)


def _rebin_pair(name, p, dev):
    """(kernel call, plain call) of one re-bin kernel on the stale buckets
    `p` (4x4 tiles of 3072 slots); the in-place kernels work on copies."""
    from minipic_torch.core.geometry import Tiling
    from minipic_torch.ops import rebin as rb
    from minipic_torch.particles.binning import route_movers

    def copy(q):
        return rb.ParticleState(*(a.clone() for a in q))

    p1, movers, wm, _ = rb.split_buckets_plain(p, **_GRID, b_cap=1536)
    seg, _ = rb.segment_movers_plain(movers, tile_rows=4, **_GRID,
                                     b_seg=256)
    nbr = rb.seg_neighbor_table(4, 4, dev)
    inc = rb.roll_segments(seg, nbr, 256)
    row, _ = route_movers(movers, Tiling(**_TILING), 1536)

    def in_place(kernel, plain):
        def run():
            q = copy(p1)
            return (q, kernel(q))
        return run, plain

    pairs = {
        "split": (lambda: rb.split_kernel(p, **_GRID, b_cap=1536),
                  lambda: rb.split_buckets_plain(p, **_GRID, b_cap=1536)),
        "segment": (
            lambda: rb.segment_kernel(movers, tile_rows=4, **_GRID,
                                      b_seg=256),
            lambda: rb.segment_movers_plain(movers, tile_rows=4, **_GRID,
                                            b_seg=256)),
        "append": in_place(
            lambda q: rb.append_kernel(q, seg, wm, nbr, b_seg=256),
            lambda: rb.append_segments_plain(p1, seg, wm, nbr, b_seg=256)),
        "defrag": in_place(
            lambda q: rb.defrag_kernel(q, seg, nbr, b_seg=256),
            lambda: rb.defrag_buckets_plain(p1, inc)),
        "append_runs": in_place(
            lambda q: rb.append_runs_kernel(q, inc, wm, b_seg=256),
            lambda: rb.append_runs_plain(p1, inc, wm, b_seg=256)),
        "append_incoming": in_place(
            lambda q: rb.append_incoming_kernel(q, row, wm),
            lambda: rb.append_incoming_plain(p1, row, wm)),
        "extract": (lambda: rb.extract_kernel(p, **_GRID, b_cap=1536),
                    lambda: rb.extract_movers_plain(p, **_GRID, b_cap=1536)),
    }
    return pairs[name]


def _tensors(out):
    for o in out:
        if isinstance(o, tuple):
            yield from o
        else:
            yield o


@pytest.mark.parametrize("name", ["split", "segment", "append", "defrag",
                                  "append_runs", "append_incoming",
                                  "extract"])
def test_f64_rebin_kernel_matches_plain(cuda, name):
    """B2-B8 over float64 channels against their plain versions, slot for
    slot: every channel (float64) and every count equal."""
    p = _double(_stale(cuda))
    kernel, plain = _rebin_pair(name, p, cuda)
    got, want = list(_tensors(kernel())), list(_tensors(plain()))
    torch.cuda.synchronize()
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        assert torch.equal(a, b), f"{name} output {i}"
    assert any(a.dtype == torch.float64 and bool((a != 0).any())
               for a in got)


# ----------------------------------------------------------------------
# The f32 and f64 deposits' J window sets: private to each warp at every
# deck's window, shared by 2, 4 or 8 warps past what shared memory holds.

def _wide_inputs(dev, n, g=2, T=4, cap=2048, n_live=1500, seed=6):
    """2x2 tiles of (n - 2g)^2 cells, windows n^2: n_live particles a
    bucket up to a cell off their tile, random fields."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tile = n - 2 * g

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    t = torch.arange(T, device=dev)[:, None]
    x = torch.remainder((t % 2) * tile + rnd(T, cap) * (tile + 2) - 1,
                        2 * tile)
    y = torch.remainder((t // 2) * tile + rnd(T, cap) * (tile + 2) - 1,
                        2 * tile)
    mom = [(rnd(T, cap) - 0.5) * 0.4 for _ in range(3)]
    w = ((torch.arange(cap, device=dev)[None, :] < n_live).float()
         * 0.004).expand(T, cap).contiguous()
    p = ParticleState(x, y, *mom, w)
    ft = FieldState(*((rnd(T, n, n) - 0.5) * 0.2 for _ in range(6)))
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=tile, tile_nx=tile,
              origins=_origins(dev, 2, 2, tile, tile), g=g, dt=0.035,
              dx=0.1, dy=0.1, grid=(2 * tile, 2 * tile))
    return p, ft, kw


@pytest.mark.parametrize("mode,n,win_warps", [
    ("f32", 48, 2), ("f32", 60, 4), ("f32", 72, 8), ("f64", 36, 2),
    ("f64", 48, 4), ("f64", 52, 8)])
def test_float_kernel_with_shared_j_windows_matches_plain(cuda, mode, n,
                                                          win_warps):
    """Windows too wide for a set of J windows per warp: 2, 4 or 8 warps
    share a set (adding with atomics) and the kernel still equals its
    plain version: positions and momenta bit for bit (f32) or within 2
    ulp of each channel's scale (f64), J within 1e-5 (f32) or 1e-12 (f64)
    of its peak."""
    from minipic_torch.ops.advance import window_warps

    assert window_warps(n, n, mode) == win_warps
    p, ft, kw = _wide_inputs(cuda, n)
    if mode == "f64":
        p, ft = _double(p), _double(ft)
    counts = live_watermark(p.w)
    pk, jk, dk = advance_tiles(p, ft, counts, mode=mode, **kw)
    pp, jp, dp = advance_plain(p, ft, counts, mode=mode, **kw)
    torch.cuda.synchronize()
    live = p.w > 0
    for name, a, b in zip("x y px py pz".split(), pk, pp):
        if mode == "f64":
            assert _ulps(a[live], b[live]) <= 2, name
        else:
            assert torch.equal(a[live], b[live]), name
    tol = 1e-12 if mode == "f64" else 1e-5
    for name, a, b in zip(("jx", "jy", "jz"), jk, jp):
        assert bool(b.abs().max() > 0), name
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * float(b.abs().max()))
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0)


def _one_base(p):
    """`p`'s live particles in slab order: the 32 slots of slab k all in
    cell k mod 64 of their tile, a quarter to 0.45 of a cell into it, so
    that each slab's lanes share one 4x4 base (the shuffle trees, plain
    adds into the warp's own windows)."""
    dev = p.x.device
    T, cap = p.x.shape
    s = torch.arange(cap, device=dev)[None, :]
    t = torch.arange(T, device=dev)[:, None]
    cell = (s // 32) % 64
    gen = torch.Generator(device=dev).manual_seed(9)
    fx, fy = (0.25 + 0.2 * torch.rand((T, cap), generator=gen, device=dev)
              for _ in range(2))
    x = (t % 4) * 8 + cell % 8 + fx
    y = (t // 4) * 8 + cell // 8 + fy
    live = p.w > 0
    return p._replace(x=torch.where(live, x.float(), p.x),
                      y=torch.where(live, y.float(), p.y),
                      px=p.px * 0.25, py=p.py * 0.25)


@pytest.mark.parametrize("mode", ["f32", "f64"])
@pytest.mark.parametrize("order", [1, 2])
def test_float_kernel_is_deterministic_in_lattice_order(cuda, order, mode):
    """With a set of J windows per warp and every slab on one base, two
    launches give the same J bit for bit, and the same positions and
    momenta, which equal the plain version's (f32 bit for bit, f64 within
    2 ulp of each channel's scale); J within the bars of its plain
    version."""
    from minipic_torch.ops.advance import window_warps

    assert window_warps(16, 16, mode) == 1
    p, ft = _inputs(cuda)
    p = _one_base(p)
    if mode == "f64":
        p, ft = _double(p), _double(ft)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=8, tile_nx=8,
              origins=_origins(cuda, 4, 4), g=4, dt=0.035, dx=0.1, dy=0.1,
              grid=(32, 32), mode=mode)
    a = advance_tiles(p, ft, counts, **kw)
    b = advance_tiles(p, ft, counts, **kw)
    pp, jp, _ = advance_plain(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for u, v in zip(a[0] + a[1] + (a[2],), b[0] + b[1] + (b[2],)):
        assert torch.equal(u, v)
    live = p.w > 0
    for name, u, v in zip("x y px py pz".split(), a[0], pp):
        if mode == "f64":
            assert _ulps(u[live], v[live]) <= 2, name
        else:
            assert torch.equal(u[live], v[live]), name
    tol = 1e-12 if mode == "f64" else 1e-5
    for u, v in zip(a[1], jp):
        torch.testing.assert_close(u, v, rtol=0,
                                   atol=tol * float(v.abs().max()))


@pytest.mark.parametrize("mode", ["f32", "f64"])
@pytest.mark.parametrize("layout", ["one-base", "lattice", "shuffled",
                                    "edge"])
def test_float_kernel_j_equals_the_warp_window_emulation(cuda, layout,
                                                         mode):
    """With a set of J windows per warp the kernel adds without atomics in
    an order that ``minipic_torch.testing`` transcribes (each base's terms
    summed in lane order, the bases in order, the sets summed in order), so
    its J equals that emulation bit for bit, on lanes' terms computed on
    the card from the
    plain version's particles (which equal the kernel's): one base a slab,
    lattice order at 11 a cell (slabs over three cells, 5-12 bases), random
    slots and window-edge supports."""
    from minipic_torch.testing import (float_deposit_terms, sum_warp_windows,
                                       warp_adds)

    p, ft = _inputs(cuda)
    if layout == "one-base":
        p = _one_base(p)
    elif layout != "shuffled":
        p = _lattice(p, 16 if layout == "edge" else 0)
    if mode == "f64":
        p, ft = _double(p), _double(ft)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
              origins=_origins(cuda, 4, 4), g=4, dt=0.035, dx=0.1, dy=0.1,
              grid=(32, 32), mode=mode)
    pk, jk, _ = advance_tiles(p, ft, counts, **kw)
    pp, _, _ = advance_plain(p, ft, counts, **kw)
    live, row0, col0, v = float_deposit_terms(p, counts, pp, **kw)
    torch.cuda.synchronize()
    n_few = n_many = 0
    for t in range(live.shape[0]):
        adds, a, b = warp_adds(live[t], row0[t], col0[t], v[t],
                               int(counts[t]), 16, 16)
        n_few, n_many = n_few + a, n_many + b
        want = sum_warp_windows(adds, 16, 16, 1, v.dtype)
        for n in range(3):
            assert (jk[n][t].cpu().numpy() == want[n]).all(), (t, n)
    assert (n_few if layout == "one-base" else n_many) > 0
