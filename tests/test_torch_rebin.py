"""The deal-route re-bin (minipic_torch/ops/rebin.py, particles/binning.py)
against the JAX package's interpreted Pallas kernels, slot for slot.

Inputs are stale buckets made with numpy from a seed: 4x4 tiles of 8x8
cells on a 32^2 periodic grid, 3072-slot buckets, live-compacted, the
particles displaced by a Gaussian off their tiles.  That is the geometry
of the 32^2 ppc-40 deck, the smallest headline-shaped deck whose buckets
take the deal route (capacity 3072 >= 8 * 256 + 256).  Every channel of
every slot must be equal, dead slots included (np.testing's equality
takes the JAX kernels' -0.0 -> +0.0 as equal), and so must the counts.

The JAX segment kernel keeps a run's tail only when a whole kc block
still fits (rebin_kernels.py:921-931); the port keeps min(n, b_seg).  The
two agree when b_seg is a multiple of kc, so the JAX side runs with
MINIPIC_SEG_KC set to the run length, and one test pins the difference at
the JAX default.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_tpu.core.geometry import Tiling as JTiling  # noqa: E402
from minipic_tpu.core.state import ParticleState as JP  # noqa: E402
from minipic_tpu.ops.pallas import rebin_kernels as jrk  # noqa: E402
from minipic_tpu.particles import binning as jb  # noqa: E402
from minipic_torch.core import config as tcfg  # noqa: E402
from minipic_torch.core.geometry import Tiling  # noqa: E402
from minipic_torch.core.state import ParticleState  # noqa: E402
from minipic_torch.ops import rebin as rb  # noqa: E402
from minipic_torch.particles.binning import rebin_auto  # noqa: E402
from minipic_torch.simulation import bucket_capacity  # noqa: E402

T, CAP, NX = 16, 3072, 32
GRID = dict(tile_cols=4, tile_ny=8, tile_nx=8)
JGRID = dict(tile_rows=4, **GRID)


def _state(n_live=2560, sigma=0.9, seed=0, holes=0.0):
    """Live-compacted buckets of n_live particles displaced by N(0, sigma)
    cells off their tiles; `holes` of the live slots then get w = 0 with
    their other channels left as they were."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    f32 = np.float32

    def pos(origin):
        v = (origin + rng.random((T, CAP)) * 8
             + rng.normal(0.0, sigma, (T, CAP))).astype(f32)
        v = np.mod(v, f32(NX)).astype(f32)
        return np.where(v >= NX, v - f32(NX), v).astype(f32)

    live = np.broadcast_to(np.arange(CAP)[None, :] < n_live, (T, CAP))
    chans = [pos((t % 4) * 8), pos((t // 4) * 8)]
    chans += [rng.normal(0.0, 0.1, (T, CAP)).astype(f32) for _ in range(3)]
    chans.append(np.full((T, CAP), 0.004, f32))
    chans = [np.where(live, c, f32(0)) for c in chans]
    if holes:
        chans[5] = np.where(rng.random((T, CAP)) < holes, f32(0), chans[5])
    return chans


def _both(chans):
    return (JP(*(jnp.asarray(c) for c in chans)),
            ParticleState(*(torch.tensor(c) for c in chans)))


def _eq(j, t, what):
    for name, a, b in zip(ParticleState._fields, j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{what}.{name}")


def _eq_counts(j, t, what):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=what)


def test_small_deck_meets_the_deal_route_gate():
    deck = tcfg.Deck(
        box_x=3.2, box_y=3.2, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=4,
        species=(tcfg.SpeciesSpec("ele", -1.0, 1.0, ppc=40, uth=0.1,
                                  ux=0.05, shape_order=2),),
        capacity_headroom=1.1, kchunk=0, deposit="int8")
    cap = bucket_capacity(deck)
    mc = deck.mover_cap(cap)
    sc = deck.mover_seg_cap(mc)
    assert (cap, mc, sc) == (CAP, 512, 256)
    assert cap >= 8 * sc + 256


@pytest.mark.parametrize("case", ["normal", "pending", "forced", "holes"])
def test_split_matches_jax(case):
    chans = _state(sigma=1.2 if case in ("pending", "forced") else 0.9,
                   holes=0.25 if case == "holes" else 0.0, seed=1)
    jp, tp = _both(chans)
    force = case == "forced"
    j = jrk.split_buckets(jp, **JGRID, b_cap=512, interpret=True,
                          force=force)
    t = rb.split_buckets_plain(tp, **GRID, b_cap=512, force=force)
    _eq(j[0], t[0], "buckets")
    _eq(j[1], t[1], "movers")
    _eq_counts(j[2], t[2], "stay counts")
    _eq_counts(j[3], t[3], "pending")
    n_pend = int(t[3].sum())
    assert (n_pend > 0) == (case in ("pending", "forced"))
    assert int((t[1].w > 0).sum()) > 0 or case == "pending"


def _movers(sigma=0.9):
    _, tp = _both(_state(sigma=sigma, seed=2))
    return rb.split_buckets_plain(tp, **GRID, b_cap=1024)


@pytest.mark.parametrize("case", ["kill", "overflow"])
def test_segment_matches_jax(case, monkeypatch):
    """A mover of tile 5 (row 1, col 1) moved to column 3, two tiles from
    home, is killed and counted; runs of 128 overflow and count."""
    b_seg = 256 if case == "kill" else 128
    monkeypatch.setenv("MINIPIC_SEG_KC", str(b_seg))
    _, movers, _, _ = _movers(sigma=0.9 if case == "kill" else 1.2)
    if case == "kill":
        x, y = movers.x.clone(), movers.y.clone()
        x[5, 0], y[5, 0] = 28.5, 12.0
        movers = movers._replace(x=x, y=y)
    jm = JP(*(jnp.asarray(a.numpy()) for a in movers))
    js, jd = jrk.segment_movers(jm, **JGRID, b_seg=b_seg, interpret=True)
    ts, td = rb.segment_movers_plain(movers, tile_rows=4, **GRID,
                                     b_seg=b_seg)
    _eq(js, ts, "segments")
    _eq_counts(jd, td, "dropped")
    if case == "kill":
        assert int(td[5]) == 1 and int(td.sum()) == 1
    else:
        assert int(td.sum()) > 0


def test_segment_tail_rule_differs_from_jax_by_design():
    """600 movers east at runs of 768: JAX's kc=512 tail rule keeps 512 and
    drops 88; the port keeps all 600."""
    rng = np.random.default_rng(3)
    mc, n, b_seg = 1024, 600, 768
    chans = [np.zeros((T, mc), np.float32) for _ in range(6)]
    # Tile 5 is row 1, column 1; east is column 2.
    chans[0][5, :n] = 16.0 + rng.random(n).astype(np.float32) * 8
    chans[1][5, :n] = 8.0 + rng.random(n).astype(np.float32) * 8
    chans[5][5, :n] = 0.004
    jm, tm = JP(*(jnp.asarray(c) for c in chans)), ParticleState(
        *(torch.tensor(c) for c in chans))
    js, jd = jrk.segment_movers(jm, **JGRID, b_seg=b_seg, interpret=True)
    ts, td = rb.segment_movers_plain(tm, tile_rows=4, **GRID, b_seg=b_seg)
    east = rb.DIR_OFFSETS.index((0, 1))
    run = slice(east * b_seg, (east + 1) * b_seg)
    assert int(np.sum(np.asarray(js.w)[5, run] > 0)) == 512
    assert int(jd[5]) == 88
    assert int((ts.w[5, run] > 0).sum()) == 600 and int(td[5]) == 0
    # The first 512 agree slot for slot; the port has the other 88 after.
    np.testing.assert_array_equal(np.asarray(js.x)[5, run][:512],
                                  ts.x[5, run][:512].numpy())
    np.testing.assert_array_equal(ts.x[5, run][512:600].numpy(),
                                  chans[0][5, 512:600])


def _split_and_segment(monkeypatch, sigma, b_cap=1024, b_seg=256, seed=4):
    monkeypatch.setenv("MINIPIC_SEG_KC", str(b_seg))
    jp, tp = _both(_state(sigma=sigma, seed=seed))
    j1, jm, jwm, _ = jrk.split_buckets(jp, **JGRID, b_cap=b_cap,
                                       interpret=True)
    t1, tm, twm, _ = rb.split_buckets_plain(tp, **GRID, b_cap=b_cap)
    js, _ = jrk.segment_movers(jm, **JGRID, b_seg=b_seg, interpret=True,
                               packed=True)
    ts, _ = rb.segment_movers_plain(tm, tile_rows=4, **GRID, b_seg=b_seg)
    return (jp, j1, js, jwm), (tp, t1, ts, twm)


def test_neighbor_table_and_arrival_counts_match_jax(monkeypatch):
    (_, _, js, _), (_, _, ts, _) = _split_and_segment(monkeypatch, 0.9)
    jt = JTiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
    jn = jb._seg_neighbor_table(jt)
    tn = rb.seg_neighbor_table(4, 4, torch.device("cpu"))
    _eq_counts(jn, tn, "nbr")
    _eq_counts(jb._seg_arrival_counts(js, jn, 256),
               rb.seg_arrival_counts(ts, tn, 256), "arrivals")
    _eq(jb._roll_segments(jrk.unpack_segments(js), jt, 256),
        rb.roll_segments(ts, tn, 256), "rolled")


def test_append_matches_jax(monkeypatch):
    (_, j1, js, jwm), (_, t1, ts, twm) = _split_and_segment(monkeypatch,
                                                            0.9)
    jt = JTiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
    ja, jd = jrk.append_segments(j1, js, jwm, jb._seg_neighbor_table(jt),
                                 b_seg=256, interpret=True)
    ta, td = rb.append_segments_plain(
        t1, ts, twm, rb.seg_neighbor_table(4, 4, torch.device("cpu")),
        b_seg=256)
    _eq(ja, ta, "buckets")
    _eq_counts(jd, td, "dropped")
    assert int(td.sum()) == 0


@pytest.mark.parametrize("case", ["alone", "incoming", "overflow"])
def test_defrag_matches_jax(case, monkeypatch):
    """Hole-ridden buckets alone; the split buckets merged with their
    arrivals; the unsplit buckets merged with 1.2-sigma arrivals (census
    over capacity)."""
    jt = JTiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
    tn = rb.seg_neighbor_table(4, 4, torch.device("cpu"))
    if case == "alone":
        jp, tp = _both(_state(holes=0.3, seed=5))
        ji, ti = None, None
    else:
        (jp0, j1, js, _), (tp0, t1, ts, _) = _split_and_segment(
            monkeypatch, 1.2 if case == "overflow" else 0.9)
        jp, tp = (jp0, tp0) if case == "overflow" else (j1, t1)
        ji = jb._roll_segments(jrk.unpack_segments(js), jt, 256)
        ti = rb.roll_segments(ts, tn, 256)
    j = jrk.defrag_buckets(jp, ji, interpret=True)
    t = rb.defrag_buckets_plain(tp, ti)
    _eq(j[0], t[0], "buckets")
    _eq_counts(j[1], t[1], "counts")
    _eq_counts(j[2], t[2], "dropped")
    assert (int(t[2].sum()) > 0) == (case == "overflow")


@pytest.mark.parametrize("branch", ["append", "defrag"])
def test_rebin_auto_matches_jax(branch, monkeypatch):
    """The whole deal route on the ppc-40 deck's buckets.  2816 live per
    bucket leaves some bucket within 256 slots of capacity after the
    arrivals, so JAX's cond and the port's device flag take the defrag."""
    monkeypatch.setenv("MINIPIC_SEG_KC", "256")
    mc, sc = 512, 256
    assert CAP >= 8 * sc + 256
    jp, tp = _both(_state(n_live=2560 if branch == "append" else 2816,
                          sigma=0.9, seed=6))
    jt = JTiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
    tt = Tiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
    j, jd, jpend = jb.rebin_auto(jp, jt, mc, interpret=True, seg_cap=sc)
    t, td, tpend = rebin_auto(tp, tt, mc, seg_cap=sc)
    _eq(j, t, "buckets")
    assert int(jd) == int(td) and int(jpend) == int(tpend)
    # Which branch ran: the split's stay counts plus arrivals against the
    # 256-slot headroom, as rebin_auto decides.
    _, _, wm, _ = rb.split_buckets_plain(tp, **GRID, b_cap=mc)
    seg, _ = rb.segment_movers_plain(
        rb.split_buckets_plain(tp, **GRID, b_cap=mc)[1], tile_rows=4,
        **GRID, b_seg=sc)
    n_in = rb.seg_arrival_counts(seg, rb.seg_neighbor_table(
        4, 4, torch.device("cpu")), sc)
    ok = bool((wm + n_in <= CAP - 256).all())
    assert ok == (branch == "append")


def test_rebin_auto_force_turns_pending_into_drops():
    """A buffer too small for the tiles' movers defers them (pending) and
    keeps every particle; forced, the overflow is dropped and counted."""
    _, tp = _both(_state(sigma=1.2, seed=7))
    tt = Tiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
    n0 = int((tp.w > 0).sum())
    for force in (False, torch.tensor(False)):
        p, dropped, pending = rebin_auto(tp, tt, 512, seg_cap=256,
                                         force=force)
        assert int(dropped) == 0 and int(pending) > 0
        assert int((p.w > 0).sum()) == n0
    for force in (True, torch.tensor(True)):
        p, dropped, pending = rebin_auto(tp, tt, 512, seg_cap=256,
                                         force=force)
        assert int(pending) == 0 and int(dropped) > 0
        assert int((p.w > 0).sum()) + int(dropped) == n0


def test_rebin_wrappers_check_inputs_before_building():
    """The CUDA launchers validate dtype, shape and layout before they
    build or launch anything; a tensor on no supported device raises."""
    _, tp = _both(_state())
    seg = ParticleState(*(torch.zeros(T, 8 * 128) for _ in range(6)))
    nbr = rb.seg_neighbor_table(4, 4, torch.device("cpu"))
    wm = torch.zeros(T, dtype=torch.int32)
    n0 = {k: v.launches for k, v in rb.KERNELS.items()}
    bad = [
        lambda: rb.split_kernel(tp._replace(x=tp.x.double()), **GRID,
                                b_cap=512),
        lambda: rb.split_kernel(tp._replace(y=tp.y.t().contiguous().t()),
                                **GRID, b_cap=512),
        lambda: rb.split_kernel(tp, **GRID, b_cap=512,
                                force=torch.tensor(1)),
        lambda: rb.segment_kernel(tp, tile_rows=3, **GRID, b_seg=128),
        lambda: rb.append_kernel(tp, seg, wm.long(), nbr, b_seg=128),
        lambda: rb.append_kernel(tp, seg._replace(w=seg.w[:, :-1]), wm, nbr,
                                 b_seg=128),
        lambda: rb.defrag_kernel(tp, seg, nbr.long(), b_seg=128),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert {k: v.launches for k, v in rb.KERNELS.items()} == n0
    meta = ParticleState(*(a.to("meta") for a in tp))
    with pytest.raises(ValueError, match="no split"):
        rb.split_buckets(meta, **GRID, b_cap=512)
