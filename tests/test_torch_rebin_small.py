"""The small-bucket re-bin and the last three re-bin kernels
(append_incoming, append_runs, extract) against the JAX package's
interpreted Pallas kernels, slot for slot.

Inputs are stale buckets made with numpy from a seed, as in
test_torch_rebin.py: 4x4 tiles of 8x8 cells on a 32^2 periodic grid,
live-compacted, the particles displaced by a Gaussian off their tiles.
The small-bucket buckets hold 1536 slots (the physics decks' size), under
the deal route's 8 * 256 + 256, so ``rebin_auto`` routes the movers by the
sort and appends them with append_incoming, as JAX does.  Every channel of
every slot must be equal, dead slots included, and so must the counts.

Two differences are pinned by their own tests: the appends take a tile
that fits its bucket (JAX keeps 128 slots of slack), and the extract keeps
min(movers, b_cap) where JAX's kc-block flush keeps (b_cap // kc) * kc.
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
from minipic_torch.core.geometry import Tiling  # noqa: E402
from minipic_torch.core.state import ParticleState  # noqa: E402
from minipic_torch.ops import rebin as rb  # noqa: E402
from minipic_torch.particles import binning as tb  # noqa: E402

T, NX = 16, 32
GRID = dict(tile_cols=4, tile_ny=8, tile_nx=8)
JGRID = dict(tile_rows=4, **GRID)
JT = JTiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
TT = Tiling(tile_rows=4, tile_cols=4, tile_nx=8, tile_ny=8)
CPU = torch.device("cpu")


def _state(cap=1536, n_live=1000, sigma=0.9, seed=0, holes=0.0):
    """Live-compacted buckets of n_live particles displaced by N(0, sigma)
    cells off their tiles; `holes` of the live slots then get w = 0 with
    their other channels left as they were."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    f32 = np.float32

    def pos(origin):
        v = (origin + rng.random((T, cap)) * 8
             + rng.normal(0.0, sigma, (T, cap))).astype(f32)
        v = np.mod(v, f32(NX)).astype(f32)
        return np.where(v >= NX, v - f32(NX), v).astype(f32)

    live = np.broadcast_to(np.arange(cap)[None, :] < n_live, (T, cap))
    chans = [pos((t % 4) * 8), pos((t // 4) * 8)]
    chans += [rng.normal(0.0, 0.1, (T, cap)).astype(f32) for _ in range(3)]
    chans.append(np.full((T, cap), 0.004, f32))
    chans = [np.where(live, c, f32(0)) for c in chans]
    if holes:
        chans[5] = np.where(rng.random((T, cap)) < holes, f32(0), chans[5])
    return chans


def _both(chans):
    return (JP(*(jnp.asarray(c) for c in chans)),
            ParticleState(*(torch.tensor(c) for c in chans)))


def _eq(j, t, what):
    for name, a, b in zip(ParticleState._fields, j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{what}.{name}")


def _eq_counts(j, t, what):
    np.testing.assert_array_equal(np.asarray(j), np.asarray(t), err_msg=what)


def _split_and_route(chans, mc=512):
    jp, tp = _both(chans)
    j1, jm, jwm, _ = jrk.split_buckets(jp, **JGRID, b_cap=mc, interpret=True)
    t1, tm, twm, _ = rb.split_buckets_plain(tp, **GRID, b_cap=mc)
    ji, jd = jb._route(jm, jp, JT, mc)
    ti, td = tb.route_movers(tm, TT, mc)
    return (j1, ji, jwm, jd), (t1, ti, twm, td)


def test_route_matches_jax():
    """The movers' sort route: incoming rows slot for slot, dead slots
    (zero) included, and the same overflow count."""
    (_, ji, _, jd), (_, ti, _, td) = _split_and_route(_state(seed=1))
    _eq(ji, ti, "incoming")
    assert int(jd) == int(td) == 0
    assert int((ti.w > 0).sum()) > 0


@pytest.mark.parametrize("crowd", [False, True])
def test_append_incoming_matches_jax(crowd):
    """The split's buckets plus their routed arrivals; crowded: the odd
    tiles' watermarks raised so that their arrivals overrun the bucket by 5
    slots and are dropped (outside the pinned cap - 128 .. cap window)."""
    (j1, ji, jwm, _), (t1, ti, twm, _) = _split_and_route(_state(seed=2))
    if crowd:
        n_in = (ti.w > 0).sum(1, dtype=torch.int32)
        odd = torch.arange(T) % 2 == 1
        twm = torch.where(odd, t1.capacity - n_in + 5, twm).to(torch.int32)
        jwm = jnp.asarray(twm.numpy())
    ja, jd = jrk.append_incoming(j1, ji, jwm, interpret=True)
    ta, td = rb.append_incoming_plain(t1, ti, twm)
    _eq(ja, ta, "buckets")
    _eq_counts(jd, td, "dropped")
    assert (int(td.sum()) > 0) == crowd


def test_append_rule_differs_from_jax_by_design():
    """A tile with cap - 128 < wm + n_in <= cap: the port appends it, JAX's
    append_incoming (128 slots of slab slack) drops and counts it."""
    (j1, ji, jwm, _), (t1, ti, twm, _) = _split_and_route(_state(seed=3))
    cap = t1.capacity
    n_in = (ti.w > 0).sum(1, dtype=torch.int32)
    wm = (cap - 64 - n_in).to(torch.int32)  # wm + n_in = cap - 64
    ja, jd = jrk.append_incoming(j1, ji, jnp.asarray(wm.numpy()),
                                 interpret=True)
    ta, td = rb.append_incoming_plain(t1, ti, wm)
    np.testing.assert_array_equal(np.asarray(jd), n_in.numpy())
    assert int(td.sum()) == 0
    _eq(j1, ParticleState(*(torch.tensor(np.asarray(a)) for a in ja)),
        "JAX leaves the buckets")
    rows = torch.arange(T)[:, None]
    k = torch.arange(cap)[None, :] - wm[:, None]
    sel = (k >= 0) & (k < n_in[:, None])
    src = ti.x[rows.expand(T, cap), k.clamp(0, ti.x.shape[1] - 1)]
    assert torch.equal(ta.x[sel], src[sel])
    assert torch.equal(ta.x[~sel], t1.x[~sel])


def test_append_runs_matches_jax(monkeypatch):
    """The unfused deal route's append: the rolled runs of each tile's own
    row, at 3072-slot buckets (the deal route's gate)."""
    monkeypatch.setenv("MINIPIC_SEG_KC", "256")
    jp, tp = _both(_state(cap=3072, n_live=2560, seed=4))
    j1, jm, jwm, _ = jrk.split_buckets(jp, **JGRID, b_cap=1024,
                                       interpret=True)
    t1, tm, twm, _ = rb.split_buckets_plain(tp, **GRID, b_cap=1024)
    js, _ = jrk.segment_movers(jm, **JGRID, b_seg=256, interpret=True,
                               packed=True)
    ts, _ = rb.segment_movers_plain(tm, tile_rows=4, **GRID, b_seg=256)
    ji = jb._roll_segments(jrk.unpack_segments(js), JT, 256)
    nbr = rb.seg_neighbor_table(4, 4, CPU)
    ti = rb.roll_segments(ts, nbr, 256)
    ja, jd = jrk.append_runs(j1, ji, jwm, b_seg=256, interpret=True)
    ta, td = rb.append_runs_plain(t1, ti, twm, b_seg=256)
    _eq(ja, ta, "buckets")
    _eq_counts(jd, td, "dropped")
    # The fused append is the same function.
    tf, tfd = rb.append_segments_plain(t1, ts, twm, nbr, b_seg=256)
    _eq(ta, tf, "fused")
    assert torch.equal(td, tfd) and int(td.sum()) == 0


@pytest.mark.parametrize("case", ["normal", "pending", "forced", "holes"])
def test_extract_matches_jax(case):
    chans = _state(n_live=1400, sigma=2.0 if case in ("pending", "forced")
                   else 0.9, holes=0.25 if case == "holes" else 0.0,
                   seed=5)
    jp, tp = _both(chans)
    force = case == "forced"
    j = jrk.extract_movers(jp, **JGRID, b_cap=512, interpret=True,
                           force=force)
    t = rb.extract_movers_plain(tp, **GRID, b_cap=512, force=force)
    _eq(j[0], t[0], "buckets")
    _eq(j[1], t[1], "movers")
    _eq_counts(j[2], t[2], "watermarks")
    _eq_counts(j[3], t[3], "pending")
    n_pend = int(t[3].sum())
    assert (n_pend > 0) == (case in ("pending", "forced"))
    # Only w changed, and only of movers.
    for a, b in zip(t[0][:5], tp[:5]):
        assert a is b
    assert int((t[1].w > 0).sum()) > 0 or case == "pending"


def test_extract_tail_differs_from_jax_by_design():
    """A forced tile of 600 movers with a 640-slot buffer (kc 256): JAX's
    whole-block flush keeps 512 and counts 88; the port keeps 600."""
    rng = np.random.default_rng(6)
    cap, n = 1536, 600
    chans = [np.zeros((T, cap), np.float32) for _ in range(6)]
    # Tile 5 is row 1, column 1: its particles sit in column 2.
    chans[0][5, :n] = 16.0 + rng.random(n).astype(np.float32) * 8
    chans[1][5, :n] = 8.0 + rng.random(n).astype(np.float32) * 8
    chans[2][5, :n] = rng.random(n).astype(np.float32)
    chans[5][5, :n] = 0.004
    jp, tp = _both(chans)
    j = jrk.extract_movers(jp, **JGRID, b_cap=640, interpret=True,
                           force=True)
    t = rb.extract_movers_plain(tp, **GRID, b_cap=640, force=True)
    assert int(np.sum(np.asarray(j[1].w)[5] > 0)) == 512
    assert int(j[3][5]) == 88
    assert int((t[1].w[5] > 0).sum()) == 600 and int(t[3][5]) == 0
    np.testing.assert_array_equal(np.asarray(j[1].px)[5, :512],
                                  t[1].px[5, :512].numpy())
    np.testing.assert_array_equal(t[1].px[5, :600].numpy(),
                                  chans[2][5, :600])
    # Unforced, both defer the tile: 600 > (640 // 256) * 256.
    t = rb.extract_movers_plain(tp, **GRID, b_cap=640)
    assert int(t[3][5]) == 600 and int((t[1].w > 0).sum()) == 0


@pytest.mark.parametrize("branch", ["append", "defrag"])
def test_small_bucket_rebin_auto_matches_jax(branch):
    """The whole small-bucket branch (split, route, append_incoming or the
    defrag with the dense incoming slab): 1400 live per bucket leaves some
    bucket within 256 slots of capacity after the arrivals."""
    mc, sc = 512, 256
    jp, tp = _both(_state(n_live=1000 if branch == "append" else 1400,
                          seed=7))
    assert tp.capacity < 8 * sc + 256
    j, jd, jpend = jb.rebin_auto(jp, JT, mc, interpret=True, seg_cap=sc)
    t, td, tpend = tb.rebin_auto(tp, TT, mc, seg_cap=sc)
    _eq(j, t, "buckets")
    assert int(jd) == int(td) and int(jpend) == int(tpend)
    _, (_, ti, twm, _) = _split_and_route(_state(
        n_live=1000 if branch == "append" else 1400, seed=7))
    n_in = (ti.w > 0).sum(1, dtype=torch.int32)
    ok = bool((twm + n_in <= tp.capacity - 256).all())
    assert ok == (branch == "append")


def test_dense_defrag_matches_jax():
    """The defrag merging one dense incoming row per tile, crowded past
    capacity so that the census overflow is counted."""
    (j1, ji, _, _), (t1, ti, _, _) = _split_and_route(
        _state(n_live=1500, seed=8))
    jp, tp = _both(_state(n_live=1500, seed=8))
    j = jrk.defrag_buckets(jp, ji, interpret=True)
    t = rb.defrag_buckets_plain(tp, ti)
    _eq(j[0], t[0], "buckets")
    _eq_counts(j[1], t[1], "counts")
    _eq_counts(j[2], t[2], "dropped")
    assert int(t[2].sum()) > 0
    # The in-place wrapper's dense form is the same function.
    q = ParticleState(*(a.clone() for a in tp))
    c, d = rb.defrag_buckets_(q, ti)
    _eq(t[0], q, "in place")
    assert torch.equal(c, t[1]) and torch.equal(d, t[2])


def test_unfused_rebin_auto_matches_jax(monkeypatch):
    """rebin_auto(fused=False) (roll, then append_runs) against JAX with
    MINIPIC_APPEND_FUSED=0, and equal to the fused route."""
    monkeypatch.setenv("MINIPIC_SEG_KC", "256")
    monkeypatch.setenv("MINIPIC_APPEND_FUSED", "0")
    jp, tp = _both(_state(cap=3072, n_live=2560, seed=9))
    j, jd, jpend = jb.rebin_auto(jp, JT, 512, interpret=True, seg_cap=256)
    t, td, tpend = tb.rebin_auto(tp, TT, 512, seg_cap=256, fused=False)
    _eq(j, t, "buckets")
    assert int(jd) == int(td) and int(jpend) == int(tpend)
    f, fd, fpend = tb.rebin_auto(tp, TT, 512, seg_cap=256)
    _eq(t, f, "fused")
    assert int(fd) == int(td) and int(fpend) == int(tpend)


@pytest.mark.parametrize("holes", [0.0, 0.3])
def test_rebin_incremental_matches_jax(holes):
    chans = _state(n_live=1000, holes=holes, seed=10)
    jp, tp = _both(chans)
    j, jd, jwm = jb.rebin_incremental(jp, JT, mover_cap=512, interpret=True)
    t, td, twm = tb.rebin_incremental(tp, TT, 512)
    _eq(j, t, "buckets")
    assert int(jd) == int(td) == 0
    assert int(jwm) == int(twm)
    assert int((t.w > 0).sum()) == int((np.asarray(chans[5]) > 0).sum())


def test_new_wrappers_check_inputs_before_building():
    """The new launchers validate their inputs before they build or launch
    anything."""
    _, tp = _both(_state())
    inc = ParticleState(*(torch.zeros(T, 512) for _ in range(6)))
    wm = torch.zeros(T, dtype=torch.int32)
    n0 = {k: v.launches for k, v in rb.KERNELS.items()}
    bad = [
        lambda: rb.append_incoming_kernel(tp, inc, wm.long()),
        lambda: rb.append_incoming_kernel(tp, inc._replace(w=inc.w[:8]), wm),
        lambda: rb.append_runs_kernel(tp, inc, wm, b_seg=384),
        lambda: rb.extract_kernel(tp._replace(x=tp.x.double()), **GRID,
                                  b_cap=512),
        lambda: rb.extract_kernel(tp, tile_cols=3, tile_ny=8, tile_nx=8,
                                  b_cap=512),
        lambda: rb.defrag_kernel(tp, inc._replace(x=inc.x.double())),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert {k: v.launches for k, v in rb.KERNELS.items()} == n0
    meta = ParticleState(*(a.to("meta") for a in tp))
    with pytest.raises(ValueError, match="no extract"):
        rb.extract_movers(meta, **GRID, b_cap=512)
    with pytest.raises(ValueError, match="no append_incoming"):
        rb.append_incoming_(meta, inc, wm)
