"""The port's advance (plain torch version of csrc/advance.cu) against the
JAX package's fused Pallas kernel, run in interpret mode, on the same
particles and fields."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from minipic_tpu.core.config import Deck, SpeciesSpec  # noqa: E402
from minipic_tpu.fields import init as finit  # noqa: E402
from minipic_tpu.fields.halo import pad_fields_periodic  # noqa: E402
from minipic_tpu.fields.tiles import extract_field_tiles  # noqa: E402
from minipic_tpu.particles.deposit import deposit_rho_chunk  # noqa: E402
from minipic_tpu.particles.species import load_species  # noqa: E402
from minipic_tpu.simulation import (  # noqa: E402
    _tile_origins, advance_species_tiles, tile_local_coords)
from minipic_torch.core.geometry import Tiling  # noqa: E402
from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.ops.advance import (  # noqa: E402
    advance_plain, advance_tiles, fused_push_deposit, live_watermark,
    qshape_scale, resolve_mode)
from minipic_torch.simulation import tile_origins  # noqa: E402
from minipic_torch.testing import push_out_through_walls  # noqa: E402

# Tile origins of the 32^2 fixtures' 4x4 grid of 8x8 tiles.
ORIGINS = tile_origins(Tiling(tile_rows=4, tile_cols=4, tile_ny=8,
                              tile_nx=8), "cpu")


def _fixture(order=1, ppc=4, kchunk=32, guard=2):
    """The sizes of tests/test_pallas_kernel.py::_fixture: 32^2 grid, 8x8
    tiles, a drifting thermal species and an oblique wave."""
    deck = Deck(
        box_x=4.0, box_y=4.0, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=guard,
        species=(SpeciesSpec("e", -1.0, 1.0, ppc=ppc, ux=0.2, uth=0.1,
                             shape_order=order),),
        precision="f32", kchunk=kchunk,
    )
    tiling = deck.tiling
    cap = deck.capacity()
    q = kchunk if kchunk > 0 else 128
    if cap % q:
        cap = -(-cap // q) * q
    p = load_species(deck.species[0], deck.domain, tiling, cap,
                     jax.random.PRNGKey(3), jnp.float32)
    f = finit.oblique_wave(deck.domain, amplitude=0.3, dtype=jnp.float32)
    ftiles = extract_field_tiles(
        pad_fields_periodic(f, deck.guard), tiling.tile_rows,
        tiling.tile_cols, tiling.tile_ny, tiling.tile_nx, deck.guard)
    return deck, tiling, p, ftiles


def _torch(nt, cls):
    return cls(*(torch.from_numpy(np.array(a)) for a in nt))


def _jax_advance(deck, tiling, p, ftiles, mode):
    qw0 = -deck.dx * deck.dy / deck.species[0].ppc
    return advance_species_tiles(
        p, ftiles, qm=-1.0, q=-1.0, order=deck.species[0].shape_order,
        tile_ny=tiling.tile_ny, tile_nx=tiling.tile_nx,
        origins=_tile_origins(tiling, jnp.float32), g=deck.guard, dt=deck.dt,
        dx=deck.dx, dy=deck.dy, kchunk=deck.kchunk, backend="pallas",
        interpret=True, deposit_mode="highest" if mode == "f32" else "int8",
        qw0=qw0, wrap=(deck.nx, deck.ny), grid=(deck.nx, deck.ny),
        return_disp=True)


def _port_advance(deck, tiling, pt, ft, mode):
    return fused_push_deposit(
        pt, ft, qm=-1.0, q=-1.0,
        order=deck.species[0].shape_order, tile_ny=tiling.tile_ny,
        tile_nx=tiling.tile_nx, origins=tile_origins(tiling, "cpu"),
        g=deck.guard,
        dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(deck.nx, deck.ny),
        mode=mode)


@pytest.mark.parametrize("kchunk", [32, 0])
@pytest.mark.parametrize("guard", [2, 4])
@pytest.mark.parametrize("deposit", ["f32", "int8"])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_advance_matches_pallas_interpret(order, deposit, guard, kchunk):
    deck, tiling, p, ftiles = _fixture(order=order, guard=guard,
                                       kchunk=kchunk)
    # The port resolves the mode as the JAX wrapper does: guard 2 (12x12
    # windows) is outside the int8 window rule, so both sides run f32.
    qw0 = -deck.dx * deck.dy / deck.species[0].ppc
    mode = resolve_mode("highest" if deposit == "f32" else "int8", qw0,
                        tiling.tile_ny, tiling.tile_nx, deck.guard)
    assert mode == ("int8" if deposit == "int8" and guard == 4 else "f32")
    pj, jj, dj = _jax_advance(deck, tiling, p, ftiles, deposit)
    pt, jt, dt_ = _port_advance(deck, tiling, _torch(p, ParticleState),
                                _torch(ftiles, FieldState), mode)

    alive = np.asarray(p.w) > 0
    for name in ("x", "y", "px", "py", "pz"):
        a = np.where(alive, np.asarray(getattr(pj, name)), 0)
        b = np.where(alive, getattr(pt, name).numpy(), 0)
        # Same tolerance as the Pallas-vs-XLA test (test_pallas_kernel.py):
        # f32 sums over the support in another order.
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-6, err_msg=name)
    # J relative to the window's peak.  int8: jx/jy are exact integer sums
    # and jz an f32 sum in another order -> 3e-6 (test_pallas_kernel.py).
    # f32: positions agree only to 1 ulp (2e-6 cells at |x| < 32), which
    # moves each raw Esirkepov term by ~1e-6 before the prefix sums; JAX's
    # own kernel is 1.5e-5 of the peak from an f64 evaluation of the same
    # deposit, and the two agree to <9e-6 -> 2e-5.
    jtol = 3e-6 if mode == "int8" else 2e-5
    for name, a, b in zip(("jx", "jy", "jz"), jj, jt):
        a = np.asarray(a)
        scale = max(1e-12, float(np.abs(a).max()))
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=jtol * scale,
                                   err_msg=name)
    # dmax: one f32 subtraction of positions that agree to ~1 ulp.  JAX's
    # kernel folds its displacement watermark over 128-lane blocks, so for
    # chunks under 128 slots (kchunk=32) it returns 0; hold the port against
    # the displacement of JAX's own output positions (nearest image) there.
    nx = float(deck.nx)
    d = [np.abs(np.asarray(getattr(pj, n), np.float64)
                - np.asarray(getattr(p, n), np.float64)) for n in ("x", "y")]
    d = [np.minimum(v, nx - v) for v in d]
    ref = float(np.where(alive, np.maximum(*d), 0.0).max())
    np.testing.assert_allclose(float(dt_), ref, rtol=1e-5)
    if kchunk == 0:
        np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)


@pytest.mark.parametrize("order", [1, 2])
def test_int8_continuity_and_amplitude(order):
    """Port of test_pallas_kernel.py::test_int8_deposit_continuity_and_
    amplitude on the plain version: div J = -d rho/dt against rho built from
    the same quantized shapes, and the net flux matches f32 after a uniform
    weight rescale (q*max(w) is read from the state)."""
    deck, tiling, p, ftiles = _fixture(order=order, guard=4, kchunk=0)
    p = p._replace(w=p.w * 0.5)
    S = qshape_scale(order)
    origins = _tile_origins(tiling, jnp.float32)
    pt = _torch(p, ParticleState)
    ft = _torch(ftiles, FieldState)

    def rho_of(q):
        xi, eta = tile_local_coords(q.x, q.y, origins, tiling.tile_nx,
                                    tiling.tile_ny, (deck.nx, deck.ny))
        return np.asarray(deposit_rho_chunk(
            xi, eta, q.w * -1.0, tiling.tile_ny, tiling.tile_nx, deck.guard,
            order, deck.dx, deck.dy, quantize=S))

    p8, (jx8, jy8, jz8), _ = _port_advance(deck, tiling, pt, ft, "int8")
    rho0 = rho_of(p)
    rho1 = rho_of(ParticleState(*(jnp.asarray(a.numpy()) for a in p8)))
    jx8, jy8 = jx8.numpy(), jy8.numpy()
    divx = np.diff(jx8, axis=2, prepend=0.0) / deck.dx
    divy = np.diff(jy8, axis=1, prepend=0.0) / deck.dy
    res = (rho1 - rho0) / deck.dt + divx + divy
    scale = float(np.abs(rho0).max()) / deck.dt
    # Exact in the integer ring; what remains is f32 conversion round-off.
    assert float(np.abs(res).max()) < 3e-6 * scale

    _, (jxh, _, jzh), _ = _port_advance(deck, tiling, pt, ft, "f32")
    sx8, sxh = float(jx8.sum()), float(jxh.sum())
    # int8 shapes are f32 shapes rounded to 1/S: the net flux moves by <2%.
    assert abs(sx8 - sxh) < 0.02 * abs(sxh), (sx8, sxh)
    jzh = jzh.numpy()
    assert float(np.abs(jz8.numpy() - jzh).max()) < 0.05 * max(
        1e-12, float(np.abs(jzh).max()))


def test_dead_slots_pass_through_and_wrapper_routes_cpu_to_plain():
    deck, tiling, p, ftiles = _fixture(order=2, guard=4, kchunk=0)
    pt = _torch(p, ParticleState)
    ft = _torch(ftiles, FieldState)
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, origins=ORIGINS,
              g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(32, 32),
              mode="int8")
    a = advance_tiles(pt, ft, counts, **kw)
    b = advance_plain(pt, ft, counts, **kw)
    for u, v in zip(a[0] + a[1] + (a[2],), b[0] + b[1] + (b[2],)):
        assert torch.equal(u, v)
    dead = pt.w == 0
    assert dead.any()
    for new, old in zip(a[0], pt[:5]):
        assert torch.equal(new[dead], old[dead])


def test_plain_blocks_of_tiles_match_one_pass(monkeypatch):
    """advance_plain works through blocks of tiles; blocks of 3 tiles, which
    straddle tile rows, give what one pass over all 16 tiles gives."""
    import minipic_torch.ops.advance as adv

    deck, tiling, p, ftiles = _fixture(order=2, guard=4, kchunk=0)
    pt = _torch(p, ParticleState)
    ft = _torch(ftiles, FieldState)
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, origins=ORIGINS,
              g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(32, 32),
              mode="int8")
    whole = advance_plain(pt, ft, counts, **kw)
    monkeypatch.setattr(adv, "_PLAIN_BLOCK_SLOTS", 3 * pt.capacity)
    blocks = advance_plain(pt, ft, counts, **kw)
    for u, v in zip(whole[0] + whole[1] + (whole[2],),
                    blocks[0] + blocks[1] + (blocks[2],)):
        assert u.shape == v.shape
        assert torch.equal(u, v)


def test_kernel_wrapper_checks_inputs_before_building():
    """The CUDA wrapper validates dtype, shape, layout and mode before it
    builds or launches anything; a tensor on no supported device raises."""
    from minipic_torch.ops.advance import advance_kernel

    deck, tiling, p, ftiles = _fixture(order=2, guard=4, kchunk=0)
    pt = _torch(p, ParticleState)
    ft = _torch(ftiles, FieldState)
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, origins=ORIGINS,
              g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(32, 32),
              mode="int8")
    n0 = advance_kernel.launches
    bad = [
        (pt._replace(x=pt.x.double()), ft, counts, kw),
        (pt._replace(y=pt.y.t().contiguous().t()), ft, counts, kw),
        (pt, ft._replace(bz=ft.bz[:, :-1]), counts, kw),
        (pt, ft, counts.long(), kw),
        (pt, ft, counts, dict(kw, mode="f16")),
        (pt, ft, counts, dict(kw, order=3)),
        # 14x14 windows: outside the tensor-core deposit's int8 rule.
        (pt, FieldState(*(a[:, 1:-1, 1:-1].contiguous() for a in ft)),
         counts, dict(kw, g=3)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            advance_kernel(*args[:3], **args[3])
    assert advance_kernel.launches == n0
    meta = ParticleState(*(a.to("meta") for a in pt))
    with pytest.raises(ValueError, match="no advance"):
        advance_tiles(meta, ft, counts, **kw)


@pytest.mark.parametrize("name", ["no-staging", "no-jz-products",
                                  "no-int8-products", "no-f64-products",
                                  "checked-gather",
                                  "contiguous", "trees", "all-groups",
                                  "carry", "staged", "passes",
                                  "passes-nostage", "stage-only"])
def test_probe_variants_edit_the_source_once(name):
    """Each edit of the probe's copies (part-removing, or another form of
    the f32 / f64 deposit) matches the kernel source once, and the copy
    changes only those texts."""
    from minipic_torch.ops._build import CSRC
    from minipic_torch.probe_atomics import VARIANTS, variant_source

    src = want = (CSRC / "advance.cu").read_text()
    for old, new in VARIANTS[name]:
        assert src.count(old) == 1
        want = want.replace(old, new)
    assert variant_source(name) == want != src


def test_no_atomics_probe_source_differs_only_by_its_define():
    from minipic_torch.ops._build import CSRC
    from minipic_torch.probe_atomics import no_deposit_source

    src = (CSRC / "advance.cu").read_text()
    probe = no_deposit_source()
    define = "#define MINIPIC_NO_DEPOSIT 1\n"
    assert probe.count(define) == 1
    # The define follows the CUDA include and comes before the source's own
    # default, which it overrides; nothing else changes.
    assert probe.index(define) > probe.index("#include <cuda_runtime.h>")
    assert probe.index(define) < probe.index("#ifndef MINIPIC_NO_DEPOSIT")
    assert "kDeposit = !MINIPIC_NO_DEPOSIT" in src
    assert probe.replace(define, "", 1) == src


# ----------------------------------------------------------------------
# The kernel's int8 deposit as csrc/advance.cu decomposes it, emulated in
# numpy: 32-slot warp slabs, dense int8 operand rows over the window, one
# int32 product per slab (mma.sync m16n8k32 on the card), and the particles
# with an operand outside int8 routed to an int32 scatter.

def _int8_operands(pt, counts, x1, y1, kw):
    """Per slot, what a lane of the kernel computes for the int8 product,
    from the plain version's own helpers: (live [T, cap], row0 and col0 of
    the 4x4 union support in window cells, and the operands a_y = q0y+q1y,
    a_x = q1x-q0x (jx), r_y = q1y-q0y, r_x = q0x+q1x (jy), [T, cap, 4]
    int64).  x1, y1: the stored (wrapped) positions after the push."""
    from minipic_torch.ops import advance as adv

    T, cap = pt.x.shape
    g, order = kw["g"], kw["order"]
    nyg, nxg = kw["tile_ny"] + 2 * g, kw["tile_nx"] + 2 * g
    c32 = {n: adv._f(v, pt.x) for n, v in adv._constants(
        qm=kw["qm"], q=kw["q"], order=order, tile_ny=kw["tile_ny"],
        tile_nx=kw["tile_nx"], dt=kw["dt"], dx=kw["dx"], dy=kw["dy"],
        grid=kw["grid"], mode="int8").items()}
    ox = kw["origins"][0].float()[:, None]
    oy = kw["origins"][1].float()[:, None]
    fx = (c32["grid_nx"], c32["half_x"], c32["inv_nx"])
    fy = (c32["grid_ny"], c32["half_y"], c32["inv_ny"])
    four = torch.arange(4, dtype=torch.float32)

    def axis(p0, p1, origin, fo, n_rows):
        a0 = adv._fold(p0, origin, *fo).reshape(-1)
        a1 = adv._fold(p1, origin, *fo).reshape(-1)
        c0, v0 = adv._support(a0, False, n_rows, g, order, True, c32["S"])
        c1, v1 = adv._support(a1, False, n_rows, g, order, True, c32["S"])
        base = torch.minimum(c0, c1) - 1.0
        cells = base[:, None] + four
        q0, q1 = adv._place4(cells, c0, v0), adv._place4(cells, c1, v1)
        as_int = lambda a: a.numpy().astype(np.int64).reshape(T, cap, 4)
        return (base.long() + g).numpy().reshape(T, cap), as_int(q0), \
            as_int(q1)

    row0, q0y, q1y = axis(pt.y, y1, oy, fy, nyg)
    col0, q0x, q1x = axis(pt.x, x1, ox, fx, nxg)
    slot = np.arange(cap)[None, :]
    live = (slot < counts.numpy()[:, None]) & (pt.w.numpy() != 0)
    return live, row0, col0, q0y + q1y, q1x - q0x, q1y - q0y, q0x + q1x


def _product_route(ops):
    """The kernel's rule: a live particle goes to the product when all 16
    of its operand values fit int8's [-127, 127]; else to the scatter."""
    live, _, _, *vals = ops
    fits = (np.abs(np.concatenate(vals, axis=-1)) <= 127).all(-1)
    return live & fits, live & ~fits


def _emulate_int8_deposit(ops, nyg, nxg):
    """int32 jx, jy windows [T, nyg, nxg] summed as the kernel sums them."""
    live, row0, col0, ay, ax, ry, rx = ops
    T, cap = live.shape
    n_slab = -(-cap // 32)
    npad = 16 * (1 if nxg <= 16 else (2 if nxg <= 32 else 4))
    prod, scatter = _product_route(ops)
    # Dense operands per slab, clipped to the window: A [16 rows, 32
    # particles] (rows past nyg stay zero), B [32 particles, npad columns].
    A = np.zeros((2, T, n_slab, 16, 32), np.int8)
    B = np.zeros((2, T, n_slab, 32, npad), np.int8)
    for j in range(4):
        for base, lim, dense, pair, trans in ((row0, nyg, A, (ay, ry), False),
                                              (col0, nxg, B, (ax, rx), True)):
            at = base + j
            t, s = np.nonzero(prod & (at >= 0) & (at < lim))
            for m, op in enumerate(pair):
                vals = op[t, s, j]
                assert np.abs(vals).max(initial=0) <= 127
                if trans:
                    dense[m, t, s // 32, s % 32, at[t, s]] = vals
                else:
                    dense[m, t, s // 32, at[t, s], s % 32] = vals
    out = []
    for m, (lo, hi) in enumerate(((ay, ax), (ry, rx))):
        win = np.matmul(A[m].astype(np.int32), B[m].astype(np.int32))
        win = win.sum(axis=1, dtype=np.int64)[:, :nyg, :nxg]
        for j in range(4):
            for i in range(4):
                r, c = row0 + j, col0 + i
                t, s = np.nonzero(scatter & (r >= 0) & (r < nyg) & (c >= 0)
                                  & (c < nxg))
                np.add.at(win, (t, r[t, s], c[t, s]),
                          lo[t, s, j] * hi[t, s, i])
        out.append(win)
    return out, prod, scatter


def _bf16_words(v, n=3):
    """f32 values split as the kernel splits them: n bf16 words (round to
    nearest even), largest first, each as f32; their sum is v to ~2^-24."""
    words = []
    for _ in range(n):
        u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
        u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
        wv = u.view(np.float32)
        words.append(wv)
        v = (np.asarray(v, np.float32) - wv).astype(np.float32)
    return words


def _emulate_jz(ops, pt, out, kw, c32, nyg, nxg):
    """jz [T, nyg, nxg] as the kernel's bf16 tensor-core product forms it:
    rows lz0 = czq q0y / 2 and lz1 = czq (q1y - q0y) / 6 in three bf16
    words, integer columns rz0 = q0x + q1x and rz1 = q0x + 2 q1x; summed in
    f64 here (the card's products of bf16 words are exact in f32)."""
    live, row0, col0, ay, ax, ry, rx = ops
    q0y, q1y = (ay - ry) // 2, (ay + ry) // 2
    q0x, q1x = (rx - ax) // 2, (rx + ax) // 2
    pxn, pyn, pzn = out[2:5]
    gn = torch.reciprocal(torch.sqrt(1.0 + pxn * pxn + pyn * pyn
                                     + pzn * pzn))
    cz = (c32["q"] * pt.w) * (pzn * gn) * c32["cz"]
    czq = (cz * c32["czq"]).numpy()[..., None]
    f32 = np.float32
    l0 = f32(0.5) * (q0y.astype(f32) * czq)
    l1 = ((q1y - q0y).astype(f32) * czq) * f32(1.0 / 6.0)
    L0 = sum(w.astype(np.float64) for w in _bf16_words(l0))
    L1 = sum(w.astype(np.float64) for w in _bf16_words(l1))
    R0, R1 = (q0x + q1x).astype(np.float64), (q0x + 2 * q1x).astype(
        np.float64)
    assert max(np.abs(R0).max(), np.abs(R1).max()) <= 256  # exact in bf16
    win = np.zeros((live.shape[0], nyg, nxg))
    for j in range(4):
        for i in range(4):
            r, c = row0 + j, col0 + i
            t, s = np.nonzero(live & (r >= 0) & (r < nyg) & (c >= 0)
                              & (c < nxg))
            np.add.at(win, (t, r[t, s], c[t, s]),
                      L0[t, s, j] * R0[t, s, i] + L1[t, s, j] * R1[t, s, i])
    return win


def _shuffled(p, seed=5):
    """`p` with each tile's slots in a random order (dead slots mixed in)."""
    rng = np.random.default_rng(seed)
    T, cap = np.asarray(p.x).shape
    perm = np.argsort(rng.random((T, cap)), axis=1)
    return type(p)(*(np.take_along_axis(np.asarray(a), perm, axis=1)
                     for a in p))


@pytest.mark.parametrize("layout", ["lattice", "shuffled"])
@pytest.mark.parametrize("kchunk", [32, 0])
@pytest.mark.parametrize("order", [1, 2])
def test_int8_tensor_core_decomposition_matches_plain_and_pallas(
        order, kchunk, layout):
    """The emulated decomposition equals advance_plain's raw int8 jx/jy bit
    for bit, and after the epilogue JAX's interpreted kernel within the
    int8 bar of test_plain_advance_matches_pallas_interpret; its jz (bf16
    words) equals the plain jz to 1e-6 of the peak (the card is held to
    1e-5, its f32 sums run in another order)."""
    deck, tiling, p, ftiles = _fixture(order=order, guard=4, kchunk=kchunk)
    if layout == "shuffled":
        p = _shuffled(p)
    pt = _torch(p, ParticleState)
    ft = _torch(ftiles, FieldState)
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=8, tile_nx=8,
              origins=ORIGINS, g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy,
              grid=(32, 32), mode="int8")
    out, (jx, jy, jz), _ = advance_plain(pt, ft, counts, **kw)
    ops = _int8_operands(pt, counts, out[0], out[1], kw)
    (wx, wy), prod, scatter = _emulate_int8_deposit(ops, 16, 16)
    assert prod.sum() == int((pt.w > 0).sum()) and not scatter.any()
    from minipic_torch.ops import advance as adv
    k32 = {n: adv._f(v, pt.x) for n, v in adv._constants(
        qm=-1.0, q=-1.0, order=order, tile_ny=8, tile_nx=8, dt=deck.dt,
        dx=deck.dx, dy=deck.dy, grid=(32, 32), mode="int8").items()}
    ez = _emulate_jz(ops, pt, out, kw, k32, 16, 16)
    np.testing.assert_allclose(ez, jz.numpy(), rtol=0,
                               atol=1e-6 * float(jz.abs().max()))
    c32 = {n: torch.tensor(v, dtype=torch.float32) for n, v in
           (("cjx", -1.0 / (2 * qshape_scale(order) ** 2 * deck.dt
                            * deck.dy)),
            ("cjy", -1.0 / (2 * qshape_scale(order) ** 2 * deck.dt
                            * deck.dx)))}
    ex = torch.from_numpy(wx).to(torch.float32) * c32["cjx"]
    ey = torch.from_numpy(wy).to(torch.float32) * c32["cjy"]
    assert torch.equal(ex, jx) and torch.equal(ey, jy)

    _, (jxj, jyj, _), _ = _jax_advance(deck, tiling, p, ftiles, "int8")
    qws = torch.tensor(-1.0) * pt.w.max()
    for name, raw, dim, ref in (("jx", ex, -1, jxj), ("jy", ey, -2, jyj)):
        got = torch.cumsum(raw * qws, dim=dim).numpy()
        ref = np.asarray(ref)
        scale = max(1e-12, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-6 * scale,
                                   err_msg=name)


# The staging layouts of csrc/advance.cu (Stage), transcribed: where each
# operand element (row or column, particle k) goes, and what each lane
# loads for its mma fragments.
def _int8_at(rc, k):
    return 32 * rc + k  # byte; A by row, B by column


def _za_at(r, k):
    return 32 * r + (k ^ ((r & 1) << 2))  # 16-byte chunk


def _zb_at(c, k):
    pair = (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1)
    return 32 * c + (pair ^ ((c & 7) << 2))  # 32-bit word


@pytest.mark.parametrize("pairs", [1, 2, 4])
def test_staging_layout_gives_each_lane_its_mma_fragments(pairs):
    """Each lane's loads (Stage::int8_products, Stage::jz_products) must
    fetch its mma.sync fragments (PTX ISA), lane = 4 grp + t.  int8
    (m16n8k32 .s8): A registers a0..a3 hold rows grp, grp+8, grp, grp+8 x
    particles 4t + 0..3 (+16 for the 3rd and 4th); B registers b0, b1 of
    column tile nt hold column grp x particles 4t + 0..3 (+16 for b1).  jz
    (m16n8k16 .bf16, k = 2 particle + term, one 32-bit word a particle):
    per k-step ks, A registers rows grp, grp+8, grp, grp+8 x particles
    8ks + t, t, 4+t, 4+t; B registers column grp x particles 8ks + t, 4+t.
    Every element has its own place, and the loads spread over the banks."""
    ncol = 16 * pairs
    a_seen = {_int8_at(r, k): (r, k) for r in range(16) for k in range(32)}
    b_seen = {_int8_at(c, k): (c, k) for c in range(ncol) for k in range(32)}
    za_seen = {_za_at(r, k): (r, k) for r in range(16) for k in range(32)}
    zb_seen = {_zb_at(c, k): (c, k) for c in range(ncol) for k in range(32)}
    assert sorted(a_seen) == list(range(512))
    assert sorted(b_seen) == list(range(512 * pairs))
    assert sorted(za_seen) == list(range(512))
    assert sorted(zb_seen) == list(range(512 * pairs))
    a_banks, zb_banks = [], []
    for lane in range(32):
        grp, t = lane >> 2, lane & 3
        # int8: the kernel's word addresses 32 grp + {0, 256, 16, 272} + 4t.
        for reg, off in enumerate((0, 256, 16, 272)):
            at = 32 * grp + off + 4 * t
            for e in range(4):
                assert a_seen[at + e] == (grp + 8 * (reg & 1),
                                          4 * t + e + 16 * (reg >> 1))
            if reg == 0:
                a_banks.append((at // 4) % 32)
        for nt in range(2 * pairs):
            for reg in range(2):
                at = 32 * (8 * nt + grp) + 4 * t + 16 * reg
                for e in range(4):
                    assert b_seen[at + e] == (8 * nt + grp,
                                              4 * t + e + 16 * reg)
        # jz
        sw = (grp & 1) << 2
        for ks in range(4):
            p0, p1 = 8 * ks + t, 8 * ks + 4 + t
            for reg, (row, p) in enumerate(((grp, p0), (grp + 8, p0),
                                            (grp, p1), (grp + 8, p1))):
                assert za_seen[32 * row + (p ^ sw)] == (
                    grp + 8 * (reg & 1), 8 * ks + 4 * (reg >> 1) + t)
            for nt in range(2 * pairs):
                c = 8 * nt + grp
                at = 32 * c + ((8 * ks + 2 * t) ^ (grp << 2))  # 8 bytes
                assert at % 2 == 0
                for reg in range(2):
                    assert zb_seen[at + reg] == (c, 8 * ks + 4 * reg + t)
                if ks == 0 and nt == 0:
                    zb_banks += [at % 32, (at + 1) % 32]
    # int8 A: two lanes a bank; jz B (8-byte loads): two lanes a bank, the
    # 2 passes of 256 bytes; jz A (16-byte loads): four lanes to each group
    # of four banks, the 4 passes of 512 bytes.
    assert max(a_banks.count(b) for b in a_banks) == 2
    assert max(zb_banks.count(b) for b in zb_banks) == 2
    for ks in range(4):
        groups = [(32 * (lane >> 2) + ((8 * ks + (lane & 3))
                                       ^ (((lane >> 2) & 1) << 2))) % 8
                  for lane in range(32)]
        assert max(groups.count(g) for g in groups) == 4


@settings(max_examples=200, deadline=None)
@given(ey=st.floats(-4.6, 11.6), ex=st.floats(-4.6, 11.6),
       dy=st.floats(-0.45, 0.45), dx=st.floats(-0.45, 0.45),
       order=st.sampled_from([1, 2]))
def test_int8_operands_fit_or_take_the_scatter(ey, ex, dy, dx, order):
    """Over positions across the whole 16x16 window, its edge cells
    included: every operand the emulation sends to the product lies in
    [-127, 127]; a particle whose centre cells stay off the window's edge
    rows and columns always takes the product."""
    ops, nudge = _one_particle_ops(ex, ey, dx, dy, order)
    prod, scatter = _product_route(ops)
    assert prod[0, 0] != scatter[0, 0]
    (wx, wy), _, _ = _emulate_int8_deposit(ops, 16, 16)  # asserts the range
    c = [np.floor(v + 0.5) + 4 for v in (ex, ey, ex + nudge[0],
                                          ey + nudge[1])]
    if all(1 <= v <= 14 for v in c):
        assert prod[0, 0]


def _one_particle_ops(ex, ey, dx, dy, order):
    """Operands of one particle of tile 0 (32^2 grid, 8x8 tiles, guard 4)
    at tile-local (ex, ey), moved by (dx, dy) cells."""
    T, cap = 16, 32
    x0 = np.zeros((T, cap), np.float32)
    y0 = np.zeros((T, cap), np.float32)
    w = np.zeros((T, cap), np.float32)
    x0[0, 0], y0[0, 0], w[0, 0] = np.float32(ex % 32), np.float32(ey % 32), 1
    x1 = np.remainder(x0 + np.float32(dx), np.float32(32))
    y1 = np.remainder(y0 + np.float32(dy), np.float32(32))
    pt = ParticleState(*(torch.from_numpy(a) for a in
                         (x0, y0, x0, x0, x0, w)))
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=8, tile_nx=8,
              origins=ORIGINS, g=4, dt=0.1, dx=0.1, dy=0.1, grid=(32, 32))
    ops = _int8_operands(pt, live_watermark(pt.w), torch.from_numpy(x1),
                         torch.from_numpy(y1), kw)
    return ops, (dx, dy)


def test_edge_fold_particle_takes_the_scatter_and_matches_plain():
    """A TSC particle at rest whose centre cell is guard row and column 0
    (tile-local -3.9): the edge fold lifts its centre value to 68, q0+q1
    to 136, out of int8; the emulation sends it to the scatter and still
    equals advance_plain's raw jx/jy."""
    ops, _ = _one_particle_ops(-3.9, -3.9, 0.0, 0.0, 2)
    prod, scatter = _product_route(ops)
    assert scatter[0, 0] and not prod.any()
    assert int(ops[3][0, 0].max()) > 127  # a_y = q0y + q1y

    deck, tiling, p, ftiles = _fixture(order=2, guard=4, kchunk=0)
    pt = _torch(p, ParticleState)
    every = np.zeros(pt.w.shape, bool)
    every[:, ::7] = True
    edge = torch.from_numpy(every) & (pt.w > 0)
    t = torch.arange(pt.x.shape[0])[:, None]
    ex = torch.remainder((t % 4) * 8 - 3.9 + 0.2 * (pt.x % 1), 32).float()
    ey = torch.remainder((t // 4) * 8 - 3.9 + 0.2 * (pt.y % 1), 32).float()
    pt = pt._replace(x=torch.where(edge, ex, pt.x),
                     y=torch.where(edge, ey, pt.y))
    ft = _torch(ftiles, FieldState)
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, origins=ORIGINS,
              g=4, dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(32, 32),
              mode="int8")
    (x1, y1, *_), (jx, jy, _), _ = advance_plain(pt, ft, counts, **kw)
    ops = _int8_operands(pt, counts, x1, y1, kw)
    (wx, wy), prod, scatter = _emulate_int8_deposit(ops, 16, 16)
    assert scatter.sum() > 0 and prod.sum() > scatter.sum()
    c = -1.0 / (2 * 83.0 ** 2 * deck.dt)
    assert torch.equal(torch.from_numpy(wx).float()
                       * torch.tensor(c / deck.dy, dtype=torch.float32), jx)
    assert torch.equal(torch.from_numpy(wy).float()
                       * torch.tensor(c / deck.dx, dtype=torch.float32), jy)


# ----------------------------------------------------------------------
# The open mode (grid None): decks between absorbing walls.

def _open_fixture(order, tile, guard, seed=7):
    """A 32^2 box of `tile`^2 tiles: thermal particles in stale buckets,
    every 7th slot dead, and in each tile next to a wall a set of
    particles within 0.2 cells of it moving out at ~0.95 c (through each
    wall, and through each corner diagonally); fields: an oblique wave."""
    deck = Deck(
        box_x=4.0, box_y=4.0, nx=32, ny=32, tile_nx=tile, tile_ny=tile,
        guard=guard, species=(SpeciesSpec("e", -1.0, 1.0, ppc=4, uth=0.1,
                                          shape_order=order),),
        precision="f32", kchunk=0)
    tiling = deck.tiling
    cap = -(-deck.capacity() // 128) * 128
    p = load_species(deck.species[0], deck.domain, tiling, cap,
                     jax.random.PRNGKey(5), jnp.float32)
    x, y, px, py, pz, w = (np.array(a) for a in p)
    rng = np.random.default_rng(seed)
    live = w > 0
    # Stale buckets: up to 0.3 cells off, kept inside the box.
    x = np.where(live, np.clip(x + rng.uniform(-0.3, 0.3, x.shape), 0.01,
                               31.99), x).astype(np.float32)
    y = np.where(live, np.clip(y + rng.uniform(-0.3, 0.3, y.shape), 0.01,
                               31.99), y).astype(np.float32)
    ox = (np.arange(tiling.num_tiles) % tiling.tile_cols * tile)[:, None]
    oy = (np.arange(tiling.num_tiles) // tiling.tile_cols * tile)[:, None]
    near = rng.uniform(0.0, 0.2, x.shape).astype(np.float32)
    # |u| = 3: 0.95 c, 0.34 cells a step along each axis.
    x, y, px, py = (a.numpy() for a in push_out_through_walls(
        *(torch.from_numpy(a) for a in (x, y, px, py, live, ox, oy)),
        tile, tile, 32.0, 32.0, torch.from_numpy(near)))
    slot = np.arange(cap)[None, :]
    w = np.where(slot % 7 == 5, 0.0, w).astype(np.float32)
    p = type(p)(*(jnp.asarray(a, jnp.float32)
                  for a in (x, y, px, py, pz, w)))
    f = finit.oblique_wave(deck.domain, amplitude=0.3, dtype=jnp.float32)
    ftiles = extract_field_tiles(
        pad_fields_periodic(f, guard), tiling.tile_rows, tiling.tile_cols,
        tiling.tile_ny, tiling.tile_nx, guard)
    return deck, tiling, p, ftiles


@pytest.mark.parametrize("order,tile,guard", [(1, 16, 2), (2, 8, 4)],
                         ids=["cic-16x16-g2", "tsc-8x8-g4"])
def test_open_mode_matches_pallas_interpret(order, tile, guard):
    """The plain version with grid=None against JAX's interpreted kernel
    with wrap=None, grid=None (the absorbing decks' call), f32 deposit:
    particles that leave through each wall and corner keep their
    unwrapped moves on both sides; positions and momenta to the f32
    bar of the periodic test (the kernel gathers by a dense product in
    another order), J within 2e-5 of its peak."""
    deck, tiling, p, ftiles = _open_fixture(order, tile, guard)
    pj, jj, dj = advance_species_tiles(
        p, ftiles, qm=-1.0, q=-1.0, order=order, tile_ny=tile, tile_nx=tile,
        origins=_tile_origins(tiling, jnp.float32), g=guard, dt=deck.dt,
        dx=deck.dx, dy=deck.dy, kchunk=0, backend="pallas", interpret=True,
        deposit_mode="highest", qw0=0.0, wrap=None, grid=None,
        return_disp=True)
    pt = _torch(p, ParticleState)
    out, jt, dt_ = fused_push_deposit(
        pt, _torch(ftiles, FieldState), qm=-1.0,
        q=-1.0, order=order, tile_ny=tile, tile_nx=tile,
        origins=tile_origins(tiling, "cpu"), g=guard, dt=deck.dt, dx=deck.dx,
        dy=deck.dy, grid=None, mode="f32")
    alive = np.asarray(p.w) > 0
    x1, y1 = out.x.numpy()[alive], out.y.numpy()[alive]
    # Leavers through every wall, stored unwrapped.
    assert (x1 < 0).sum() >= 4 and (x1 >= 32).sum() >= 4
    assert (y1 < 0).sum() >= 4 and (y1 >= 32).sum() >= 4
    assert (((x1 < 0) | (x1 >= 32)) & ((y1 < 0) | (y1 >= 32))).sum() >= 4
    assert ((x1 < -0.5) | (x1 > 32.5)).sum() == 0
    for name in ("x", "y", "px", "py", "pz"):
        a = np.asarray(getattr(pj, name))[alive]
        b = getattr(out, name).numpy()[alive]
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-6, err_msg=name)
    dead = ~alive
    for name, a in zip(("x", "y", "px", "py", "pz"), out[:5]):
        np.testing.assert_array_equal(a.numpy()[dead],
                                      np.asarray(getattr(p, name))[dead])
    for name, a, b in zip(("jx", "jy", "jz"), jj, jt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=2e-5 * np.abs(a).max(), err_msg=name)
    np.testing.assert_allclose(float(dt_), float(dj), rtol=1e-5)


def test_open_and_periodic_modes_differ_only_at_the_walls():
    """Away from the walls the open mode is the periodic mode: the same
    arithmetic on every particle whose fold and wrap do nothing."""
    deck, tiling, p, ftiles = _open_fixture(2, 8, 4)
    pt = _torch(p, ParticleState)
    ft = _torch(ftiles, FieldState)
    counts = live_watermark(pt.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8,
              origins=tile_origins(tiling, "cpu"), g=4, dt=deck.dt, dx=deck.dx,
              dy=deck.dy, mode="f32")
    po, jo, _ = advance_plain(pt, ft, counts, grid=None, **kw)
    pp, jp, _ = advance_plain(pt, ft, counts, grid=(32, 32), **kw)
    inside = ((po[0] >= 0) & (po[0] < 32) & (po[1] >= 0) & (po[1] < 32))
    for a, b in zip(po, pp):
        assert torch.equal(a[inside], b[inside])
    assert not torch.equal(po[0], pp[0])
    # A particle that left sits at its unwrapped move in the open mode and
    # at its periodic image in the periodic one.
    out = ~inside
    np.testing.assert_allclose(torch.remainder(po[0][out], 32.0).numpy(),
                               pp[0][out].numpy(), atol=1e-5)


# ----------------------------------------------------------------------
# The kernel's f32 and f64 deposit as csrc/advance.cu decomposes it,
# emulated in numpy (minipic_torch.testing): warps walking 32-slot slabs
# at a stride of 8, lanes grouped by their 4x4 base, reduce16 shuffle trees
# with one add per cell into the warp's set of J windows (else 48 adds
# lane by lane), 1, 2, 4 or 8 warps to a set, and the sets summed in a
# fixed order.

def _edge(p, every=13):
    """`p` with every `every`-th live particle moved 3.6-3.9 cells below
    and left of its tile (every 2nd of those 3.1-3.4 above and right of
    it): supports at the window's edge rows and columns, bases partly off
    the window."""
    x, y, w = (np.array(a) for a in (p.x, p.y, p.w))
    T, cap = x.shape
    t = np.arange(T)[:, None]
    ox, oy = (t % 4 * 8).astype(np.float32), (t // 4 * 8).astype(np.float32)
    s = np.arange(cap)[None, :]
    low = (w > 0) & (s % every == 0)
    high = low & (s % (2 * every) == 0)
    fx, fy = np.float32(0.3) * (x % 1), np.float32(0.3) * (y % 1)
    x = np.where(low, ox - 3.9 + fx, x)
    y = np.where(low, oy - 3.9 + fy, y)
    x = np.where(high, ox + 8 + 3.1 + fx, x)
    y = np.where(high, oy + 8 + 3.1 + fy, y)
    x, y = (np.mod(a, 32.0).astype(np.float32) for a in (x, y))
    return p._replace(x=jnp.asarray(x), y=jnp.asarray(y))


def _float_case(layout):
    """(particles, field tiles, advance keywords) of one layout: the
    32^2 fixture at ppc 32 (as loaded, a cell to a slab: its TSC bases are
    the four halves of the cell), shuffled, or with window-edge supports;
    or the open fixture (CIC, 20^2 windows, leavers through every wall)."""
    if layout == "open":
        deck, tiling, p, ftiles = _open_fixture(1, 16, 2)
        grid = None
    else:
        deck, tiling, p, ftiles = _fixture(order=2, ppc=32, kchunk=0,
                                           guard=4)
        grid = (deck.nx, deck.ny)
        p = {"lattice": p, "shuffled": _shuffled(p) if layout == "shuffled"
             else p, "edge": _edge(p) if layout == "edge" else p}[layout]
    kw = dict(qm=-1.0, q=-1.0, order=deck.species[0].shape_order,
              tile_ny=tiling.tile_ny, tile_nx=tiling.tile_nx,
              origins=tile_origins(tiling, "cpu"), g=deck.guard, dt=deck.dt,
              dx=deck.dx, dy=deck.dy, grid=grid)
    return _torch(p, ParticleState), _torch(ftiles, FieldState), kw


# J bars of the kernel against its plain version (ROADMAP C, chip_smoke):
# sums in another order.
FLOAT_J_TOL = {"f32": 2e-5, "f64": 1e-12}


@pytest.mark.parametrize("mode", ["f32", "f64"])
@pytest.mark.parametrize("layout", ["lattice", "shuffled", "edge", "open"])
def test_float_warp_window_decomposition_matches_plain(layout, mode):
    """The emulated f32 / f64 deposit equals advance_plain's raw J windows
    within the kernel's bars (1e-12 of the peak in f64, 2e-5 in f32) at
    every window sharing: a set per warp (the staged sums per base) and
    2, 4 or 8 warps to a set (shuffle trees where a slab holds at most four
    bases, as in lattice order; lane by lane past them, as with shuffled
    slots); the edge and open layouts take cells off the window."""
    from minipic_torch.testing import (float_deposit_terms, sum_warp_windows,
                                       warp_adds)

    pt, ft, kw = _float_case(layout)
    if mode == "f64":
        pt = ParticleState(*(a.double() for a in pt))
        ft = FieldState(*(a.double() for a in ft))
    counts = live_watermark(pt.w)
    out, jp, _ = advance_plain(pt, ft, counts, mode=mode, **kw)
    live, row0, col0, v = float_deposit_terms(pt, counts, out, mode=mode,
                                              **kw)
    assert v.dtype == (np.float64 if mode == "f64" else np.float32)
    g = kw["g"]
    nyg, nxg = kw["tile_ny"] + 2 * g, kw["tile_nx"] + 2 * g
    tiles = {private: [warp_adds(live[t], row0[t], col0[t], v[t],
                                 int(counts[t]), nyg, nxg, private)
                       for t in range(live.shape[0])]
             for private in (True, False)}
    n_few = sum(a[1] for a in tiles[False])
    n_many = sum(a[2] for a in tiles[False])
    if layout == "lattice":
        assert n_few > 3 * n_many, (n_few, n_many)
    else:
        assert n_many > 0, n_few
    if layout == "edge":
        off = np.concatenate([row0[live], col0[live]])
        assert (off < 0).any() and (off + 3 >= min(nyg, nxg)).any()
    if layout == "open":
        x1 = out[0].numpy()[live]
        assert (x1 < 0).any() and (x1 >= 32).any()
    for win_warps in (1, 2, 4, 8):
        got = np.stack([sum_warp_windows(a[0], nyg, nxg, win_warps, v.dtype)
                        for a in tiles[win_warps == 1]])
        for n, name in enumerate(("jx", "jy", "jz")):
            want = jp[n].numpy()
            np.testing.assert_allclose(
                got[:, n], want, rtol=0,
                atol=FLOAT_J_TOL[mode] * np.abs(want).max(),
                err_msg=f"{name}, {win_warps} warps to a set")


# ----------------------------------------------------------------------
# Shared memory of the f32 and f64 modes: the J window sets a block takes.

@pytest.mark.parametrize("name", ["headline"] + sorted(
    __import__("minipic_torch.decks.standard", fromlist=["CASES"]).CASES))
def test_every_deck_window_takes_private_j_windows(name):
    """Every deck with particles has a window (16^2 or 20^2) that fits a
    set of J windows and a staging area for each warp, in f32 and in f64:
    no atomic in its deposit.  In f64 the 16^2 windows deposit through the
    tensor-core products instead (one set and each warp's operand areas);
    the 20^2 ones keep the private sets.  (reference_pulse, 29^2, has no
    particles.)"""
    from minipic_torch.decks import standard
    from minipic_torch.headline import headline_deck
    from minipic_torch.ops.advance import (f64_products, kernel_smem_bytes,
                                           window_warps)

    deck = headline_deck() if name == "headline" else standard.make(name).deck
    nyg, nxg = deck.tile_ny + 2 * deck.guard, deck.tile_nx + 2 * deck.guard
    if not deck.species:
        assert name == "reference_pulse"
        return
    assert (nyg, nxg) in ((16, 16), (20, 20))
    for mode, real in (("f32", 4), ("f64", 8)):
        assert window_warps(nyg, nxg, mode) == 1, (mode, nyg, nxg)
        private = real * (nyg * nxg * 30 + 8 * 48 * 33)
        assert kernel_smem_bytes(nyg, nxg, mode, 1) == private
        if f64_products(nyg, nxg, mode):
            assert (mode, nyg) == ("f64", 16)
            assert kernel_smem_bytes(nyg, nxg, mode) == \
                8 * 9 * nyg * nxg + 8 * 4 * 16 * 36 * 8
        else:
            assert (mode, nyg) != ("f64", 16)
            assert kernel_smem_bytes(nyg, nxg, mode) == private


@pytest.mark.parametrize("name", ["headline"] + sorted(
    __import__("minipic_torch.decks.standard", fromlist=["CASES"]).CASES))
def test_f64_products_take_every_16_window_of_a_named_deck(name):
    """The route of each named deck's window, in every mode: the f64
    tensor-core deposit at 16^2 (the headline and every 8x8-tile deck, as
    ``--precision f64`` runs them), the private sets at the laser decks'
    20^2, never in f32 or int8."""
    from minipic_torch.decks import standard
    from minipic_torch.headline import headline_deck
    from minipic_torch.ops.advance import f64_products

    deck = headline_deck() if name == "headline" else standard.make(name).deck
    nyg, nxg = deck.tile_ny + 2 * deck.guard, deck.tile_nx + 2 * deck.guard
    want = nyg <= 16 and nxg <= 16
    assert want == (deck.tile_nx == 8 and deck.guard == 4) or \
        name == "reference_pulse"
    assert f64_products(nyg, nxg, "f64") == want
    assert not f64_products(nyg, nxg, "f32")
    assert not f64_products(nyg, nxg, "int8")


def test_f64_product_layout_fits_a_block():
    """Every window the f64 products take (at most 16 rows and columns:
    the accumulators' 2 x 2 tiles of 8 x 8) fits a block's shared memory
    with its one set and eight warps' operand areas; one more row or
    column leaves the route."""
    from minipic_torch.ops.advance import (_SMEM_LIMIT, f64_products,
                                           kernel_smem_bytes, window_warps)

    for nyg in range(4, 19):
        for nxg in range(4, 19):
            takes = f64_products(nyg, nxg, "f64")
            assert takes == (nyg <= 16 and nxg <= 16)
            smem = kernel_smem_bytes(nyg, nxg, "f64")
            if takes:
                assert smem == 72 * nyg * nxg + 8 * 18432 <= _SMEM_LIMIT
            else:
                assert smem == kernel_smem_bytes(
                    nyg, nxg, "f64", window_warps(nyg, nxg, "f64"))
    assert kernel_smem_bytes(16, 16, "f64") == 165888


def test_f64_product_constants_mirror_the_kernel():
    """ops/advance.py's widest product window and operand bytes a warp are
    csrc/advance.cu's kProdCells and prod_stage_bytes() (four areas of
    kProdCells x kProdLd doubles), and the products flag follows fused in
    the parameter struct."""
    import re

    from minipic_torch.ops import advance
    from minipic_torch.ops._build import CSRC

    src = (CSRC / "advance.cu").read_text()
    cells = int(re.search(r"constexpr int kProdCells = (\d+);", src)[1])
    ld = int(re.search(r"constexpr int kProdLd = (\d+);", src)[1])
    assert "return 4 * kProdArea * (int)sizeof(double);" in src
    assert "constexpr int kProdArea = kProdCells * kProdLd;" in src
    assert cells == advance._PRODUCT_CELLS
    assert advance._PRODUCT_STAGE == 4 * cells * ld * 8
    assert ld % 16 == 4  # the half warps' fragment loads: distinct banks
    names = [n for n, _ in advance.AdvanceParams64._fields_]
    assert names[names.index("fused") + 1] == "products"


@pytest.mark.parametrize("n,mode,want", [
    (16, "f64", 1), (23, "f64", 1), (24, "f64", 2), (40, "f64", 2),
    (48, "f64", 4), (52, "f64", 8), (38, "f32", 1), (39, "f32", 2),
    (60, "f32", 4), (72, "f32", 8), (16, "int8", 8)])
def test_wide_windows_share_j_windows(n, mode, want):
    """Past what a block's shared memory holds with a set and a staging
    area per warp, 2, 4 and then 8 warps share a set (no staging): the
    fewest that fit (f64: (48 + 24 * 8 / w) bytes a cell; f32 half of
    it).  int8 keeps its one set."""
    from minipic_torch.ops.advance import (_SMEM_LIMIT, kernel_smem_bytes,
                                           window_warps)

    assert window_warps(n, n, mode) == want
    assert kernel_smem_bytes(n, n, mode) <= _SMEM_LIMIT
    if want > 1 and mode != "int8":
        assert kernel_smem_bytes(n, n, mode, want // 2) > _SMEM_LIMIT
    if mode == "f64" and want > 1:
        assert kernel_smem_bytes(n, n, mode, want) == (48 + 192 // want) * n * n


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_window_limit_is_the_one_set_layouts(mode):
    """8 warps to a set is the layout of one set for the block (nine
    windows: 36 bytes a cell in f32, 72 in f64), so a window is admitted
    exactly when it was before the sets became per warp."""
    from minipic_torch.ops.advance import (_SMEM_LIMIT, kernel_smem_bytes,
                                           window_warps)

    one_set = 72 if mode == "f64" else 36
    for nyg in range(8, 100, 3):
        for nxg in range(8, 100, 5):
            assert kernel_smem_bytes(nyg, nxg, mode, 8) == \
                one_set * nyg * nxg
            fits = one_set * nyg * nxg <= _SMEM_LIMIT
            assert (kernel_smem_bytes(nyg, nxg, mode) <= _SMEM_LIMIT) == fits
            w = window_warps(nyg, nxg, mode)
            assert w in (1, 2, 4, 8)
            assert w == 8 or kernel_smem_bytes(nyg, nxg, mode, w) \
                <= _SMEM_LIMIT


def test_wrapper_refuses_a_window_past_shared_memory_before_building():
    """A window whose one-set layout does not fit (f32 81^2) is refused
    with ValueError before anything is built or launched."""
    from minipic_torch.ops.advance import advance_kernel

    T, cap, n = 1, 32, 81
    p = ParticleState(*(torch.zeros(T, cap) for _ in range(6)))
    ft = FieldState(*(torch.zeros(T, n, n) for _ in range(6)))
    o = torch.zeros(T, dtype=torch.int32)
    n0 = advance_kernel.launches
    with pytest.raises(ValueError, match="shared memory"):
        advance_kernel(p, ft, torch.zeros(T, dtype=torch.int32), qm=-1.0,
                       q=-1.0, order=2, tile_ny=n - 8, tile_nx=n - 8,
                       origins=(o, o), g=4, dt=0.035, dx=0.1, dy=0.1,
                       grid=(n - 8, n - 8), mode="f32")
    assert advance_kernel.launches == n0


def test_params_mirror_the_kernel_struct():
    """ops/advance.py's ctypes parameter structs list AdvanceParamsT's
    fields of csrc/advance.cu in its order (win_warps after periodic), as
    int and as the mode's real type."""
    import ctypes
    import re

    from minipic_torch.ops._build import CSRC
    from minipic_torch.ops.advance import AdvanceParams, AdvanceParams64

    src = (CSRC / "advance.cu").read_text()
    body = src.split("struct AdvanceParamsT {", 1)[1].split("};", 1)[0]
    fields = []
    for decl in re.findall(r"^\s*(int|R)\s+([^;]+);", body, re.M):
        fields += [(n.strip(), decl[0]) for n in decl[1].split(",")]
    assert [n for n, _ in fields][5:7] == ["periodic", "win_warps"]
    for cls, real in ((AdvanceParams, ctypes.c_float),
                      (AdvanceParams64, ctypes.c_double)):
        assert [(n, t) for n, t in cls._fields_] == [
            (n, ctypes.c_int if k == "int" else real) for n, k in fields]
