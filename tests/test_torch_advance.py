"""The port's advance (plain torch version of csrc/advance.cu) against the
JAX package's fused Pallas kernel, run in interpret mode, on the same
particles and fields."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.ops.advance import (  # noqa: E402
    advance_plain, advance_tiles, fused_push_deposit, live_watermark,
    qshape_scale, resolve_mode)


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
        pt, ft, live_watermark(pt.w), qm=-1.0, q=-1.0,
        order=deck.species[0].shape_order, tile_ny=tiling.tile_ny,
        tile_nx=tiling.tile_nx, tile_cols=tiling.tile_cols, g=deck.guard,
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
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, tile_cols=4,
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
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, tile_cols=4,
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
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, tile_cols=4,
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
    ]
    for args in bad:
        with pytest.raises(ValueError):
            advance_kernel(*args[:3], **args[3])
    assert advance_kernel.launches == n0
    meta = ParticleState(*(a.to("meta") for a in pt))
    with pytest.raises(ValueError, match="no advance"):
        advance_tiles(meta, ft, counts, **kw)


def test_no_atomics_probe_source_differs_only_by_its_define():
    from minipic_torch.ops._build import CSRC
    from minipic_torch.probe_atomics import no_atomics_source

    src = (CSRC / "advance.cu").read_text()
    probe = no_atomics_source()
    define = "#define atomicAdd(addr, val) ((void)0)\n"
    assert probe.count(define) == 1
    # The define follows the CUDA include, so it reaches only the kernel's
    # own atomicAdd calls, and nothing else changes.
    assert probe.index(define) > probe.index("#include <cuda_runtime.h>")
    assert probe.index(define) < probe.index("atomicAdd(&")
    assert probe.replace(define, "", 1) == src
