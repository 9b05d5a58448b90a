"""The CUDA advance kernel against its plain torch version, on the card.

Marked ``gpu``: each test skips without CUDA.  On a machine with a card
(which need not have JAX) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from minipic_torch.core.state import FieldState, ParticleState  # noqa: E402
from minipic_torch.ops.advance import (  # noqa: E402
    AdvanceKernel, advance_kernel, advance_plain, advance_tiles,
    live_watermark)
from minipic_torch.probe_atomics import no_atomics_source  # noqa: E402

pytestmark = pytest.mark.gpu


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
              tile_cols=4, g=4, dt=0.035, dx=0.1, dy=0.1, grid=(32, 32),
              mode=mode)
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


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    p, ft = _inputs(cuda)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, tile_cols=4,
              g=4, dt=0.035, dx=0.1, dy=0.1, grid=(32, 32), mode="int8")
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
    src = tmp_path / "advance_noatomics.cu"
    src.write_text(no_atomics_source())
    p, ft = _inputs(cuda)
    counts = live_watermark(p.w)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=8, tile_nx=8, tile_cols=4,
              g=4, dt=0.035, dx=0.1, dy=0.1, grid=(32, 32), mode=mode)
    pv, jv, dv = AdvanceKernel(src)(p, ft, counts, **kw)
    pk, _, dk = advance_kernel(p, ft, counts, **kw)
    torch.cuda.synchronize()
    for a, b in zip(pv, pk):
        assert torch.equal(a, b)
    assert torch.equal(dv, dk)
    for j in jv:
        assert not bool(j.any())
