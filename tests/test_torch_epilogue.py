"""The advance's epilogue on the CPU: the contract of csrc/advance.cu's
fused launch and the kernel after it (``minipic_torch.testing.
fused_epilogue``: int8's integers summed exactly before the conversion and
the q*max(w) scale, f32 and f64 summed in order) against the torch epilogue
(``ops.advance.torch_epilogue``) over ``advance_plain``'s raw windows, and
the live watermark's edge cases.  The card's tests hold the kernels to the
same contract bit for bit."""
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread, as the port's other test files.
torch.set_num_threads(1)

from minipic_torch import trace  # noqa: E402
from minipic_torch.ops.advance import (  # noqa: E402
    advance_plain, fused_push_deposit, live_watermark, torch_epilogue)
from minipic_torch.testing import (  # noqa: E402
    edge_case_buckets, fused_epilogue, prefix_gap_bound, running_sum)

# One bucket's weights and its watermark: the highest slot with w > 0,
# plus 1.
_WATERMARKS = {
    "empty": ([0.0] * 8, 0),
    "full": ([0.5] * 8, 8),
    "last_slot": ([0.0] * 7 + [0.5], 8),
    "holes": ([0.5, 0.0, 0.5, 0.0, 0.0, 0.5, 0.0, 0.0], 6),
    "negative_zero": ([0.5, -0.0, 0.5, -0.0, 0.0, -0.0, -0.0, -0.0], 3),
    "negative": ([0.5, 0.0, -0.5, 0.0, 0.0, 0.0, 0.0, -0.5], 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(_WATERMARKS))
def test_live_watermark_edge_cases(case, dtype):
    w, want = _WATERMARKS[case]
    # The bucket beside an empty one and a full one: tiles are independent.
    t = torch.tensor([w, [0.0] * 8, [1.0] * 8], dtype=dtype)
    got = live_watermark(t)
    assert got.dtype == torch.int32
    assert got.tolist() == [want, 0, 8]


_CASES = {
    # name: edge_case_buckets arguments
    "periodic": dict(periodic=True),
    "open_gids_graded": dict(periodic=False, gids=True, graded=True),
}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("mode", ["int8", "f32", "f64"])
def test_fused_epilogue_matches_the_torch_epilogue(mode, order, case):
    """Over the plain version's raw windows: jz and the max displacement
    equal; jx and jy within ``prefix_gap_bound`` of the scaled terms (two
    prefix sums of the same terms, each rounding at most n + 3 times a
    prefix: int8's kernel rounds the exact integer prefix twice, the torch
    epilogue each term and each add)."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    p, ft, kw = edge_case_buckets("cpu", cap=256, n_live=180, dtype=dtype,
                                  **_CASES[case])
    kw = dict(kw, order=order, mode=mode)
    _, js, dmax = advance_plain(p, ft, live_watermark(p.w), **kw)
    (jx, jy, jz), d = fused_epilogue(js, dmax, p.w, **kw)
    (tx, ty, tz), td = torch_epilogue(js, dmax, p.w, q=kw["q"], mode=mode)
    assert torch.equal(jz, tz) and torch.equal(d, td) and d.dim() == 0
    qws = p.w.max() * kw["q"] if mode == "int8" else 1.0
    for got, want, raw, dim in ((jx, tx, js[0], -1), (jy, ty, js[1], -2)):
        assert got.dtype == want.dtype == dtype
        bound = prefix_gap_bound(raw * qws, dim)
        gap = (got.double() - want.double()).abs()
        assert bool((gap <= bound).all()), float((gap - bound).max())
        assert float(got.abs().max()) > 0.0
    # The empty tile deposits nothing; the holes' tile does.
    assert not bool(jz[0].any()) and bool(jz[2].any())


def test_fused_epilogue_refuses_int8_windows_that_are_not_integers():
    p, ft, kw = edge_case_buckets("cpu", cap=256, n_live=180)
    kw = dict(kw, mode="int8")
    _, (jx, jy, jz), dmax = advance_plain(p, ft, live_watermark(p.w), **kw)
    fused_epilogue((jx, jy, jz), dmax, p.w, **kw)
    with pytest.raises(ValueError, match="integers"):
        fused_epilogue((jx * 1.1, jy, jz), dmax, p.w, **kw)


@pytest.mark.parametrize("dim", [-1, -2])
def test_running_sum_adds_in_order(dim):
    """running_sum adds left to right in the tensor's type: 1 + 2^-24 +
    2^-24 rounds to 1 twice in float32, while a sum in double would keep
    2^-23."""
    a = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -24],
                      [0.5, 0.25, -0.75], [3.0, -0.0, 1.0]])
    a = a if dim == -1 else a.t().contiguous()
    got = running_sum(a, dim)
    want = [[1.0, 1.0, 1.0], [0.5, 0.75, 0.0], [3.0, 3.0, 4.0]]
    assert (got if dim == -1 else got.t()).tolist() == want


@pytest.mark.parametrize("mode", ["int8", "f32", "f64"])
def test_fused_push_deposit_on_the_cpu_is_the_plain_sequence(mode):
    """On the CPU fused_push_deposit is advance_plain over the live
    watermark and the torch epilogue, bit for bit, and counts no fused
    epilogue and no f64 products (the counters count the card's
    launches)."""
    dtype = torch.float64 if mode == "f64" else torch.float32
    p, ft, kw = edge_case_buckets("cpu", cap=256, n_live=180, dtype=dtype,
                                  graded=True)
    trace.drain()
    trace.enable()
    try:
        out, js, d = fused_push_deposit(p, ft, mode=mode, **kw)
    finally:
        trace.disable()
    _, counters = trace.drain()
    assert "advance.fused_epilogue" not in counters
    assert "advance.f64_products" not in counters
    raw_out, raw_js, raw_d = advance_plain(p, ft, live_watermark(p.w),
                                           mode=mode, **kw)
    want_js, want_d = torch_epilogue(raw_js, raw_d, p.w, q=kw["q"],
                                     mode=mode)
    for a, b in zip(out, tuple(raw_out) + (p.w,)):
        assert torch.equal(a, b)
    for a, b in zip(js, want_js):
        assert torch.equal(a, b)
    assert torch.equal(d, want_d)


@pytest.mark.parametrize("mode", ["int8", "f32", "f64"])
def test_the_torch_epilogue_runs_twelve_operations_in_int8_eight_else(mode):
    """What the card's fused launch takes off the step: the watermark's
    five torch operations over the buckets and the epilogue's seven (int8:
    max(w), its product with q, the two scales, the two prefix sums, the
    displacement's max) or three, each a kernel launch on the card."""
    from minipic_torch.testing import torch_ops

    dtype = torch.float64 if mode == "f64" else torch.float32
    p, ft, kw = edge_case_buckets("cpu", cap=64, n_live=40, dtype=dtype)
    _, js, d = advance_plain(p, ft, live_watermark(p.w), mode=mode, **kw)
    _, wm = torch_ops(lambda: live_watermark(p.w), "cpu")
    _, ep = torch_ops(lambda: torch_epilogue(js, d, p.w, q=-1.0, mode=mode),
                      "cpu")
    assert wm == ["arange", "gt", "_to_copy", "mul", "amax"]
    assert ep == (["max", "mul", "mul", "mul"] if mode == "int8" else []) \
        + ["cumsum", "cumsum", "max"]
