"""The index arithmetic of the extract and row-append kernels
(csrc/rebin.cu ``extract_kernel``, ``append_rows_kernel``), emulated in
numpy step by step and held slot for slot to the plain versions.

The kernels run only on a card; these emulations follow their
decomposition so that the CPU can check it:

* extract: each warp ballots the mover predicate of its own run of 32-slot
  words, writes w as if the tile extracts, and sums its popcounts; one
  block phase gives the tile's total, each warp's offset and the two
  watermark maxima; a mover's rank is offset + popc(word & lanes below);
  a tile that does not extract puts w back at its mover slots.
* row append: the runs' live counts (per warp for one run, per run
  otherwise), their sum, and the flat copy in which thread i walks a run
  cursor forward to find the run and index of arrival i.

Outputs start as NaN, as ``torch.empty`` may, so a slot the emulation
never writes fails the comparison.  The block sizes are read from the
source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in parallel worker processes, and
# their OpenMP threads oversubscribing the cores slow a step ~85x.
torch.set_num_threads(1)

from minipic_torch.core.state import ParticleState  # noqa: E402
from minipic_torch.ops import rebin as rb  # noqa: E402

SOURCE = (Path(__file__).resolve().parent.parent / "minipic_torch" / "csrc"
          / "rebin.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


EXTRACT_WARPS = _const("kExtractThreads") // 32
COPY_WORDS = _const("kCopyWords")
APPEND_THREADS = _const("kAppendRowsThreads")
T, NX = 16, 32
GRID = dict(tile_cols=4, tile_ny=8, tile_nx=8)


def test_python_sizes_match_the_source():
    assert rb.MAX_RUNS == _const("kMaxRuns")
    assert rb._EXTRACT_RED == _const("kExtractRed") == 3 * 32
    assert EXTRACT_WARPS <= 32 and APPEND_THREADS % 32 == 0
    assert rb.extract_smem_bytes(27136) == 4 * (848 + 96)
    assert rb.extract_smem_bytes(1000) == 4 * (32 + 96)


def _state(cap=1536, n_live=1000, sigma=0.9, seed=0, holes=0.0, empty=()):
    """Live-compacted buckets of n_live particles displaced by N(0, sigma)
    cells off their 8x8 tiles on a 32^2 periodic grid; `holes` of the live
    slots get w = 0; the tiles in `empty` hold no live slot."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    f32 = np.float32

    def pos(origin):
        v = (origin + rng.random((T, cap)) * 8
             + rng.normal(0.0, sigma, (T, cap))).astype(f32)
        v = np.mod(v, f32(NX)).astype(f32)
        return np.where(v >= NX, v - f32(NX), v).astype(f32)

    live = np.broadcast_to(np.arange(cap)[None, :] < n_live, (T, cap)).copy()
    live[list(empty)] = False
    chans = [pos((t % 4) * 8), pos((t // 4) * 8)]
    chans += [rng.normal(0.0, 0.1, (T, cap)).astype(f32) for _ in range(3)]
    chans.append(np.full((T, cap), 0.004, f32))
    chans = [np.where(live, c, f32(0)) for c in chans]
    if holes:
        chans[5] = np.where(rng.random((T, cap)) < holes, f32(0), chans[5])
    return chans


def _popc(a):
    a = np.asarray(a, dtype=np.uint32).reshape(-1)
    return np.unpackbits(a.astype(">u4").view(np.uint8)).reshape(
        -1, 32).sum(1).astype(np.int64)


def _ballot(pred):
    """The 32-slot words of a [cap] predicate, the last word ragged."""
    nw = -(-pred.size // 32)
    bits = np.zeros(nw * 32, np.uint64)
    bits[:pred.size] = pred
    lanes = np.arange(32, dtype=np.uint64)
    return (bits.reshape(nw, 32) << lanes).sum(1).astype(np.uint32)


def _emulate_extract(chans, *, tile_cols, tile_ny, tile_nx, b_cap, force):
    x, y, w = chans[0], chans[1], chans[5]
    Tn, cap = x.shape
    kc = rb.extract_chunk(cap, b_cap)
    fit_cap = (b_cap // kc) * kc
    inv_nx, inv_ny = np.float32(1.0 / tile_nx), np.float32(1.0 / tile_ny)
    nw = -(-cap // 32)
    per = -(-nw // EXTRACT_WARPS)
    below = (np.uint32(1) << np.arange(32, dtype=np.uint32)) - np.uint32(1)
    w_out = np.full((Tn, cap), np.nan, np.float32)
    mov = np.full((6, Tn, b_cap), np.nan, np.float32)
    wm = np.zeros(Tn, np.int32)
    pending = np.zeros(Tn, np.int32)
    for t in range(Tn):
        row, col = np.float32(t // tile_cols), np.float32(t % tile_cols)
        # 1. Each warp's words: ballots, optimistic w, popcounts, maxima.
        live = w[t] > 0
        mv = live & ((np.floor(x[t] * inv_nx) != col)
                     | (np.floor(y[t] * inv_ny) != row))
        bits = _ballot(mv)
        w_out[t] = np.where(mv, np.float32(0), w[t])
        red = np.zeros((3, EXTRACT_WARPS), np.int64)
        spans = []
        for v in range(EXTRACT_WARPS):
            j0 = min(v * per, nw)
            j1 = min(j0 + per, nw)
            spans.append((j0, j1))
            s = np.arange(j0 * 32, min(j1 * 32, cap))
            red[0, v] = _popc(bits[j0:j1]).sum()
            red[1, v] = (s[live[s] & ~mv[s]] + 1).max(initial=0)
            red[2, v] = (s[live[s]] + 1).max(initial=0)
        # 2. The block phase.
        total = int(red[0].sum())
        before = np.concatenate([[0], np.cumsum(red[0])[:-1]])
        extract = total <= fit_cap or force
        kept = min(total, b_cap) if extract else 0
        # 3. Ranks from the words, or w put back.
        for v, (j0, j1) in enumerate(spans):
            if not extract:
                for j in range(j0, j1):
                    lanes = np.flatnonzero((bits[j] >> np.arange(32)) & 1)
                    w_out[t, j * 32 + lanes] = w[t, j * 32 + lanes]
                continue
            run = int(before[v])
            for j in range(j0, j1, COPY_WORDS):
                if run >= b_cap:
                    break
                for u in range(COPY_WORDS):
                    word = bits[j + u] if j + u < j1 else np.uint32(0)
                    lanes = np.flatnonzero((word >> np.arange(32)) & 1)
                    rank = run + _popc(word & below[lanes])
                    ok = rank < b_cap
                    for c in range(6):
                        mov[c, t, rank[ok]] = chans[c][t, (j + u) * 32
                                                       + lanes[ok]]
                    run += int(_popc(word)[0])
        mov[:, t, kept:] = 0
        wm[t] = red[1].max() if extract else red[2].max()
        pending[t] = total - kept
    return w_out, mov, wm, pending


EXTRACT_CASES = {
    # name: (state kwargs, b_cap, force)
    "normal": (dict(), 512, False),
    "pending": (dict(n_live=1400, sigma=2.0), 512, False),
    "forced": (dict(n_live=1400, sigma=2.0), 512, True),
    "holes": (dict(holes=0.25), 512, False),
    "ragged cap": (dict(cap=1000, n_live=900), 1000, False),
    "ragged cap forced": (dict(cap=1000, n_live=900, sigma=2.0), 256, True),
    # kc 256: a tile extracts when its movers fit 512 of the 640 slots;
    # forced, it keeps up to 640.
    "b_cap % kc": (dict(n_live=1400, sigma=2.0), 640, False),
    "b_cap % kc forced": (dict(n_live=1400, sigma=2.4), 640, True),
    "empty tiles": (dict(empty=(0, 5, 15)), 512, False),
    "fewer words than warps": (dict(cap=200, n_live=150, sigma=1.5), 200,
                               False),
}


@pytest.mark.parametrize("case", list(EXTRACT_CASES))
def test_extract_decomposition_matches_plain(case):
    kwargs, b_cap, force = EXTRACT_CASES[case]
    chans = _state(seed=len(case), **kwargs)
    p = ParticleState(*(torch.tensor(c) for c in chans))
    want = rb.extract_movers_plain(p, **GRID, b_cap=b_cap, force=force)
    w_out, mov, wm, pending = _emulate_extract(chans, **GRID, b_cap=b_cap,
                                               force=force)
    np.testing.assert_array_equal(w_out, want[0].w.numpy())
    for c, name in enumerate(ParticleState._fields):
        np.testing.assert_array_equal(mov[c], want[1][c].numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(wm, want[2].numpy())
    np.testing.assert_array_equal(pending, want[3].numpy())
    # Each case reaches what it is named for.
    cap = chans[0].shape[1]
    n_out = int((want[1].w > 0).sum())
    n_pend = int(want[3].sum())
    assert n_out > 0 or case == "pending"
    assert (n_pend > 0) == (case in ("pending", "forced", "b_cap % kc",
                                     "ragged cap forced"))
    if case.startswith("ragged"):
        assert cap % 32
    if case == "b_cap % kc forced":
        assert int((want[1].w > 0).sum(1).max()) > 512
    if case == "empty tiles":
        assert int(want[2][5]) == 0 and not bool(want[1].w[5].any())
    if case == "fewer words than warps":
        assert -(-cap // 32) < EXTRACT_WARPS


def _emulate_append(chans, inc, wm, runs, b_run):
    """append_rows_kernel on numpy rows: counts, their sum, the flat copy."""
    Tn, cap = chans[0].shape
    nwarps = APPEND_THREADS // 32
    out = [c.copy() for c in chans]
    dropped = np.zeros(Tn, np.int32)
    for t in range(Tn):
        live = inc[5][t] > 0
        if runs == 1:
            # Thread i counts slots i, i + APPEND_THREADS, ...; warp v sums
            # its 32 threads.
            thread = np.arange(b_run) % APPEND_THREADS
            cnt = [int(live[(thread // 32) == v].sum())
                   for v in range(nwarps)]
        else:
            cnt = [int(live[r * b_run:(r + 1) * b_run].sum())
                   for r in range(runs)]
        n_in = sum(cnt)
        if wm[t] + n_in > cap:
            dropped[t] = n_in
            continue
        for tid in range(APPEND_THREADS):
            r, off = 0, 0
            end = n_in if runs == 1 else cnt[0]
            for i in range(tid, n_in, APPEND_THREADS):
                while i >= end:
                    off = end
                    r += 1
                    end += cnt[r]
                for c in range(6):
                    out[c][t, wm[t] + i] = inc[c][t, r * b_run + i - off]
    return out, dropped


def _runs(runs, b_run, n, seed, full=(), empty=()):
    """Each tile's incoming row of `runs` live-compacted runs of b_run
    slots, run r of tile t holding n[t, r] arrivals (all b_run for the runs
    in `full`, none for those in `empty`), the dead tail zero."""
    rng = np.random.default_rng(seed)
    n = n.copy()
    n[:, list(full)] = b_run
    n[:, list(empty)] = 0
    live = np.arange(b_run)[None, None, :] < n[:, :, None]
    chans = [rng.random((T, runs, b_run)).astype(np.float32) * 32
             for _ in range(5)]
    chans.append(np.full((T, runs, b_run), 0.004, np.float32))
    return [np.where(live, c, np.float32(0)).reshape(T, runs * b_run)
            for c in chans]


APPEND_CASES = {
    # name: (runs, b_run, full runs, empty runs, tiles that do not fit)
    "one run": (1, 640, (), (), ()),
    "one run, short row": (1, 100, (), (), ()),
    "eight runs": (8, 96, (), (), ()),
    "eight runs, some empty": (8, 96, (), (0, 3, 4, 7), ()),
    "eight runs, all full": (8, 96, tuple(range(8)), (), ()),
    "eight runs, tiles not fitting": (8, 96, (), (2,), (1, 6, 11)),
    "three runs": (3, 200, (1,), (2,), (4,)),
    "one run, tiles not fitting": (1, 640, (), (), (0, 9)),
}


@pytest.mark.parametrize("case", list(APPEND_CASES))
def test_row_append_flat_copy_matches_plain(case):
    runs, b_run, full, empty, crowded = APPEND_CASES[case]
    rng = np.random.default_rng(len(case))
    cap = 2048
    n = rng.integers(0, b_run + 1, (T, runs))
    inc = _runs(runs, b_run, n, len(case) + 1, full, empty)
    chans = _state(cap=cap, n_live=700, seed=3)
    n_in = (inc[5] > 0).sum(1)
    wm = (chans[5] > 0).sum(1).astype(np.int32)
    wm[list(crowded)] = cap - n_in[list(crowded)] + 1
    got, dropped = _emulate_append(chans, inc, wm, runs, b_run)
    p = ParticleState(*(torch.tensor(c) for c in chans))
    pi = ParticleState(*(torch.tensor(c) for c in inc))
    wt = torch.tensor(wm)
    if runs == 1:
        want, want_d = rb.append_incoming_plain(p, pi, wt)
    else:
        want, want_d = rb.append_runs_plain(p, pi, wt, b_seg=b_run)
    for c, name in enumerate(ParticleState._fields):
        np.testing.assert_array_equal(got[c], want[c].numpy(), err_msg=name)
    np.testing.assert_array_equal(dropped, want_d.numpy())
    assert (dropped > 0).sum() == len(crowded)
    assert int(n_in.sum()) > 0


def test_wrappers_raise_past_the_kernels_sizes():
    """An extract bucket whose ballot words pass a block's shared memory,
    and a row of more runs than the kernel takes, raise before anything is
    built or launched; the largest bucket that fits is accepted that far."""
    n0 = {k: v.launches for k, v in rb.KERNELS.items()}
    words = (rb.SMEM_LIMIT // 4 - rb._EXTRACT_RED)
    too_big = ParticleState(*(torch.empty((4, 32 * words + 1), device="meta")
                              for _ in range(6)))
    with pytest.raises(ValueError, match="ballot words"):
        rb.extract_kernel(too_big, **GRID, b_cap=512)
    assert rb.extract_smem_bytes(32 * words) == rb.SMEM_LIMIT
    p = ParticleState(*(torch.zeros(T, 256) for _ in range(6)))
    inc = ParticleState(*(torch.zeros(T, 65 * 4) for _ in range(6)))
    with pytest.raises(ValueError, match="at most 64"):
        rb.append_runs_kernel(p, inc, torch.zeros(T, dtype=torch.int32),
                              b_seg=4)
    assert {k: v.launches for k, v in rb.KERNELS.items()} == n0
