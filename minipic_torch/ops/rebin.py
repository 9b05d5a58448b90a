"""The incremental re-bin kernels: split, segment, append, defrag,
append_incoming, append_runs and extract.

Port of ``minipic_tpu.ops.pallas.rebin_kernels`` (``split_buckets``,
``segment_movers``, ``append_segments``, ``defrag_buckets``,
``append_incoming``, ``append_runs``, ``extract_movers``).  Each has two
implementations of one function:

* a CUDA kernel in ``csrc/rebin.cu``, launched for CUDA tensors;
* a plain torch version (``*_plain``), vectorised over tiles with cumsum
  ranks and scatters.  The wrappers take it only for CPU tensors;
  ``chip_smoke.py`` holds each kernel against it on the card.

The payload moves by pure copies, so both are bit-equal to each other and,
slot for slot, to the JAX package's interpreted kernels, dead slots
included (the JAX kernels zero everything past each run or count).  What
each computes, per tile ``t``.  A tile's row and column are GLOBAL, as the
JAX kernels' ``_tile_rc``: tile t of a row-major block of ``tile_cols``
columns whose first tile is ``(row0, col0)`` of the global grid (the whole
grid on one device, a shard's block under ``parallel.step``), or, given
``tile_ids``, the tile whose global id is ``tile_ids[t]`` (``tile_cols``
then counts the global grid's columns: a shard's striped tiles under
``parallel.balanced``).

* **split** — a live slot whose ``floor(x * (1/tile_nx))`` or
  ``floor(y * (1/tile_ny))`` is not the tile's column or row (in the
  channels' type: f32 as the JAX kernel, f64 on a float64 state) is a
  mover.  If the tile's movers fit the ``b_cap`` buffer, or
  ``force`` is set, they go to it and the stayers are compacted in slot
  order; otherwise the tile defers (all its live slots stay, compacted, and
  its movers count as pending).  Buffer order is the JAX kernel's: ``kc``
  slot chunks in order, movers within a chunk in REVERSE slot order.  A
  forced tile keeps the first ``b_cap`` movers in that order and counts the
  rest.  Returns the buckets (zero past the stay count), the movers (zero
  past the kept count), the stay count (the new watermark) and the pending
  count, int32 ``[T]``.
* **segment** — each mover goes to the run of its destination direction d
  (``DIR_OFFSETS``, the tile delta folded on the periodic global grid
  ``grid_rows`` x ``grid_cols``, by default the block's own) in stable buffer
  order; a run keeps its first ``b_seg`` movers and counts the rest.  A
  mover more than one tile from home is killed and counted.  (The JAX
  kernel flushes a run's tail only when a whole ``kc`` block still fits,
  so at ``b_seg % kc != 0`` it drops movers that fit; the port does not.)
* **append** — the eight arrival runs ``seg[nbr[t, d], d]`` (each
  live-compacted: its length is its count of ``w > 0``) are written in
  direction order at ``[wm, wm + n_in)``.  A tile whose arrivals do not fit
  its bucket takes none and counts them.
* **append_runs** — the append with the runs read from the tile's own
  incoming row ``[T, runs * b_seg]`` (run r at offset ``r * b_seg``): the
  unfused deal route, after ``roll_segments``.
* **append_incoming** — append_runs with one run: the tile's own
  live-compacted incoming row ``[T, b_in]`` from the sort route.
* **defrag** — the live slots of the bucket and then of the arrivals (the
  eight runs, or one dense incoming row), in that order, are compacted to
  the front; ``min(census, cap)`` are kept and the rest counted; the tail
  is zeroed.
* **extract** — the extract-only split of ``rebin_incremental``: movers as
  in the split, all or nothing per tile (a tile extracts when its movers
  fit ``(b_cap // kc) * kc`` slots, or ``force``).  The input comes back
  with only ``w`` replaced (a leaver's w is 0; stayers are not compacted),
  the movers go to the buffer in FORWARD slot order, the first ``b_cap``
  kept, and the watermark is 1 + the last live stayer's slot.  The fourth
  output is the movers not kept: dropped for a tile that extracted, its
  whole mover count (pending) for one that did not.

The three appends all take a tile's arrivals when ``wm + n_in <= cap``: the
JAX kernels ask for ``cap - 128``, slack for the TPU's 128-lane slab anchor
that a GPU copy does not need (ROADMAP C).

The appends and the defrag work in place on the buckets the split returned
and take a 0-d ``active`` flag from device memory: ``rebin_auto`` launches
an append and the defrag together, and each returns at once unless its
branch was chosen, so the choice costs no host read.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.state import ParticleState
from .advance import _SMEM_LIMIT as SMEM_LIMIT, _check

# Deal-route direction order: d = (dr+1)*3 + (dc+1) with self (0, 0)
# removed; DIR_OFFSETS[d] = (dr, dc) of the destination tile relative to the
# source tile.
DIR_OFFSETS = tuple(
    (dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr, dc) != (0, 0))


def split_chunk(cap: int, b_cap: int) -> int:
    """The JAX split's slot chunk (rebin_kernels.py:678-686): 512 when it
    divides the bucket and fits the buffer, else the largest of 512, 384,
    256, 128 that does, else the whole bucket."""
    if cap % 512 == 0 and 512 <= b_cap:
        return 512
    for d in (512, 384, 256, 128):
        if cap % d == 0 and d <= b_cap:
            return d
    return cap


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant rounded once to `like`'s dtype, as the kernels'
    constant is."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _tile_rc(num_tiles: int, tile_cols: int, device, row0: int = 0,
            col0: int = 0, tile_ids: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.float32):
    """([T, 1], [T, 1]) global row and column of each tile in `dtype` (see
    the module docstring)."""
    if tile_ids is not None:
        t = tile_ids.to(device=device, dtype=torch.int64)
        rows, cols = t // tile_cols, t % tile_cols
    else:
        t = torch.arange(num_tiles, device=device)
        rows, cols = row0 + t // tile_cols, col0 + t % tile_cols
    return rows.to(dtype)[:, None], cols.to(dtype)[:, None]


def _scatter_rows(src: ParticleState, mask: torch.Tensor, dest: torch.Tensor,
                  width: int, base: Optional[ParticleState] = None
                  ) -> ParticleState:
    """Rows of `width` slots per tile holding src[t, s] at dest[t, s] where
    mask; every other slot is zero, or `base`'s slot when given."""
    T = src.x.shape[0]
    rows = torch.arange(T, device=src.x.device)
    rows = rows.reshape((T,) + (1,) * (dest.dim() - 1))
    idx = torch.where(mask, rows * width + dest,
                      torch.full_like(dest, T * width)).reshape(-1)
    outs = []
    for i, a in enumerate(src):
        out = torch.zeros(T * width + 1, dtype=a.dtype, device=a.device)
        if base is not None:
            out[:-1] = base[i].reshape(-1)
        # Every masked destination is unique; the unmasked ones all land on
        # the spare last slot, which is cut off.
        out.scatter_(0, idx, a.reshape(-1))
        outs.append(out[:-1].reshape(T, width))
    return ParticleState(*outs)


# ----------------------------------------------------------------------
# Plain torch versions.


def _away(p: ParticleState, tile_cols: int, tile_ny: int, tile_nx: int,
          row0: int = 0, col0: int = 0, tile_ids=None):
    """Live slots whose floor(pos * (1/tile)) is not their tile's cell."""
    rows, cols = _tile_rc(p.x.shape[0], tile_cols, p.x.device, row0, col0,
                          tile_ids, p.x.dtype)
    col = torch.floor(p.x * _const(1.0 / tile_nx, p.x))
    row = torch.floor(p.y * _const(1.0 / tile_ny, p.y))
    return (p.w > 0) & ((col != cols) | (row != rows))


def split_buckets_plain(p: ParticleState, *, tile_cols: int, tile_ny: int,
                        tile_nx: int, b_cap: int, force=False, row0: int = 0,
                        col0: int = 0, tile_ids=None):
    """Plain version of the split (see the module docstring).  `force` is a
    bool or a 0-d bool tensor.  Returns (buckets, movers [T, b_cap], stay
    count [T], pending [T])."""
    T, cap = p.x.shape
    kc = split_chunk(cap, b_cap)
    i32 = torch.int32
    mov = _away(p, tile_cols, tile_ny, tile_nx, row0, col0, tile_ids)
    total = mov.sum(1, dtype=i32)
    extract = (total <= b_cap) | torch.as_tensor(force, device=p.x.device)
    mov = mov & extract[:, None]
    stay = (p.w > 0) & ~mov
    srank = torch.cumsum(stay, 1, dtype=i32)
    buckets = _scatter_rows(p, stay, srank - 1, cap)
    # Buffer position of a mover: movers of earlier kc chunks, then its
    # chunk's movers in reverse slot order.
    inc = torch.cumsum(mov, 1, dtype=i32).reshape(T, cap // kc, kc)
    ends = inc[:, :, -1:]
    before = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    pos = (before + ends - inc).reshape(T, cap)
    keep = mov & (pos < b_cap)
    movers = _scatter_rows(p, keep, pos, b_cap)
    kept = torch.clamp(total, max=b_cap)
    pending = torch.where(extract, total - kept, total)
    return buckets, movers, srank[:, -1].contiguous(), pending


def segment_movers_plain(movers: ParticleState, *, tile_rows: int,
                         tile_cols: int, tile_ny: int, tile_nx: int,
                         b_seg: int, row0: int = 0, col0: int = 0,
                         grid_rows: Optional[int] = None,
                         grid_cols: Optional[int] = None):
    """Plain version of the segment (see the module docstring).  Returns
    (segments [T, 8*b_seg], dropped [T]: run overflow plus >1-hop kills)."""
    T = movers.x.shape[0]
    i32 = torch.int32
    gr = tile_rows if grid_rows is None else grid_rows
    gc = tile_cols if grid_cols is None else grid_cols
    rows, cols = _tile_rc(T, tile_cols, movers.x.device, row0, col0,
                          dtype=movers.x.dtype)
    dc = torch.floor(movers.x * _const(1.0 / tile_nx, movers.x)) - cols
    dr = torch.floor(movers.y * _const(1.0 / tile_ny, movers.y)) - rows
    dc = torch.where(dc > 1.5, dc - gc, torch.where(dc < -1.5, dc + gc, dc))
    dr = torch.where(dr > 1.5, dr - gr, torch.where(dr < -1.5, dr + gr, dr))
    hop1 = (dc.abs() <= 1.5) & (dr.abs() <= 1.5)
    zero = torch.zeros_like(dc)
    d9 = ((torch.where(hop1, dr, zero).to(i32) + 1) * 3
          + torch.where(hop1, dc, zero).to(i32) + 1)
    alive = movers.w > 0
    mov = alive & hop1 & (d9 != 4)
    d8 = d9 - (d9 > 4).to(i32)
    dest = torch.full_like(d8, -1)
    dropped = (alive & ~hop1).sum(1, dtype=i32)
    for d in range(8):
        m = mov & (d8 == d)
        rank = torch.cumsum(m, 1, dtype=i32) - 1
        dest = torch.where(m & (rank < b_seg), d * b_seg + rank, dest)
        dropped = dropped + torch.clamp(rank[:, -1] + 1 - b_seg, min=0)
    return _scatter_rows(movers, dest >= 0, dest, 8 * b_seg), dropped


def roll_segments(seg: ParticleState, nbr: torch.Tensor,
                  b_seg: int) -> ParticleState:
    """Arrivals [T, 8*b_seg]: run d of tile t is run d of tile nbr[t, d]
    (the JAX package's ``_roll_segments``, as a gather)."""
    T = seg.x.shape[0]
    dirs = torch.arange(8, device=nbr.device)[None, :]
    return ParticleState(*(a.reshape(T, 8, b_seg)[nbr.long(), dirs]
                           .reshape(T, 8 * b_seg) for a in seg))


def seg_arrival_counts(seg: ParticleState, nbr: torch.Tensor,
                       b_seg: int) -> torch.Tensor:
    """Arrivals per tile: the live slots of run d of tile nbr[t, d], summed
    over d (int32 [T])."""
    T = seg.w.shape[0]
    cnt = (seg.w.reshape(T, 8, b_seg) > 0).sum(2, dtype=torch.int32)
    dirs = torch.arange(8, device=nbr.device)[None, :]
    return cnt[nbr.long(), dirs].sum(1, dtype=torch.int32)


def append_runs_plain(p: ParticleState, inc: ParticleState,
                      wm: torch.Tensor, *, b_seg: int):
    """Plain version of append_runs (see the module docstring), out of
    place: the runs of `b_seg` slots of each tile's own row `inc`.
    Returns (buckets, dropped [T])."""
    T, cap = p.x.shape
    runs = inc.x.shape[1] // b_seg
    n_r = (inc.w.reshape(T, runs, b_seg) > 0).sum(2, dtype=torch.int32)
    off = torch.cumsum(n_r, 1, dtype=torch.int32) - n_r
    n_in = n_r.sum(1, dtype=torch.int32)
    fits = wm + n_in <= cap
    i = torch.arange(b_seg, device=p.x.device, dtype=torch.int32)
    valid = (i < n_r[:, :, None]) & fits[:, None, None]
    dest = wm[:, None, None] + off[:, :, None] + i
    out = _scatter_rows(ParticleState(*(a.reshape(T, runs, b_seg)
                                        for a in inc)),
                        valid, dest, cap, base=p)
    return out, torch.where(fits, torch.zeros_like(n_in), n_in)


def append_incoming_plain(p: ParticleState, inc: ParticleState,
                          wm: torch.Tensor):
    """Plain version of append_incoming: append_runs with one run of the
    row's width.  Returns (buckets, dropped [T])."""
    return append_runs_plain(p, inc, wm, b_seg=inc.x.shape[1])


def append_segments_plain(p: ParticleState, seg: ParticleState,
                          wm: torch.Tensor, nbr: torch.Tensor, *,
                          b_seg: int):
    """Plain version of the append (see the module docstring), out of
    place.  Returns (buckets, dropped [T])."""
    return append_runs_plain(p, roll_segments(seg, nbr, b_seg), wm,
                             b_seg=b_seg)


def defrag_buckets_plain(p: ParticleState,
                         incoming: Optional[ParticleState] = None):
    """Plain version of the defrag (see the module docstring), out of place;
    `incoming` [T, b_in] is merged after the bucket's own live slots.
    Returns (buckets, counts [T], dropped [T])."""
    T, cap = p.x.shape
    a = p if incoming is None else ParticleState(
        *(torch.cat([u, v], 1) for u, v in zip(p, incoming)))
    live = a.w > 0
    rank = torch.cumsum(live, 1, dtype=torch.int32) - 1
    out = _scatter_rows(a, live & (rank < cap), rank, cap)
    census = rank[:, -1] + 1
    counts = torch.clamp(census, max=cap)
    return out, counts, census - counts


def extract_chunk(cap: int, b_cap: int) -> int:
    """The JAX extract's slot chunk (rebin_kernels.py:356-362): 256 unless
    it does not divide the bucket or exceeds the buffer, then the first of
    128, 256, 384, 512 that does both, else the whole bucket.  It sets only
    the all-or-nothing rule: a tile extracts when its movers fit
    (b_cap // kc) * kc slots."""
    kc = 256
    if cap % kc or kc > b_cap:
        for d in (128, 256, 384, 512):
            if cap % d == 0 and d <= b_cap:
                return d
        return cap
    return kc


# The kernels' fixed sizes (csrc/rebin.cu): the row append takes at most
# kMaxRuns runs; an extract block keeps one ballot word per 32 slots of its
# bucket, and kExtractRed per-warp totals, in shared memory.
MAX_RUNS = 64
_EXTRACT_RED = 96


def extract_smem_bytes(cap: int) -> int:
    """Shared memory of one extract block for buckets of `cap` slots: the
    mover ballot words and the per-warp totals (csrc/rebin.cu
    extract_smem_bytes)."""
    return 4 * (-(-cap // 32) + _EXTRACT_RED)


def extract_movers_plain(p: ParticleState, *, tile_cols: int, tile_ny: int,
                         tile_nx: int, b_cap: int, force=False):
    """Plain version of the extract (see the module docstring).  Returns
    (p with w replaced, movers [T, b_cap], watermark [T], not kept [T])."""
    T, cap = p.x.shape
    i32 = torch.int32
    mov = _away(p, tile_cols, tile_ny, tile_nx)
    total = mov.sum(1, dtype=i32)
    kc = extract_chunk(cap, b_cap)
    extract = ((total <= (b_cap // kc) * kc)
               | torch.as_tensor(force, device=p.x.device))
    mov = mov & extract[:, None]
    w = torch.where(mov, torch.zeros_like(p.w), p.w)
    slot = torch.arange(1, cap + 1, device=p.x.device, dtype=i32)
    wm = torch.where((p.w > 0) & ~mov, slot, 0).amax(1).to(i32)
    rank = torch.cumsum(mov, 1, dtype=i32) - 1
    movers = _scatter_rows(p, mov & (rank < b_cap), rank, b_cap)
    kept = torch.where(extract, torch.clamp(total, max=b_cap),
                       torch.zeros_like(total))
    return p._replace(w=w), movers, wm, total - kept


# ----------------------------------------------------------------------
# CUDA kernels.


class Channels(ctypes.Structure):
    """Mirror of ``struct Channels`` in csrc/rebin.cu: six channel pointers
    (x, y, px, py, pz, w), passed by value; the entry point's first
    argument says whether they are float32 or float64."""

    _fields_ = [("c", ctypes.c_void_p * 6)]


def _channels(p: ParticleState) -> Channels:
    return Channels((ctypes.c_void_p * 6)(*(a.data_ptr() for a in p)))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import build

        lib = ctypes.CDLL(str(build("rebin.cu").path))
        # Each entry point takes `f64` (int) first; inverse tile sizes are
        # doubles, rounded to the channels' type in the kernel.
        ci, cd, vp = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
        lib.minipic_split.argtypes = ([ci] * 8 + [vp, cd, cd, Channels, vp,
                                                  Channels, Channels]
                                      + [vp] * 3)
        lib.minipic_segment.argtypes = ([ci] * 9 + [cd, cd, Channels,
                                                    Channels] + [vp] * 2)
        lib.minipic_append.argtypes = ([ci] * 4 + [vp] * 3
                                       + [Channels, Channels] + [vp] * 3)
        lib.minipic_defrag.argtypes = ([ci] * 4 + [vp] * 2
                                       + [Channels, Channels] + [vp] * 4)
        lib.minipic_append_rows.argtypes = ([ci] * 5 + [vp] * 2
                                            + [Channels, Channels]
                                            + [vp] * 3)
        lib.minipic_extract.argtypes = ([ci] * 6 + [cd, cd, Channels]
                                        + [vp] * 2 + [Channels] + [vp] * 3)
        for fn in (lib.minipic_split, lib.minipic_segment,
                   lib.minipic_append, lib.minipic_defrag,
                   lib.minipic_append_rows, lib.minipic_extract):
            fn.restype = ci
        _LIB = lib
    return _LIB


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _flag(v, dev) -> torch.Tensor:
    """A bool or 0-d bool tensor as a 0-d bool tensor on `dev`, made
    without a host transfer."""
    if isinstance(v, torch.Tensor):
        _check(v, "flag", torch.bool, (), dev)
        return v
    return torch.full((), bool(v), dtype=torch.bool, device=dev)


# The channel types the kernels are built for, and each one's `f64` flag.
_F64 = {torch.float32: 0, torch.float64: 1}


def _check_p(p: ParticleState, what: str, shape, dev,
             dtype: torch.dtype) -> None:
    for name, a in zip(ParticleState._fields, p):
        _check(a, f"{what}.{name}", dtype, shape, dev)


def _real(p: ParticleState) -> torch.dtype:
    """The channels' type, which every other state of the call shares."""
    if p.x.dtype not in _F64:
        raise ValueError(f"particles of {p.x.dtype}: the re-bin kernels take "
                         "float32 or float64")
    return p.x.dtype


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


class _Kernel:
    """Base of the launchers: ``launches`` counts kernel launches.  The
    appends and the defrag also count on the device, in ``taken``, the
    launches whose ``active`` flag was set (read with ``taken_count``)."""

    def __init__(self):
        self.launches = 0
        self.taken: Optional[torch.Tensor] = None

    def _taken(self, dev) -> torch.Tensor:
        if self.taken is None or self.taken.device != dev:
            self.taken = torch.zeros(1, dtype=torch.int32, device=dev)
        return self.taken

    def taken_count(self) -> int:
        return 0 if self.taken is None else int(self.taken[0])

    def reset(self) -> None:
        self.launches = 0
        if self.taken is not None:
            self.taken.zero_()


class SplitKernel(_Kernel):
    def __call__(self, p: ParticleState, *, tile_cols: int, tile_ny: int,
                 tile_nx: int, b_cap: int, force=False, row0: int = 0,
                 col0: int = 0, tile_ids: Optional[torch.Tensor] = None):
        T, cap = p.x.shape
        dev, real = p.x.device, _real(p)
        _check_p(p, "p", (T, cap), dev, real)
        kc = split_chunk(cap, b_cap)
        if kc > 1024 or kc % 32:
            raise ValueError(f"split chunk {kc} (bucket {cap}, buffer "
                             f"{b_cap}) is not a block size of the kernel")
        if tile_ids is not None:
            _check(tile_ids, "tile_ids", torch.int32, (T,), dev)
        elif T % tile_cols:
            raise ValueError(f"{T} tiles not a multiple of {tile_cols} cols")
        force = _flag(force, dev)
        lib = _lib()
        # The buckets are six allocations: the next advance replaces all
        # channels but w, which must not pin the other five.
        out = ParticleState(*(torch.empty((T, cap), dtype=real, device=dev)
                              for _ in range(6)))
        mbuf = torch.empty((6, T, b_cap), dtype=real, device=dev)
        movers = ParticleState(*mbuf)
        stay = torch.empty(T, dtype=torch.int32, device=dev)
        pending = torch.empty(T, dtype=torch.int32, device=dev)
        _launched(lib.minipic_split(
            _F64[real], T, cap, b_cap, kc, tile_cols, row0, col0,
            None if tile_ids is None else tile_ids.data_ptr(),
            1.0 / tile_nx, 1.0 / tile_ny, _channels(p), force.data_ptr(),
            _channels(out),
            _channels(movers), stay.data_ptr(), pending.data_ptr(),
            _stream(dev)), "split")
        self.launches += 1
        return out, movers, stay, pending


class SegmentKernel(_Kernel):
    def __call__(self, movers: ParticleState, *, tile_rows: int,
                 tile_cols: int, tile_ny: int, tile_nx: int, b_seg: int,
                 row0: int = 0, col0: int = 0,
                 grid_rows: Optional[int] = None,
                 grid_cols: Optional[int] = None):
        T, mc = movers.x.shape
        dev, real = movers.x.device, _real(movers)
        _check_p(movers, "movers", (T, mc), dev, real)
        if T != tile_rows * tile_cols:
            raise ValueError(f"{T} tiles, grid {tile_rows}x{tile_cols}")
        lib = _lib()
        buf = torch.empty((6, T, 8 * b_seg), dtype=real, device=dev)
        seg = ParticleState(*buf)
        dropped = torch.empty(T, dtype=torch.int32, device=dev)
        _launched(lib.minipic_segment(
            _F64[real], T, mc, b_seg, tile_cols, row0, col0,
            tile_rows if grid_rows is None else grid_rows,
            tile_cols if grid_cols is None else grid_cols, 1.0 / tile_nx,
            1.0 / tile_ny, _channels(movers), _channels(seg),
            dropped.data_ptr(), _stream(dev)), "segment")
        self.launches += 1
        return seg, dropped


def _check_runs(seg: ParticleState, nbr: torch.Tensor, T: int, b_seg: int,
                dev, real) -> None:
    _check_p(seg, "seg", (T, 8 * b_seg), dev, real)
    _check(nbr, "nbr", torch.int32, (T, 8), dev)


class AppendKernel(_Kernel):
    def __call__(self, p: ParticleState, seg: ParticleState,
                 wm: torch.Tensor, nbr: torch.Tensor, *, b_seg: int,
                 active=True) -> torch.Tensor:
        T, cap = p.x.shape
        dev, real = p.x.device, _real(p)
        _check_p(p, "p", (T, cap), dev, real)
        _check_runs(seg, nbr, T, b_seg, dev, real)
        _check(wm, "wm", torch.int32, (T,), dev)
        active = _flag(active, dev)
        lib = _lib()
        dropped = torch.zeros(T, dtype=torch.int32, device=dev)
        _launched(lib.minipic_append(
            _F64[real], T, cap, b_seg, wm.data_ptr(), nbr.data_ptr(),
            active.data_ptr(), _channels(p), _channels(seg),
            dropped.data_ptr(),
            self._taken(dev).data_ptr(), _stream(dev)), "append")
        self.launches += 1
        return dropped


class DefragKernel(_Kernel):
    """The defrag.  Arrivals to merge: none; the eight runs of `seg`
    through `nbr` (runs of `b_seg`); or, with `nbr` None, `seg` as one
    dense incoming row [T, b_in] per tile."""

    def __call__(self, p: ParticleState, seg: Optional[ParticleState] = None,
                 nbr: Optional[torch.Tensor] = None, *, b_seg: int = 0,
                 active=True) -> Tuple[torch.Tensor, torch.Tensor]:
        T, cap = p.x.shape
        dev, real = p.x.device, _real(p)
        _check_p(p, "p", (T, cap), dev, real)
        if seg is None:
            b_seg, seg_ch, nbr_ptr = 0, Channels(), None
        elif nbr is None:
            b_seg = seg.x.shape[1]
            _check_p(seg, "incoming", (T, b_seg), dev, real)
            seg_ch, nbr_ptr = _channels(seg), None
        else:
            _check_runs(seg, nbr, T, b_seg, dev, real)
            seg_ch, nbr_ptr = _channels(seg), nbr.data_ptr()
        active = _flag(active, dev)
        lib = _lib()
        counts = torch.zeros(T, dtype=torch.int32, device=dev)
        dropped = torch.zeros(T, dtype=torch.int32, device=dev)
        _launched(lib.minipic_defrag(
            _F64[real], T, cap, b_seg, nbr_ptr, active.data_ptr(),
            _channels(p), seg_ch, counts.data_ptr(), dropped.data_ptr(),
            self._taken(dev).data_ptr(), _stream(dev)), "defrag")
        self.launches += 1
        return counts, dropped


class _AppendRowsKernel(_Kernel):
    """Shared launcher of append_incoming and append_runs (one device
    kernel, csrc/rebin.cu append_rows_kernel); each has its own instance
    and so its own counters."""

    name = ""

    def _launch(self, p: ParticleState, inc: ParticleState,
                wm: torch.Tensor, b_run: int, active) -> torch.Tensor:
        T, cap = p.x.shape
        dev, real = p.x.device, _real(p)
        _check_p(p, "p", (T, cap), dev, real)
        width = inc.x.shape[-1]
        if b_run <= 0 or width % b_run:
            raise ValueError(f"incoming width {width} is not a whole number "
                             f"of runs of {b_run}")
        if width // b_run > MAX_RUNS:
            raise ValueError(f"{width // b_run} runs; the kernel takes at "
                             f"most {MAX_RUNS}")
        _check_p(inc, "incoming", (T, width), dev, real)
        _check(wm, "wm", torch.int32, (T,), dev)
        active = _flag(active, dev)
        lib = _lib()
        dropped = torch.zeros(T, dtype=torch.int32, device=dev)
        _launched(lib.minipic_append_rows(
            _F64[real], T, cap, width // b_run, b_run, wm.data_ptr(),
            active.data_ptr(), _channels(p), _channels(inc),
            dropped.data_ptr(),
            self._taken(dev).data_ptr(), _stream(dev)), self.name)
        self.launches += 1
        return dropped


class AppendIncomingKernel(_AppendRowsKernel):
    name = "append_incoming"

    def __call__(self, p: ParticleState, inc: ParticleState,
                 wm: torch.Tensor, *, active=True) -> torch.Tensor:
        return self._launch(p, inc, wm, inc.x.shape[-1], active)


class AppendRunsKernel(_AppendRowsKernel):
    name = "append_runs"

    def __call__(self, p: ParticleState, inc: ParticleState,
                 wm: torch.Tensor, *, b_seg: int,
                 active=True) -> torch.Tensor:
        return self._launch(p, inc, wm, b_seg, active)


class ExtractKernel(_Kernel):
    def __call__(self, p: ParticleState, *, tile_cols: int, tile_ny: int,
                 tile_nx: int, b_cap: int, force=False):
        T, cap = p.x.shape
        dev, real = p.x.device, _real(p)
        _check_p(p, "p", (T, cap), dev, real)
        if T % tile_cols:
            raise ValueError(f"{T} tiles not a multiple of {tile_cols} cols")
        smem = extract_smem_bytes(cap)
        if smem > SMEM_LIMIT:
            raise ValueError(f"buckets of {cap} slots need {smem} bytes of "
                             f"ballot words; a block may use {SMEM_LIMIT}")
        kc = extract_chunk(cap, b_cap)
        force = _flag(force, dev)
        lib = _lib()
        w = torch.empty((T, cap), dtype=real, device=dev)
        mbuf = torch.empty((6, T, b_cap), dtype=real, device=dev)
        movers = ParticleState(*mbuf)
        wm = torch.empty(T, dtype=torch.int32, device=dev)
        pending = torch.empty(T, dtype=torch.int32, device=dev)
        _launched(lib.minipic_extract(
            _F64[real], T, cap, b_cap, (b_cap // kc) * kc, tile_cols,
            1.0 / tile_nx, 1.0 / tile_ny, _channels(p), force.data_ptr(),
            w.data_ptr(),
            _channels(movers), wm.data_ptr(), pending.data_ptr(),
            _stream(dev)), "extract")
        self.launches += 1
        return p._replace(w=w), movers, wm, pending


split_kernel = SplitKernel()
segment_kernel = SegmentKernel()
append_kernel = AppendKernel()
defrag_kernel = DefragKernel()
append_incoming_kernel = AppendIncomingKernel()
append_runs_kernel = AppendRunsKernel()
extract_kernel = ExtractKernel()
KERNELS = {"split": split_kernel, "segment": segment_kernel,
           "append": append_kernel, "defrag": defrag_kernel,
           "append_incoming": append_incoming_kernel,
           "append_runs": append_runs_kernel, "extract": extract_kernel}


# ----------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors.


def _on_cpu(a: torch.Tensor, what: str) -> None:
    if a.device.type != "cpu":
        raise ValueError(f"no {what} for device {a.device}")


def split_buckets(p: ParticleState, *, tile_cols: int, tile_ny: int,
                  tile_nx: int, b_cap: int, force=False, row0: int = 0,
                  col0: int = 0, tile_ids: Optional[torch.Tensor] = None):
    kw = dict(tile_cols=tile_cols, tile_ny=tile_ny, tile_nx=tile_nx,
              b_cap=b_cap, force=force, row0=row0, col0=col0,
              tile_ids=tile_ids)
    if p.x.is_cuda:
        return split_kernel(p, **kw)
    _on_cpu(p.x, "split")
    return split_buckets_plain(p, **kw)


def segment_movers(movers: ParticleState, *, tile_rows: int, tile_cols: int,
                   tile_ny: int, tile_nx: int, b_seg: int, row0: int = 0,
                   col0: int = 0, grid_rows: Optional[int] = None,
                   grid_cols: Optional[int] = None):
    kw = dict(tile_rows=tile_rows, tile_cols=tile_cols, tile_ny=tile_ny,
              tile_nx=tile_nx, b_seg=b_seg, row0=row0, col0=col0,
              grid_rows=grid_rows, grid_cols=grid_cols)
    if movers.x.is_cuda:
        return segment_kernel(movers, **kw)
    _on_cpu(movers.x, "segment")
    return segment_movers_plain(movers, **kw)


def _assign(p: ParticleState, new: ParticleState, active) -> None:
    for a, b in zip(p, new):
        a.copy_(torch.where(torch.as_tensor(active), b, a))


def append_segments_(p: ParticleState, seg: ParticleState, wm: torch.Tensor,
                     nbr: torch.Tensor, *, b_seg: int,
                     active=True) -> torch.Tensor:
    """The append, in place on `p` when `active`.  Returns dropped [T]."""
    if p.x.is_cuda:
        return append_kernel(p, seg, wm, nbr, b_seg=b_seg, active=active)
    _on_cpu(p.x, "append")
    out, dropped = append_segments_plain(p, seg, wm, nbr, b_seg=b_seg)
    _assign(p, out, active)
    return torch.where(torch.as_tensor(active), dropped,
                       torch.zeros_like(dropped))


def append_runs_(p: ParticleState, inc: ParticleState, wm: torch.Tensor, *,
                 b_seg: int, active=True) -> torch.Tensor:
    """append_runs, in place on `p` when `active`.  Returns dropped [T]."""
    if p.x.is_cuda:
        return append_runs_kernel(p, inc, wm, b_seg=b_seg, active=active)
    _on_cpu(p.x, "append_runs")
    out, dropped = append_runs_plain(p, inc, wm, b_seg=b_seg)
    _assign(p, out, active)
    return torch.where(torch.as_tensor(active), dropped,
                       torch.zeros_like(dropped))


def append_incoming_(p: ParticleState, inc: ParticleState, wm: torch.Tensor,
                     *, active=True) -> torch.Tensor:
    """append_incoming, in place on `p` when `active`.  Returns dropped
    [T].  The JAX wrapper also asks for cap >= b_in + 256, room for its
    slab anchor; the port writes at the watermark itself and needs none."""
    if p.x.is_cuda:
        return append_incoming_kernel(p, inc, wm, active=active)
    _on_cpu(p.x, "append_incoming")
    out, dropped = append_incoming_plain(p, inc, wm)
    _assign(p, out, active)
    return torch.where(torch.as_tensor(active), dropped,
                       torch.zeros_like(dropped))


def defrag_buckets_(p: ParticleState, seg: Optional[ParticleState] = None,
                    nbr: Optional[torch.Tensor] = None, *, b_seg: int = 0,
                    active=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The defrag, in place on `p` when `active`, merging the arrival runs
    of `seg` through `nbr` when given, or `seg` as one dense incoming row
    per tile when `nbr` is None.  Returns (counts, dropped) [T]."""
    if p.x.is_cuda:
        return defrag_kernel(p, seg, nbr, b_seg=b_seg, active=active)
    _on_cpu(p.x, "defrag")
    inc = seg if nbr is None else roll_segments(seg, nbr, b_seg)
    out, counts, dropped = defrag_buckets_plain(p, inc)
    _assign(p, out, active)
    on = torch.as_tensor(active)
    return (torch.where(on, counts, torch.zeros_like(counts)),
            torch.where(on, dropped, torch.zeros_like(dropped)))


def extract_movers(p: ParticleState, *, tile_cols: int, tile_ny: int,
                   tile_nx: int, b_cap: int, force=False):
    kw = dict(tile_cols=tile_cols, tile_ny=tile_ny, tile_nx=tile_nx,
              b_cap=b_cap, force=force)
    if p.x.is_cuda:
        return extract_kernel(p, **kw)
    _on_cpu(p.x, "extract")
    return extract_movers_plain(p, **kw)


@functools.lru_cache(maxsize=None)
def seg_neighbor_table(tile_rows: int, tile_cols: int,
                       device: torch.device) -> torch.Tensor:
    """[T, 8] int32: nbr[t, d] is the tile whose direction-d run lands at t,
    t's (-DIR_OFFSETS[d]) neighbour on the periodic tile grid.  Static, so
    it is built once per grid and device (its host-to-device copy would
    otherwise sync every re-bin)."""
    r = torch.arange(tile_rows, device=device)[:, None, None]
    c = torch.arange(tile_cols, device=device)[None, :, None]
    dr = torch.tensor([o[0] for o in DIR_OFFSETS], device=device)
    dc = torch.tensor([o[1] for o in DIR_OFFSETS], device=device)
    nbr = (torch.remainder(r - dr, tile_rows) * tile_cols
           + torch.remainder(c - dc, tile_cols))
    return nbr.reshape(tile_rows * tile_cols, 8).to(torch.int32)


@functools.lru_cache(maxsize=None)
def identity_neighbor_table(num_tiles: int,
                            device: torch.device) -> torch.Tensor:
    """[T, 8] int32 with nbr[t, d] = t: the append's table for arrivals that
    already sit at their destination tile (the sharded deal route's rolled
    runs)."""
    t = torch.arange(num_tiles, dtype=torch.int32, device=device)
    return t[:, None].expand(num_tiles, 8).contiguous()
