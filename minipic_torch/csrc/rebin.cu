// The incremental re-bin for Hopper (sm_90a): split, segment, append,
// defrag, append_incoming, append_runs, extract.
//
// Replaces: minipic_tpu/ops/pallas/rebin_kernels.py, split_buckets
// (pallas_call at :719), segment_movers (:1009), append_segments (:1457),
// defrag_buckets (:1201), append_incoming (:1643), append_runs (:1589) and
// extract_movers (:394).  Plain torch versions of the same functions:
// minipic_torch/ops/rebin.py (its docstring states what each computes).
//
// Layout.  One thread block per tile for every kernel.  Particles are six
// channels (x, y, px, py, pz, w) of one element type, float or double (the
// decks of precision f64: every kernel is a template on it, the tile
// predicates evaluated in that type), each [T, width] row-major; a slot is
// live iff w > 0.  The payload moves by copies only, so each kernel is
// bit-equal to its plain version.  Ranks, counts and ballot words are the
// same for both types; a double channel moves twice the bytes.
//
// The TPU kernels compact through permutation matmuls on the MXU, chunk by
// chunk.  Here a chunk is one slot per thread: a block-wide stable rank of a
// predicate is a warp ballot plus __popc of the lanes below, then a serial
// scan of the per-warp counts (block_scan).  The split's chunk is the JAX
// kernel's kc (block size = kc), because mover order within a chunk is part
// of the result: the TPU kernel's combined permutation places a chunk's
// movers in REVERSE slot order, and the port reproduces it.
//
// Memory traffic per re-bin at the headline size (4096 tiles x 27136 slots,
// mover buffer 2560, segment runs 768): the split reads x, y, w twice and the
// other channels once and writes every bucket slot (~6.7 GB); the segment
// reads the mover buffers and writes the runs (~0.5 GB); the append copies
// only the arrivals (~0.05 GB).  The defrag, when it runs, reads and writes
// every bucket slot.  HBM bounds the work, but a chunk loop with barriers
// need not reach it: measured on an H100 80GB HBM3 at 700 W, the split takes
// 2.56 ms (~2.5 TB/s, 0.65 of its bound), the segment 0.36 ms, the append
// 0.08 ms and the defrag 2.1 ms, while the first extract, the same chunk
// loop over a third of the bytes, took 2.19 ms, 0.28 of its bound: a tile
// was a dependent chain of 53 chunk scans, three barriers each, so latency
// bound it.  The extract and the row append (below) are built the other
// way: one pass over each stream with loads in flight, ranks from ballot
// words kept in shared memory, one block phase per tile.  Every kernel
// keeps each tile's streams coalesced (consecutive threads, consecutive
// slots) and does the ranking in registers and shared words, with no
// global atomics on the data path.
//
// Tile coordinates.  The split and the segment compare a particle's cell
// with its tile's GLOBAL row and column, as the TPU kernels' _tile_rc
// (rebin_kernels.py:306-317): tile t of a row-major block of tile_cols
// columns whose first tile is (row0, col0) of the global grid, or, given
// tile_ids, the tile whose global id is tile_ids[t] (tile_cols then counts
// the global grid's columns: a shard's striped tiles).  The segment folds a
// periodic tile delta by the global grid (grid_rows, grid_cols), so a
// mover across a shard seam is not taken for a wrap-around.  One device
// passes row0 = col0 = 0, no tile_ids and its own grid.
//
// Branch choice on the device.  rebin_auto launches the append and the defrag
// together with complementary 0-d flags (all buckets keep 256 slots of
// headroom, or not); a block whose flag is clear returns at once (the row
// append after its count loads), so the choice needs no host read.  Block 0 of the active kernel adds one to its
// `taken` counter.

#include <cuda_runtime.h>

// The six channels of one element type T (float or double), and their
// pointers as the C entry points take them.
template <typename T>
struct ChannelsT {
  T* c[6];
};
struct Channels {
  void* c[6];
};

namespace {

template <typename T>
ChannelsT<T> typed(const Channels& ch) {
  ChannelsT<T> out;
  for (int k = 0; k < 6; ++k) out.c[k] = static_cast<T*>(ch.c[k]);
  return out;
}

// The tile predicates in the channels' type: floor(x * (1/tile_nx)) is the
// f32 rule of the TPU kernels on float channels and the f64 one on double.
__device__ __forceinline__ float r_floor(float v) { return floorf(v); }
__device__ __forceinline__ double r_floor(double v) { return floor(v); }
__device__ __forceinline__ float r_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double r_abs(double v) { return fabs(v); }

constexpr int kSegThreads = 512;
constexpr int kAppendThreads = 256;  // 8 warps: one per direction
constexpr int kDefragThreads = 512;

// Block-wide stable ranks of N predicates.  For each k: excl[k] is the number
// of threads below this one (in thread order) whose f[k] holds, tot[k] the
// block's total.  blockDim.x is a multiple of 32, at most 1024.  sh is shared
// scratch [N][33]; every thread of the block must call it.
template <int N>
__device__ __forceinline__ void block_scan(const bool (&f)[N], int (&excl)[N],
                                           int (&tot)[N], int (*sh)[33]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const unsigned b = __ballot_sync(0xffffffffu, f[k]);
    excl[k] = __popc(b & below);
    if (lane == 0) sh[k][warp] = __popc(b);
  }
  __syncthreads();
  if (threadIdx.x < N) {
    int* row = sh[threadIdx.x];
    int acc = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int v = row[w];
      row[w] = acc;
      acc += v;
    }
    row[32] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    excl[k] += sh[k][warp];
    tot[k] = sh[k][32];
  }
  __syncthreads();  // sh is reused by the next call
}

// Block-wide sum and max of one int per thread (sh: shared scratch [32]).
__device__ __forceinline__ int block_sum(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += sh[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int block_max(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int m = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = max(m, sh[w]);
  __syncthreads();
  return m;
}

template <typename T>
__device__ __forceinline__ void load6(const ChannelsT<T>& ch, size_t i,
                                      T (&v)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = ch.c[k][i];
}

template <typename T>
__device__ __forceinline__ void store6(const ChannelsT<T>& ch, size_t i,
                                       const T (&v)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) ch.c[k][i] = v[k];
}

template <typename T>
__device__ __forceinline__ void zero6(const ChannelsT<T>& ch, size_t i) {
#pragma unroll
  for (int k = 0; k < 6; ++k) ch.c[k][i] = T(0);
}

// ---------------------------------------------------------------------------
// Split (blockDim.x == kc).

// Global (row, col) of tile t (see "Tile coordinates" above).
template <typename T>
__device__ __forceinline__ void tile_rc(int t, int tile_cols, int row0,
                                        int col0, const int* tile_ids,
                                        T* row, T* col) {
  if (tile_ids != nullptr) {
    const int gid = tile_ids[t];
    *row = (T)(gid / tile_cols);
    *col = (T)(gid % tile_cols);
  } else {
    *row = (T)(row0 + t / tile_cols);
    *col = (T)(col0 + t % tile_cols);
  }
}

template <typename T>
struct SplitArgs {
  int cap, b_cap, tile_cols, row0, col0;
  const int* tile_ids;  // nullptr: the block at (row0, col0)
  T inv_nx, inv_ny;
  ChannelsT<T> in, out, mov;
  const bool* force;
  int* stay;
  int* pending;
};

template <typename T>
__global__ void split_kernel(SplitArgs<T> a) {
  __shared__ int sh[2][33];
  const int t = blockIdx.x;
  const int kc = blockDim.x;
  T my_row, my_col;
  tile_rc(t, a.tile_cols, a.row0, a.col0, a.tile_ids, &my_row, &my_col);
  const size_t row = (size_t)t * a.cap;
  const T* x = a.in.c[0] + row;
  const T* y = a.in.c[1] + row;
  const T* w = a.in.c[5] + row;

  // Pass 1: the tile's movers (all-or-nothing decision) and last live slot.
  int n_mov = 0, last = -1;
  for (int s = threadIdx.x; s < a.cap; s += kc) {
    if (w[s] > T(0)) {
      last = s;
      n_mov += (r_floor(x[s] * a.inv_nx) != my_col) ||
               (r_floor(y[s] * a.inv_ny) != my_row);
    }
  }
  const int total = block_sum(n_mov, sh[0]);
  last = block_max(last, sh[0]);
  const bool extract = total <= a.b_cap || *a.force;

  // Pass 2: chunks of kc slots up to the last live one.
  int s_cur = 0, m_cur = 0;
  const size_t mrow = (size_t)t * a.b_cap;
  for (int base = 0; base <= last; base += kc) {
    const int s = base + threadIdx.x;
    T v[6] = {0, 0, 0, 0, 0, 0};
    bool live = false, away = false;
    if (s < a.cap) {
      load6(a.in, row + s, v);
      live = v[5] > T(0);
      away = (r_floor(v[0] * a.inv_nx) != my_col) ||
             (r_floor(v[1] * a.inv_ny) != my_row);
    }
    const bool mv = live && away && extract;
    const bool f[2] = {live && !mv, mv};
    int ex[2], tot[2];
    block_scan<2>(f, ex, tot, sh);
    if (f[0]) store6(a.out, row + s_cur + ex[0], v);
    if (f[1]) {
      // Reverse slot order within the chunk, as the TPU kernel.
      const int pos = m_cur + tot[1] - 1 - ex[1];
      if (pos < a.b_cap) store6(a.mov, mrow + pos, v);
    }
    s_cur += tot[0];
    m_cur += tot[1];
  }
  for (int s = s_cur + threadIdx.x; s < a.cap; s += kc) zero6(a.out, row + s);
  const int kept = min(m_cur, a.b_cap);
  for (int s = kept + threadIdx.x; s < a.b_cap; s += kc) zero6(a.mov, mrow + s);
  if (threadIdx.x == 0) {
    a.stay[t] = s_cur;
    a.pending[t] = total - kept;  // deferred tile: kept == 0
  }
}

// ---------------------------------------------------------------------------
// Segment (kSegThreads threads).

template <typename T>
struct SegmentArgs {
  int mc, b_seg, tile_cols, row0, col0, grid_rows, grid_cols;
  T inv_nx, inv_ny;
  ChannelsT<T> mov, seg;
  int* dropped;
};

template <typename T>
__global__ void segment_kernel(SegmentArgs<T> a) {
  __shared__ int sh[8][33];
  const int t = blockIdx.x;
  T my_row, my_col;
  tile_rc(t, a.tile_cols, a.row0, a.col0, nullptr, &my_row, &my_col);
  const T cols = (T)a.grid_cols, rows = (T)a.grid_rows;
  const size_t row = (size_t)t * a.mc;
  const size_t srow = (size_t)t * 8 * a.b_seg;
  int cur[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int killed = 0;
  for (int base = 0; base < a.mc; base += blockDim.x) {
    const int s = base + threadIdx.x;
    T v[6] = {0, 0, 0, 0, 0, 0};
    int d8 = -1;
    if (s < a.mc) {
      load6(a.mov, row + s, v);
      if (v[5] > T(0)) {
        T dc = r_floor(v[0] * a.inv_nx) - my_col;
        T dr = r_floor(v[1] * a.inv_ny) - my_row;
        dc = dc > T(1.5) ? dc - cols : (dc < -T(1.5) ? dc + cols : dc);
        dr = dr > T(1.5) ? dr - rows : (dr < -T(1.5) ? dr + rows : dr);
        if (r_abs(dc) <= T(1.5) && r_abs(dr) <= T(1.5)) {
          const int d9 = ((int)dr + 1) * 3 + ((int)dc + 1);
          // A mover whose destination is its own tile is neither kept nor
          // counted, as in the TPU kernel (the split never makes one).
          if (d9 != 4) d8 = d9 - (d9 > 4);
        } else {
          ++killed;  // more than one tile from home
        }
      }
    }
    bool f[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) f[d] = d8 == d;
    int ex[8], tot[8];
    block_scan<8>(f, ex, tot, sh);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (f[d]) {
        const int pos = cur[d] + ex[d];
        if (pos < a.b_seg) store6(a.seg, srow + (size_t)d * a.b_seg + pos, v);
      }
      cur[d] += tot[d];
    }
  }
  int over = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int kept = min(cur[d], a.b_seg);
    over += cur[d] - kept;
    for (int i = kept + threadIdx.x; i < a.b_seg; i += blockDim.x)
      zero6(a.seg, srow + (size_t)d * a.b_seg + i);
  }
  killed = block_sum(killed, sh[0]);
  if (threadIdx.x == 0) a.dropped[t] = over + killed;
}

// ---------------------------------------------------------------------------
// Append (kAppendThreads threads), in place.

template <typename T>
struct AppendArgs {
  int cap, b_seg;
  const int* wm;
  const int* nbr;
  const bool* active;
  ChannelsT<T> p, seg;
  int* dropped;
  int* taken;
};

template <typename T>
__global__ void append_kernel(AppendArgs<T> a) {
  if (!*a.active) return;
  __shared__ int n_r[8], off[9];
  const int t = blockIdx.x;
  if (t == 0 && threadIdx.x == 0) atomicAdd(a.taken, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Warp d counts the live slots of run d of tile nbr[t, d].
  {
    const int src = a.nbr[t * 8 + warp];
    const T* sw =
        a.seg.c[5] + ((size_t)src * 8 + warp) * (size_t)a.b_seg;
    int c = 0;
    for (int i = lane; i < a.b_seg; i += 32) c += sw[i] > T(0);
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0) n_r[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int d = 0; d < 8; ++d) off[d + 1] = off[d] + n_r[d];
  }
  __syncthreads();
  const int n_in = off[8];
  const int wm = a.wm[t];
  if (wm + n_in > a.cap) {  // all or nothing
    if (threadIdx.x == 0) a.dropped[t] = n_in;
    return;
  }
  const size_t dst = (size_t)t * a.cap + wm;
  for (int d = 0; d < 8; ++d) {
    const size_t src =
        ((size_t)a.nbr[t * 8 + d] * 8 + d) * (size_t)a.b_seg;
    for (int i = threadIdx.x; i < n_r[d]; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        a.p.c[k][dst + off[d] + i] = a.seg.c[k][src + i];
    }
  }
  if (threadIdx.x == 0) a.dropped[t] = 0;
}

// ---------------------------------------------------------------------------
// Defrag (kDefragThreads threads), in place.

template <typename T>
struct DefragArgs {
  // b_seg 0: no arrivals to merge.  nbr set: the eight runs seg[nbr[t, d],
  // d] of b_seg slots; nbr null: one dense row of b_seg slots per tile,
  // seg[t] (the sort route's incoming slab).
  int cap, b_seg;
  const int* nbr;
  const bool* active;
  ChannelsT<T> p, seg;
  int* counts;
  int* dropped;
  int* taken;
};

template <typename T>
__global__ void defrag_kernel(DefragArgs<T> a) {
  if (!*a.active) return;
  __shared__ int sh[1][33];
  const int t = blockIdx.x;
  if (t == 0 && threadIdx.x == 0) atomicAdd(a.taken, 1);
  const size_t row = (size_t)t * a.cap;
  int cursor = 0;
  // The bucket's own live slots.  The write cursor never passes the read
  // point, and block_scan's barrier separates a chunk's reads from its
  // writes, so compaction in place is safe.
  for (int base = 0; base < a.cap; base += blockDim.x) {
    const int s = base + threadIdx.x;
    T v[6] = {0, 0, 0, 0, 0, 0};
    if (s < a.cap) load6(a.p, row + s, v);
    const bool f[1] = {v[5] > T(0)};
    int ex[1], tot[1];
    block_scan<1>(f, ex, tot, sh);
    if (f[0]) store6(a.p, row + cursor + ex[0], v);
    cursor += tot[0];
  }
  // Then the live slots of the arrival runs, in direction order.
  const int runs = a.b_seg == 0 ? 0 : (a.nbr != nullptr ? 8 : 1);
  for (int d = 0; d < runs; ++d) {
    const size_t src =
        a.nbr != nullptr ? ((size_t)a.nbr[t * 8 + d] * 8 + d) * (size_t)a.b_seg
                         : (size_t)t * a.b_seg;
    for (int base = 0; base < a.b_seg; base += blockDim.x) {
      const int i = base + threadIdx.x;
      T v[6] = {0, 0, 0, 0, 0, 0};
      if (i < a.b_seg) load6(a.seg, src + i, v);
      const bool f[1] = {v[5] > T(0)};
      int ex[1], tot[1];
      block_scan<1>(f, ex, tot, sh);
      if (f[0] && cursor + ex[0] < a.cap) store6(a.p, row + cursor + ex[0], v);
      cursor += tot[0];
    }
  }
  const int kept = min(cursor, a.cap);
  for (int s = kept + threadIdx.x; s < a.cap; s += blockDim.x)
    zero6(a.p, row + s);
  if (threadIdx.x == 0) {
    a.counts[t] = kept;
    a.dropped[t] = cursor - kept;
  }
}

// ---------------------------------------------------------------------------
// Append of a tile's own incoming row (kAppendRowsThreads threads), in place:
// append_incoming (one run of b_run slots) and append_runs (`runs` runs of
// b_run slots each, the rolled arrival runs of the unfused deal route).
//
// Replaces rebin_kernels.py _append_kernel (:1220) and _append_runs_kernel
// (:1474).  Each run is live-compacted, so its count of w > 0 is its length;
// the runs are written one after another at [wm, wm + n_in).
//
// Bytes bound it: the incoming w row read once and the live arrivals' six
// channels read and written, ~(4 * runs * b_run + 48 * n_in) bytes a tile
// (0.045 ms at the headline's 8 runs of 768; ~0.2 us for the physics decks'
// one row over 64-256 tiles, below any launch).  The first design lost to
// latency: it read the w row twice (the fit total, then each run's count),
// paid two barriers a run, and copied run after run, each run's few
// arrivals spread over the whole block.  This one counts each run once
// (runs == 8: warp r counts run r, as the append does; one run: every warp
// a share of the row; else warps take runs in turn), sums the counts behind
// one barrier, and copies [0, n_in) in one flat loop: arrival i is slot
// i - off[r] of the run r with off[r] <= i < off[r + 1], so every thread
// copies and no run waits for the one before it.  The flag, the watermark
// and the w row are loaded together: one round trip before the barrier,
// one after it.  The TPU kernels stream a 128-aligned slab around the
// watermark and keep 128 slots of slack for its anchor; here the write
// starts at wm exactly and a tile fits when wm + n_in <= cap.

constexpr int kAppendRowsThreads = 256;
constexpr int kMaxRuns = 64;

template <typename T>
struct AppendRowsArgs {
  int cap, runs, b_run;
  const int* wm;
  const bool* active;
  ChannelsT<T> p, inc;
  int* dropped;
  int* taken;
};

template <typename T>
__global__ void __launch_bounds__(kAppendRowsThreads)
    append_rows_kernel(AppendRowsArgs<T> a) {
  // Live counts: of run r at [r] (runs > 1), of warp w's share at [w] (one
  // run).
  __shared__ int cnt[kMaxRuns];
  const int t = blockIdx.x;
  const int wm = a.wm[t];
  const bool active = *a.active;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t src = (size_t)t * a.runs * a.b_run;
  const T* iw = a.inc.c[5] + src;
  if (a.runs == 1) {
    int c = 0;
#pragma unroll 4
    for (int i = threadIdx.x; i < a.b_run; i += blockDim.x) c += iw[i] > T(0);
    c = warp_sum(c);
    if (lane == 0) cnt[warp] = c;
  } else {
    for (int r = warp; r < a.runs; r += nwarps) {
      const T* rw = iw + (size_t)r * a.b_run;
      int c = 0;
#pragma unroll 8
      for (int i = lane; i < a.b_run; i += 32) c += rw[i] > T(0);
      c = warp_sum(c);
      if (lane == 0) cnt[r] = c;
    }
  }
  // The flag is tested only now, so that its load, the watermark's and the
  // counts' are in flight together (an inactive block reads the w row).
  if (!active) return;
  if (t == 0 && threadIdx.x == 0) atomicAdd(a.taken, 1);
  __syncthreads();
  const int nc = a.runs == 1 ? nwarps : a.runs;
  int n_in = 0;
  for (int k = 0; k < nc; ++k) n_in += cnt[k];
  if (wm + n_in > a.cap) {  // all or nothing
    if (threadIdx.x == 0) a.dropped[t] = n_in;
    return;
  }
  const size_t dst = (size_t)t * a.cap + wm;
  // A thread's i only rise, so its run cursor (r, [off, end)) only moves
  // forward; empty runs are stepped over.
  int r = 0, off = 0, end = a.runs == 1 ? n_in : cnt[0];
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    while (i >= end) {
      off = end;
      end += cnt[++r];
    }
    T v[6];
    load6(a.inc, src + (size_t)r * a.b_run + (i - off), v);
    store6(a.p, dst + i, v);
  }
  if (threadIdx.x == 0) a.dropped[t] = 0;
}

// ---------------------------------------------------------------------------
// Extract (kExtractThreads threads): the extract-only split of
// rebin_incremental.
//
// Replaces rebin_kernels.py _extract_kernel (:147).  A live slot off its
// tile (the split's test) is a mover.  A tile extracts when its movers fit
// fit_cap = (b_cap // kc) * kc slots, or `force` is set; then its movers'
// w becomes 0 in the new w row (every other channel stays in the caller's
// tensors), and the first b_cap of them go to the buffer in FORWARD slot
// order (the TPU kernel ranks by a triangular matmul).  A tile that does not
// extract is left as it was and reports its mover count.  The watermark is
// 1 + the index of the last live stayer, not a count: the stayers are not
// compacted, so leavers leave holes.
//
// Bytes bound it: x, y and w of every slot read and w written once, 16 B a
// slot, plus 48 B a mover and the buffer's zeroed tail (0.61 ms at the
// headline's final state).  The first design reached 0.28 of that: it read
// x, y and w twice (count, then extract), and its second pass was a chain
// of 512-slot chunks, each a block scan with three barriers, one load per
// thread in flight; latency, not HBM, set its pace.  This one reads each
// stream once:
//   1. Warp v owns the ballot words [j0, j1) of the tile (word j: slots
//      32j .. 32j + 31), kExtractWords words a step in flight.  It ballots
//      the mover predicate of each word into shared memory (cap / 8 bytes),
//      writes w_out as if the tile extracts (a mover's w 0, every other
//      slot's copied), sums its words' popcounts, and keeps the last live
//      slot and the last live stayer.
//   2. One barrier: each thread sums the warps' totals (the tile's movers,
//      and its warp's offset: the movers of the words before j0) and takes
//      the two watermark maxima.  The decision follows.
//   3. A tile that extracts: warp v walks its words again in shared memory;
//      a set bit's rank is offset + popc(word & lanes below), so forward
//      slot order, and a mover ranked below b_cap copies its six channels
//      (kCopyWords words' loads in flight).  A tile that does not (rare: the
//      pending case) puts w back at its mover slots only.  Then the buffer
//      tail is zeroed; no further barrier.
// The words of a bucket must fit a block's shared memory (227 KB: about
// 1.8 M slots); the wrapper raises past it.

constexpr int kExtractThreads = 512;
constexpr int kExtractWords = 8;  // pass 1: words a warp loads per step
constexpr int kCopyWords = 4;     // pass 3: words whose movers copy together
constexpr int kExtractRed = 96;   // per-warp totals and maxima: [3][32]

template <typename T>
struct ExtractArgs {
  int cap, b_cap, fit_cap, tile_cols;
  T inv_nx, inv_ny;
  ChannelsT<T> in;
  const bool* force;
  T* w_out;
  ChannelsT<T> mov;
  int* wm;
  int* pending;
};

template <typename T>
__global__ void __launch_bounds__(kExtractThreads)
    extract_kernel(ExtractArgs<T> a) {
  // [nw] ballot words of the mover predicate, then [3][32] per warp: its
  // movers, 1 + its last live stayer, 1 + its last live slot.
  extern __shared__ unsigned ext_sh[];
  const int nw = (a.cap + 31) >> 5;
  unsigned* bits = ext_sh;
  int* red = reinterpret_cast<int*>(ext_sh + nw);
  const int t = blockIdx.x;
  const bool force = *a.force;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (nw + nwarps - 1) / nwarps;
  const int j0 = min(warp * per, nw), j1 = min(j0 + per, nw);
  const T my_row = (T)(t / a.tile_cols);
  const T my_col = (T)(t % a.tile_cols);
  const size_t row = (size_t)t * a.cap;
  const T* x = a.in.c[0] + row;
  const T* y = a.in.c[1] + row;
  const T* w = a.in.c[5] + row;
  T* wo = a.w_out + row;

  // 1. One pass over x, y and w.
  int n_mov = 0, last_stay = 0, last_live = 0;
  for (int j = j0; j < j1; j += kExtractWords) {
    T xv[kExtractWords], yv[kExtractWords], wv[kExtractWords];
#pragma unroll
    for (int u = 0; u < kExtractWords; ++u) {
      const int s = ((j + u) << 5) + lane;
      const bool in = j + u < j1 && s < a.cap;
      xv[u] = in ? x[s] : T(0);
      yv[u] = in ? y[s] : T(0);
      wv[u] = in ? w[s] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kExtractWords; ++u) {
      const int s = ((j + u) << 5) + lane;
      const bool live = wv[u] > T(0);
      const bool mv = live && ((r_floor(xv[u] * a.inv_nx) != my_col) ||
                               (r_floor(yv[u] * a.inv_ny) != my_row));
      const unsigned b = __ballot_sync(0xffffffffu, mv);
      if (j + u < j1) {
        if (s < a.cap) wo[s] = mv ? T(0) : wv[u];
        if (lane == 0) bits[j + u] = b;
      }
      n_mov += __popc(b);
      if (live) {
        last_live = s + 1;
        if (!mv) last_stay = s + 1;
      }
    }
  }
  last_stay = warp_max(last_stay);
  last_live = warp_max(last_live);
  if (lane == 0) {
    red[warp] = n_mov;
    red[32 + warp] = last_stay;
    red[64 + warp] = last_live;
  }

  // 2. The tile's one block phase.
  __syncthreads();
  int total = 0, before = 0, wm_stay = 0, wm_live = 0;
  for (int v = 0; v < nwarps; ++v) {
    const int c = red[v];
    before += v < warp ? c : 0;
    total += c;
    wm_stay = max(wm_stay, red[32 + v]);
    wm_live = max(wm_live, red[64 + v]);
  }
  const bool extract = total <= a.fit_cap || force;
  const int kept = extract ? min(total, a.b_cap) : 0;
  const size_t mrow = (size_t)t * a.b_cap;

  // 3. Copy the movers, or put their w back.
  if (extract) {
    const unsigned below = (1u << lane) - 1u;
    int run = before;  // movers in the words before j (uniform in the warp)
    for (int j = j0; j < j1 && run < a.b_cap; j += kCopyWords) {
      int rank[kCopyWords];
#pragma unroll
      for (int u = 0; u < kCopyWords; ++u) {
        const unsigned word = j + u < j1 ? bits[j + u] : 0u;
        rank[u] = (word >> lane) & 1u ? run + __popc(word & below) : a.b_cap;
        run += __popc(word);
      }
      T v[kCopyWords][6];
#pragma unroll
      for (int u = 0; u < kCopyWords; ++u)
        if (rank[u] < a.b_cap) load6(a.in, row + ((j + u) << 5) + lane, v[u]);
#pragma unroll
      for (int u = 0; u < kCopyWords; ++u)
        if (rank[u] < a.b_cap) store6(a.mov, mrow + rank[u], v[u]);
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      if ((bits[j] >> lane) & 1u) {
        const int s = (j << 5) + lane;
        wo[s] = w[s];
      }
    }
  }
  for (int s = kept + threadIdx.x; s < a.b_cap; s += blockDim.x)
    zero6(a.mov, mrow + s);
  if (threadIdx.x == 0) {
    a.wm[t] = extract ? wm_stay : wm_live;
    a.pending[t] = total - kept;  // a tile that did not extract: kept == 0
  }
}

// Dynamic shared memory of one extract block for buckets of `cap` slots.
size_t extract_smem_bytes(int cap) {
  return sizeof(unsigned) * ((size_t)(cap + 31) / 32 + kExtractRed);
}

int finish() { return (int)cudaGetLastError(); }

// The launches, on the channels' element type T.
template <typename T>
int split(int num_tiles, int cap, int b_cap, int kc, int tile_cols,
          int row0, int col0, const int* tile_ids, double inv_nx,
          double inv_ny, const Channels& in, const bool* force,
          const Channels& out, const Channels& mov, int* stay, int* pending,
          cudaStream_t stream) {
  SplitArgs<T> a{cap,         b_cap,       tile_cols,   row0,
                 col0,        tile_ids,    (T)inv_nx,   (T)inv_ny,
                 typed<T>(in), typed<T>(out), typed<T>(mov), force,
                 stay,        pending};
  split_kernel<T><<<num_tiles, kc, 0, stream>>>(a);
  return finish();
}

template <typename T>
int segment(int num_tiles, int mc, int b_seg, int tile_cols, int row0,
            int col0, int grid_rows, int grid_cols, double inv_nx,
            double inv_ny, const Channels& mov, const Channels& seg,
            int* dropped, cudaStream_t stream) {
  SegmentArgs<T> a{mc,        b_seg,        tile_cols,   row0,
                   col0,      grid_rows,    grid_cols,   (T)inv_nx,
                   (T)inv_ny, typed<T>(mov), typed<T>(seg), dropped};
  segment_kernel<T><<<num_tiles, kSegThreads, 0, stream>>>(a);
  return finish();
}

template <typename T>
int append(int num_tiles, int cap, int b_seg, const int* wm, const int* nbr,
           const bool* active, const Channels& p, const Channels& seg,
           int* dropped, int* taken, cudaStream_t stream) {
  AppendArgs<T> a{cap,         b_seg,         wm,      nbr,  active,
                  typed<T>(p), typed<T>(seg), dropped, taken};
  append_kernel<T><<<num_tiles, kAppendThreads, 0, stream>>>(a);
  return finish();
}

template <typename T>
int defrag(int num_tiles, int cap, int b_seg, const int* nbr,
           const bool* active, const Channels& p, const Channels& seg,
           int* counts, int* dropped, int* taken, cudaStream_t stream) {
  DefragArgs<T> a{cap,     b_seg,   nbr,  active, typed<T>(p), typed<T>(seg),
                  counts,  dropped, taken};
  defrag_kernel<T><<<num_tiles, kDefragThreads, 0, stream>>>(a);
  return finish();
}

template <typename T>
int append_rows(int num_tiles, int cap, int runs, int b_run, const int* wm,
                const bool* active, const Channels& p, const Channels& inc,
                int* dropped, int* taken, cudaStream_t stream) {
  AppendRowsArgs<T> a{cap,         runs,          b_run,   wm,   active,
                      typed<T>(p), typed<T>(inc), dropped, taken};
  append_rows_kernel<T><<<num_tiles, kAppendRowsThreads, 0, stream>>>(a);
  return finish();
}

template <typename T>
int extract(int num_tiles, int cap, int b_cap, int fit_cap, int tile_cols,
            double inv_nx, double inv_ny, const Channels& in,
            const bool* force, void* w_out, const Channels& mov, int* wm,
            int* pending, cudaStream_t stream) {
  const size_t smem = extract_smem_bytes(cap);  // the wrapper bounds it
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extract_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ExtractArgs<T> a{cap,          b_cap,     fit_cap,
                   tile_cols,    (T)inv_nx, (T)inv_ny,
                   typed<T>(in), force,     static_cast<T*>(w_out),
                   typed<T>(mov), wm,       pending};
  extract_kernel<T><<<num_tiles, kExtractThreads, smem, stream>>>(a);
  return finish();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each takes `f64` (0: float32
// channels, 1: float64) first, launches on `stream`, allocates nothing and
// returns the CUDA error code of the launch (0 on success).
#define MINIPIC_DISPATCH(fn, ...)                                   \
  return f64 ? fn<double>(__VA_ARGS__, static_cast<cudaStream_t>(stream)) \
             : fn<float>(__VA_ARGS__, static_cast<cudaStream_t>(stream))

extern "C" int minipic_split(int f64, int num_tiles, int cap, int b_cap,
                             int kc, int tile_cols, int row0, int col0,
                             const int* tile_ids, double inv_nx,
                             double inv_ny, Channels in, const bool* force,
                             Channels out, Channels mov, int* stay,
                             int* pending, void* stream) {
  if (kc <= 0 || kc > 1024 || kc % 32) return (int)cudaErrorInvalidValue;
  MINIPIC_DISPATCH(split, num_tiles, cap, b_cap, kc, tile_cols, row0, col0,
                   tile_ids, inv_nx, inv_ny, in, force, out, mov, stay,
                   pending);
}

extern "C" int minipic_segment(int f64, int num_tiles, int mc, int b_seg,
                               int tile_cols, int row0, int col0,
                               int grid_rows, int grid_cols, double inv_nx,
                               double inv_ny, Channels mov, Channels seg,
                               int* dropped, void* stream) {
  MINIPIC_DISPATCH(segment, num_tiles, mc, b_seg, tile_cols, row0, col0,
                   grid_rows, grid_cols, inv_nx, inv_ny, mov, seg, dropped);
}

extern "C" int minipic_append(int f64, int num_tiles, int cap, int b_seg,
                              const int* wm, const int* nbr,
                              const bool* active, Channels p, Channels seg,
                              int* dropped, int* taken, void* stream) {
  MINIPIC_DISPATCH(append, num_tiles, cap, b_seg, wm, nbr, active, p, seg,
                   dropped, taken);
}

extern "C" int minipic_defrag(int f64, int num_tiles, int cap, int b_seg,
                              const int* nbr, const bool* active, Channels p,
                              Channels seg, int* counts, int* dropped,
                              int* taken, void* stream) {
  MINIPIC_DISPATCH(defrag, num_tiles, cap, b_seg, nbr, active, p, seg,
                   counts, dropped, taken);
}

extern "C" int minipic_append_rows(int f64, int num_tiles, int cap,
                                   int runs, int b_run, const int* wm,
                                   const bool* active, Channels p,
                                   Channels inc, int* dropped, int* taken,
                                   void* stream) {
  if (runs < 1 || runs > kMaxRuns) return (int)cudaErrorInvalidValue;
  MINIPIC_DISPATCH(append_rows, num_tiles, cap, runs, b_run, wm, active, p,
                   inc, dropped, taken);
}

extern "C" int minipic_extract(int f64, int num_tiles, int cap, int b_cap,
                               int fit_cap, int tile_cols, double inv_nx,
                               double inv_ny, Channels in, const bool* force,
                               void* w_out, Channels mov, int* wm,
                               int* pending, void* stream) {
  MINIPIC_DISPATCH(extract, num_tiles, cap, b_cap, fit_cap, tile_cols,
                   inv_nx, inv_ny, in, force, w_out, mov, wm, pending);
}
#undef MINIPIC_DISPATCH
