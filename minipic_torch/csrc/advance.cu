// Particle advance for Hopper (sm_90a): gather + relativistic Boris push +
// move (+ periodic wrap) + Esirkepov current deposit, one pass per tile.
//
// Replaces: minipic_tpu/ops/pallas/ppd_kernel.py, fused_push_deposit
// (pallas_call at :1187; kernel body _kernel -> _process_tile -> _sub_chunk).
// Plain torch version of the same arithmetic: minipic_torch/ops/advance.py,
// advance_plain (see that module's docstring for the step-by-step contract).
//
// Layout.  One thread block per tile (grid = num_tiles), 8 warps.  The
// block loads the tile's six field windows [nyg, nxg] into shared memory and
// zeroes its J windows there: in the f32 and f64 modes one set of three
// (jx, jy, jz) for each group of P.win_warps warps (below), in int8 mode one
// set for the block.  Each warp walks the bucket in slabs of 32
// consecutive slots, one per lane (loads stay coalesced), up to the live
// watermark rounded up to 32, so all 32 lanes run the same trip count; the
// next slab's six values are loaded before the current slab's arithmetic.
// Lanes at or past the watermark, and dead slots (w == 0), are copied
// through untouched and contribute nothing; the slots past the rounded
// watermark are copied through in a loop of their own.  Particles are
// written to NEW output tensors (x, y, px, py, pz; w is not written).
//
// Two forms of a launch (P.fused, a run-time flag read outside the slab
// loop).  Raw (0): the watermark is counts[t], and the J windows are
// written whole before the prefix sums, with the per-tile max displacement
// dmax[t]: the form the plain version computes.  Fused (1, the step's): the
// block finds the watermark itself, the highest slot with w > 0 plus 1
// (ops/advance.live_watermark), reading the bucket's w from its end down,
// a chunk at a time, until a chunk holds a live slot; it writes the J
// windows with the x prefix sums of jx and the y prefix sums of jy applied
// (left to right, bottom to top; int8 sums the integers, exact, before the
// conversion), and in int8 mode its largest weight wmax[t] (over every slot
// it read, which is every slot).  finish_kernel, launched after it, then
// applies what needs every tile: the uniform q*max(w) scale of int8 jx and
// jy, and the 0-d max displacement.  Together they are the JAX wrapper's
// pallas_call and the epilogue after it.
//
// Tile origins.  Each tile's origin in global cells comes from two int32
// arrays ox[t], oy[t], as the TPU kernel's scalar-prefetch ox_ref, oy_ref:
// the row-major grid on one device, a shard's block of the grid, or a
// shard's striped tiles (the tile's window gid), so the same kernel runs
// every layout.  The periodic fold keeps the global box (grid_nx, grid_ny).
//
// Boundary (P.periodic, a compile-time PERIODIC chosen at launch, so the
// periodic kernels carry no trace of the open mode): periodic folds each
// position to its nearest image around the tile and wraps the stored
// move; open (P.periodic 0, decks with absorbing walls) takes the raw
// offset x - ox and stores the unwrapped move, s1 from it through the same
// ops as the next step's s0.  A particle that has just left through a wall
// lies at most one move (< 1 cell) outside the grid, inside its tile's
// guard band, and its supports take the bounds-checked gather and deposit
// where they reach past the window.
//
// Modes (compile-time): ORDER 1 (CIC) or 2 (TSC); QUANT false (f32 shapes
// and f32 J) or true (int8 matched quantization: shape values round(S*s)
// with the centre-cell partition fold and the window-edge fold; jx/jy are
// integer sums, converted once to f32 times -1/(2 S^2 dt d{y,x}); jz is an
// f32 sum).  NP: the int8 product's column tiles, in pairs of 8 (nxg <= 16
// NP 1, <= 32 NP 2, <= 64 NP 4; the int8 window rule admits nxg <= 64 and
// nyg 8 or 16).  PERIODIC: the boundary, above.
//
// The int8 deposit runs on the tensor cores, as the TPU kernel's is a
// contraction over the particle axis (ppd_kernel.py:745-875): for a slab of
// 32 particles jx = A B with A[row][k] = q0y+q1y and B[k][col] = q1x-q0x of
// particle k (jy: q1y-q0y and q0x+q1x), dense over the window, clipped to
// it.  Each lane writes its particle's (at most) 4 nonzero elements of each
// operand into the warp's staging area (Stage) and clears those of its last
// slab; the warp then loads its mma fragments from there and runs mma.sync
// m16n8k32 s8 x s8 -> s32 (M = nyg padded to 16, N = nxg in steps of 8),
// keeping the s32 sums in registers across its whole walk of the bucket;
// once, at the end, each warp adds them to the block's int32 windows.
// Exact in any order, so equal to the plain version.  The window-edge fold
// can give a centre value up to S = 83, so q0+q1 can leave int8: a particle
// with any operand outside [-127, 127] writes no int8 operands and adds its
// jx/jy terms with int32 shared atomics instead (exact too; the TPU kernel
// casts such a value to int8).  jz carries an f32 factor per particle: it
// is the same kind of product over k = 2*particle + term with integer
// columns (exact in bf16) and f32 rows split into three bf16 words,
// mma.sync m16n8k16 bf16 x bf16 -> f32, each slab summed from zero and then
// added to f32 sums in registers (see Operands).
//
// f32 mode (off the headline) keeps f32 products: the warp groups its lanes
// by their 4x4 base (__match_any_sync); when it holds at most kMaxGroups
// bases it sums each group's 48 values by shuffle trees and one lane per
// cell adds each sum; otherwise each lane adds its own (warp_deposit).  On
// sm_90 a shared float or double atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN), and in lattice order all 8 warps of a block work on
// the same few cells, so the deposit does not add into one set of windows
// for the block: each warp owns a set (P.win_warps 1, SHARED false), and
// adds to it with plain loads and stores, no atomic.  Nor does it sum by
// shuffle trees there: a tree costs the same for a group of 2 lanes as for
// 32, and after a few steps a lattice-order slab spans 5-9 bases.  Where
// no base holds more than kMaxPasses lanes (scattered slots), the lanes
// add their own terms in passes by their rank within their base, term by
// term: two lanes meet on a cell in the same term only when they share a
// base.  Otherwise each lane writes its 48 terms to the warp's staging
// area (kStage values a term, one per lane and a pad: conflict-free both
// ways); then, base by base, lane l sums term l (and lane l < 16 term 32 +
// l) over the base's lanes in lane order, and adds the sums to 16
// distinct cells of each window, the bases one after another: 64 shared
// loads a slab for any number of bases.  The block then sums the sets in
// a fixed order (0, 1, ...) into the output, so J comes out the same from
// run to run.  Wider
// windows, whose private sets and staging do not fit a block's shared
// memory, are taken by 2, 4 or 8 warps to a set (SHARED, chosen at launch
// from P.win_warps, which the wrapper sets: ops/advance.window_warps), and
// those warps deposit as every warp did before the sets were private:
// shuffle trees and atomics; 8 to a set is the one-set layout, so the
// widest window admitted is unchanged.
//
// f64 mode (decks with precision "f64"; the JAX package's exact f64
// Esirkepov deposit, whatever the deck's deposit asks): the f32 mode's code
// instantiated on R = double.  Particles, field and J windows, shapes, the
// fold, the Boris push (1.0 / sqrt), the move and the displacement are all
// double; its own entry point (minipic_advance_f64) takes double constants.
// One block per SM is asked of the compiler (the double registers).  At
// windows of at most 16^2 (every 8x8-tile deck's: P.products, which the
// wrapper sets, ops/advance.f64_products; the template's PRODUCTS) the
// deposit runs on the tensor cores, as the int8 one does.  Each current is
// a sum over particles of outer products of 1-D factors (jx = a_y x a_x,
// jy = r_y x r_x, jz = lz0 x rz0 + lz1 x rz1, rz0 = r_x), so a slab's share
// of a window is A B with A[row][k] particle k's row factor (zero off its
// support) and B[k][col] its column factor, K = 32, 32 and 64.  Each lane
// writes its particle's at most 4 rows and 4 columns of a round's four
// operands into the warp's areas (ProdStage; two rounds a slab), clipped
// to the window; the warp runs mma.sync m16n8k16 f64 on them (M = the 16
// rows; N = the 8-column tiles that the slab's supports reach, a
// warp-uniform skip) and keeps its sums in registers (24 doubles a lane)
// across its whole walk of the bucket; at the end the block adds the
// warps' sums in warp order (0, 1, ...), so J is the same from launch to
// launch.  Every operand and sum is IEEE double; only the order of J's
// additions differs from the plain version's.  Shared memory: the six
// field windows and one J set, 72 bytes a cell, and 18 KB of operands a
// warp (162 KB a block at 16^2).  Wider f64 windows (the laser decks'
// 20^2) keep the f32 mode's deposit in double: the warps' private J sets
// and staging, 240 bytes a cell and 99 KB, or past that shared sets (72
// bytes a cell, one set and no staging, at the widest windows).
//
// What bounds it on this card.  Per particle it moves about 44 bytes of HBM
// (read x, y, px, py, pz, w; write x, y, px, py, pz), about 4.4 GB per step
// at the headline (1e8 particles): 1.32 ms at 3.35 TB/s; its ~400 f32
// operations a particle take 0.6 ms at 67 TFLOP/s.  The first kernel (48
// shared atomics a particle, all 32 lanes of a warp on the same 16 cells:
// consecutive slots hold particles of one cell) took 13.7 ms on an H100
// 80GB HBM3 at 700 W.  This one takes ~6.2 ms there: ~2.9 without its
// deposit (the gather reads a support inside the window without bounds
// checks), ~1.6 in the staging stores (clear and write; shared-memory
// store traffic and address arithmetic), ~1.0 in the jz products, ~0.3 in
// the int8 products (minipic_torch/probe_atomics.py --variants).  Not
// HBM but instruction issue and shared memory, at 2 blocks (16 warps) per
// SM, which both its 128 registers and its 107 KB of shared memory a block
// allow.  The f64 mode moves twice the bytes, 2.65 ms a step at the
// headline.  At the headline's state after 300 steps (a slab's particles
// spread over its tile, as in a long run) it takes 13.4 ms there, where
// the staged per-base sums it replaced took 22.1-22.6: ~7.0 without its
// deposit (the push, latency-bound at one block, 8 warps, per SM), the
// rest the products (each slab's dense 16 x 32 operands, mostly zeros,
// read from shared memory and multiplied: 16 m16n8k16 a slab) and the
// operand stores.
//
// Numerics.  Build with --fmad=false and without --use_fast_math: a
// multiply-add contracted at one site and not at another breaks the
// bit-exact telescoping of s1 (step n) into s0 (step n+1) that the int8
// deposit's continuity rests on.  Rounding is rintf (half to even, as
// jnp.round and torch.round), never roundf.  The reciprocal square root is
// 1.0f / sqrtf(v), correctly rounded, the same expression as the plain
// version's reciprocal(sqrt(v)); CUDA's approximate rsqrtf is not used.

#include <cuda_runtime.h>

// Defined to 1 only by minipic_torch/probe_atomics.py's build: the kernel
// without its deposit (J stays zero), to time the rest.
#ifndef MINIPIC_NO_DEPOSIT
#define MINIPIC_NO_DEPOSIT 0
#endif

// R: float (the int8 and f32 modes) or double (the f64 mode).
template <typename R>
struct AdvanceParamsT {
  int num_tiles, capacity, tile_nx, tile_ny, guard;
  int periodic;         // 1: periodic box (fold and wrap); 0: open walls
  int win_warps;        // f32, f64: warps to a set of J windows (1, 2, 4, 8)
  int fused;            // 1: own watermark, prefix sums, wmax (see Layout)
  int products;         // f64: 1 for the tensor-core deposit (see f64 mode)
  R h;                  // push half-kick q/m dt/2 (int8: times 1/S^2)
  R dtdx, dtdy;         // dt/dx, dt/dy
  R q;                  // species charge
  R grid_nx, grid_ny;   // periodic box in cells (fold and wrap; 0 open)
  R inv_nx, inv_ny;     // 1/nx, 1/ny (0 open)
  R half_x, half_y;     // (nx - tile_nx)/2, (ny - tile_ny)/2 (0 open)
  R cjx, cjy;           // jx, jy factors (f32, f64: -1/(dt dy), -1/(dt dx);
                        // int8: -1/(2 S^2 dt dy), -1/(2 S^2 dt dx))
  R cz;                 // 1/(dx dy)
  R czq;                // 1/S^2
  R S;                  // shape quantization scale
};
using AdvanceParams = AdvanceParamsT<float>;
using AdvanceParams64 = AdvanceParamsT<double>;

namespace {

// The math of one real type: float's single-precision functions, double's
// own, correctly rounded where IEEE asks it (sqrt, division).
__device__ __forceinline__ float r_floor(float v) { return floorf(v); }
__device__ __forceinline__ double r_floor(double v) { return floor(v); }
__device__ __forceinline__ float r_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double r_abs(double v) { return fabs(v); }
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float r_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double r_sqrt(double v) { return sqrt(v); }


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// f32 mode: bases a warp pre-reduces (one shuffle tree each) before it
// falls back to per-lane atomics.
constexpr int kMaxGroups = 4;
// f32 and f64 modes with private J windows: a warp's staging holds its 48
// terms a lane, kStage values each (32 lanes and a pad).
constexpr int kStage = 33;
constexpr int kTerms = 48;
// ... unless no base of the slab holds more than kMaxPasses lanes: then
// the lanes add their own terms, one pass per rank within a base.
constexpr int kMaxPasses = 3;
// Staged sums: a base's lanes' terms loaded kUnroll at a time.
constexpr int kUnroll = 4;
constexpr bool kDeposit = !MINIPIC_NO_DEPOSIT;
constexpr float kSixth = (float)(1.0 / 6.0);
// The fused watermark's scan: kScanUnroll<R> loads in flight a thread, so
// a chunk of kThreads * kScanUnroll<R> slots per block-wide round trip.
// Measured at the headline's state (H100 80GB HBM3): float 8 and 16 take the
// same time, 16 and more spill in the int8 kernel; double 64 is the fastest
// of 8 to 64 (its kernel 20.4 ms against 21.5 without the scan).
template <typename R>
constexpr int kScanUnroll = sizeof(R) == 8 ? 64 : 8;

__device__ __forceinline__ float neg_inf(float) {
  return __int_as_float((int)0xff800000u);
}
__device__ __forceinline__ double neg_inf(double) {
  return __longlong_as_double((long long)0xfff0000000000000ULL);
}

// torch's max of two values: NaN wins (so a NaN anywhere is the max).
template <typename R>
__device__ __forceinline__ R nan_max(R a, R b) {
  return (b > a || b != b) ? b : a;
}

// nan_max over v of every lane of the warp.
template <typename R>
__device__ __forceinline__ R warp_nan_max(R v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The highest slot of w[0, n) with w > 0, plus 1 (0 for none), as
// ops/advance.live_watermark: the block reads w from slot n - 1 down, a
// chunk at a time (coalesced, kScanUnroll<R> loads in flight a thread),
// until a chunk holds a slot with w > 0.  wmx takes the nan_max of
// every value this thread read.  Every thread of the block calls it; *s_wm
// is 0 on entry (and read by all after a barrier).
template <typename R>
__device__ int watermark(const R* __restrict__ w, int n, int* s_wm, R& wmx) {
  constexpr int U = kScanUnroll<R>;
  for (int end = n; end > 0; end -= kThreads * U) {
    R v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = end - 1 - (u * kThreads + (int)threadIdx.x);
      v[u] = s >= 0 ? w[s] : R(0);
    }
    int hi = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = end - 1 - (u * kThreads + (int)threadIdx.x);
      if (s >= 0) {
        wmx = nan_max(wmx, v[u]);
        if (v[u] > R(0)) hi = max(hi, s + 1);
      }
    }
    if (__syncthreads_or(hi != 0)) {
      if (hi) atomicMax(s_wm, hi);
      __syncthreads();
      return *s_wm;
    }
  }
  return 0;
}

// In place: a[k] = a[0] + a[1] + ... + a[k] (stride apart), added left to
// right in V.
template <typename V>
__device__ __forceinline__ void prefix_sum(V* a, int n, int stride) {
  V acc = a[0];
  for (int k = 1; k < n; ++k) {
    acc = acc + a[k * stride];
    a[k * stride] = acc;
  }
}

// Staging bytes of one warp for its tensor-core products, at NP pairs of
// 8-column tiles: int8 A of jx and of jy (16 rows x 32 particles, 512 each)
// and B (16 NP columns x 32 particles, 512 NP each); jz's A (16 rows x 32
// particles, both terms in three bf16 words, 16 bytes: 8192) and B (16 NP
// columns x 32 particles, both terms in bf16: 2048 NP).
__host__ __device__ constexpr int stage_bytes(int np) {
  return 9216 + 3072 * np;
}

template <int ORDER, typename R>
__device__ __forceinline__ R shape_val(R u) {
  const R au = r_abs(u);
  if (ORDER == 1) return r_max(R(0), R(1) - au);
  const R inner = R(0.75) - au * au;
  const R o = R(1.5) - au;
  const R outer = R(0.5) * (o * o);
  return au <= R(0.5) ? inner : (au <= R(1.5) ? outer : R(0));
}

// shape_val for |u| in [0.5, 1.5].
template <int ORDER>
__device__ __forceinline__ float shape_outer(float u) {
  if (ORDER == 1) return shape_val<1>(u);
  const float o = 1.5f - fabsf(u);
  return 0.5f * (o * o);
}

// Centre cell c (returned, as a real) and the support values at c-1, c,
// c+1 of one stagger class (half: cell coordinates a + 1/2).  QUANT is
// float only.
template <int ORDER, bool QUANT, typename R>
__device__ __forceinline__ R support3(R pos, bool half, int n_rows, int g,
                                      R S, R v[3]) {
  const R c = half ? r_floor(pos) : r_floor(pos + R(0.5));
  if constexpr (QUANT) {
    float tm = pos - (c - 1.0f);
    float tp = pos - (c + 1.0f);
    if (half) {
      tm = tm - 0.5f;
      tp = tp - 0.5f;
    }
    // |tm|, |tp| lie in [0.5, 1.5]: TSC's outer branch alone gives the
    // same value there (both branches give 0.5 at 0.5).
    const float qm = rintf(shape_outer<ORDER>(tm) * S);
    const float qp = rintf(shape_outer<ORDER>(tp) * S);
    float qc = (S - qm) - qp;
    const float cr = c + (float)g;
    if (cr <= 0.0f) qc = qc + qm;
    if (cr >= (float)(n_rows - 1)) qc = qc + qp;
    v[0] = qm;
    v[1] = qc;
    v[2] = qp;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      R u = pos - (c + R(k - 1));
      if (half) u = u - R(0.5);
      v[k] = shape_val<ORDER>(u);
    }
  }
  return c;
}

// sum_j sy[j] * (sum_i F[row, col] * sx[i]); off-window cells skipped.
template <typename R>
__device__ __forceinline__ R gather(const R* F, int cy, const R sy[3],
                                    int cx, const R sx[3], int g, int nyg,
                                    int nxg) {
  R e = R(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int r = cy + j - 1 + g;
    if (r < 0 || r >= nyg) continue;
    R m = R(0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int col = cx + i - 1 + g;
      if (col < 0 || col >= nxg) continue;
      m = m + F[r * nxg + col] * sx[i];
    }
    e = e + m * sy[j];
  }
  return e;
}

// gather() of a support inside the window, from F at its first cell: no
// checks, and the plain version's order (the first term is not added to a
// zero).
template <typename R>
__device__ __forceinline__ R gather_in(const R* F, int nxg, const R sy[3],
                                       const R sx[3]) {
  R e = R(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const R* row = F + j * nxg;
    R m = row[0] * sx[0];
    m = m + row[1] * sx[1];
    m = m + row[2] * sx[2];
    e = j == 0 ? m * sy[0] : e + m * sy[j];
  }
  return e;
}

template <typename R>
__device__ __forceinline__ R fold(R pos, R origin, R gn, R half, R inv) {
  const R xi = pos - origin;
  return xi - gn * r_floor((xi + half) * inv);
}

// Tile-local coordinate: the nearest-image fold on a periodic box, the raw
// offset between open walls.
template <typename R>
__device__ __forceinline__ R local(R pos, R origin, bool periodic, R gn,
                                   R half, R inv) {
  return periodic ? fold(pos, origin, gn, half, inv) : pos - origin;
}

template <typename R>
__device__ __forceinline__ R wrap(R v, R n, R inv) {
  R w = v - n * r_floor(v * inv);
  if (w < R(0)) w = w + n;
  if (w >= n) w = w - n;
  return w;
}

// Sparse 3-point values (centre c) laid on 4 cells base, base+1, ...
__device__ __forceinline__ void place4(float base, float c, const float v[3],
                                       float out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float d = (base + (float)k) - c;
    out[k] = d == -1.0f ? v[0] : (d == 0.0f ? v[1] : (d == 1.0f ? v[2] : 0.0f));
  }
}

// place4 where c - base is 1 (at1) or 2: the union support of two centres
// at most a cell apart, base = min(c0, c1) - 1.
__device__ __forceinline__ void place4_near(bool at1, const float v[3],
                                            float out[4]) {
  out[0] = at1 ? v[0] : 0.0f;
  out[1] = at1 ? v[1] : v[0];
  out[2] = at1 ? v[2] : v[1];
  out[3] = at1 ? 0.0f : v[2];
}

// s8 x s8 -> s32: c += A (16 x 32, row) B (32 x 8, col).
__device__ __forceinline__ void mma_s8(int c[4], const uint4& a, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// bf16 x bf16 -> f32: c += A (16 x 16, row) B (16 x 8, col).
__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest, ties to even) as one bf16x2
// register, lo in the low half (the even k).
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// One lane's operands over its 4x4 support.  int8 (jx = ay x ax, jy =
// ry x rx): ay = q0y+q1y, ax = q1x-q0x, ry = q1y-q0y, rx = q0x+q1x.  jz =
// sum_e lz_e x rz_e with lz0 = czq q0y / 2, lz1 = czq (q1y-q0y) / 6 and the
// integers rz0 = q0x+q1x, rz1 = q0x+2 q1x (|rz| <= 249: exact in bf16); the
// same terms as lz0 rz0 + lz1 rz1 of the plain version, factors moved.  Each
// lz goes to the tensor cores as three bf16 words (hi + mid + lo, ~24 bits),
// so that the bf16 products are f32-accurate.
struct Operands {
  int ay[4], ax[4], ry[4], rx[4];
  float lz[2][4];
  unsigned zc[4];  // [column]: bf16x2 (rz0, rz1)

  // Returns whether every int8 operand fits [-127, 127].
  __device__ __forceinline__ bool set(const float q0x[4], const float q1x[4],
                                      const float q0y[4], const float q1y[4],
                                      float czq) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ay[i] = (int)(q0y[i] + q1y[i]);
      ax[i] = (int)(q1x[i] - q0x[i]);
      ry[i] = (int)(q1y[i] - q0y[i]);
      rx[i] = (int)(q0x[i] + q1x[i]);
      // |q1 - q0| <= S <= 83: only the sums can leave int8.
      ok = ok && abs(ay[i]) <= 127 && abs(rx[i]) <= 127;
      lz[0][i] = 0.5f * (q0y[i] * czq);
      lz[1][i] = ((q1y[i] - q0y[i]) * czq) * kSixth;
      zc[i] = bf16x2((float)rx[i], (float)(rx[i] + (int)q1x[i]));
    }
    return ok;
  }
};

// One warp's staging area (stage_bytes(NP) bytes), seen from one lane: the
// particle k = lane of each slab.  Each element's offset is linear in its
// row (or column), so a lane finds its four with one multiply-add each;
// xors on the particle index spread a warp's loads over the banks.  int8
// (m16n8k32 .s8), bytes: A of jx and of jy at 32*row + k; B of jx and of jy
// at 32*col + k.  jz (m16n8k16 .bf16, k = 2*particle + term, the two terms
// in one 32-bit word): A as 16 bytes (words 0-2: the three bf16 words of
// lz) at uint4 32*row + (k ^ 4*(row&1)); B (rz) at word 32*col + (pair(k)
// ^ 4*(col&7)), where pair() puts particles 8i + t and 8i + 4 + t side by
// side (one 8-byte load).  Each slab clears the lane's elements of the last
// slab and writes its own, so the area is zero wherever no particle of the
// slab has an element.
template <int NP>
struct Stage {
  static constexpr int kBytes = stage_bytes(NP);
  unsigned char *ax, *ay, *bx, *by;
  uint4* za;
  unsigned* zb;
  int k;

  __device__ Stage(unsigned char* p, int lane)
      : ax(p), ay(p + 512), bx(p + 1024), by(p + 1024 + 512 * NP),
        za(reinterpret_cast<uint4*>(p + 1024 + 1024 * NP)),
        zb(reinterpret_cast<unsigned*>(p + 9216 + 1024 * NP)), k(lane) {}

  __device__ static int pair(int p) {
    return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
  }

  // Writes this lane's row elements (A: jz's, and int8's when prod) from
  // support row row0, when live; with clear, zeroes them instead (o is not
  // read).  jz A's xor flips with the row's parity.
  __device__ __forceinline__ void put_rows(const Operands& o, bool live,
                                           bool prod, int row0, int nyg,
                                           bool clear) {
    if (!live) return;
    const int zr = 32 * row0 + (k ^ ((row0 & 1) << 2)), ar = 32 * row0 + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + j;
      if (r < 0 || r >= nyg) continue;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!clear) {
        float l0 = o.lz[0][j], l1 = o.lz[1][j];
        v.x = bf16x2(l0, l1);
        l0 = l0 - __uint_as_float(v.x << 16);
        l1 = l1 - __uint_as_float(v.x & 0xffff0000u);
        v.y = bf16x2(l0, l1);
        l0 = l0 - __uint_as_float(v.y << 16);
        l1 = l1 - __uint_as_float(v.y & 0xffff0000u);
        v.z = bf16x2(l0, l1);
      }
      za[(zr + 32 * j) ^ ((j & 1) << 2)] = v;
      if (prod) {
        ax[ar + 32 * j] = clear ? 0 : (unsigned char)(signed char)o.ay[j];
        ay[ar + 32 * j] = clear ? 0 : (unsigned char)(signed char)o.ry[j];
      }
    }
  }

  // The same for the column elements (B) from support column col0.
  __device__ __forceinline__ void put_cols(const Operands& o, bool live,
                                           bool prod, int col0, int nxg,
                                           bool clear) {
    if (!live) return;
    const int bc = 32 * col0 + k, pk = pair(k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + j;
      if (c < 0 || c >= nxg) continue;
      zb[32 * c + (pk ^ ((c & 7) << 2))] = clear ? 0u : o.zc[j];
      if (prod) {
        bx[bc + 32 * j] = clear ? 0 : (unsigned char)(signed char)o.ax[j];
        by[bc + 32 * j] = clear ? 0 : (unsigned char)(signed char)o.rx[j];
      }
    }
  }

  // The slab's int8 products into the s32 sums: A rows grp and grp+8 x
  // particles 4t.. and 16+4t.. (4 bytes each), B column grp of each column
  // tile x the same particles.
  __device__ __forceinline__ void int8_products(int lane, int accx[][4],
                                                int accy[][4]) const {
    const int grp = lane >> 2, t4 = 4 * (lane & 3);
    const auto word = [](const unsigned char* m, int at) {
      return *reinterpret_cast<const unsigned*>(m + at);
    };
    const uint4 fx = make_uint4(word(ax, 32 * grp + t4),
                                word(ax, 32 * grp + 256 + t4),
                                word(ax, 32 * grp + 16 + t4),
                                word(ax, 32 * grp + 272 + t4));
    const uint4 fy = make_uint4(word(ay, 32 * grp + t4),
                                word(ay, 32 * grp + 256 + t4),
                                word(ay, 32 * grp + 16 + t4),
                                word(ay, 32 * grp + 272 + t4));
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt) {
      const int at = 32 * (8 * nt + grp) + t4;
      mma_s8(accx[nt], fx, word(bx, at), word(bx, at + 16));
      mma_s8(accy[nt], fy, word(by, at), word(by, at + 16));
    }
  }

  // The slab's jz product (4 k-steps x 3 words), summed from zero and then
  // added to the f32 sums: the tensor cores' own f32 adds stay within a
  // slab.  k-step ks: A rows grp and grp+8 x particles 8ks + t and 8ks +
  // 4 + t (both terms each), B column grp of each column tile x the same.
  __device__ __forceinline__ void jz_products(int lane,
                                              float accz[][4]) const {
    const int grp = lane >> 2, t = lane & 3;
    float d[2 * NP][4];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int p0 = 8 * ks + t, p1 = p0 + 4;
      const int sw = (grp & 1) << 2;  // rows grp and grp+8: same parity
      const uint4 a0 = za[32 * grp + (p0 ^ sw)];
      const uint4 a1 = za[32 * (grp + 8) + (p0 ^ sw)];
      const uint4 a2 = za[32 * grp + (p1 ^ sw)];
      const uint4 a3 = za[32 * (grp + 8) + (p1 ^ sw)];
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt) {
        // Particles p0 and p1 = p0 + 4 side by side (pair()).
        const uint2 b = *reinterpret_cast<const uint2*>(
            zb + 32 * (8 * nt + grp) + ((8 * ks + 2 * t) ^ (grp << 2)));
        mma_bf16(d[nt], make_uint4(a0.x, a1.x, a2.x, a3.x), b.x, b.y);
        mma_bf16(d[nt], make_uint4(a0.y, a1.y, a2.y, a3.y), b.x, b.y);
        mma_bf16(d[nt], make_uint4(a0.z, a1.z, a2.z, a3.z), b.x, b.y);
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) accz[n][e] = accz[n][e] + d[n][e];
  }
};

// f64 x f64 -> f64: c += A (16 x 16, row) B (16 x 8, col).  Lane (g, t)
// = (lane / 4, lane % 4) holds A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i],
// B[t + 4 i][g] in b[i] and C[g + 8 (i / 2)][2 t + i % 2] in c[i].  Of
// sm_90's f64 shapes m8n8k4, m16n8k4, m16n8k8 and m16n8k16 the last gave
// B1 its least time on an H100 (the headline's state after 300 steps: 13.4
// ms; m8n8k4 14.6).
constexpr int kProdK = 16;
__device__ __forceinline__ void mma_f64(double c[4], const double a[8],
                                        const double b[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The f64 mode's tensor-core deposit (PRODUCTS) takes windows of at most
// kProdCells rows and columns: a warp keeps each current's sums as two C
// tiles of 16 rows x 8 columns.
constexpr int kProdCells = 16;
// One warp's operand areas, seen from one lane (particle k = lane of each
// slab): rows A0 and A1 [row][k], columns B0 and B1 [col][k], kProdLd
// doubles a row or column (32 particles and a pad: each fragment load of
// the warp reads rows (columns) g and particles 4 q + t, and each half
// warp's 16 loads fall on 16 distinct bank pairs).  Each slab writes a
// lane's at most 4 rows (or columns) of its column k, clipped to the
// window, and clears those of its last slab that it does not overwrite,
// so an area is zero wherever no particle of the slab has an element.
constexpr int kProdLd = 36;
constexpr int kProdArea = kProdCells * kProdLd;

__host__ __device__ constexpr int prod_stage_bytes() {
  return 4 * kProdArea * (int)sizeof(double);
}

struct ProdStage {
  double* a[2];
  double* b[2];
  int k;

  __device__ ProdStage(double* p, int lane)
      : a{p, p + kProdArea}, b{p + 2 * kProdArea, p + 3 * kProdArea},
        k(lane) {}

  // v[j] (or zero, with clear) at row (column) first + j < n of column k
  // of m.
  __device__ __forceinline__ void put(double* m, const double v[4],
                                      int first, int n, bool clear) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = first + j;
      if (r >= 0 && r < n) m[r * kProdLd + k] = clear ? 0.0 : v[j];
    }
  }

  // acc0 += A0 B0 and acc1 += A1 B1 over the slab's 32 particles (k-steps
  // of kProdK), on the C tiles j (the window's 16 rows x columns 8 j ..
  // 8 j + 7; acc[j]) set in COLS; (a0, b0) and (a1, b1) index a and b.
  template <unsigned COLS>
  __device__ __forceinline__ void products_on(int a0, int b0,
                                              double acc0[2][4], int a1,
                                              int b1,
                                              double acc1[2][4]) const {
    constexpr int kq = kProdK / 4;
    const int g = k >> 2, t = k & 3;
#pragma unroll
    for (int kb = 0; kb < 32; kb += kProdK) {
      double fa0[2 * kq], fa1[2 * kq];
#pragma unroll
      for (int i = 0; i < 2 * kq; ++i) {
        const int at = (g + 8 * (i & 1)) * kProdLd + kb + 4 * (i >> 1) + t;
        fa0[i] = a[a0][at];
        fa1[i] = a[a1][at];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!(COLS >> j & 1u)) continue;
        double fb0[kq], fb1[kq];
#pragma unroll
        for (int i = 0; i < kq; ++i) {
          const int at = (8 * j + g) * kProdLd + kb + 4 * i + t;
          fb0[i] = b[b0][at];
          fb1[i] = b[b1][at];
        }
        mma_f64(acc0[j], fa0, fb0);
        mma_f64(acc1[j], fa1, fb1);
      }
    }
  }

  // products_on the column tiles marked in `cols` (a warp-uniform mask of
  // 1, 2 or 3; 0 for none): one branch a slab, and no work issued for a
  // column tile that no support reaches.
  __device__ __forceinline__ void products(int a0, int b0,
                                           double acc0[2][4], int a1,
                                           int b1, double acc1[2][4],
                                           unsigned cols) const {
    if (cols == 1u) products_on<1u>(a0, b0, acc0, a1, b1, acc1);
    if (cols == 2u) products_on<2u>(a0, b0, acc0, a1, b1, acc1);
    if (cols == 3u) products_on<3u>(a0, b0, acc0, a1, b1, acc1);
  }
};

// The 8-column tiles of [0, n) that columns first .. first + 3 of the
// warp's depositing lanes reach, as a mask (warp-uniform; 0 for none).
__device__ __forceinline__ unsigned prod_tiles(bool dep, int first, int n) {
  const int lo = max(__reduce_min_sync(kFull, dep ? first : n), 0);
  const int hi = min(__reduce_max_sync(kFull, dep ? first + 3 : -1), n - 1);
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lo <= 8 * i + 7 && hi >= 8 * i && lo <= hi) m |= 1u << i;
  return m;
}

// One stage of reduce16: lanes 2*HALF apart swap half of their remaining
// 2*HALF values and add the other half.
template <int HALF, typename R>
__device__ __forceinline__ void tree_stage(R v[16], int lane) {
  const bool up = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const R send = up ? v[i] : v[i + HALF];
    const R keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2 * HALF);
  }
}

// The warp's sum of value (lane >> 1) & 15 of v[16] (v is overwritten).
template <typename R>
__device__ __forceinline__ R reduce16(R v[16], int lane) {
  tree_stage<8>(v, lane);
  tree_stage<4>(v, lane);
  tree_stage<2>(v, lane);
  tree_stage<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// f32 and f64 modes: adds the jx, jy and jz terms v[3][16] (cell (row0 +
// k/4, col0 + k%4) for k = 0..15) of every depositing lane to the windows
// win[3], the lanes grouped by their 4x4 base.  OWN (win is this warp's
// alone), plain load-add-stores: where no base holds more than kMaxPasses
// lanes, in passes by each lane's rank within its base and term by term
// (the lanes of one round hit distinct cells); else through the warp's
// staging `stage` (kTerms x kStage), base by base in the order of each
// base's first lane, each base's 48 sums (its lanes' terms in lane order)
// to 16 distinct cells of each window.  __syncwarp() after each round or
// base orders its stores before the next one's loads of the same cells
// (two bases a cell apart share 12), and the staging loads before the
// next slab's stores.
// Not OWN (windows shared with other warps): per base by shuffle trees
// when the warp holds at most kMaxGroups bases, else lane by lane, with
// atomics.
template <bool OWN, typename R>
__device__ __forceinline__ void warp_deposit(R* const win[3], R v[3][16],
                                             R* stage, bool dep,
                                             int row0, int col0, int lane,
                                             int nyg, int nxg) {
  // A base off the window by 4 or more adds nothing: clamp it to make a key.
  const unsigned rk = (unsigned)(min(max(row0, -4), nyg) + 4);
  const unsigned ck = (unsigned)(min(max(col0, -4), nxg) + 4);
  const unsigned key = dep ? (rk << 16) | ck : kFull;
  const unsigned grp = __match_any_sync(kFull, key);
  const unsigned leaders =
      __ballot_sync(kFull, dep && (__ffs(grp) - 1) == lane);
  if constexpr (OWN) {
    const int rank = __popc(grp & ((1u << lane) - 1u));
    const int passes = (int)__reduce_max_sync(kFull, dep ? rank + 1 : 0);
    if (passes <= kMaxPasses) {
      for (int pass = 0; pass < passes; ++pass) {
        const bool go = dep && rank == pass;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + j, c = col0 + i;
            if (go && r >= 0 && r < nyg && c >= 0 && c < nxg) {
#pragma unroll
              for (int n = 0; n < 3; ++n) {
                R* const cell = &win[n][r * nxg + c];
                *cell = *cell + v[n][j * 4 + i];
              }
            }
            __syncwarp();
          }
        }
      }
      return;
    }
    if (dep) {
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int k = 0; k < 16; ++k)
          stage[(16 * n + k) * kStage + lane] = v[n][k];
    }
    __syncwarp();
    const int k = lane & 15;
    for (unsigned todo = leaders; todo; todo &= todo - 1) {
      const int first = __ffs(todo) - 1;
      const unsigned members = __shfl_sync(kFull, grp, first);
      const unsigned lkey = __shfl_sync(kFull, key, first);
      // Lane l: term l (jx, jy) and, below 16, term 32 + l (jz), into the
      // cell's window values, which are loaded first.
      const int r = (int)(lkey >> 16) - 4 + (k >> 2);
      const int c = (int)(lkey & 0xffffu) - 4 + (k & 3);
      const bool in = r >= 0 && r < nyg && c >= 0 && c < nxg;
      R* const a = (lane < 16 ? win[0] : win[1]) + r * nxg + c;
      R* const z = win[2] + r * nxg + c;
      const R a0 = in ? *a : R(0);
      const R z0 = in && lane < 16 ? *z : R(0);
      // The base's lanes' terms in lane order, kUnroll loads in flight (a
      // missing one adds an exact zero).
      R s = R(0), sz = R(0);
      for (unsigned m = members; m;) {
        R t[kUnroll], tz[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          t[u] = tz[u] = R(0);
          if (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            t[u] = stage[lane * kStage + src];
            if (lane < 16) tz[u] = stage[(32 + lane) * kStage + src];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s = s + t[u];
          sz = sz + tz[u];
        }
      }
      if (in) {
        *a = a0 + s;
        if (lane < 16) *z = z0 + sz;
      }
      __syncwarp();
    }
  } else if (__popc(leaders) <= kMaxGroups) {
    const int idx = (lane >> 1) & 15;
    for (unsigned todo = leaders; todo; todo &= todo - 1) {
      const unsigned lkey = __shfl_sync(kFull, key, __ffs(todo) - 1);
      const bool mine = key == lkey;
      const int r = (int)(lkey >> 16) - 4 + (idx >> 2);
      const int c = (int)(lkey & 0xffffu) - 4 + (idx & 3);
      const bool add = (lane & 1) == 0 && r >= 0 && r < nyg && c >= 0 &&
                       c < nxg;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        R t[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) t[k] = mine ? v[n][k] : R(0);
        const R s = reduce16(t, lane);
        if (add) atomicAdd(&win[n][r * nxg + c], s);
      }
    }
  } else if (dep) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + j;
      if (r < 0 || r >= nyg) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = col0 + i;
        if (c < 0 || c >= nxg) continue;
#pragma unroll
        for (int n = 0; n < 3; ++n)
          atomicAdd(&win[n][r * nxg + c], v[n][j * 4 + i]);
      }
    }
  }
}

// Blocks per SM asked of the compiler: 2 for float; 1 for double, whose
// registers are twice as many.
template <typename R>
constexpr int kMinBlocks = sizeof(R) == 4 ? 2 : 1;

template <int ORDER, bool QUANT, int NP, bool PERIODIC, bool SHARED,
          typename R, bool PRODUCTS = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks<R>)
advance_kernel(AdvanceParamsT<R> P,
               const R* __restrict__ x, const R* __restrict__ y,
               const R* __restrict__ px, const R* __restrict__ py,
               const R* __restrict__ pz, const R* __restrict__ w,
               const int* __restrict__ counts,
               const int* __restrict__ ox_t, const int* __restrict__ oy_t,
               const R* __restrict__ ex, const R* __restrict__ ey,
               const R* __restrict__ ez, const R* __restrict__ bx,
               const R* __restrict__ by, const R* __restrict__ bz,
               R* __restrict__ xo, R* __restrict__ yo,
               R* __restrict__ pxo, R* __restrict__ pyo,
               R* __restrict__ pzo,
               R* __restrict__ jxo, R* __restrict__ jyo,
               R* __restrict__ jzo, R* __restrict__ dmax,
               R* __restrict__ wmax) {
  static_assert(!QUANT || sizeof(R) == 4, "the int8 mode is float only");
  static_assert(!(QUANT && SHARED), "the int8 mode has its own one set");
  static_assert(!PRODUCTS || (sizeof(R) == 8 && !QUANT && !SHARED),
                "the tensor-core f64 deposit keeps one set of its own");
  constexpr int NT = 2 * NP;  // column tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The block's max displacement: float's as its bits (non-negative floats
  // order as their bits read as integers) by a shared atomicMax; double's
  // by the warps' maxima, one slot a warp (a 64-bit shared atomicMax is a
  // compare-and-swap loop on sm_90).
  __shared__ int s_dmax;
  __shared__ R s_wmax[kWarps];
  // Fused: the watermark found, and (int8) the warps' largest weights.
  __shared__ int s_wm;
  __shared__ R s_weight[kWarps];
  const int g = P.guard;
  const int nxg = P.tile_nx + 2 * g;
  const int nyg = P.tile_ny + 2 * g;
  const int nwin = nxg * nyg;
  R* f_ex = reinterpret_cast<R*>(smem_raw);
  R* f_ey = f_ex + nwin;
  R* f_ez = f_ey + nwin;
  R* f_bx = f_ez + nwin;
  R* f_by = f_bx + nwin;
  R* f_bz = f_by + nwin;
  // J: nsets sets of (jx, jy, jz) windows, warps w * win_warps .. (w + 1) *
  // win_warps - 1 adding to set w (SHARED; else a set per warp); QUANT: one
  // set, jx and jy int32; PRODUCTS: one set.
  const int nsets =
      QUANT || PRODUCTS ? 1 : (SHARED ? kWarps / P.win_warps : kWarps);
  R* s_jx = f_bz + nwin;  // set 0
  R* s_jy = s_jx + nwin;
  R* s_jz = s_jy + nwin;
  int* i_jx = reinterpret_cast<int*>(s_jx);
  int* i_jy = reinterpret_cast<int*>(s_jy);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // QUANT: this warp's staging (nwin is a multiple of 8: 16-byte aligned).
  Stage<NP> st(reinterpret_cast<unsigned char*>(s_jz + nwin) +
                   warp * Stage<NP>::kBytes,
               lane);
  // What this lane staged last, for Stage::put to clear.
  bool last_live = false, last_prod = false;
  int last_row0 = 0, last_col0 = 0;
  int accx[NT][4], accy[NT][4];
  float accz[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      accx[n][e] = accy[n][e] = 0;
      accz[n][e] = 0.0f;
    }
  // PRODUCTS: this warp's operand areas (after the one set) and its sums of
  // jx, jy, jz as mma_f64's C fragments [column tile][element].
  const ProdStage pst(reinterpret_cast<double*>(s_jz + nwin) +
                          warp * (prod_stage_bytes() / 8),
                      lane);
  double pacc[3][2][4];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[n][j][e] = 0.0;

  const int t = blockIdx.x;
  const size_t fbase = (size_t)t * nwin;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    f_ex[i] = ex[fbase + i];
    f_ey[i] = ey[fbase + i];
    f_ez[i] = ez[fbase + i];
    f_bx[i] = bx[fbase + i];
    f_by[i] = by[fbase + i];
    f_bz[i] = bz[fbase + i];
    s_jx[i] = R(0);  // all-zero bits: int 0 as well
    s_jy[i] = R(0);
    s_jz[i] = R(0);
  }
  for (int i = 3 * nwin + threadIdx.x; i < 3 * nsets * nwin; i += blockDim.x)
    s_jx[i] = R(0);  // the other sets
  if (QUANT || PRODUCTS) {
    unsigned* words = reinterpret_cast<unsigned*>(s_jz + nwin);
    const int n = kWarps * (QUANT ? Stage<NP>::kBytes : prod_stage_bytes());
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) words[i] = 0u;
  }
  if (threadIdx.x == 0) {
    s_dmax = 0;
    s_wm = 0;
  }
  __syncthreads();

  const size_t pbase = (size_t)t * P.capacity;
  // int8: the largest weight of every slot this thread reads (the scan's
  // and the slab loop's; together every slot of the bucket).
  R wmx = neg_inf(R(0));
  const int count = P.fused ? watermark(w + pbase, P.capacity, &s_wm, wmx)
                            : counts[t];
  const int count32 = min(P.capacity, (count + 31) & ~31);
  const R ox = (R)ox_t[t];
  const R oy = (R)oy_t[t];
  const R S = P.S;
  const R third = R(1.0 / 3.0);
  constexpr bool periodic = PERIODIC;
  R* const set =
      s_jx + (QUANT ? 0 : (SHARED ? warp / P.win_warps : warp)) * 3 * nwin;
  R* const wins[3] = {set, set + nwin, set + 2 * nwin};
  // Private sets: this warp's staging, after the sets.
  R* const stage = s_jx + 3 * nsets * nwin + warp * kTerms * kStage;
  R local_max = R(0);

  // The slab loop: trip count uniform across the warp; six values of the
  // next slab in flight while this one computes.  The warp's walk: slabs
  // warp, warp + kWarps, ... of the bucket.
  const int s_first = warp * 32, s_step = kThreads, s_end = count32;
  R nx0 = R(0), ny0 = R(0), nux = R(0), nuy = R(0), nuz = R(0), nwv = R(0);
  {
    const int s = s_first + lane;
    if (s < s_end) {
      const size_t k = pbase + s;
      nx0 = x[k]; ny0 = y[k]; nux = px[k]; nuy = py[k]; nuz = pz[k];
      nwv = w[k];
    }
  }
  for (int sbase = s_first; sbase < s_end; sbase += s_step) {
    const int s = sbase + lane;
    const size_t k = pbase + s;
    const R x0 = nx0, y0 = ny0, ux = nux, uy = nuy, uz = nuz, wv = nwv;
    if constexpr (QUANT) {
      if (s < s_end) wmx = nan_max(wmx, wv);
    }
    if (s + s_step < s_end) {
      const size_t kn = k + s_step;
      nx0 = x[kn]; ny0 = y[kn]; nux = px[kn]; nuy = py[kn]; nuz = pz[kn];
      nwv = w[kn];
    }
    const bool live = s < count && wv != R(0);
    bool prod = false;  // int8 jx/jy through the tensor cores
    int row0 = 0, col0 = 0;
    Operands ops;      // QUANT
    R v[3][16];        // f32 and f64 modes: jx, jy, jz terms
    // PRODUCTS: the rows a_y, r_y, lz0, lz1 and the columns a_x, r_x (=
    // rz0), rz1 of the terms.
    R fr[4][4], fc[3][4];
    if (!live) {
      if (s < count32) {
        xo[k] = x0;
        yo[k] = y0;
        pxo[k] = ux;
        pyo[k] = uy;
        pzo[k] = uz;
      }
    } else {
      const R xi = local(x0, ox, periodic, P.grid_nx, P.half_x, P.inv_nx);
      const R eta = local(y0, oy, periodic, P.grid_ny, P.half_y, P.inv_ny);

      R sxi[3], sxh[3], syi[3], syh[3];
      const R cxi = support3<ORDER, QUANT>(xi, false, nxg, g, S, sxi);
      const R cxh = support3<ORDER, QUANT>(xi, true, nxg, g, S, sxh);
      const R cyi = support3<ORDER, QUANT>(eta, false, nyg, g, S, syi);
      const R cyh = support3<ORDER, QUANT>(eta, true, nyg, g, S, syh);
      const int ixi = (int)cxi, ixh = (int)cxh, iyi = (int)cyi,
                iyh = (int)cyh;

      R e1, e2, e3, b1, b2, b3;
      if (min(iyi, iyh) + g >= 1 && max(iyi, iyh) + g <= nyg - 2 &&
          min(ixi, ixh) + g >= 1 && max(ixi, ixh) + g <= nxg - 2) {
        // Both staggers' 3x3 supports inside the window (nearly always).
        const int ri = (iyi - 1 + g) * nxg, rh = (iyh - 1 + g) * nxg;
        const int ci = ixi - 1 + g, ch = ixh - 1 + g;
        e1 = gather_in(f_ex + ri + ch, nxg, syi, sxh);
        e2 = gather_in(f_ey + rh + ci, nxg, syh, sxi);
        e3 = gather_in(f_ez + ri + ci, nxg, syi, sxi);
        b1 = gather_in(f_bx + rh + ci, nxg, syh, sxi);
        b2 = gather_in(f_by + ri + ch, nxg, syi, sxh);
        b3 = gather_in(f_bz + rh + ch, nxg, syh, sxh);
      } else {
        e1 = gather(f_ex, iyi, syi, ixh, sxh, g, nyg, nxg);
        e2 = gather(f_ey, iyh, syh, ixi, sxi, g, nyg, nxg);
        e3 = gather(f_ez, iyi, syi, ixi, sxi, g, nyg, nxg);
        b1 = gather(f_bx, iyh, syh, ixi, sxi, g, nyg, nxg);
        b2 = gather(f_by, iyi, syi, ixh, sxh, g, nyg, nxg);
        b3 = gather(f_bz, iyh, syh, ixh, sxh, g, nyg, nxg);
      }

      // Boris rotation (ppd_kernel.py:649-661, same association).
      const R h = P.h;
      const R pxm = ux + h * e1;
      const R pym = uy + h * e2;
      const R pzm = uz + h * e3;
      const R gi = R(1) / r_sqrt(R(1) + pxm * pxm + pym * pym + pzm * pzm);
      const R tx = h * b1 * gi, ty = h * b2 * gi, tz = h * b3 * gi;
      const R sf = R(2) / (R(1) + tx * tx + ty * ty + tz * tz);
      const R sxr = tx * sf, syr = ty * sf, szr = tz * sf;
      const R ppx = pxm + (pym * tz - pzm * ty);
      const R ppy = pym + (pzm * tx - pxm * tz);
      const R ppz = pzm + (pxm * ty - pym * tx);
      const R pxn = pxm + (ppy * szr - ppz * syr) + h * e1;
      const R pyn = pym + (ppz * sxr - ppx * szr) + h * e2;
      const R pzn = pzm + (ppx * syr - ppy * sxr) + h * e3;
      const R gn = R(1) / r_sqrt(R(1) + pxn * pxn + pyn * pyn + pzn * pzn);
      const R xn = x0 + pxn * gn * P.dtdx;
      const R yn = y0 + pyn * gn * P.dtdy;
      // Open walls: the unwrapped move (the caller kills and clamps).
      const R x1 = periodic ? wrap(xn, P.grid_nx, P.inv_nx) : xn;
      const R y1 = periodic ? wrap(yn, P.grid_ny, P.inv_ny) : yn;
      xo[k] = x1;
      yo[k] = y1;
      pxo[k] = pxn;
      pyo[k] = pyn;
      pzo[k] = pzn;
      local_max = r_max(local_max, r_max(r_abs(xn - x0), r_abs(yn - y0)));

      if (kDeposit) {
        // Esirkepov over the union support, 4 cells from min(c0, c1) - 1;
        // s1 from the stored position through the same ops as next step's
        // s0.
        const R xi1 = local(x1, ox, periodic, P.grid_nx, P.half_x, P.inv_nx);
        const R eta1 =
            local(y1, oy, periodic, P.grid_ny, P.half_y, P.inv_ny);
        R q1x3[3], q1y3[3];
        const R c1x = support3<ORDER, QUANT>(xi1, false, nxg, g, S, q1x3);
        const R c1y = support3<ORDER, QUANT>(eta1, false, nyg, g, S, q1y3);
        const R basex = r_min(cxi, c1x) - R(1);
        const R basey = r_min(cyi, c1y) - R(1);
        col0 = (int)basex + g;
        row0 = (int)basey + g;
        const R qw = P.q * wv;
        const R cz = qw * (pzn * gn) * P.cz;
        if constexpr (QUANT) {
          float q0x[4], q1x[4], q0y[4], q1y[4];
          if (fabsf(cxi - c1x) <= 1.0f && fabsf(cyi - c1y) <= 1.0f) {
            place4_near(cxi == basex + 1.0f, sxi, q0x);
            place4_near(c1x == basex + 1.0f, q1x3, q1x);
            place4_near(cyi == basey + 1.0f, syi, q0y);
            place4_near(c1y == basey + 1.0f, q1y3, q1y);
          } else {
            place4(basex, cxi, sxi, q0x);
            place4(basex, c1x, q1x3, q1x);
            place4(basey, cyi, syi, q0y);
            place4(basey, c1y, q1y3, q1y);
          }
          const float czq = cz * P.czq;
          prod = ops.set(q0x, q1x, q0y, q1y, czq);
          if (!prod) {
            // Out of int8 (window-edge fold): exact int32 atomics.
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = row0 + j;
              if (r < 0 || r >= nyg) continue;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = col0 + i;
                if (c < 0 || c >= nxg) continue;
                atomicAdd(&i_jx[r * nxg + c], ops.ay[j] * ops.ax[i]);
                atomicAdd(&i_jy[r * nxg + c], ops.ry[j] * ops.rx[i]);
              }
            }
          }
        } else {
          // jx: a_y x a_x; jy: r_y x r_x; jz: lz0 x rz0 + lz1 x rz1.
          const R wjx = qw * P.cjx, wjy = qw * P.cjy;
          R a_x[4], a_y[4], r_x[4], r_y[4];
          R lz0[4], lz1[4], rz0[4], rz1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const R cx = basex + (R)i, cy = basey + (R)i;
            const R s0x = shape_val<ORDER>(xi - cx);
            const R s1x = shape_val<ORDER>(xi1 - cx);
            const R s0y = shape_val<ORDER>(eta - cy);
            const R s1y = shape_val<ORDER>(eta1 - cy);
            const R dsx = s1x - s0x, dsy = s1y - s0y;
            a_y[i] = (s0y + R(0.5) * dsy) * wjx;
            a_x[i] = dsx;
            r_y[i] = dsy * wjy;
            r_x[i] = s0x + R(0.5) * dsx;
            lz0[i] = s0y * cz;
            lz1[i] = dsy * cz;
            rz0[i] = r_x[i];
            rz1[i] = R(0.5) * s0x + third * dsx;
          }
          if constexpr (PRODUCTS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fr[0][i] = a_y[i];
              fr[1][i] = r_y[i];
              fr[2][i] = lz0[i];
              fr[3][i] = lz1[i];
              fc[0][i] = a_x[i];
              fc[1][i] = r_x[i];
              fc[2][i] = rz1[i];
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                v[0][j * 4 + i] = a_y[j] * a_x[i];
                v[1][j * 4 + i] = r_y[j] * r_x[i];
                v[2][j * 4 + i] = lz0[j] * rz0[i] + lz1[j] * rz1[i];
              }
          }
        }
      }
    }
    if (!kDeposit) continue;

    if constexpr (PRODUCTS) {
      // Two rounds over the four areas: jx += a_y . a_x and jy += r_y .
      // r_x; then jz += lz0 . rz0 + lz1 . rz1 (rz0 = r_x, still in B1),
      // on the column tiles that the slab's supports reach.  A lane's
      // elements of one slab share their rows (columns), so the second
      // round overwrites the first's; the last slab's are cleared first
      // where this one does not overwrite them.
      if (!__any_sync(kFull, live)) continue;
      const bool moved_r = last_live && (!live || row0 != last_row0);
      const bool moved_c = last_live && (!live || col0 != last_col0);
      for (int n = 0; n < 2; ++n) {
        if (moved_r) pst.put(pst.a[n], fr[n], last_row0, nyg, true);
        if (moved_c) pst.put(pst.b[n], fc[n], last_col0, nxg, true);
      }
      last_live = live;
      last_row0 = row0;
      last_col0 = col0;
      const unsigned cols = prod_tiles(live, col0, nxg);
      if (live) {
        for (int n = 0; n < 2; ++n) {
          pst.put(pst.a[n], fr[n], row0, nyg, false);
          pst.put(pst.b[n], fc[n], col0, nxg, false);
        }
      }
      __syncwarp();
      pst.products(0, 0, pacc[0], 1, 1, pacc[1], cols);
      __syncwarp();
      if (live) {
        pst.put(pst.a[0], fr[2], row0, nyg, false);
        pst.put(pst.a[1], fr[3], row0, nyg, false);
        pst.put(pst.b[0], fc[2], col0, nxg, false);
      }
      __syncwarp();
      pst.products(0, 1, pacc[2], 1, 0, pacc[2], cols);
      __syncwarp();
    } else if constexpr (QUANT) {
      // Stage this lane's operand elements (only lane k writes particle
      // k's), run the slab's products.
      if (!__any_sync(kFull, live)) continue;
      st.put_rows(ops, last_live, last_prod, last_row0, nyg, true);
      st.put_cols(ops, last_live, last_prod, last_col0, nxg, true);
      st.put_rows(ops, live, prod, row0, nyg, false);
      st.put_cols(ops, live, prod, col0, nxg, false);
      last_live = live;
      last_prod = prod;
      last_row0 = row0;
      last_col0 = col0;
      __syncwarp();
      if (__any_sync(kFull, prod)) st.int8_products(lane, accx, accy);
      st.jz_products(lane, accz);
      __syncwarp();
    } else {
      warp_deposit<!SHARED>(wins, v, stage, live, row0, col0, lane, nyg,
                            nxg);
    }
  }

  if constexpr (QUANT && kDeposit) {
    // Each warp's sums into its own staging area, which its last slab has
    // done with, as windows [3][nwin] (jx, jy int32, jz f32): every cell of
    // the window is one element of one lane's fragments.  Summed below in a
    // fixed order, so J comes out the same from launch to launch.
    __syncwarp();
    int* const own = reinterpret_cast<int*>(st.ax);
    float* const own_z = reinterpret_cast<float*>(own + 2 * nwin);
    const int grp = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = grp + 8 * (e >> 1);
        const int c = 8 * n + 2 * tq + (e & 1);
        if (r < nyg && c < nxg) {
          own[r * nxg + c] = accx[n][e];
          own[nwin + r * nxg + c] = accy[n][e];
          own_z[r * nxg + c] = accz[n][e];
        }
      }
  }
  if constexpr (PRODUCTS && kDeposit) {
    // The same for the f64 sums, as double windows [3][nwin].
    __syncwarp();
    double* const own = pst.a[0];
    const int grp = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = grp + 8 * (e >> 1), c = 8 * j + 2 * tq + (e & 1);
        if (r < nyg && c < nxg) {
#pragma unroll
          for (int n = 0; n < 3; ++n)
            own[n * nwin + r * nxg + c] = pacc[n][j][e];
        }
      }
  }
  for (int s = count32 + threadIdx.x; s < P.capacity; s += blockDim.x) {
    const size_t k = pbase + s;
    xo[k] = x[k];
    yo[k] = y[k];
    pxo[k] = px[k];
    pyo[k] = py[k];
    pzo[k] = pz[k];
  }

  if constexpr (sizeof(R) == 8) {
    R m = local_max;
#pragma unroll
    for (int o = 16; o; o >>= 1) m = r_max(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) s_wmax[warp] = m;
  } else {
    atomicMax(&s_dmax, __float_as_int(local_max));
  }
  if constexpr (QUANT) {
    const R m = warp_nan_max(wmx);
    if (lane == 0) s_weight[warp] = m;
  }
  __syncthreads();
  // The block's J: int8, the warps' sums (warp 0, 1, ...) and the int32
  // adds of particles outside int8; f64 PRODUCTS, the warps' sums (warp 0,
  // 1, ...); f32 and f64, the sets summed in a fixed order (set 0, then 1,
  // ...).  Raw: written out; fused: kept in set 0 for the prefix sums.
  const unsigned char* const stages =
      reinterpret_cast<const unsigned char*>(s_jz + nwin);
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    if constexpr (QUANT) {
      int sx = i_jx[i], sy = i_jy[i];
      float sz = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) {
        const int* const o =
            reinterpret_cast<const int*>(stages + wp * Stage<NP>::kBytes);
        const float z = reinterpret_cast<const float*>(o + 2 * nwin)[i];
        sx += o[i];
        sy += o[nwin + i];
        sz = wp == 0 ? z : sz + z;
      }
      if (P.fused) {
        i_jx[i] = sx;
        i_jy[i] = sy;
        s_jz[i] = sz;
      } else {
        jxo[fbase + i] = (float)sx * P.cjx;
        jyo[fbase + i] = (float)sy * P.cjy;
        jzo[fbase + i] = sz;
      }
    } else if constexpr (PRODUCTS) {
      R sx = R(0), sy = R(0), sz = R(0);
      for (int wp = 0; wp < kWarps; ++wp) {
        const R* const o = reinterpret_cast<const R*>(
            stages + wp * prod_stage_bytes());
        sx = wp == 0 ? o[i] : sx + o[i];
        sy = wp == 0 ? o[nwin + i] : sy + o[nwin + i];
        sz = wp == 0 ? o[2 * nwin + i] : sz + o[2 * nwin + i];
      }
      if (P.fused) {
        s_jx[i] = sx;
        s_jy[i] = sy;
        s_jz[i] = sz;
      } else {
        jxo[fbase + i] = sx;
        jyo[fbase + i] = sy;
        jzo[fbase + i] = sz;
      }
    } else {
      R sx = s_jx[i], sy = s_jy[i], sz = s_jz[i];
      for (int set_w = 1; set_w < nsets; ++set_w) {
        const R* const o = s_jx + 3 * set_w * nwin;
        sx = sx + o[i];
        sy = sy + o[nwin + i];
        sz = sz + o[2 * nwin + i];
      }
      if (P.fused) {
        s_jx[i] = sx;
        s_jy[i] = sy;
        s_jz[i] = sz;
      } else {
        jxo[fbase + i] = sx;
        jyo[fbase + i] = sy;
        jzo[fbase + i] = sz;
      }
    }
  }
  if (P.fused) {
    // jx summed along x (each row, by the first half of the block), jy
    // along y (each column, by the second), in order; int8's integers are
    // exact (a prefix of one particle's terms is bounded as a cell's sum
    // is: the prefix of q1 - q0 along a row lies in [-S, S]).
    __syncthreads();
    constexpr int kHalf = kThreads / 2;
    if (threadIdx.x < kHalf) {
      for (int r = threadIdx.x; r < nyg; r += kHalf) {
        if constexpr (QUANT) prefix_sum(i_jx + r * nxg, nxg, 1);
        else prefix_sum(s_jx + r * nxg, nxg, 1);
      }
    } else {
      for (int c = threadIdx.x - kHalf; c < nxg; c += kHalf) {
        if constexpr (QUANT) prefix_sum(i_jy + c, nyg, nxg);
        else prefix_sum(s_jy + c, nyg, nxg);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
      if constexpr (QUANT) {
        jxo[fbase + i] = (float)i_jx[i] * P.cjx;
        jyo[fbase + i] = (float)i_jy[i] * P.cjy;
      } else {
        jxo[fbase + i] = s_jx[i];
        jyo[fbase + i] = s_jy[i];
      }
      jzo[fbase + i] = s_jz[i];
    }
  }
  if (threadIdx.x == 0) {
    if constexpr (sizeof(R) == 8) {
      R m = s_wmax[0];
      for (int wp = 1; wp < kWarps; ++wp) m = r_max(m, s_wmax[wp]);
      dmax[t] = m;
    } else {
      dmax[t] = __int_as_float(s_dmax);
    }
    if constexpr (QUANT) {
      if (P.fused) {
        R m = s_weight[0];
        for (int wp = 1; wp < kWarps; ++wp) m = nan_max(m, s_weight[wp]);
        wmax[t] = m;
      }
    }
  }
}

// Dynamic shared memory of one block: six field windows and three J
// windows for each set (kWarps / win_warps sets; int8 and f64 products
// one) of `real` bytes a cell, and the staging: int8's or the f64
// products' operands, or with private sets (f32, f64 at win_warps 1) each
// warp's terms.
size_t smem_bytes(bool quant, int np, int nwin, size_t real, int win_warps,
                  bool products = false) {
  if (products) return 9 * nwin * real + (size_t)kWarps * prod_stage_bytes();
  const int nsets = quant ? 1 : kWarps / win_warps;
  const size_t stage = quant ? (size_t)kWarps * stage_bytes(np)
                             : (win_warps == 1 ? (size_t)kWarps * kTerms *
                                                     kStage * real
                                               : 0);
  return (size_t)(6 + 3 * nsets) * nwin * real + stage;
}

bool win_warps_ok(int w) { return w == 1 || w == 2 || w == 4 || w == 8; }

template <int ORDER, bool QUANT, int NP, bool PERIODIC, bool SHARED,
          typename R, bool PRODUCTS = false>
cudaError_t launch(const AdvanceParamsT<R>& P, const R* x, const R* y,
                   const R* px, const R* py, const R* pz, const R* w,
                   const int* counts, const int* ox, const int* oy,
                   const R* ex, const R* ey, const R* ez, const R* bx,
                   const R* by, const R* bz, R* xo, R* yo, R* pxo, R* pyo,
                   R* pzo, R* jx, R* jy, R* jz, R* dmax, R* wmax,
                   cudaStream_t stream) {
  const int nwin = (P.tile_nx + 2 * P.guard) * (P.tile_ny + 2 * P.guard);
  const size_t smem =
      smem_bytes(QUANT, NP, nwin, sizeof(R), P.win_warps, PRODUCTS);
  auto* kernel =
      advance_kernel<ORDER, QUANT, NP, PERIODIC, SHARED, R, PRODUCTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<P.num_tiles, kThreads, smem, stream>>>(
      P, x, y, px, py, pz, w, counts, ox, oy, ex, ey, ez, bx, by, bz, xo, yo,
      pxo, pyo, pzo, jx, jy, jz, dmax, wmax);
  return cudaGetLastError();
}

// nan_max of a[0, n), on every thread of the block (scratch: kWarps
// values of shared memory, free again on return).
template <typename R>
__device__ R block_nan_max(const R* __restrict__ a, int n, R* scratch) {
  R m = neg_inf(R(0));
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = nan_max(m, a[i]);
  m = warp_nan_max(m);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = m;
  __syncthreads();
  m = scratch[0];
  for (int wp = 1; wp < kWarps; ++wp) m = nan_max(m, scratch[wp]);
  __syncthreads();
  return m;
}

// After a fused launch, what needs every tile: the 0-d max displacement,
// the max of the tiles' dmax_t (block 0), and in int8 mode (QUANT) the
// scale of the n values of jx and of jy by q * max(w), max(w) the max of
// the tiles' wmax_t (each block finds it and scales a share).  The same
// values as torch's dmax.max(), w.max() * q and jx * qws: a max is exact in
// any order, and each value is rounded once.  Bound by the 2 x n window
// values read and written (8 MB at the int8 headline).
template <bool QUANT, typename R>
__global__ void __launch_bounds__(kThreads)
finish_kernel(int num_tiles, int n, R q, R* __restrict__ jx,
              R* __restrict__ jy, const R* __restrict__ dmax_t,
              const R* __restrict__ wmax_t, R* __restrict__ dmax) {
  __shared__ R scratch[kWarps];
  if constexpr (QUANT) {
    const R qws = block_nan_max(wmax_t, num_tiles, scratch) * q;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      jx[i] = jx[i] * qws;
      jy[i] = jy[i] * qws;
    }
  }
  if (blockIdx.x == 0) {
    const R m = block_nan_max(dmax_t, num_tiles, scratch);
    if (threadIdx.x == 0) *dmax = m;
  }
}

// Blocks of finish_kernel: int8, one for every kFinishValues window values,
// at most kFinishBlocks; else one.
constexpr int kFinishValues = 4 * kThreads;
constexpr int kFinishBlocks = 264;

template <bool QUANT, typename R>
cudaError_t launch_finish(int num_tiles, int nwin, R q, R* jx, R* jy,
                          const R* dmax_t, const R* wmax_t, R* dmax,
                          cudaStream_t stream) {
  const int n = num_tiles * nwin;
  const int want = (n + kFinishValues - 1) / kFinishValues;
  const int blocks = !QUANT ? 1 : (want < kFinishBlocks ? want : kFinishBlocks);
  finish_kernel<QUANT, R><<<blocks, kThreads, 0, stream>>>(
      num_tiles, n, q, jx, jy, dmax_t, wmax_t, dmax);
  return cudaGetLastError();
}

}  // namespace

// Both boundaries of one instantiation, chosen by P.periodic, and off the
// int8 mode both J window layouts, chosen by P.win_warps (1: private).
#define MINIPIC_ARGS                                                        \
  P, x, y, px, py, pz, w, counts, ox, oy, ex, ey, ez, bx, by, bz, xo, yo, \
      pxo, pyo, pzo, jx, jy, jz, dmax, wmax, s
#define MINIPIC_LAUNCH(O, Q, N)                                             \
  return (int)(P.periodic                                                   \
                   ? (!Q && P.win_warps > 1                                 \
                          ? launch<O, Q, N, true, !Q>(MINIPIC_ARGS)         \
                          : launch<O, Q, N, true, false>(MINIPIC_ARGS))     \
                   : (!Q && P.win_warps > 1                                 \
                          ? launch<O, Q, N, false, !Q>(MINIPIC_ARGS)        \
                          : launch<O, Q, N, false, false>(MINIPIC_ARGS)))
#define MINIPIC_LAUNCH_PRODUCTS(O)                                          \
  return (int)(P.periodic ? launch<O, false, 1, true, false, double, true>( \
                                MINIPIC_ARGS)                               \
                          : launch<O, false, 1, false, false, double, true>( \
                                MINIPIC_ARGS))

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch (0 on success); launches on `stream`, allocates nothing.  The
// int8 mode needs nyg 8 or 16 and nxg <= 64 (the wrapper checks); the f32
// mode P.win_warps 1, 2, 4 or 8 (int8 does not read it).  Raw launches
// (P.fused 0) read counts and not wmax; fused ones the reverse (wmax: int8
// only; either may be null where it is not read).
extern "C" int minipic_advance(int order, int quant, AdvanceParams P,
                               const float* x, const float* y,
                               const float* px, const float* py,
                               const float* pz, const float* w,
                               const int* counts, const int* ox,
                               const int* oy, const float* ex,
                               const float* ey, const float* ez,
                               const float* bx, const float* by,
                               const float* bz, float* xo, float* yo,
                               float* pxo, float* pyo, float* pzo, float* jx,
                               float* jy, float* jz, float* dmax,
                               float* wmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nxg = P.tile_nx + 2 * P.guard;
  const int np = nxg <= 16 ? 1 : (nxg <= 32 ? 2 : 4);
  if (P.products) return (int)cudaErrorInvalidValue;
  if (!quant) {
    if (!win_warps_ok(P.win_warps)) return (int)cudaErrorInvalidValue;
    if (order == 1) MINIPIC_LAUNCH(1, false, 1);
    if (order == 2) MINIPIC_LAUNCH(2, false, 1);
  } else if (nxg <= 64) {
    if (order == 1 && np == 1) MINIPIC_LAUNCH(1, true, 1);
    if (order == 1 && np == 2) MINIPIC_LAUNCH(1, true, 2);
    if (order == 1 && np == 4) MINIPIC_LAUNCH(1, true, 4);
    if (order == 2 && np == 1) MINIPIC_LAUNCH(2, true, 1);
    if (order == 2 && np == 2) MINIPIC_LAUNCH(2, true, 2);
    if (order == 2 && np == 4) MINIPIC_LAUNCH(2, true, 4);
  }
  return (int)cudaErrorInvalidValue;
}

// The f64 mode: the same kernel on double particles, windows and constants;
// P.products 1 takes the tensor-core deposit (windows of at most kProdCells
// rows and columns; P.win_warps is not read).
extern "C" int minipic_advance_f64(int order, AdvanceParams64 P,
                                   const double* x, const double* y,
                                   const double* px, const double* py,
                                   const double* pz, const double* w,
                                   const int* counts, const int* ox,
                                   const int* oy, const double* ex,
                                   const double* ey, const double* ez,
                                   const double* bx, const double* by,
                                   const double* bz, double* xo, double* yo,
                                   double* pxo, double* pyo, double* pzo,
                                   double* jx, double* jy, double* jz,
                                   double* dmax, double* wmax,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.products) {
    if (P.tile_nx + 2 * P.guard > kProdCells ||
        P.tile_ny + 2 * P.guard > kProdCells)
      return (int)cudaErrorInvalidValue;
    if (order == 1) MINIPIC_LAUNCH_PRODUCTS(1);
    if (order == 2) MINIPIC_LAUNCH_PRODUCTS(2);
    return (int)cudaErrorInvalidValue;
  }
  if (!win_warps_ok(P.win_warps)) return (int)cudaErrorInvalidValue;
  if (order == 1) MINIPIC_LAUNCH(1, false, 1);
  if (order == 2) MINIPIC_LAUNCH(2, false, 1);
  return (int)cudaErrorInvalidValue;
}
#undef MINIPIC_LAUNCH_PRODUCTS
#undef MINIPIC_LAUNCH
#undef MINIPIC_ARGS

// finish_kernel after a fused launch of num_tiles windows of nwin cells:
// int8 (quant) scales jx and jy by q * max(wmax_t) and reduces dmax_t into
// the 0-d dmax; f32 only reduces dmax_t (jx, jy, wmax_t are not read).
extern "C" int minipic_advance_finish(int quant, int num_tiles, int nwin,
                                      float q, float* jx, float* jy,
                                      const float* dmax_t,
                                      const float* wmax_t, float* dmax,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(quant ? launch_finish<true>(num_tiles, nwin, q, jx, jy, dmax_t,
                                           wmax_t, dmax, s)
                     : launch_finish<false>(num_tiles, nwin, q, jx, jy,
                                            dmax_t, wmax_t, dmax, s));
}

// The f64 mode's: dmax_t reduced into the 0-d dmax.
extern "C" int minipic_advance_finish_f64(int num_tiles, const double* dmax_t,
                                          double* dmax, void* stream) {
  return (int)launch_finish<false, double>(
      num_tiles, 0, 0.0, nullptr, nullptr, dmax_t, nullptr, dmax,
      static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the periodic kernel that minipic_advance (mode
// 0 f32, 1 int8) or minipic_advance_f64 (mode 2; 3 with P.products) would
// launch for this window at win_warps warps to a set of J windows (the
// occupancy calculator's answer), or -1 on error.
extern "C" int minipic_advance_blocks_per_sm(int order, int mode, int nyg,
                                             int nxg, int win_warps) {
  const int np = nxg <= 16 ? 1 : (nxg <= 32 ? 2 : 4);
  const bool quant = mode == 1;
  if (!quant && !win_warps_ok(win_warps)) return -1;
  const size_t smem = smem_bytes(quant, np, nyg * nxg,
                                 mode >= 2 ? sizeof(double) : sizeof(float),
                                 win_warps, mode == 3);
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
#define MINIPIC_OCC(O, Q, N, R)                                               \
  do {                                                                        \
    auto* k = !Q && win_warps > 1 ? &advance_kernel<O, Q, N, true, !Q, R>     \
                                  : &advance_kernel<O, Q, N, true, false, R>; \
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                    \
    if (err == cudaSuccess)                                                   \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,         \
                                                          kThreads, smem);    \
  } while (0)
  if (mode == 0 && order == 1) MINIPIC_OCC(1, false, 1, float);
  if (mode == 0 && order == 2) MINIPIC_OCC(2, false, 1, float);
  if (mode == 2 && order == 1) MINIPIC_OCC(1, false, 1, double);
  if (mode == 2 && order == 2) MINIPIC_OCC(2, false, 1, double);
  if (mode == 3) {
    auto* k = order == 1
                  ? &advance_kernel<1, false, 1, true, false, double, true>
                  : &advance_kernel<2, false, 1, true, false, double, true>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                          smem);
  }
  if (quant && order == 1 && np == 1) MINIPIC_OCC(1, true, 1, float);
  if (quant && order == 1 && np == 2) MINIPIC_OCC(1, true, 2, float);
  if (quant && order == 1 && np == 4) MINIPIC_OCC(1, true, 4, float);
  if (quant && order == 2 && np == 1) MINIPIC_OCC(2, true, 1, float);
  if (quant && order == 2 && np == 2) MINIPIC_OCC(2, true, 2, float);
  if (quant && order == 2 && np == 4) MINIPIC_OCC(2, true, 4, float);
#undef MINIPIC_OCC
  return err == cudaSuccess ? blocks : -1;
}
