// Particle advance for Hopper (sm_90a): gather + relativistic Boris push +
// move (+ periodic wrap) + Esirkepov current deposit, one pass per tile.
//
// Replaces: minipic_tpu/ops/pallas/ppd_kernel.py, fused_push_deposit
// (pallas_call at :1187; kernel body _kernel -> _process_tile -> _sub_chunk).
// Plain torch version of the same arithmetic: minipic_torch/ops/advance.py,
// advance_plain (see that module's docstring for the step-by-step contract).
//
// Layout.  One thread block per tile (grid = num_tiles), 256 threads.  The
// block loads the tile's six field windows [nyg, nxg] into shared memory and
// zeroes three J windows there; threads stride over the bucket's slots.
// Slots at or past counts[t] (the live watermark) and dead slots (w == 0)
// are copied through untouched.  Particles are written to NEW output
// tensors (x, y, px, py, pz; w is not written).  J windows are written
// whole, before the prefix sums (the caller applies them, and in int8 mode
// the q*max(w) scale, in torch).
//
// Modes (compile-time): ORDER 1 (CIC) or 2 (TSC); QUANT false (f32 shapes,
// f32 shared-memory atomics for all of J) or true (int8 matched
// quantization: shape values round(S*s) with the centre-cell partition fold
// and the window-edge fold; jx/jy accumulate integer products in int32 —
// exact in any atomic order, |q0+q1| <= 127 — and are converted once to f32
// times -1/(2 S^2 dt d{y,x}); jz is an f32 sum whose atomic order varies).
//
// What bounds it on this card.  Per particle it moves about 44 bytes of HBM
// (read x, y, px, py, pz, w; write x, y, px, py, pz), about 4.9 GB per step
// at 1e8 particles: ~1.5 ms at 3.35 TB/s.  Against that it does per
// particle ~54 shared-memory field reads, ~300 flops of shape, gather and
// push arithmetic, and 48 shared-memory atomics into a 16x16 window that
// all 256 threads of the block hit.  Measured on an H100 80GB HBM3 at
// 700 W, 1e8 particles in 4096 x 27136 slots: 13.7-20.7 ms, 9-14x the HBM
// floor; with the atomics made no-ops, 3.3 ms.  Contended shared atomics
// bound it: consecutive slots hold particles of one cell, so a warp's
// lanes hit the same 16 cells.  The design keeps every window in shared
// memory (no global atomics at all), reads and writes particle streams
// coalesced (consecutive threads, consecutive slots), and makes int8
// jx/jy integer atomics.  Pre-reducing within the warp before the atomics
// is the next step.
//
// Numerics.  Build with --fmad=false and without --use_fast_math: a
// multiply-add contracted at one site and not at another breaks the
// bit-exact telescoping of s1 (step n) into s0 (step n+1) that the int8
// deposit's continuity rests on.  Rounding is rintf (half to even, as
// jnp.round and torch.round), never roundf.  The reciprocal square root is
// 1.0f / sqrtf(v), correctly rounded, the same expression as the plain
// version's reciprocal(sqrt(v)); CUDA's approximate rsqrtf is not used.

#include <cuda_runtime.h>

struct AdvanceParams {
  int num_tiles, capacity, tile_cols, tile_nx, tile_ny, guard;
  float h;                  // push half-kick q/m dt/2 (int8: times 1/S^2)
  float dtdx, dtdy;         // dt/dx, dt/dy
  float q;                  // species charge
  float grid_nx, grid_ny;   // periodic box in cells (fold and wrap)
  float inv_nx, inv_ny;     // 1/nx, 1/ny
  float half_x, half_y;     // (nx - tile_nx)/2, (ny - tile_ny)/2
  float cjx, cjy;           // jx, jy factors (f32: -1/(dt dy), -1/(dt dx);
                            // int8: -1/(2 S^2 dt dy), -1/(2 S^2 dt dx))
  float cz;                 // 1/(dx dy)
  float czq;                // 1/S^2
  float S;                  // shape quantization scale
};

namespace {

constexpr int kThreads = 256;
constexpr float kThird = (float)(1.0 / 3.0);

template <int ORDER>
__device__ __forceinline__ float shape_val(float u) {
  const float au = fabsf(u);
  if (ORDER == 1) return fmaxf(0.0f, 1.0f - au);
  const float inner = 0.75f - au * au;
  const float o = 1.5f - au;
  const float outer = 0.5f * (o * o);
  return au <= 0.5f ? inner : (au <= 1.5f ? outer : 0.0f);
}

// Centre cell c (returned, as float) and the support values at c-1, c, c+1
// of one stagger class (half: cell coordinates a + 1/2).
template <int ORDER, bool QUANT>
__device__ __forceinline__ float support3(float pos, bool half, int n_rows,
                                          int g, float S, float v[3]) {
  const float c = half ? floorf(pos) : floorf(pos + 0.5f);
  if (QUANT) {
    float tm = pos - (c - 1.0f);
    float tp = pos - (c + 1.0f);
    if (half) {
      tm = tm - 0.5f;
      tp = tp - 0.5f;
    }
    const float qm = rintf(shape_val<ORDER>(tm) * S);
    const float qp = rintf(shape_val<ORDER>(tp) * S);
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
      float u = pos - (c + (float)(k - 1));
      if (half) u = u - 0.5f;
      v[k] = shape_val<ORDER>(u);
    }
  }
  return c;
}

// sum_j sy[j] * (sum_i F[row, col] * sx[i]); off-window cells skipped.
__device__ __forceinline__ float gather(const float* F, int cy,
                                        const float sy[3], int cx,
                                        const float sx[3], int g, int nyg,
                                        int nxg) {
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int r = cy + j - 1 + g;
    if (r < 0 || r >= nyg) continue;
    float m = 0.0f;
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

__device__ __forceinline__ float fold(float pos, float origin, float gn,
                                      float half, float inv) {
  const float xi = pos - origin;
  return xi - gn * floorf((xi + half) * inv);
}

__device__ __forceinline__ float wrap(float v, float n, float inv) {
  float w = v - n * floorf(v * inv);
  if (w < 0.0f) w = w + n;
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

template <int ORDER, bool QUANT>
__global__ void __launch_bounds__(kThreads)
advance_kernel(AdvanceParams P,
               const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ pz, const float* __restrict__ w,
               const int* __restrict__ counts,
               const float* __restrict__ ex, const float* __restrict__ ey,
               const float* __restrict__ ez, const float* __restrict__ bx,
               const float* __restrict__ by, const float* __restrict__ bz,
               float* __restrict__ xo, float* __restrict__ yo,
               float* __restrict__ pxo, float* __restrict__ pyo,
               float* __restrict__ pzo,
               float* __restrict__ jxo, float* __restrict__ jyo,
               float* __restrict__ jzo, float* __restrict__ dmax) {
  extern __shared__ float smem[];
  __shared__ int s_dmax;
  const int g = P.guard;
  const int nxg = P.tile_nx + 2 * g;
  const int nyg = P.tile_ny + 2 * g;
  const int nwin = nxg * nyg;
  float* f_ex = smem;
  float* f_ey = f_ex + nwin;
  float* f_ez = f_ey + nwin;
  float* f_bx = f_ez + nwin;
  float* f_by = f_bx + nwin;
  float* f_bz = f_by + nwin;
  float* s_jx = f_bz + nwin;  // int32 in QUANT mode
  float* s_jy = s_jx + nwin;  // int32 in QUANT mode
  float* s_jz = s_jy + nwin;
  int* i_jx = reinterpret_cast<int*>(s_jx);
  int* i_jy = reinterpret_cast<int*>(s_jy);

  const int t = blockIdx.x;
  const size_t fbase = (size_t)t * nwin;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    f_ex[i] = ex[fbase + i];
    f_ey[i] = ey[fbase + i];
    f_ez[i] = ez[fbase + i];
    f_bx[i] = bx[fbase + i];
    f_by[i] = by[fbase + i];
    f_bz[i] = bz[fbase + i];
    s_jx[i] = 0.0f;  // all-zero bits: int 0 as well
    s_jy[i] = 0.0f;
    s_jz[i] = 0.0f;
  }
  if (threadIdx.x == 0) s_dmax = 0;
  __syncthreads();

  const int count = counts[t];
  const size_t pbase = (size_t)t * P.capacity;
  const float ox = (float)((t % P.tile_cols) * P.tile_nx);
  const float oy = (float)((t / P.tile_cols) * P.tile_ny);
  const float S = P.S;
  float local_max = 0.0f;

  for (int s = threadIdx.x; s < P.capacity; s += blockDim.x) {
    const size_t k = pbase + s;
    const float x0 = x[k], y0 = y[k];
    const float ux = px[k], uy = py[k], uz = pz[k];
    const float wv = w[k];
    if (s >= count || wv == 0.0f) {
      xo[k] = x0;
      yo[k] = y0;
      pxo[k] = ux;
      pyo[k] = uy;
      pzo[k] = uz;
      continue;
    }
    const float xi = fold(x0, ox, P.grid_nx, P.half_x, P.inv_nx);
    const float eta = fold(y0, oy, P.grid_ny, P.half_y, P.inv_ny);

    float sxi[3], sxh[3], syi[3], syh[3];
    const float cxi = support3<ORDER, QUANT>(xi, false, nxg, g, S, sxi);
    const float cxh = support3<ORDER, QUANT>(xi, true, nxg, g, S, sxh);
    const float cyi = support3<ORDER, QUANT>(eta, false, nyg, g, S, syi);
    const float cyh = support3<ORDER, QUANT>(eta, true, nyg, g, S, syh);
    const int ixi = (int)cxi, ixh = (int)cxh, iyi = (int)cyi, iyh = (int)cyh;

    const float e1 = gather(f_ex, iyi, syi, ixh, sxh, g, nyg, nxg);
    const float e2 = gather(f_ey, iyh, syh, ixi, sxi, g, nyg, nxg);
    const float e3 = gather(f_ez, iyi, syi, ixi, sxi, g, nyg, nxg);
    const float b1 = gather(f_bx, iyh, syh, ixi, sxi, g, nyg, nxg);
    const float b2 = gather(f_by, iyi, syi, ixh, sxh, g, nyg, nxg);
    const float b3 = gather(f_bz, iyh, syh, ixh, sxh, g, nyg, nxg);

    // Boris rotation (ppd_kernel.py:649-661, same association).
    const float h = P.h;
    const float pxm = ux + h * e1;
    const float pym = uy + h * e2;
    const float pzm = uz + h * e3;
    const float gi = 1.0f / sqrtf(1.0f + pxm * pxm + pym * pym + pzm * pzm);
    const float tx = h * b1 * gi, ty = h * b2 * gi, tz = h * b3 * gi;
    const float sf = 2.0f / (1.0f + tx * tx + ty * ty + tz * tz);
    const float sxr = tx * sf, syr = ty * sf, szr = tz * sf;
    const float ppx = pxm + (pym * tz - pzm * ty);
    const float ppy = pym + (pzm * tx - pxm * tz);
    const float ppz = pzm + (pxm * ty - pym * tx);
    const float pxn = pxm + (ppy * szr - ppz * syr) + h * e1;
    const float pyn = pym + (ppz * sxr - ppx * szr) + h * e2;
    const float pzn = pzm + (ppx * syr - ppy * sxr) + h * e3;
    const float gn = 1.0f / sqrtf(1.0f + pxn * pxn + pyn * pyn + pzn * pzn);
    const float xn = x0 + pxn * gn * P.dtdx;
    const float yn = y0 + pyn * gn * P.dtdy;
    const float x1 = wrap(xn, P.grid_nx, P.inv_nx);
    const float y1 = wrap(yn, P.grid_ny, P.inv_ny);
    xo[k] = x1;
    yo[k] = y1;
    pxo[k] = pxn;
    pyo[k] = pyn;
    pzo[k] = pzn;
    local_max = fmaxf(local_max, fmaxf(fabsf(xn - x0), fabsf(yn - y0)));

    // Esirkepov over the union support, 4 cells from min(c0, c1) - 1; s1
    // from the stored position through the same ops as next step's s0.
    const float xi1 = fold(x1, ox, P.grid_nx, P.half_x, P.inv_nx);
    const float eta1 = fold(y1, oy, P.grid_ny, P.half_y, P.inv_ny);
    float q1x3[3], q1y3[3];
    const float c1x = support3<ORDER, QUANT>(xi1, false, nxg, g, S, q1x3);
    const float c1y = support3<ORDER, QUANT>(eta1, false, nyg, g, S, q1y3);
    const float basex = fminf(cxi, c1x) - 1.0f;
    const float basey = fminf(cyi, c1y) - 1.0f;
    const int col0 = (int)basex + g;
    const int row0 = (int)basey + g;
    const float qw = P.q * wv;
    const float cz = qw * (pzn * gn) * P.cz;

    float a_x[4], a_y[4], r_x[4], r_y[4];  // jx: a_y x a_x; jy: r_y x r_x
    float lz0[4], lz1[4], rz0[4], rz1[4];  // jz: lz0 x rz0 + lz1 x rz1
    if (QUANT) {
      float q0x[4], q1x[4], q0y[4], q1y[4];
      place4(basex, cxi, sxi, q0x);
      place4(basex, c1x, q1x3, q1x);
      place4(basey, cyi, syi, q0y);
      place4(basey, c1y, q1y3, q1y);
      const float czq = cz * P.czq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_y[i] = q0y[i] + q1y[i];
        a_x[i] = q1x[i] - q0x[i];
        r_y[i] = q1y[i] - q0y[i];
        r_x[i] = q0x[i] + q1x[i];
        lz0[i] = q0y[i] * czq;
        lz1[i] = (q1y[i] - q0y[i]) * czq;
        rz0[i] = 0.5f * (q0x[i] + q1x[i]);
        rz1[i] = 0.5f * q0x[i] + kThird * (q1x[i] - q0x[i]);
      }
    } else {
      const float wjx = qw * P.cjx, wjy = qw * P.cjy;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float cx = basex + (float)i, cy = basey + (float)i;
        const float s0x = shape_val<ORDER>(xi - cx);
        const float s1x = shape_val<ORDER>(xi1 - cx);
        const float s0y = shape_val<ORDER>(eta - cy);
        const float s1y = shape_val<ORDER>(eta1 - cy);
        const float dsx = s1x - s0x, dsy = s1y - s0y;
        a_y[i] = (s0y + 0.5f * dsy) * wjx;
        a_x[i] = dsx;
        r_y[i] = dsy * wjy;
        r_x[i] = s0x + 0.5f * dsx;
        lz0[i] = s0y * cz;
        lz1[i] = dsy * cz;
        rz0[i] = r_x[i];
        rz1[i] = 0.5f * s0x + kThird * dsx;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + j;
      if (r < 0 || r >= nyg) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = col0 + i;
        if (c < 0 || c >= nxg) continue;
        const int cell = r * nxg + c;
        if (QUANT) {
          atomicAdd(&i_jx[cell], (int)a_y[j] * (int)a_x[i]);
          atomicAdd(&i_jy[cell], (int)r_y[j] * (int)r_x[i]);
        } else {
          atomicAdd(&s_jx[cell], a_y[j] * a_x[i]);
          atomicAdd(&s_jy[cell], r_y[j] * r_x[i]);
        }
        atomicAdd(&s_jz[cell], lz0[j] * rz0[i] + lz1[j] * rz1[i]);
      }
    }
  }

  // Displacements are >= 0, so their float bits order as ints.
  atomicMax(&s_dmax, __float_as_int(local_max));
  __syncthreads();
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    if (QUANT) {
      jxo[fbase + i] = (float)i_jx[i] * P.cjx;
      jyo[fbase + i] = (float)i_jy[i] * P.cjy;
    } else {
      jxo[fbase + i] = s_jx[i];
      jyo[fbase + i] = s_jy[i];
    }
    jzo[fbase + i] = s_jz[i];
  }
  if (threadIdx.x == 0) dmax[t] = __int_as_float(s_dmax);
}

template <int ORDER, bool QUANT>
cudaError_t launch(const AdvanceParams& P, const float* x, const float* y,
                   const float* px, const float* py, const float* pz,
                   const float* w, const int* counts, const float* ex,
                   const float* ey, const float* ez, const float* bx,
                   const float* by, const float* bz, float* xo, float* yo,
                   float* pxo, float* pyo, float* pzo, float* jx, float* jy,
                   float* jz, float* dmax, cudaStream_t stream) {
  const int nwin = (P.tile_nx + 2 * P.guard) * (P.tile_ny + 2 * P.guard);
  const size_t smem = (size_t)9 * nwin * sizeof(float);
  advance_kernel<ORDER, QUANT><<<P.num_tiles, kThreads, smem, stream>>>(
      P, x, y, px, py, pz, w, counts, ex, ey, ez, bx, by, bz, xo, yo, pxo,
      pyo, pzo, jx, jy, jz, dmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch (0 on success); launches on `stream`, allocates nothing.
extern "C" int minipic_advance(int order, int quant, AdvanceParams P,
                               const float* x, const float* y,
                               const float* px, const float* py,
                               const float* pz, const float* w,
                               const int* counts, const float* ex,
                               const float* ey, const float* ez,
                               const float* bx, const float* by,
                               const float* bz, float* xo, float* yo,
                               float* pxo, float* pyo, float* pzo, float* jx,
                               float* jy, float* jz, float* dmax,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MINIPIC_LAUNCH(O, Q)                                                \
  return (int)launch<O, Q>(P, x, y, px, py, pz, w, counts, ex, ey, ez, bx, \
                           by, bz, xo, yo, pxo, pyo, pzo, jx, jy, jz, dmax, s)
  if (order == 1 && !quant) MINIPIC_LAUNCH(1, false);
  if (order == 1 && quant) MINIPIC_LAUNCH(1, true);
  if (order == 2 && !quant) MINIPIC_LAUNCH(2, false);
  if (order == 2 && quant) MINIPIC_LAUNCH(2, true);
#undef MINIPIC_LAUNCH
  return (int)cudaErrorInvalidValue;
}
