// The step's float64 diagnostics for Hopper (sm_90a): moments and census.
//
// Replaces no TPU kernel: the JAX package takes its diagnostics with jnp
// reductions, which XLA fuses.  The plain torch versions (core/state.py
// kinetic_energy_plain, momentum_sum_plain, field_energy_plain;
// ops/diag.py census_plain) cast every channel to float64 as a whole
// tensor before they multiply and sum: at the headline's 4096 x 40704 slots
// each intermediate is 1.33 GB, and the layer took 27 ms a step for ~1 ms
// of reading.
//
// * moments — one species after its advance: sum w m p2/(gamma+1) and
//   sum w m u per axis, from px, py, pz and w.
// * census — the re-binned species and the fields: the live count
//   (w > 0, all species), each species' least live w and greatest w (the
//   int8 deposit's uniform-weight guard), and sum E^2 + B^2 over the six
//   fields.
//
// Bound: bytes.  Each kernel reads each channel once, in 16-byte vector
// loads (float4, or double2 over float64 channels), neighbouring threads on
// neighbouring addresses, grid-stride over the flat [num_tiles * capacity]
// slots, and accumulates in float64 registers; nothing is written but the
// results.  The moments load w first and skip the momenta of a vector whose
// slots are all dead (w == 0): such a slot adds exactly 0 for finite
// channels, and the dead slots of a re-binned bucket lie together at its
// tail.
//
// Rounding.  A slot's term is formed in float64 in the plain version's
// operation order (p2 = px*px + py*py + pz*pz, gamma = sqrt(1 + p2),
// (w*m) * (p2 / (gamma + 1)), (w*m) * u); with --fmad=false nothing is
// contracted, so each term is bit for bit the plain one.  Only the order of
// the sums differs.
//
// Determinism.  No floating-point atomics: each block reduces its threads'
// sums in a fixed order (warp shuffles, then the warps in order) into one
// partial per block; the last block to finish (an integer counter, reset by
// that block) reduces the partials in block order and writes the results.
// The grid depends only on the slot count and the card, so a call repeats
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>

// The species the census takes.
constexpr int kMaxSpecies = 8;

// The entry points' arguments, passed by value (mirrored in ops/diag.py).
struct MomentsArgs {
  long long n;  // slots
  int vec;      // the four channels are 16-byte aligned
  const void* px;
  const void* py;
  const void* pz;
  const void* w;
  double mass;
  double* ke;   // 0-d
  double* mom;  // [3]
};

struct CensusArgs {
  const void* w[kMaxSpecies];
  long long n[kMaxSpecies];  // slots of each species
  int vec[kMaxSpecies];      // w[s] is 16-byte aligned
  int check[kMaxSpecies];    // count species s in `bad` if its live w differ
  int ns;                    // species
  int fvec;                  // the fields are contiguous, 16-byte aligned
  const void* f[6];          // ex, ey, ez, bx, by, bz, or all null
  long long nf;              // cells of each field
  long long fnx;             // a field's columns
  long long fld;             // and its row stride, in elements
  double dx;
  double dy;
  int* live;   // [1]
  int* bad;    // 0-d, or null
  double* fe;  // 0-d, or null (no fields)
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Vectors a thread loads before it uses any of them.
constexpr int kUnroll = 4;
constexpr int kMomentsK = 4;  // kinetic, then momentum x, y, z
// live, least live w per species, greatest w per species, E^2 + B^2 per
// field.
constexpr int kCensusK = 1 + 2 * kMaxSpecies + 6;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int lanes = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int lanes = 2;
};

__device__ __forceinline__ double lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane(const double2& v, int k) {
  return k == 0 ? v.x : v.y;
}

template <typename V>
__device__ __forceinline__ V zero_vec() {
  V v;
  v.x = 0;
  v.y = 0;
  if constexpr (sizeof(V) == 16 && sizeof(v.x) == 4) {
    v.z = 0;
    v.w = 0;
  }
  return v;
}

template <typename V>
__device__ __forceinline__ bool all_zero(const V& v) {
  if constexpr (sizeof(v.x) == 4) {
    return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f;
  } else {
    return v.x == 0.0 && v.y == 0.0;
  }
}

// The reductions of a partial, by its kind.
enum Op { kSum, kMin, kMax };

__device__ __forceinline__ double combine(Op op, double a, double b) {
  if (op == kSum) return a + b;
  if (op == kMin) return b < a ? b : a;
  // A NaN weight makes the greatest NaN, as torch's max.
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ double identity(Op op) {
  return op == kSum ? 0.0 : op == kMin ? INFINITY : -INFINITY;
}

// The kind of each partial of a kernel.
struct MomentsOps {
  __device__ Op operator()(int) const { return kSum; }
};
struct CensusOps {
  __device__ Op operator()(int k) const {
    if (k == 0 || k > 2 * kMaxSpecies) return kSum;
    return k <= kMaxSpecies ? kMin : kMax;
  }
};

// The block's K values, each reduced over its threads in a fixed order;
// thread k < K writes value k to out[k].
template <int K, typename OpOf>
__device__ void block_reduce(double (&v)[K], OpOf op_of, double* out) {
  __shared__ double red[kWarps][K];
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Op op = op_of(k);
    double x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = combine(op, x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane_id == 0) red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    const Op op = op_of(k);
    double x = red[0][k];
    for (int w = 1; w < kWarps; ++w) x = combine(op, x, red[w][k]);
    out[k] = x;
  }
}

// This block's partial into partials[blockIdx.x]; in the block that
// finishes last, every block's partials reduced in block order into `tot`
// (shared), and true.  That block resets the counter for the next launch.
template <int K, typename OpOf>
__device__ bool reduce_grid(double (&v)[K], OpOf op_of, double* partials,
                            unsigned* counter, double* tot) {
  __shared__ bool last;
  block_reduce<K>(v, op_of, partials + (size_t)blockIdx.x * K);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  double x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = identity(op_of(k));
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] = combine(op_of(k), x[k], __ldcg(partials + (size_t)b * K + k));
  }
  __syncthreads();  // `red` is reused
  block_reduce<K>(x, op_of, tot);
  __syncthreads();
  if (threadIdx.x == 0) *counter = 0u;
  return true;
}

// ---------------------------------------------------------------------
// Moments.

// One slot's terms, in the plain version's order.
__device__ __forceinline__ void add_slot(double px, double py, double pz,
                                         double w, double mass,
                                         double (&acc)[kMomentsK]) {
  const double wm = w * mass;
  const double p2 = px * px + py * py + pz * pz;
  const double gamma = sqrt(1.0 + p2);
  acc[0] += wm * (p2 / (gamma + 1.0));
  acc[1] += wm * px;
  acc[2] += wm * py;
  acc[3] += wm * pz;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(const MomentsArgs a, double* partials, unsigned* counter) {
  using V = typename Vec<T>::type;
  constexpr int L = Vec<T>::lanes;
  const T* __restrict__ px = static_cast<const T*>(a.px);
  const T* __restrict__ py = static_cast<const T*>(a.py);
  const T* __restrict__ pz = static_cast<const T*>(a.pz);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  double acc[kMomentsK] = {0.0, 0.0, 0.0, 0.0};
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nv = a.vec ? a.n / L : 0;
  const V* wv = reinterpret_cast<const V*>(w);
  const V* xv = reinterpret_cast<const V*>(px);
  const V* yv = reinterpret_cast<const V*>(py);
  const V* zv = reinterpret_cast<const V*>(pz);
  for (long long i0 = first; i0 < nv; i0 += kUnroll * stride) {
    V wk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      wk[u] = i < nv ? __ldg(wv + i) : zero_vec<V>();
    }
    // The momenta of the vectors with a live slot, all loads in flight
    // before the first is used.
    V xk[kUnroll], yk[kUnroll], zk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (all_zero(wk[u])) continue;  // dead slots: 0 each
      const long long i = i0 + u * stride;
      xk[u] = __ldg(xv + i);
      yk[u] = __ldg(yv + i);
      zk[u] = __ldg(zv + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (all_zero(wk[u])) continue;
#pragma unroll
      for (int k = 0; k < L; ++k)
        add_slot(lane(xk[u], k), lane(yk[u], k), lane(zk[u], k),
                 lane(wk[u], k), a.mass, acc);
    }
  }
  // The slots past the last whole vector, or all of them when unaligned.
  for (long long i = nv * L + first; i < a.n; i += stride) {
    const T wi = w[i];
    if (wi != (T)0) add_slot(px[i], py[i], pz[i], wi, a.mass, acc);
  }
  __shared__ double tot[kMomentsK];
  if (reduce_grid<kMomentsK>(acc, MomentsOps(), partials, counter, tot) &&
      threadIdx.x == 0) {
    *a.ke = tot[0];
    for (int k = 0; k < 3; ++k) a.mom[k] = tot[1 + k];
  }
}

// ---------------------------------------------------------------------
// Census.

// One weight: live count, least live w, greatest w.
__device__ __forceinline__ void census_slot(double w, double& live,
                                            double& lo, double& hi) {
  if (w > 0.0) {
    live += 1.0;
    lo = w < lo ? w : lo;
  }
  hi = combine(kMax, hi, w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    census_kernel(const CensusArgs a, double* partials, unsigned* counter) {
  using V = typename Vec<T>::type;
  constexpr int L = Vec<T>::lanes;
  double v[kCensusK];
#pragma unroll
  for (int k = 0; k < kCensusK; ++k) v[k] = identity(CensusOps()(k));
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kMaxSpecies; ++s) {
    if (s >= a.ns) continue;
    const T* __restrict__ w = static_cast<const T*>(a.w[s]);
    const long long n = a.n[s];
    const long long nv = a.vec[s] ? n / L : 0;
    const V* wv = reinterpret_cast<const V*>(w);
    double live = 0.0, lo = INFINITY, hi = -INFINITY;
    for (long long i0 = first; i0 < nv; i0 += kUnroll * stride) {
      V wk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * stride;
        if (i < nv) wk[u] = __ldg(wv + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * stride >= nv) break;
#pragma unroll
        for (int k = 0; k < L; ++k) census_slot(lane(wk[u], k), live, lo, hi);
      }
    }
    for (long long i = nv * L + first; i < n; i += stride)
      census_slot(w[i], live, lo, hi);
    v[0] += live;
    v[1 + s] = lo;
    v[1 + kMaxSpecies + s] = hi;
  }
  if (a.fe != nullptr) {
    const long long nv = a.fvec ? a.nf / L : 0;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const T* __restrict__ f = static_cast<const T*>(a.f[c]);
      const V* fv = reinterpret_cast<const V*>(f);
      double acc = 0.0;
      for (long long i = first; i < nv; i += stride) {
        const V x = __ldg(fv + i);
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const double e = lane(x, k);
          acc += e * e;
        }
      }
      for (long long i = nv * L + first; i < a.nf; i += stride) {
        const long long r = i / a.fnx;
        const double e = f[r * a.fld + (i - r * a.fnx)];
        acc += e * e;
      }
      v[1 + 2 * kMaxSpecies + c] = acc;
    }
  }
  __shared__ double tot[kCensusK];
  if (!reduce_grid<kCensusK>(v, CensusOps(), partials, counter, tot) ||
      threadIdx.x != 0)
    return;
  a.live[0] = (int)tot[0];
  if (a.bad != nullptr) {
    int bad = 0;
    for (int s = 0; s < a.ns; ++s) {
      const double lo = tot[1 + s], hi = tot[1 + kMaxSpecies + s];
      if (a.check[s] && lo != hi && isfinite(lo)) ++bad;
    }
    *a.bad = bad;
  }
  if (a.fe != nullptr) {
    // The plain version's order: the fields' sums in turn, then
    // 0.5 * total * dx * dy.
    double total = tot[1 + 2 * kMaxSpecies];
    for (int c = 1; c < 6; ++c) total += tot[1 + 2 * kMaxSpecies + c];
    *a.fe = 0.5 * total * a.dx * a.dy;
  }
}

int finish() { return (int)cudaGetLastError(); }

template <typename T>
int moments(const MomentsArgs& a, double* partials, unsigned* counter,
            int blocks, cudaStream_t stream) {
  moments_kernel<T><<<blocks, kThreads, 0, stream>>>(a, partials, counter);
  return finish();
}

template <typename T>
int census(const CensusArgs& a, double* partials, unsigned* counter,
           int blocks, cudaStream_t stream) {
  census_kernel<T><<<blocks, kThreads, 0, stream>>>(a, partials, counter);
  return finish();
}

template <typename T>
int resident(int census_kernel_of, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = census_kernel_of
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, census_kernel<T>, kThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, moments_kernel<T>, kThreads, 0);
  *blocks = sms * per_sm;
  return (int)err;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each takes `f64` (0: float32
// channels, 1: float64) first, launches on `stream`, allocates nothing and
// returns the CUDA error code (0 on success).  `partials` holds `blocks` x
// the kernel's partial count of doubles; `counter` is 0 before the launch
// and after it.
extern "C" int minipic_moments(int f64, MomentsArgs a, double* partials,
                               unsigned* counter, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? moments<double>(a, partials, counter, blocks, s)
             : moments<float>(a, partials, counter, blocks, s);
}

extern "C" int minipic_census(int f64, CensusArgs a, double* partials,
                              unsigned* counter, int blocks, void* stream) {
  if (a.ns < 0 || a.ns > kMaxSpecies) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? census<double>(a, partials, counter, blocks, s)
             : census<float>(a, partials, counter, blocks, s);
}

// The blocks of a kernel (census 1: the census, 0: the moments) that the
// current device holds at once, into *blocks.
extern "C" int minipic_diag_resident(int f64, int census_kernel_of,
                                     int* blocks) {
  return f64 ? resident<double>(census_kernel_of, blocks)
             : resident<float>(census_kernel_of, blocks);
}

// The partials a block of each kernel writes.
extern "C" int minipic_diag_partials(int census_kernel_of) {
  return census_kernel_of ? kCensusK : kMomentsK;
}
