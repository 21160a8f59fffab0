// GroupNorm + activation forward for Hopper (sm_90a), channels-last, fp32 or
// bf16 in and out, float32 statistics.
//
// Replaces oneshotdet_tpu/ops/pallas_groupnorm.py::_gn_pallas (the Pallas TPU
// kernels _moments_kernel and _make_normalize_kernel, with the per-group
// reduction XLA does between them). x is (B, S, C) with S every non-batch,
// non-channel position; for each (image, group of C / G adjacent channels):
//   mean = E[x], inv = rsqrt(max(E[x^2] - mean^2, 0) + eps)   (one pass, f32)
//   y = act(((x - mean) * inv) * gamma + beta), act none, ReLU or LeakyReLU.
// The one-pass formula is the JAX package's; it is kept although two-pass
// statistics are more accurate at a large input mean.
//
// Bound. A few flops per element: memory traffic bounds it. The least traffic
// is x read once and y written once; this design reads x twice (moments,
// normalize) and writes y once, as the Pallas pair does. At the FCOS tower's
// P3 (8 x 104 x 152 x 256, bf16): 64.8 MB in + 64.8 MB out, ~39 us at
// 3.35 TB/s, and ~58 us for the three passes; the second read of x may come
// from the 50 MB L2.
//
// Design. Two launches on the caller's stream; no block waits for another.
// A thread owns CPT = VEC * NV channels of a row: NV vectors of VEC channels,
// 16 bytes each where C allows (CPT = 8: one vector of 8 bf16, or two of 4
// f32 half a row apart; else 8 or 4 bytes, CPT 4 or 2). tpr = C / CPT
// threads cover a row and `lanes` = blockDim / tpr rows are read at once; each
// load instruction of a warp reads a contiguous run of a row. CPT, and so the
// order of the sums, depends on C alone, not on the dtype. Each image's rows
// are cut into `splits` runs of `rows_per_split`; block (split, image) takes
// one run, and lane l of it the rows l, l + lanes, ... of the run, with U rows
// (64 bytes a thread) in flight at a time.
//   1. gn_moments: each thread sums x and x^2 of its channels over its rows,
//      in row order; the lanes are summed in lane order through shared memory
//      and the block writes its run's sums to partial (B, splits, 2, C), with
//      no atomics on the data. Then the threadFenceReduction pattern: a fence,
//      and one atomicAdd on the image's arrival counter, read once and never
//      waited on. The block that arrives last for its image sums the image's
//      partials in split order, then each group's channels in channel order,
//      writes the per-channel mean and inv, and sets the counter back to 0,
//      so the counters are 0 between calls (and CUDA-graph replays).
//   2. gn_normalize: each thread loads its channels' mean, inv, gamma and beta
//      once, then walks its rows: 16-byte load, the JAX order of operations,
//      the activation, 16-byte store. A block covers one (image, run), so the
//      loop has no division. The blocks take the runs in the reverse of
//      gn_moments' order and each lane walks its rows backwards: the rows
//      gn_moments read last, which may still be in L2, are read first.
// Built with -fmad=false: the plain version (ops/group_norm.py) repeats these
// sums and divisions in this order and equals the kernels bit for bit.
// tools/ablate_group_norm.py times each launch; PERF.md has what it measured
// and what was tried (more rows in flight, L2 prefetch, more blocks, a
// programmatic dependent launch, the normalize launch in gn_moments' order)
// and did not help.
//
// The wrapper (oneshotdet_tpu_torch/ops/group_norm.py) checks shapes, dtypes,
// devices, contiguity and x's alignment to one vector, picks the layout
// (moments_layout), allocates the outputs and `partial`, and keeps one zeroed
// arrival counter per image for each (device, stream) (a CUDA graph's capture
// gets its own); this file launches and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// W 32-bit words at p, one vector load (p is aligned to 4 * W bytes).
template <int W>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 r = *static_cast<const uint4*>(p);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else if constexpr (W == 2) {
    const uint2 r = *static_cast<const uint2*>(p);
    w[0] = r.x; w[1] = r.y;
  } else {
    w[0] = *static_cast<const unsigned*>(p);
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const unsigned (&w)[W]) {
  if constexpr (W == 4) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *static_cast<unsigned*>(p) = w[0];
  }
}

// VEC channels of T as float32 v[0..VEC), in one load or one store.
template <typename T, int VEC> struct Io;

template <int VEC> struct Io<float, VEC> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    unsigned w[VEC];
    load_words<VEC>(p, w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __uint_as_float(w[i]);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    unsigned w[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) w[i] = __float_as_uint(v[i]);
    store_words<VEC>(p, w);
  }
};

template <int VEC> struct Io<__nv_bfloat16, VEC> {
  static constexpr int W = VEC / 2;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    unsigned w[W];
    load_words<W>(p, w);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    unsigned w[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
    store_words<W>(p, w);
  }
};

// Where a thread's rows and channels lie: it owns the channels
// (j * tpr + v) * VEC + i, j < NV, i < VEC, of rows s0 + lane + k * lanes,
// k < n, of its block's run.
struct Slot {
  int tpr, lanes, v, lane;
  int64_t n, step, off;  // rows, elements between them, element of the first
};

template <int VEC, int NV>
__device__ __forceinline__ Slot slot_of(int split, int b, int64_t spatial, int channels,
                                        int rows_per_split) {
  Slot t;
  t.tpr = channels / (VEC * NV);
  t.lanes = blockDim.x / t.tpr;
  t.v = threadIdx.x % t.tpr;
  t.lane = threadIdx.x / t.tpr;
  const int64_t s0 = (int64_t)split * rows_per_split;
  const int64_t s1 = s0 + rows_per_split < spatial ? s0 + rows_per_split : spatial;
  const int64_t left = s1 - s0 - t.lane;
  t.n = left > 0 ? (left + t.lanes - 1) / t.lanes : 0;
  t.step = (int64_t)t.lanes * channels;
  t.off = ((int64_t)b * spatial + s0 + t.lane) * channels + t.v * VEC;
  return t;
}

// Rows a thread keeps in flight: 64 bytes of x, at most 8 rows (128 bytes
// in gn_moments measured no faster).
template <typename T, int CPT>
__host__ __device__ constexpr int rows_in_flight() {
  return 64 / (CPT * (int)sizeof(T)) > 8 ? 8 : 64 / (CPT * (int)sizeof(T));
}

// grid (splits, B), blockDim = tpr * lanes <= LB (with LB = 256, four blocks
// fit on an SM: at most 64 registers a thread); dynamic shared memory
// max(lanes * 2 * C, 2 * C + 2 * G) floats.
template <typename T, int VEC, int NV, int LB>
__global__ void __launch_bounds__(LB, 1024 / LB)
gn_moments(const T* __restrict__ x, int64_t spatial, int channels, int groups,
           int rows_per_split, float count, float eps, float* __restrict__ partial,
           unsigned* __restrict__ arrivals, float* __restrict__ mean_c,
           float* __restrict__ inv_c) {
  constexpr int CPT = VEC * NV;
  constexpr int U = rows_in_flight<T, CPT>();
  extern __shared__ float smem[];
  __shared__ int is_last;
  const int b = blockIdx.y;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const Slot t = slot_of<VEC, NV>(split, b, spatial, channels, rows_per_split);
  const T* p = x + t.off;
  const int jstride = t.tpr * VEC;
  float sum[CPT], sq[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) sum[i] = sq[i] = 0.f;
  int64_t k = 0;
  for (; k + U <= t.n; k += U) {
    float val[U][CPT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j) Io<T, VEC>::load(p + u * t.step + j * jstride, val[u] + j * VEC);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        sum[i] += val[u][i];
        sq[i] += val[u][i] * val[u][i];
      }
    }
    p += U * t.step;
  }
  for (; k < t.n; ++k) {
    float val[CPT];
#pragma unroll
    for (int j = 0; j < NV; ++j) Io<T, VEC>::load(p + j * jstride, val + j * VEC);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      sum[i] += val[i];
      sq[i] += val[i] * val[i];
    }
    p += t.step;
  }
  float* mine = smem + (int64_t)t.lane * 2 * channels + t.v * VEC;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mine[j * jstride + i] = sum[j * VEC + i];
      mine[channels + j * jstride + i] = sq[j * VEC + i];
    }
  }
  __syncthreads();
  float* part = partial + ((int64_t)b * splits + split) * 2 * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    float a = smem[c], q = smem[channels + c];
    for (int l = 1; l < t.lanes; ++l) {
      a += smem[l * 2 * channels + c];
      q += smem[l * 2 * channels + channels + c];
    }
    part[c] = a;
    part[channels + c] = q;
  }
  // every thread's partials reach device scope before the block arrives
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(arrivals + b, 1u) == (unsigned)(splits - 1);
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;

  // the last block of image b: its statistics from the partials, read
  // through L2 (__ldcg) after the counter
  float* s_sum = smem;
  float* s_sq = s_sum + channels;
  float* g_mean = s_sq + channels;
  float* g_inv = g_mean + groups;
  const float* pb = partial + (int64_t)b * splits * 2 * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      a += __ldcg(pb + (int64_t)sp * 2 * channels + c);
      q += __ldcg(pb + (int64_t)sp * 2 * channels + channels + c);
    }
    s_sum[c] = a;
    s_sq[c] = q;
  }
  __syncthreads();
  const int cpg = channels / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cpg; ++i) {
      a += s_sum[g * cpg + i];
      q += s_sq[g * cpg + i];
    }
    const float m = a / count;
    const float m2 = q / count;
    g_mean[g] = m;
    g_inv[g] = 1.f / sqrtf(fmaxf(m2 - m * m, 0.f) + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    mean_c[(int64_t)b * channels + c] = g_mean[c / cpg];
    inv_c[(int64_t)b * channels + c] = g_inv[c / cpg];
  }
  if (threadIdx.x == 0) arrivals[b] = 0u;
}

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
  if (ACT == 1) return fmaxf(y, 0.f);
  if (ACT == 2) return y >= 0.f ? y : y * slope;
  return y;
}

// grid (splits, B), blockDim = tpr * lanes <= LB.
template <typename T, int VEC, int NV, int ACT, int LB>
__global__ void __launch_bounds__(LB, 1024 / LB)
gn_normalize(const T* __restrict__ x, const float* __restrict__ mean_c,
             const float* __restrict__ inv_c, const float* __restrict__ gamma,
             const float* __restrict__ beta, int64_t spatial, int channels,
             int rows_per_split, float slope, T* __restrict__ y) {
  constexpr int CPT = VEC * NV;
  constexpr int U = rows_in_flight<T, CPT>();
  // the runs, and each lane's rows, in the reverse of gn_moments' order
  const int split = gridDim.x - 1 - blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;
  Slot t = slot_of<VEC, NV>(split, b, spatial, channels, rows_per_split);
  const int jstride = t.tpr * VEC;
  float m[CPT], r[CPT], g[CPT], be[CPT];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = t.v * VEC + j * jstride + i;
      m[j * VEC + i] = mean_c[(int64_t)b * channels + c];
      r[j * VEC + i] = inv_c[(int64_t)b * channels + c];
      g[j * VEC + i] = gamma[c];
      be[j * VEC + i] = beta[c];
    }
  }
  t.off += (t.n - 1) * t.step;
  t.step = -t.step;
  int64_t k = 0;
  for (; k + U <= t.n; k += U) {
    float val[U][CPT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Io<T, VEC>::load(x + t.off + u * t.step + j * jstride, val[u] + j * VEC);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        val[u][i] = activate<ACT>((val[u][i] - m[i]) * r[i] * g[i] + be[i], slope);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Io<T, VEC>::store(y + t.off + u * t.step + j * jstride, val[u] + j * VEC);
    }
    t.off += U * t.step;
  }
  for (; k < t.n; ++k) {
    float val[CPT];
#pragma unroll
    for (int j = 0; j < NV; ++j) Io<T, VEC>::load(x + t.off + j * jstride, val + j * VEC);
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      val[i] = activate<ACT>((val[i] - m[i]) * r[i] * g[i] + be[i], slope);
#pragma unroll
    for (int j = 0; j < NV; ++j) Io<T, VEC>::store(y + t.off + j * jstride, val + j * VEC);
    t.off += t.step;
  }
}

struct Args {
  const void* x;
  int batch;
  int64_t spatial;
  int channels, groups;
  float eps;
  int act;
  float slope;
  const float *gamma, *beta;
  int splits, rows_per_split, lanes;
  float* partial;
  unsigned* arrivals;
  float *mean_c, *inv_c;
  void* y;
  cudaStream_t stream;
};

template <typename T, int VEC, int NV, int LB>
static int run(const Args& a) {
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int threads = a.channels / (VEC * NV) * a.lanes;
  const dim3 grid(a.splits, a.batch);
  const int lane_floats = a.lanes * 2 * a.channels;
  const int stat_floats = 2 * a.channels + 2 * a.groups;
  const size_t smem = sizeof(float) * (lane_floats > stat_floats ? lane_floats : stat_floats);
  const float count = (float)(a.spatial * (a.channels / a.groups));
  gn_moments<T, VEC, NV, LB><<<grid, threads, smem, a.stream>>>(
      x, a.spatial, a.channels, a.groups, a.rows_per_split, count, a.eps, a.partial,
      a.arrivals, a.mean_c, a.inv_c);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
#define GN_NORMALIZE(ACT)                                                        \
  gn_normalize<T, VEC, NV, ACT, LB><<<grid, threads, 0, a.stream>>>(             \
      x, a.mean_c, a.inv_c, a.gamma, a.beta, a.spatial, a.channels,             \
      a.rows_per_split, a.slope, y)
  if (a.act == 1)
    GN_NORMALIZE(1);
  else if (a.act == 2)
    GN_NORMALIZE(2);
  else
    GN_NORMALIZE(0);
#undef GN_NORMALIZE
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int NV>
static int run_bounded(const Args& a) {
  return a.channels / (VEC * NV) * a.lanes <= 256 ? run<T, VEC, NV, 256>(a)
                                                   : run<T, VEC, NV, 1024>(a);
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 none, 1 ReLU, 2 LeakyReLU(slope);
// cpt: channels a thread owns (8, 4 or 2; C % cpt == 0; x aligned to
// min(cpt elements, 16 bytes)); (C / cpt) * lanes <= 1024 threads; partial
// holds B * splits * 2 * C floats; arrivals B zeroed counters, left at 0.
// Returns the first nonzero cudaGetLastError() of the two launches.
int oneshot_group_norm_forward(const void* x, int dtype, int batch, long long spatial,
                               int channels, int groups, float eps, int act, float slope,
                               const void* gamma, const void* beta, int cpt, int splits,
                               int rows_per_split, int lanes, void* partial, void* arrivals,
                               void* mean_c, void* inv_c, void* y, void* stream) {
  const Args a{x, batch, (int64_t)spatial, channels, groups, eps, act, slope,
               static_cast<const float*>(gamma), static_cast<const float*>(beta), splits,
               rows_per_split, lanes, static_cast<float*>(partial),
               static_cast<unsigned*>(arrivals), static_cast<float*>(mean_c),
               static_cast<float*>(inv_c), y, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && cpt == 8) return run_bounded<float, 4, 2>(a);
  if (dtype == 0 && cpt == 4) return run_bounded<float, 4, 1>(a);
  if (dtype == 0 && cpt == 2) return run_bounded<float, 2, 1>(a);
  if (dtype == 1 && cpt == 8) return run_bounded<__nv_bfloat16, 8, 1>(a);
  if (dtype == 1 && cpt == 4) return run_bounded<__nv_bfloat16, 4, 1>(a);
  if (dtype == 1 && cpt == 2) return run_bounded<__nv_bfloat16, 2, 1>(a);
  return (int)cudaErrorInvalidValue;
}

const char* oneshot_group_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
