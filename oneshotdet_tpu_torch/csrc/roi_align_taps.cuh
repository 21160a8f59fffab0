// What the cross-ROI ROIAlign kernels K4 (roi_align_v3.cu) and K5
// (roi_align_v4.cu) share: the pyramid, vectors of N channels, one sample's
// interpolation in the spec's float32 operations, a warp's tap lists and the
// kernels' arguments. oneshotdet_tpu_torch/csrc/__init__.py hashes this file
// into both libraries' names, so an edit rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ONESHOT_MAX_LEVELS 5
#define MAX_POOLED_W 8
#define MAX_TAPS 8           // 2 * sampling_ratio
#define MAX_G 4
#define ROW_CHUNK 8          // output rows whose taps a warp lists at once
#define BODY_WARPS 8         // warps of a kernel block, at most
#define LOADS 4              // tap loads a lane keeps in flight

struct Pyramid {
  const void* data[ONESHOT_MAX_LEVELS];  // (B, H_l, W_l, C), contiguous NHWC
  int height[ONESHOT_MAX_LEVELS];
  int width[ONESHOT_MAX_LEVELS];
  float scale[ONESHOT_MAX_LEVELS];
  int num_levels;
};

// ---- vectors of N channels --------------------------------------------------

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned; };

template <typename T, int N>
struct Vec {
  static constexpr int BYTES = N * (int)sizeof(T);
  static constexpr int WORDS = BYTES / 4;
  using raw = typename Raw<BYTES>::type;
  union Words {
    raw r;
    unsigned u[WORDS];
  };
  __device__ static __forceinline__ raw load(const T* p) {
    return __ldg(reinterpret_cast<const raw*>(p));
  }
  __device__ static __forceinline__ void store(T* p, raw v) {
    *reinterpret_cast<raw*>(p) = v;
  }
  // fp32 words as they are; a bf16 -> fp32 widening is exact (the 16 bits
  // become the high half of the float)
  __device__ static __forceinline__ void widen(raw q, float* f) {
    Words w;
    w.r = q;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      if constexpr (sizeof(T) == 4) {
        f[k] = __uint_as_float(w.u[k]);
      } else {
        f[2 * k] = __uint_as_float(w.u[k] << 16);
        f[2 * k + 1] = __uint_as_float(w.u[k] & 0xffff0000u);
      }
    }
  }
  __device__ static __forceinline__ raw narrow(const float* f) {
    Words w;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      if constexpr (sizeof(T) == 4) {
        w.u[k] = __float_as_uint(f[k]);
      } else {
        const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(f[2 * k], f[2 * k + 1]));
        w.u[k] = *reinterpret_cast<const unsigned*>(&v);
      }
    }
    return w.r;
  }
};

// ---- taps ----------------------------------------------------------------------

// Sample `s` of output index i on one axis: interp_params' float32
// operations in their order. (s + 0.5) / g is formed in double and rounded
// once to float32, as the spec's Python scalar is.
struct Interp {
  float low, high, lfrac, in;
};

__device__ __forceinline__ Interp interp(float start, float bin, float dim, int i, int s, int g) {
  const float frac = (float)(((double)s + 0.5) / (double)g);
  const float pos = start + ((float)i + frac) * bin;
  Interp t;
  t.in = (pos >= -1.f && pos <= dim) ? 1.f : 0.f;
  const float posc = fmaxf(pos, 0.f);
  t.low = fminf(floorf(posc), dim - 1.f);
  t.high = fminf(t.low + 1.f, dim - 1.f);
  const float posf = t.low >= dim - 1.f ? t.low : posc;
  t.lfrac = posf - t.low;
  return t;
}

// One warp's taps of one ROI: per output column, and per output row of the
// current chunk, cells and weights in summation order, and their count.
struct Taps {
  int xc[MAX_POOLED_W][MAX_TAPS];
  float xw[MAX_POOLED_W][MAX_TAPS];
  int nx[MAX_POOLED_W];
  int yc[ROW_CHUNK][MAX_TAPS];
  float yw[ROW_CHUNK][MAX_TAPS];
  int ny[ROW_CHUNK];
};


// One inner contraction in the plain version's order: s = sum over k < n of
// w[k] * F[p + cell[k] * stride], one multiply and one add at a time from
// zero; LOADS loads in flight at once.
template <typename T, int N>
__device__ __forceinline__ void contract(const T* p, const int* cell, const float* w, int n,
                                         int64_t stride, bool active, float* s) {
  using V = Vec<T, N>;
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] = 0.f;
  for (int k0 = 0; k0 < n; k0 += LOADS) {
    typename V::raw v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k)
      if (k0 + k < n && active) v[k] = V::load(p + cell[k0 + k] * stride);
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      if (k0 + k < n) {
        float f[N];
        V::widen(v[k], f);
        const float wk = w[k0 + k];
#pragma unroll
        for (int e = 0; e < N; ++e) s[e] = s[e] + wk * f[e];
      }
    }
  }
}

// The last one or two inner contractions of one sweep of bins, by the cell
// they were taken at: a bin whose tap lies on one of those cells reuses the
// value (the same operations on the same inputs give the same bits).
template <int N, int SLOTS>
struct Recent {
  static_assert(SLOTS == 1 || SLOTS == 2, "one or two values");
  int cell0 = -1, cell1 = -1;
  float v0[N], v1[N];
  __device__ __forceinline__ bool get(int at, float* s) const {
    const bool first = at == cell0;
    if (!first && (SLOTS == 1 || at != cell1)) return false;
#pragma unroll
    for (int e = 0; e < N; ++e) s[e] = first ? v0[e] : v1[e];
    return true;
  }
  __device__ __forceinline__ void put(int at, const float* s) {
    if constexpr (SLOTS == 2) {
      cell1 = cell0;
#pragma unroll
      for (int e = 0; e < N; ++e) v1[e] = v0[e];
    }
    cell0 = at;
#pragma unroll
    for (int e = 0; e < N; ++e) v0[e] = s[e];
  }
};

struct BodyArgs {
  Pyramid pyr;
  int batch, channels;
  const float* rois;  // (R, 5) with strides rs0, rs1 (elements)
  long long rs0, rs1;
  const int* block_group;
  const int* slot_roi;
  int t, pooled_h, pooled_w, g;
  void* out;
  // K5 only: each level's window width (w_l_of) and the tallest level's height
  int window_width[ONESHOT_MAX_LEVELS];
  int slab_h;
};

// roi_geometry of one ROI on its level: the box in cells of the level, at
// least one cell on each axis, and the bin sizes (true divisions)
struct RoiBox {
  float start_w, start_h, bin_w, bin_h;
};

__device__ __forceinline__ RoiBox roi_box(const BodyArgs& a, int r, int lvl) {
  const float* roi = a.rois + (int64_t)r * a.rs0;
  const float scale = a.pyr.scale[lvl];
  RoiBox box;
  box.start_w = roi[a.rs1] * scale;
  box.start_h = roi[2 * a.rs1] * scale;
  const float roi_w = fmaxf(roi[3 * a.rs1] * scale - box.start_w, 1.f);
  const float roi_h = fmaxf(roi[4 * a.rs1] * scale - box.start_h, 1.f);
  box.bin_w = roi_w / (float)a.pooled_w;
  box.bin_h = roi_h / (float)a.pooled_h;
  return box;
}

// The arguments both entry points take; K5 sets its window fields itself.
static BodyArgs body_args(const void* pyramid, int batch, int channels, const void* rois,
                          long long rs0, long long rs1, const void* block_group,
                          const void* slot_roi, int t, int pooled_h, int pooled_w, int g,
                          void* out) {
  BodyArgs a = {};
  a.pyr = *static_cast<const Pyramid*>(pyramid);
  a.batch = batch;
  a.channels = channels;
  a.rois = static_cast<const float*>(rois);
  a.rs0 = rs0;
  a.rs1 = rs1;
  a.block_group = static_cast<const int*>(block_group);
  a.slot_roi = static_cast<const int*>(slot_roi);
  a.t = t;
  a.pooled_h = pooled_h;
  a.pooled_w = pooled_w;
  a.g = g;
  a.out = out;
  return a;
}

// A slot that is not live: its pooled_h x pooled_w vectors of zeros.
template <typename T, int N>
__device__ __forceinline__ void store_zeros(T* out_roi, int bins, int channels) {
  float zero[N];
#pragma unroll
  for (int e = 0; e < N; ++e) zero[e] = 0.f;
  for (int o = 0; o < bins; ++o)
    Vec<T, N>::store(out_roi + (int64_t)o * channels, Vec<T, N>::narrow(zero));
}

// Launch a body kernel with a warp for each ROI and channel segment of a
// slab block, at most BODY_WARPS; returns cudaGetLastError().
template <typename T, int N, typename Kernel>
static int launch_body(Kernel kernel, const BodyArgs& a, int num_blocks, cudaStream_t s) {
  const int segs = (a.channels + 32 * N - 1) / (32 * N);
  const int warps = a.t * segs < BODY_WARPS ? a.t * segs : BODY_WARPS;
  kernel<<<num_blocks, 32 * warps, 0, s>>>(a);
  return (int)cudaGetLastError();
}
