// What the multi-level ROIAlign's forward (roi_align.cu, K1) and backward
// (roi_align_bwd.cu, K1b) share: the pyramid they are given, the per-ROI
// sample grid, so that both sample exactly the same positions with the same
// weights, the 16-byte asynchronous copies and the 16-byte channel vectors.
//
// The grid is separable: a sample's y depends only on (ph, iy) and its x
// only on (pw, ix). Each axis sample is computed with the float32 operations
// of oneshotdet_tpu_torch/ops/roi_align.py::_axis_samples, in its order
// (the files build with -fmad=false).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ONESHOT_MAX_LEVELS 5

// The pyramid's levels, passed by value. `data` points at each level's
// (B, H_l, W_l, C) contiguous NHWC map: the features in the forward, the
// level's gradient in the backward.
struct Pyramid {
  const void* data[ONESHOT_MAX_LEVELS];
  int height[ONESHOT_MAX_LEVELS];
  int width[ONESHOT_MAX_LEVELS];
  float scale[ONESHOT_MAX_LEVELS];
  int num_levels;
};

// One sample position on one axis: the weights of its high (l) and low (h)
// cell, and the cells (the forward's slot pass turns them into slots in the
// ROI's list of distinct rows or columns); lo = -1: out of range.
struct AxisSample {
  float l, h;
  int lo, hi;
};

// Axis sample s = p * grid + i at start + (p + (i + 0.5) / grid) * bin:
// in range inside [-1, size], clamped to >= 0, its cells clamped to the
// level's last row (column).
__device__ __forceinline__ AxisSample axis_sample(float start, float bin, int p, int i,
                                                  int grid, int size) {
  const float pos = start + ((float)p + ((float)i + 0.5f) / (float)grid) * bin;
  AxisSample a;
  a.lo = -1;
  a.hi = -1;
  a.l = 0.f;
  a.h = 0.f;
  if (pos >= -1.f && pos <= (float)size) {
    const float y = fmaxf(pos, 0.f);
    const int low = min((int)floorf(y), size - 1);
    const float yv = low >= size - 1 ? (float)low : y;
    a.lo = low;
    a.hi = min(low + 1, size - 1);
    a.l = yv - (float)low;
    a.h = 1.f - a.l;
  }
  return a;
}

// Sample s of one axis of ROI `roi` (batch, x1, y1, x2, y2) on a level of
// `scale` and `size` cells: the y axis when `y`, else the x axis. The ROI
// extent is at least one cell.
__device__ __forceinline__ AxisSample roi_axis_sample(const float* roi, float scale, bool y,
                                                      int s, int pooled, int grid, int size) {
  const float start = (y ? roi[2] : roi[1]) * scale;
  const float extent = fmaxf((y ? roi[4] : roi[3]) * scale - start, 1.f);
  const float bin = extent / (float)pooled;
  return axis_sample(start, bin, s / grid, s % grid, grid, size);
}

// 16-byte asynchronous copies from global into shared memory, in groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte vectors of channels: 4 fp32 or 8 bf16.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void widen(const uint4 q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  __device__ static __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(a, b));
  return *reinterpret_cast<const unsigned*>(&v);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> fp32 is exact: the 16 bits become the high half of the float
  __device__ static __forceinline__ void widen(const uint4 q, float* f) {
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};
