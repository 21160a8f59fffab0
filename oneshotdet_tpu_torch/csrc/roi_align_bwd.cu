// Multi-level (FPN) ROIAlign backward for Hopper (sm_90a), NHWC, fp32 or bf16
// gradients: d(ROIAlign)/d(features), the gradient that trains both
// backbones through the 1x1 support pools, the support 7x7 and the
// proposals' 7x7.
//
// No TPU kernel: the JAX package trains on its XLA ROIAlign
// (oneshotdet_tpu/ops/roi_align.py::multilevel_roi_align) and takes this
// gradient as XLA's transpose of that gather. The forward kernel K1
// (roi_align.cu) computes exactly that function, so this kernel computes
// exactly its transpose: every in-range sample of a bin carries grad / g^2
// to its four bilinear corners with the weights w1..w4 of the forward
// (roi_align_common.cuh, shared with K1); clamped corners (low == high) land
// twice on one pixel; out-of-range samples and dead ROIs (valid = False, a
// level or batch index out of range) carry nothing. Its plain version is
// oneshotdet_tpu_torch/ops/roi_align.py::multilevel_roi_align_backward_plain.
//
// Design (simple first). One thread block per ROI. Warp 0 computes the ROI's
// y samples and warp 1 its x samples into shared memory, one lane per sample,
// as K1 does. A thread owns one 16-byte vector of grad_out channels (8 bf16
// or 4 fp32) of one bin; it widens it to float32, divides by g^2 and, for
// each in-range sample, adds w * grad to the four corners with float32
// atomicAdd, four channels per 16-byte vector atomic, into a zeroed float32
// workspace. The wrapper
// (oneshotdet_tpu_torch/ops/roi_align.py) allocates that workspace level by
// level, each level a contiguous (B, H, W, C) block, and casts it to the
// features' dtype afterwards: bf16 atomics would round at every add. The
// order of the atomic adds varies from run to run, so the result matches the
// plain version within a float32 tolerance, not bit for bit.
//
// Bound. The inputs read once (grad_out, the ROIs) and the gradient written
// once in the features' dtype; on the train path (batch 8, 832x1216 query,
// C = 256, R = 1024 proposals, bf16) that is 25.7 MB + 86.3 MB. What it
// costs: the 172.6 MB float32 workspace zeroed, 205 M atomic adds
// (R x 49 bins x 4 samples x 4 corners x 256 channels) that read, add and
// write the workspace in L2 (it is larger than L2, so lines travel to device
// memory), and the cast. Sampled ROIs crowd onto the GT boxes, so adds of
// neighbouring ROIs meet on the same addresses.

#include <stdint.h>

#include "roi_align_common.cuh"

#define MAX_AXIS 32  // pooled * sampling_ratio on one axis, as roi_align.cu
#define THREADS 256

// w * g[0..3] added to the 16-byte aligned p[0..3]: one vector atomic of
// compute capability 9.x, each float added atomically on its own.
__device__ __forceinline__ void add4(float* p, float w, const float* g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g[0], w * g[1], w * g[2], w * g[3]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    roi_align_bwd_kernel(Pyramid ws, int batch, int channels, const float* __restrict__ rois,
                         const int* __restrict__ levels, const unsigned char* __restrict__ valid,
                         int pooled_h, int pooled_w, int grid, const T* __restrict__ grad_out) {
  constexpr int N = Vec<T>::N;
  __shared__ AxisSample ys[MAX_AXIS], xs[MAX_AXIS];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* roi = rois + 5 * (int64_t)r;
  const int lvl = levels[r];
  const int b = (int)roi[0];
  if (!((valid == nullptr || valid[r] != 0) && lvl >= 0 && lvl < ws.num_levels && b >= 0 &&
        b < batch))
    return;

  const int height = ws.height[lvl];
  const int width = ws.width[lvl];
  if (tid < 64) {
    const bool y = tid < 32;
    const int s = tid % 32;
    const int pooled = y ? pooled_h : pooled_w;
    if (s < pooled * grid)
      (y ? ys : xs)[s] =
          roi_axis_sample(roi, ws.scale[lvl], y, s, pooled, grid, y ? height : width);
  }
  __syncthreads();

  float* base = static_cast<float*>(const_cast<void*>(ws.data[lvl])) +
                (int64_t)b * height * width * channels;
  const int vpp = channels / N;  // 16-byte vectors per pixel
  const int bins = pooled_h * pooled_w;
  const uint4* g_roi = reinterpret_cast<const uint4*>(grad_out + (int64_t)r * bins * channels);
  const float count = (float)(grid * grid);
  for (int k = tid; k < bins * vpp; k += THREADS) {
    const int bin = k / vpp;
    const int v = k - bin * vpp;
    const int ph = bin / pooled_w;
    const int pw = bin - ph * pooled_w;
    float gv[N];
    Vec<T>::widen(g_roi[k], gv);
#pragma unroll
    for (int j = 0; j < N; ++j) gv[j] = gv[j] / count;
    for (int iy = 0; iy < grid; ++iy) {
      const AxisSample sy = ys[ph * grid + iy];
      if (sy.lo < 0) continue;
      for (int ix = 0; ix < grid; ++ix) {
        const AxisSample sx = xs[pw * grid + ix];
        if (sx.lo < 0) continue;
        const float w1 = sy.h * sx.h, w2 = sy.h * sx.l, w3 = sy.l * sx.h, w4 = sy.l * sx.l;
        float* p1 = base + ((int64_t)sy.lo * width + sx.lo) * channels + v * N;
        float* p2 = base + ((int64_t)sy.lo * width + sx.hi) * channels + v * N;
        float* p3 = base + ((int64_t)sy.hi * width + sx.lo) * channels + v * N;
        float* p4 = base + ((int64_t)sy.hi * width + sx.hi) * channels + v * N;
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          add4(p1 + j, w1, gv + j);
          add4(p2 + j, w2, gv + j);
          add4(p3 + j, w3, gv + j);
          add4(p4 + j, w4, gv + j);
        }
      }
    }
  }
}

extern "C" {

// `workspace` is a Pyramid whose data pointers are the float32 gradient
// blocks of the levels, zeroed by the caller. dtype (of grad_out): 0 =
// float32, 1 = bfloat16. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes beyond the limits.
int oneshot_roi_align_backward(const void* workspace, int batch, int channels, int dtype,
                               const void* rois, const void* levels, const void* valid,
                               int num_rois, int pooled_h, int pooled_w, int sampling_ratio,
                               const void* grad_out, void* stream) {
  const Pyramid ws = *static_cast<const Pyramid*>(workspace);
  const int elt = dtype == 0 ? 4 : 2;
  const int g = sampling_ratio;
  if ((dtype != 0 && dtype != 1) || g <= 0 || pooled_h <= 0 || pooled_w <= 0 ||
      pooled_h * g > MAX_AXIS || pooled_w * g > MAX_AXIS || channels <= 0 ||
      (channels * elt) % 16 != 0 || ws.num_levels < 1 || ws.num_levels > ONESHOT_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* lv = static_cast<const int*>(levels);
  const unsigned char* vd = static_cast<const unsigned char*>(valid);
  if (dtype == 0)
    roi_align_bwd_kernel<float><<<num_rois, THREADS, 0, s>>>(
        ws, batch, channels, r, lv, vd, pooled_h, pooled_w, g,
        static_cast<const float*>(grad_out));
  else
    roi_align_bwd_kernel<__nv_bfloat16><<<num_rois, THREADS, 0, s>>>(
        ws, batch, channels, r, lv, vd, pooled_h, pooled_w, g,
        static_cast<const __nv_bfloat16*>(grad_out));
  return (int)cudaGetLastError();
}

const char* oneshot_roi_align_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
