// Multi-level (FPN) ROIAlign forward for Hopper (sm_90a), NHWC, fp32 or bf16.
//
// Replaces oneshotdet_tpu/ops/pallas_roi_align.py::pallas_multilevel_roi_align
// (the Pallas TPU kernel). It computes exactly
// oneshotdet_tpu/ops/roi_align.py::multilevel_roi_align, with slots whose
// `valid` flag is false written as zeros:
//   - each ROI row is (batch, x1, y1, x2, y2) in image pixels, pooled on its
//     own pyramid level at that level's scale, with no rounding;
//   - the ROI extent is at least one cell on each axis;
//   - every output bin is the mean of a sampling_ratio x sampling_ratio grid
//     of bilinear samples at (i + 0.5) / grid fractions of the bin;
//   - samples outside [-1, H] x [-1, W] contribute zero; in-range samples
//     clamp to >= 0 and their corners to the level's last row / column.
// The Pallas kernel's window tiers (which clamp ROIs beyond about 5:1), its
// ROI sort and its 8-column window alignment existed for the TPU's VMEM and
// have no counterpart here.
//
// Bound. The kernel does a few flops per byte, so it is bound by memory
// traffic: at least one read of the pyramid and one write of the output.
// On the main path (batch 8, 832x1216 query, C = 256, bf16, pyramid
// 86.3 MB) with the H100 SXM's 3.35 TB/s:
//   - R = 4096 ROIs (EVAL_ROI_TOPK = 512): 102.8 MB out + 86.3 MB in, ~56 us;
//   - R = 16000 ROIs (2000 per image):    401.4 MB out + 86.3 MB in, ~146 us.
//
// Design. One thread block per (ROI, output row); each thread owns two
// adjacent channels (one 4-byte bf16x2 or 8-byte float2 load per corner, so a
// warp reads 128 or 256 contiguous bytes of one NHWC pixel), accumulates the
// sampling grid x 4 corners in fp32 and stores each bin once in the input
// dtype. The five level base pointers and sizes are passed by value, so the
// pyramid is never concatenated. Corner reads of neighbouring ROIs hit L2;
// staging a level window in shared memory (cp.async / TMA) is left for later.
//
// The wrapper (oneshotdet_tpu_torch/ops/roi_align.py) checks shapes, dtypes,
// devices and contiguity and allocates the output; this file launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ONESHOT_MAX_LEVELS 5

struct Pyramid {
  const void* data[ONESHOT_MAX_LEVELS];  // (B, H_l, W_l, C), contiguous NHWC
  int height[ONESHOT_MAX_LEVELS];
  int width[ONESHOT_MAX_LEVELS];
  float scale[ONESHOT_MAX_LEVELS];
  int num_levels;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

template <typename T>
__global__ void roi_align_kernel(Pyramid pyr, int batch, int channels,
                                 const float* __restrict__ rois,
                                 const int* __restrict__ levels,
                                 const unsigned char* __restrict__ valid,
                                 int pooled_h, int pooled_w, int grid,
                                 T* __restrict__ out) {
  const int r = blockIdx.x / pooled_h;
  const int ph = blockIdx.x - r * pooled_h;
  T* out_row = out + ((int64_t)r * pooled_h + ph) * pooled_w * channels;

  const float* roi = rois + 5 * (int64_t)r;
  const int lvl = levels[r];
  const int b = (int)roi[0];
  const bool live = (valid == nullptr || valid[r] != 0) && lvl >= 0 &&
                    lvl < pyr.num_levels && b >= 0 && b < batch;
  if (!live) {
    for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x)
      for (int pw = 0; pw < pooled_w; ++pw)
        store2(out_row + pw * channels + c, make_float2(0.f, 0.f));
    return;
  }

  const int height = pyr.height[lvl];
  const int width = pyr.width[lvl];
  const float scale = pyr.scale[lvl];
  const T* base = static_cast<const T*>(pyr.data[lvl]) +
                  (int64_t)b * height * width * channels;

  // Same float32 operations, in the same order, as the plain version
  // (built with -fmad=false so no multiply-add is contracted).
  const float start_w = roi[1] * scale;
  const float start_h = roi[2] * scale;
  const float roi_w = fmaxf(roi[3] * scale - start_w, 1.f);
  const float roi_h = fmaxf(roi[4] * scale - start_h, 1.f);
  const float bin_h = roi_h / (float)pooled_h;
  const float bin_w = roi_w / (float)pooled_w;
  const float hf = (float)height;
  const float wf = (float)width;
  const float count = (float)(grid * grid);

  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    for (int pw = 0; pw < pooled_w; ++pw) {
      float2 acc = make_float2(0.f, 0.f);
      for (int iy = 0; iy < grid; ++iy) {
        const float yy =
            start_h + ((float)ph + ((float)iy + 0.5f) / (float)grid) * bin_h;
        for (int ix = 0; ix < grid; ++ix) {
          const float xx =
              start_w + ((float)pw + ((float)ix + 0.5f) / (float)grid) * bin_w;
          if (!(yy >= -1.f && yy <= hf && xx >= -1.f && xx <= wf)) continue;
          const float y = fmaxf(yy, 0.f);
          const float x = fmaxf(xx, 0.f);
          const int y_low = min((int)floorf(y), height - 1);
          const int x_low = min((int)floorf(x), width - 1);
          const int y_high = min(y_low + 1, height - 1);
          const int x_high = min(x_low + 1, width - 1);
          const float yv = y_low >= height - 1 ? (float)y_low : y;
          const float xv = x_low >= width - 1 ? (float)x_low : x;
          const float ly = yv - (float)y_low;
          const float lx = xv - (float)x_low;
          const float hy = 1.f - ly;
          const float hx = 1.f - lx;
          const float w1 = hy * hx, w2 = hy * lx, w3 = ly * hx, w4 = ly * lx;
          const float2 v1 = load2(base + ((int64_t)y_low * width + x_low) * channels + c);
          const float2 v2 = load2(base + ((int64_t)y_low * width + x_high) * channels + c);
          const float2 v3 = load2(base + ((int64_t)y_high * width + x_low) * channels + c);
          const float2 v4 = load2(base + ((int64_t)y_high * width + x_high) * channels + c);
          acc.x += w1 * v1.x + w2 * v2.x + w3 * v3.x + w4 * v4.x;
          acc.y += w1 * v1.y + w2 * v2.y + w3 * v3.y + w4 * v4.y;
        }
      }
      store2(out_row + pw * channels + c, make_float2(acc.x / count, acc.y / count));
    }
  }
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int oneshot_roi_align_forward(const void* pyramid, int batch, int channels,
                              int dtype, const void* rois, const void* levels,
                              const void* valid, int num_rois, int pooled_h,
                              int pooled_w, int sampling_ratio, void* out,
                              void* stream) {
  const Pyramid pyr = *static_cast<const Pyramid*>(pyramid);
  const int half = channels / 2;
  const int threads = half < 256 ? ((half + 31) / 32) * 32 : 256;
  const dim3 blocks((unsigned)num_rois * (unsigned)pooled_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  if (dtype == 0) {
    roi_align_kernel<float><<<blocks, threads, 0, s>>>(
        pyr, batch, channels, r, l, v, pooled_h, pooled_w, sampling_ratio,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        pyr, batch, channels, r, l, v, pooled_h, pooled_w, sampling_ratio,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oneshot_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
