// Cross-ROI separable multi-level ROIAlign (v3) for Hopper (sm_90a), NHWC,
// fp32 or bf16 in and out, float32 accumulation.
//
// Replaces oneshotdet_tpu/ops/pallas_roi_align_v3.py::
// pallas_multilevel_roi_align_v3 (the Pallas TPU kernel). Same function as
// roi_align.cu, exact for every aspect ratio, in the separable form the TPU
// kernel uses: the wrapper (oneshotdet_tpu_torch/ops/roi_align_v3.py) gives
// each output row p and column q of a ROI 2g cell indices and weights
// (interp_params: the bilinear corners of each sample, in-range mask, border
// clamp and the 1/g bin mean folded in), zero weights for invalid slots, and
// sorts the slots into blocks of t ROIs that share one (image, level) map:
//   out[r, p, q, c] = sum_j yw[r,p,j] * sum_k xw[r,q,k] * F[b, yi[r,p,j], xi[r,q,k], c].
//
// Bound. As roi_align.cu: a few flops per byte, bound by memory traffic, at
// least one read of the pyramid and one write of the output (~146 us at
// R = 16 000 on the main path's bf16 shapes at 3.35 TB/s).
//
// Design. The TPU kernel contracts a whole slab with two block-wide matmuls
// (its MXU wants large products); a CUDA thread block instead owns one output
// row p of the t ROIs of one block, one ROI after another, so the t ROIs'
// reads of one map run back to back and share L1 and L2. Per ROI the block
// stages the row's y taps and all x taps in shared memory; each thread owns
// two adjacent channels (one 4- or 8-byte load per tap) and contracts the x
// taps of each column, then the y taps, in float32 registers. Taps of zero
// weight (samples outside the map, invalid slots) are skipped: the weights
// are the same for every thread of the block, so the branch does not diverge.
// No tensor cores: each product has only 2g terms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ONESHOT_MAX_LEVELS 5
#define MAX_POOLED_W 8
#define MAX_TAPS 8

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

__device__ __forceinline__ int clamp_cell(float idx, int dim) {
  return min(max((int)idx, 0), dim - 1);
}

// grid (blocks, pooled_h); yi/yw (R, pooled_h, taps), xi/xw (R, pooled_w, taps)
template <typename T>
__global__ void roi_align_v3_kernel(Pyramid pyr, int batch, int channels,
                                    const float* __restrict__ yi,
                                    const float* __restrict__ yw,
                                    const float* __restrict__ xi,
                                    const float* __restrict__ xw,
                                    const int* __restrict__ block_group,
                                    const int* __restrict__ slot_roi, int t,
                                    int pooled_h, int pooled_w, int taps,
                                    T* __restrict__ out) {
  __shared__ int s_yi[MAX_TAPS];
  __shared__ float s_yw[MAX_TAPS];
  __shared__ int s_xi[MAX_POOLED_W * MAX_TAPS];
  __shared__ float s_xw[MAX_POOLED_W * MAX_TAPS];

  const int k = blockIdx.x;
  const int p = blockIdx.y;
  const int n_groups = batch * pyr.num_levels;
  const int group = block_group[k];
  if (group > n_groups) return;  // unused block
  const bool dead = group == n_groups;  // slots that are not valid: zeros
  const int b = dead ? 0 : group / pyr.num_levels;
  const int lvl = dead ? 0 : group % pyr.num_levels;
  const int height = pyr.height[lvl];
  const int width = pyr.width[lvl];
  const T* base = static_cast<const T*>(pyr.data[lvl]) +
                  (int64_t)b * height * width * channels;

  for (int i = 0; i < t; ++i) {
    const int r = slot_roi[(int64_t)k * t + i];
    if (r < 0) continue;  // padding slot (the same for the whole block)
    T* out_row = out + ((int64_t)r * pooled_h + p) * pooled_w * channels;
    if (dead) {
      for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x)
        for (int q = 0; q < pooled_w; ++q)
          store2(out_row + q * channels + c, make_float2(0.f, 0.f));
      continue;
    }
    __syncthreads();  // the previous ROI's taps are no longer read
    for (int j = threadIdx.x; j < taps; j += blockDim.x) {
      const int64_t e = ((int64_t)r * pooled_h + p) * taps + j;
      s_yi[j] = clamp_cell(yi[e], height);
      s_yw[j] = yw[e];
    }
    for (int j = threadIdx.x; j < pooled_w * taps; j += blockDim.x) {
      const int64_t e = (int64_t)r * pooled_w * taps + j;
      s_xi[j] = clamp_cell(xi[e], width);
      s_xw[j] = xw[e];
    }
    __syncthreads();

    for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
      float2 acc[MAX_POOLED_W];
#pragma unroll
      for (int q = 0; q < MAX_POOLED_W; ++q) acc[q] = make_float2(0.f, 0.f);
      for (int jy = 0; jy < taps; ++jy) {
        const float wy = s_yw[jy];
        if (wy == 0.f) continue;
        const T* row = base + (int64_t)s_yi[jy] * width * channels + c;
#pragma unroll
        for (int q = 0; q < MAX_POOLED_W; ++q) {
          if (q >= pooled_w) break;
          // x taps of column q on this row
          float2 sx = make_float2(0.f, 0.f);
          for (int jx = 0; jx < taps; ++jx) {
            const float wx = s_xw[q * taps + jx];
            if (wx == 0.f) continue;
            const float2 v = load2(row + (int64_t)s_xi[q * taps + jx] * channels);
            sx.x += wx * v.x;
            sx.y += wx * v.y;
          }
          // then the y tap
          acc[q].x += wy * sx.x;
          acc[q].y += wy * sx.y;
        }
      }
#pragma unroll
      for (int q = 0; q < MAX_POOLED_W; ++q)
        if (q < pooled_w) store2(out_row + q * channels + c, acc[q]);
    }
  }
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int oneshot_roi_align_v3_forward(const void* pyramid, int batch, int channels,
                                 int dtype, const void* yi, const void* yw,
                                 const void* xi, const void* xw,
                                 const void* block_group, const void* slot_roi,
                                 int num_blocks, int rois_per_block,
                                 int pooled_h, int pooled_w, int taps, void* out,
                                 void* stream) {
  const Pyramid pyr = *static_cast<const Pyramid*>(pyramid);
  if (pooled_w > MAX_POOLED_W || taps > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const int half = channels / 2;
  const int threads = half < 256 ? ((half + 31) / 32) * 32 : 256;
  const dim3 grid((unsigned)num_blocks, (unsigned)pooled_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fyi = static_cast<const float*>(yi);
  const float* fyw = static_cast<const float*>(yw);
  const float* fxi = static_cast<const float*>(xi);
  const float* fxw = static_cast<const float*>(xw);
  const int* bg = static_cast<const int*>(block_group);
  const int* sr = static_cast<const int*>(slot_roi);
  if (dtype == 0) {
    roi_align_v3_kernel<float><<<grid, threads, 0, s>>>(
        pyr, batch, channels, fyi, fyw, fxi, fxw, bg, sr, rois_per_block, pooled_h,
        pooled_w, taps, static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_align_v3_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        pyr, batch, channels, fyi, fyw, fxi, fxw, bg, sr, rois_per_block, pooled_h,
        pooled_w, taps, static_cast<__nv_bfloat16*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oneshot_roi_align_v3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
