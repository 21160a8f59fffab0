// Windowed cross-ROI multi-level ROIAlign (v4) for Hopper (sm_90a), NHWC,
// fp32 or bf16 in and out, float32 accumulation.
//
// Replaces oneshotdet_tpu/ops/pallas_roi_align_v4.py::
// pallas_multilevel_roi_align_v4 (the Pallas TPU kernel). The wrapper
// (oneshotdet_tpu_torch/ops/roi_align_v4.py) builds, as the JAX package does
// outside its kernel, dense interpolation weights per ROI: rows wy
// (R, pooled_h, slab_h) over the level's height, columns wx (R, pooled_w, 64)
// over a 64-column window from x0 (R,) whose out-of-window corners clamp to
// the window's edge; invalid slots have zero weights. It sorts the slots into
// blocks of t ROIs that share one (image, level) map. This kernel computes
//   A[p, w, c]   = sum_h wy[r, p, h] * F0[b, h, x0 + w, c]        (stage A, rows)
//   out[p, q, c] = sum_w wx[r, q, w] * A[p, w, c]                 (stage B, columns)
// with F0 the level zero-padded on the right: a window column at or past the
// level's width contributes nothing. So it gives the TPU kernel's window
// clamp for ROIs wider than 56 cells, and its zero padding on narrow levels.
//
// Bound. As roi_align.cu: at least one read of the pyramid and one write of
// the output, plus the dense weights the wrapper writes and this kernel
// reads once (~4 * (slab_h + 64) * 7 bytes per ROI).
//
// Design. The TPU kernel runs stage A as one matmul over the whole slab and
// stage B as a block-diagonal matmul; almost all of both products' terms are
// zeros (a dense row has at most 2g non-zero weights). A thread block here
// owns one output row p of the t ROIs of one block, one ROI after another.
// Per ROI it stages the window's column weights in shared memory, and one
// warp compacts the row's non-zero weights (ballot) and the window columns
// that some output column uses and that lie inside the level. Each thread
// owns two adjacent channels: for each such column it forms the stage-A value
// from the non-zero rows, then adds it into the pooled_w stage-B accumulators
// in float32 registers. Skipping zero weights leaves the sums unchanged.
// No tensor cores: each product has only a few non-zero terms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ONESHOT_MAX_LEVELS 5
#define MAX_POOLED_W 8
#define WIN 64

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

// grid (blocks, pooled_h); dynamic shared memory: slab_h ints + slab_h floats
template <typename T>
__global__ void roi_align_v4_kernel(Pyramid pyr, int batch, int channels,
                                    const float* __restrict__ wy, int slab_h,
                                    const float* __restrict__ wx,
                                    const int* __restrict__ x0s,
                                    const int* __restrict__ block_group,
                                    const int* __restrict__ slot_roi, int t,
                                    int pooled_h, int pooled_w,
                                    T* __restrict__ out) {
  extern __shared__ int s_dyn[];
  int* s_rows = s_dyn;                                         // [slab_h]
  float* s_wrow = reinterpret_cast<float*>(s_dyn + slab_h);    // [slab_h]
  __shared__ float s_wx[MAX_POOLED_W * WIN];
  __shared__ int s_cols[WIN];
  __shared__ int s_nrows, s_ncols;

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
  const int lane = threadIdx.x & 31;

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
    const int x0 = x0s[r];
    __syncthreads();  // the previous ROI's staging is no longer read
    for (int j = threadIdx.x; j < pooled_w * WIN; j += blockDim.x)
      s_wx[j] = wx[(int64_t)r * pooled_w * WIN + j];
    __syncthreads();
    if (threadIdx.x < 32) {
      // non-zero row weights of output row p (rows past the level are zero)
      const float* wrow = wy + ((int64_t)r * pooled_h + p) * slab_h;
      int n = 0;
      for (int h0 = 0; h0 < height; h0 += 32) {
        const int h = h0 + lane;
        const float w = h < height ? wrow[h] : 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, w != 0.f);
        if (w != 0.f) {
          const int at = n + __popc(m & ((1u << lane) - 1u));
          s_rows[at] = h;
          s_wrow[at] = w;
        }
        n += __popc(m);
      }
      // window columns some output column weighs and that lie in the level
      int nc = 0;
      for (int w0 = 0; w0 < WIN; w0 += 32) {
        const int w = w0 + lane;
        bool used = false;
        for (int q = 0; q < pooled_w; ++q) used |= s_wx[q * WIN + w] != 0.f;
        used &= x0 + w < width;
        const unsigned m = __ballot_sync(0xffffffffu, used);
        if (used) s_cols[nc + __popc(m & ((1u << lane) - 1u))] = w;
        nc += __popc(m);
      }
      if (lane == 0) {
        s_nrows = n;
        s_ncols = nc;
      }
    }
    __syncthreads();
    const int nrows = s_nrows, ncols = s_ncols;

    for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
      float2 acc[MAX_POOLED_W];
#pragma unroll
      for (int q = 0; q < MAX_POOLED_W; ++q) acc[q] = make_float2(0.f, 0.f);
      for (int ci = 0; ci < ncols; ++ci) {
        const int w = s_cols[ci];
        const T* col = base + (int64_t)(x0 + w) * channels + c;
        // stage A: the window column's value on output row p
        float2 a = make_float2(0.f, 0.f);
        for (int ri = 0; ri < nrows; ++ri) {
          const float2 v = load2(col + (int64_t)s_rows[ri] * width * channels);
          a.x += s_wrow[ri] * v.x;
          a.y += s_wrow[ri] * v.y;
        }
        // stage B: into every output column that weighs it
#pragma unroll
        for (int q = 0; q < MAX_POOLED_W; ++q) {
          if (q >= pooled_w) break;
          const float wq = s_wx[q * WIN + w];
          acc[q].x += wq * a.x;
          acc[q].y += wq * a.y;
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
int oneshot_roi_align_v4_forward(const void* pyramid, int batch, int channels,
                                 int dtype, const void* wy, int slab_h,
                                 const void* wx, const void* x0,
                                 const void* block_group, const void* slot_roi,
                                 int num_blocks, int rois_per_block,
                                 int pooled_h, int pooled_w, void* out,
                                 void* stream) {
  const Pyramid pyr = *static_cast<const Pyramid*>(pyramid);
  if (pooled_w > MAX_POOLED_W) return (int)cudaErrorInvalidValue;
  const int half = channels / 2;
  const int threads = half < 256 ? ((half + 31) / 32) * 32 : 256;
  const dim3 grid((unsigned)num_blocks, (unsigned)pooled_h);
  const size_t smem = (size_t)slab_h * (sizeof(int) + sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fwy = static_cast<const float*>(wy);
  const float* fwx = static_cast<const float*>(wx);
  const int* ix0 = static_cast<const int*>(x0);
  const int* bg = static_cast<const int*>(block_group);
  const int* sr = static_cast<const int*>(slot_roi);
  if (dtype == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(roi_align_v4_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    roi_align_v4_kernel<float><<<grid, threads, smem, s>>>(
        pyr, batch, channels, fwy, slab_h, fwx, ix0, bg, sr, rois_per_block,
        pooled_h, pooled_w, static_cast<float*>(out));
  } else if (dtype == 1) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(roi_align_v4_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    roi_align_v4_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        pyr, batch, channels, fwy, slab_h, fwx, ix0, bg, sr, rois_per_block,
        pooled_h, pooled_w, static_cast<__nv_bfloat16*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oneshot_roi_align_v4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
