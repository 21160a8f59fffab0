// Windowed cross-ROI multi-level ROIAlign (v4) for Hopper (sm_90a), NHWC,
// fp32 or bf16 in and out, float32 accumulation.
//
// Replaces oneshotdet_tpu/ops/pallas_roi_align_v4.py::
// pallas_multilevel_roi_align_v4 (the Pallas TPU kernel). The spec
// (oneshotdet_tpu_torch/ops/roi_align_v4.py::window_operands) gives each ROI
// dense interpolation weights: rows wy (pooled_h, slab_h) over the level's
// height, columns wx (pooled_w, 64) over a 64-column window from x0 whose
// out-of-window corners clamp to the window's edge; zeros for slots that are
// not live. The function is
//   A[p, w, c]   = sum_h wy[r, p, h] * F0[b, h, x0 + w, c]        (stage A, rows)
//   out[p, q, c] = sum_w wx[r, q, w] * A[p, w, c]                 (stage B, columns)
// with F0 the level zero-padded on the right: a window column at or past the
// level's width contributes nothing. So it gives the TPU kernel's window
// clamp for ROIs wider than 56 cells, and its zero padding on narrow levels.
//
// Bound. As roi_align.cu: at least one read of the pyramid and one write of
// the output (~146 us at R = 16 000 on the main path's bf16 shapes at
// 3.35 TB/s). A dense row has at most 2g non-zero weights, so the products'
// non-zero terms are as few as K4's.
//
// Design. Two launches per call: the block sort of roi_align_v3.cu
// (roi_slab_sort_kernel, shared with K4), then roi_align_v4_kernel, laid out
// as K4's body (roi_align_v3.cu): a block takes one slab block, a warp one
// ROI (or one 32-lane channel segment of it), a lane one vector of N
// channels. The warp lists the ROI's taps itself, once per ROI: the window
// origin x0 as window_operands forms it; for each output column (lane q)
// the window columns whose dense weight is not zero and that lie inside the
// level, ascending, each with the very value dense_weights sums for it
// (corners clamped to the window's edge included); for each output row
// (lanes 16.., ROW_CHUNK rows at a time) its at most 2g rows of non-zero
// weight, ascending. No dense weight is written to memory. Per bin the lane
// forms the stage-A value of each window column from its rows (LOADS loads
// in flight), then adds it, weighed, into the bin: rows, then window
// columns, in increasing order, in float32 registers, the plain version's
// order; zero weights are left out, which leaves the sums unchanged. It
// sweeps each output row along its bins and keeps the last stage-A value: a
// bin whose first window column is the last one of the bin before reuses it
// (the values live in registers; a second one cost more than it saved).
// No tensor cores: each product has only a few non-zero terms.

#include <math.h>

#include "roi_align_taps.cuh"

#define WIN 64               // window columns

// window_operands' x0 = floor8(clip(floor(start_w), 0, w_l_of - WIN))
__device__ __forceinline__ float window_origin(float start_w, float w_l_of) {
  const float x0 = fminf(fmaxf(floorf(start_w), 0.f), w_l_of - (float)WIN);
  return floorf(x0 / 8.f) * 8.f;
}

// Output index i's list on one axis: the distinct corner cells of its
// samples, clamped to [0, last] cells from `origin`, ascending, each with the
// weight dense_weights sums for it (per sample in order: (cell == lo) *
// (1 - lfrac) + (cell == hi) * lfrac, times in-range; then times 1/g); those
// of zero weight, and those whose cell origin + c is at or past `limit` (the
// level's zero padding), left out. Cells are returned as origin + c.
__device__ __forceinline__ int window_taps(float start, float bin, float dim, float origin,
                                           float last, int limit, int i, int g, int* cell,
                                           float* w) {
  const float inv_g = (float)(1.0 / (double)g);
  float lo[MAX_G], hi[MAX_G], lf[MAX_G], in[MAX_G];
#pragma unroll
  for (int s = 0; s < MAX_G; ++s) {
    if (s < g) {
      const Interp t = interp(start, bin, dim, i, s, g);
      lo[s] = fminf(fmaxf(t.low - origin, 0.f), last);
      hi[s] = fminf(fmaxf(t.high - origin, 0.f), last);
      lf[s] = t.lfrac;
      in[s] = t.in;
    }
  }
  int n = 0;
  float prev = -1.f;
  for (int it = 0; it < 2 * g; ++it) {
    float at = INFINITY;  // the smallest corner cell above prev
#pragma unroll
    for (int s = 0; s < MAX_G; ++s) {
      if (s < g) {
        if (lo[s] > prev) at = fminf(at, lo[s]);
        if (hi[s] > prev) at = fminf(at, hi[s]);
      }
    }
    if (at == INFINITY) break;
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_G; ++s) {
      if (s < g) {
        const float m = (at == lo[s] ? 1.f - lf[s] : 0.f) + (at == hi[s] ? lf[s] : 0.f);
        total = total + m * in[s];
      }
    }
    const float wv = total * inv_g;
    const int c = (int)origin + (int)at;
    if (wv != 0.f && c < limit) {
      cell[n] = c;
      w[n++] = wv;
    }
    prev = at;
  }
  return n;
}

// grid (num_blocks,), block 32 * min(BODY_WARPS, t * segments) threads;
// registers cut for 4 resident blocks per SM (at most 64): the faster on the
// H100 of 1, 3 and 4 in both dtypes (tools/ablate_v4.py --variants)
template <typename T, int N>
__global__ void __launch_bounds__(BODY_WARPS * 32, 4)
    roi_align_v4_kernel(const BodyArgs a) {
  using V = Vec<T, N>;
  __shared__ Taps s_taps[BODY_WARPS];
  const int group = a.block_group[blockIdx.x];
  const int n_levels = a.pyr.num_levels;
  if (group > a.batch * n_levels) return;  // unused block
  const bool dead = group == a.batch * n_levels;  // slots that are not live: zeros
  const int b = dead ? 0 : group / n_levels;
  const int lvl = dead ? 0 : group % n_levels;
  const int C = a.channels, ph = a.pooled_h, pw = a.pooled_w;
  const int height = a.pyr.height[lvl];
  const int width = a.pyr.width[lvl];
  const T* base = static_cast<const T*>(a.pyr.data[lvl]) + (int64_t)b * height * width * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int segs = (C + 32 * N - 1) / (32 * N);
  Taps& tp = s_taps[warp];

  for (int u = warp; u < a.t * segs; u += blockDim.x / 32) {
    const int r = a.slot_roi[(int64_t)blockIdx.x * a.t + u / segs];
    if (r < 0) continue;  // padding slot
    const int c = (u % segs) * 32 * N + lane * N;
    const bool active = c < C;
    T* out_roi = static_cast<T*>(a.out) + (int64_t)r * ph * pw * C + c;
    if (dead) {
      if (active) store_zeros<T, N>(out_roi, ph * pw, C);
      continue;
    }
    const RoiBox box = roi_box(a, r, lvl);
    const float x0 = window_origin(box.start_w, (float)a.window_width[lvl]);
    if (lane < pw)
      tp.nx[lane] = window_taps(box.start_w, box.bin_w, (float)width, x0, (float)(WIN - 1),
                                width, lane, a.g, tp.xc[lane], tp.xw[lane]);

    for (int p0 = 0; p0 < ph; p0 += ROW_CHUNK) {
      const int rows = min(ROW_CHUNK, ph - p0);
      const int yl = lane - 16;
      if (yl >= 0 && yl < rows)
        tp.ny[yl] = window_taps(box.start_h, box.bin_h, (float)height, 0.f,
                                (float)(a.slab_h - 1), height, p0 + yl, a.g, tp.yc[yl],
                                tp.yw[yl]);
      __syncwarp();
      for (int pp = 0; pp < rows; ++pp) {
        // along the output row, so that neighbouring bins that share a
        // window column reuse its stage-A value
        Recent<N, 1> recent;
        for (int q = 0; q < pw; ++q) {
          const int nx = tp.nx[q];
          float acc[N];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] = 0.f;
          for (int i = 0; i < nx; ++i) {
            const int x = tp.xc[q][i];
            float sa[N];  // stage A: the window column's value on this output row
            if (!recent.get(x, sa)) {
              contract<T, N>(base + (int64_t)x * C + c, tp.yc[pp], tp.yw[pp], tp.ny[pp],
                             (int64_t)width * C, active, sa);
              recent.put(x, sa);
            }
            // stage B: weighed into the bin
            const float wq = tp.xw[q][i];
#pragma unroll
            for (int e = 0; e < N; ++e) acc[e] = acc[e] + wq * sa[e];
          }
          if (active) V::store(out_roi + ((int64_t)(p0 + pp) * pw + q) * C, V::narrow(acc));
        }
      }
      __syncwarp();  // the chunk's row taps are no longer read
    }
  }
}

extern "C" {

// window_widths: each level's w_l_of (int[num_levels]); slab_h: the tallest
// level's height. dtype: 0 = float32, 1 = bfloat16; vec: channels per lane
// (bf16 8, 4, 2; f32 4, 2). Returns cudaGetLastError() after launch.
int oneshot_roi_align_v4_forward(const void* pyramid, const void* window_widths, int slab_h,
                                 int batch, int channels, int dtype, const void* rois,
                                 long long rs0, long long rs1, const void* block_group,
                                 const void* slot_roi, int num_blocks, int rois_per_block,
                                 int pooled_h, int pooled_w, int sampling_ratio, int vec,
                                 void* out, void* stream) {
  if (pooled_w > MAX_POOLED_W || sampling_ratio < 1 || sampling_ratio > MAX_G ||
      rois_per_block < 1)
    return (int)cudaErrorInvalidValue;
  BodyArgs a = body_args(pyramid, batch, channels, rois, rs0, rs1, block_group, slot_roi,
                         rois_per_block, pooled_h, pooled_w, sampling_ratio, out);
  for (int l = 0; l < a.pyr.num_levels; ++l)
    a.window_width[l] = static_cast<const int*>(window_widths)[l];
  a.slab_h = slab_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch_body<float, 4>(roi_align_v4_kernel<float, 4>, a, num_blocks, s);
  if (dtype == 0 && vec == 2)
    return launch_body<float, 2>(roi_align_v4_kernel<float, 2>, a, num_blocks, s);
  if (dtype == 1 && vec == 8)
    return launch_body<__nv_bfloat16, 8>(roi_align_v4_kernel<__nv_bfloat16, 8>, a, num_blocks, s);
  if (dtype == 1 && vec == 4)
    return launch_body<__nv_bfloat16, 4>(roi_align_v4_kernel<__nv_bfloat16, 4>, a, num_blocks, s);
  if (dtype == 1 && vec == 2)
    return launch_body<__nv_bfloat16, 2>(roi_align_v4_kernel<__nv_bfloat16, 2>, a, num_blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* oneshot_roi_align_v4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
