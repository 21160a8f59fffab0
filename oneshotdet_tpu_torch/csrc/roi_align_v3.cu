// Cross-ROI separable multi-level ROIAlign (v3) for Hopper (sm_90a), NHWC,
// fp32 or bf16 in and out, float32 accumulation; and the block sort that the
// v3 and v4 kernels share.
//
// Replaces oneshotdet_tpu/ops/pallas_roi_align_v3.py::
// pallas_multilevel_roi_align_v3 (the Pallas TPU kernel). Same function as
// roi_align.cu, exact for every aspect ratio, in the separable form the TPU
// kernel uses: each output row p and column q of a ROI has 2g cell indices
// and weights (oneshotdet_tpu_torch/ops/roi_align_v3.py::interp_params: the
// bilinear corners of each sample, in-range mask, border clamp and the 1/g
// bin mean folded in), and
//   out[r, p, q, c] = sum_j yw[r,p,j] * sum_k xw[r,q,k] * F[b, yi[r,p,j], xi[r,q,k], c],
// zeros for slots that are not live (valid = False, bad image or level).
//
// Bound. A few flops per byte, bound by memory traffic: at least one read of
// the pyramid and one write of the output (~146 us at R = 16 000 on the main
// path's bf16 shapes at 3.35 TB/s). The multiplies and adds (K4: 2 x 20 per
// output value, ~8 GFLOP at R = 16 000, C = 256) are far below the FMA rate.
//
// Design. Two launches per call, nothing else on the card but the outputs'
// allocation:
//   1. roi_slab_sort_kernel, one block: the slab_blocks sort of the wrapper's
//      spec (ops/roi_align_v3.py::slab_blocks), equal to it: the slots of
//      each (image, level) group in a stable order, in blocks of t, group
//      B*L for the slots that are not live, B*L + 1 for unused blocks, nb =
//      ceil(R/t) + B*L + 1 blocks. Warp w takes the w-th contiguous run of
//      slots and counts its keys (__match_any_sync, a leader per key);
//      scans over the warps and over the groups give each warp's first rank
//      in each group and each group's first block; each warp walks its run
//      again and scatters its slots. No host sync.
//   2. roi_align_v3_kernel: a block takes one slab block (t ROIs of one
//      map); a warp takes one ROI, or one 32-lane channel segment of it
//      (f32 at C = 256 takes two). The warp builds the ROI's taps itself,
//      once per ROI, from its box, its level's scale and size: lane q lists
//      output column q's taps, lanes 16.. output rows' (ROW_CHUNK at a
//      time), in the spec's float32 operations and order (-fmad=false,
//      true divisions), leaving out zero weights. Each lane owns one vector
//      of N channels (16 bytes where C and the levels' addresses allow it:
//      8 bf16 or 4 fp32; else 8 or 4 bytes), so a warp reads and writes
//      whole 512-byte channel rows. Per bin it contracts the x taps of
//      each y tap (LOADS loads in flight), then weighs the sum by the y tap:
//      x taps, then y taps, in float32 registers, the plain version's
//      order. It sweeps each output column down the rows and keeps the last
//      two x contractions: a y tap on a row just contracted (the same row
//      twice in one bin, or shared by neighbouring output rows) reuses the
//      value. The taps' pixels are read through L1: neighbouring bins and
//      the block's ROIs share them.
// No tensor cores: each product has only 2g terms.

#include "roi_align_taps.cuh"

#define SORT_WARPS 32        // warps of the block sort, at most

// The taps of output index i: low and high corner of each sample in order,
// weights ((1 - lfrac) * in) / g and (lfrac * in) / g, those of zero weight
// left out. Returns their count.
__device__ __forceinline__ int axis_taps(float start, float bin, float dim, int i, int g,
                                         int* cell, float* w) {
  const float gf = (float)g;
  const int last = (int)dim - 1;
  int n = 0;
  for (int s = 0; s < g; ++s) {
    const Interp t = interp(start, bin, dim, i, s, g);
    const float wl = ((1.f - t.lfrac) * t.in) / gf;
    const float wh = (t.lfrac * t.in) / gf;
    if (wl != 0.f) {
      cell[n] = min(max((int)t.low, 0), last);
      w[n++] = wl;
    }
    if (wh != 0.f) {
      cell[n] = min(max((int)t.high, 0), last);
      w[n++] = wh;
    }
  }
  return n;
}

// grid (num_blocks,), block 32 * min(BODY_WARPS, t * segments) threads;
// registers cut for 3 resident blocks per SM (at most 80) in bf16, 4 (64) in
// f32: the faster on the H100 of 1, 3 and 4 (tools/ablate_v4.py --variants)
template <typename T, int N>
__global__ void __launch_bounds__(BODY_WARPS * 32, sizeof(T) == 4 ? 4 : 3)
    roi_align_v3_kernel(const BodyArgs a) {
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
    if (lane < pw)
      tp.nx[lane] = axis_taps(box.start_w, box.bin_w, (float)width, lane, a.g, tp.xc[lane],
                              tp.xw[lane]);

    for (int p0 = 0; p0 < ph; p0 += ROW_CHUNK) {
      const int rows = min(ROW_CHUNK, ph - p0);
      const int yl = lane - 16;
      if (yl >= 0 && yl < rows)
        tp.ny[yl] = axis_taps(box.start_h, box.bin_h, (float)height, p0 + yl, a.g, tp.yc[yl],
                              tp.yw[yl]);
      __syncwarp();
      // column by column, so that output rows that share a tap row reuse its
      // x contraction
      for (int q = 0; q < pw; ++q) {
        Recent<N, 2> recent;
        for (int pp = 0; pp < rows; ++pp) {
          const int ny = tp.ny[pp];
          float acc[N];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] = 0.f;
          for (int j = 0; j < ny; ++j) {
            const int y = tp.yc[pp][j];
            float sx[N];
            if (!recent.get(y, sx)) {
              contract<T, N>(base + (int64_t)y * width * C + c, tp.xc[q], tp.xw[q], tp.nx[q],
                             C, active, sx);
              recent.put(y, sx);
            }
            const float wy = tp.yw[pp][j];
#pragma unroll
            for (int e = 0; e < N; ++e) acc[e] = acc[e] + wy * sx[e];
          }
          if (active) V::store(out_roi + ((int64_t)(p0 + pp) * pw + q) * C, V::narrow(acc));
        }
      }
      __syncwarp();  // the chunk's row taps are no longer read
    }
  }
}

// ---- the block sort ------------------------------------------------------------

struct SortArgs {
  const float* rois;
  long long rs0, rs1;
  const void* levels;
  int level_code;  // 0 int32, 1 int64, 2 int16, 3 int8, 4 uint8, 5 float32
  long long ls;
  const unsigned char* valid;  // bool, or null
  long long vs;
  int n, batch, n_levels, t, num_blocks;
  int* block_group;
  int* slot_roi;
};

__device__ __forceinline__ long long level_at(const SortArgs& a, int i) {
  const long long o = (long long)i * a.ls;
  switch (a.level_code) {
    case 0: return static_cast<const int*>(a.levels)[o];
    case 1: return static_cast<const long long*>(a.levels)[o];
    case 2: return static_cast<const short*>(a.levels)[o];
    case 3: return static_cast<const signed char*>(a.levels)[o];
    case 4: return static_cast<const unsigned char*>(a.levels)[o];
    default: return (long long)static_cast<const float*>(a.levels)[o];
  }
}

// slab_blocks' key: b * L + l for a live slot, B * L otherwise
__device__ __forceinline__ int slab_key(const SortArgs& a, int i) {
  const long long b = (long long)a.rois[(long long)i * a.rs0];
  const long long lv = level_at(a, i);
  bool ok = b >= 0 && b < a.batch && lv >= 0 && lv < a.n_levels;
  if (a.valid != nullptr) ok = ok && a.valid[(long long)i * a.vs] != 0;
  return ok ? (int)(b * a.n_levels + lv) : a.batch * a.n_levels;
}

// one block of 32 * warps threads; dynamic shared memory
// (warps * (G + 1) + G + 2) ints, G = B * L
__global__ void roi_slab_sort_kernel(const SortArgs a) {
  extern __shared__ int s_sort[];
  const int warps = blockDim.x / 32, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ng1 = a.batch * a.n_levels + 1;
  int* cnt = s_sort;               // [warps][ng1]: counts, then first ranks
  int* first = s_sort + warps * ng1;  // [ng1 + 1]: totals, then first blocks
  for (int i = threadIdx.x; i < warps * ng1; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int per = (a.n + warps - 1) / warps;
  const int lo = min(w * per, a.n), hi = min(lo + per, a.n);
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int key = i0 + lane < hi ? slab_key(a, i0 + lane) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (peers & below) == 0) cnt[w * ng1 + key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int g = threadIdx.x; g < ng1; g += blockDim.x) {
    int run = 0;
    for (int v = 0; v < warps; ++v) {
      const int c = cnt[v * ng1 + g];
      cnt[v * ng1 + g] = run;
      run += c;
    }
    first[g] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int g = 0; g < ng1; ++g) {
      const int blocks = (first[g] + a.t - 1) / a.t;
      first[g] = acc;
      acc += blocks;
    }
    first[ng1] = acc;
  }
  __syncthreads();
  // block k's group: the number of groups whose blocks end at or before k
  for (int k = threadIdx.x; k < a.num_blocks; k += blockDim.x) {
    int l = 0, h = ng1;
    while (l < h) {
      const int m = (l + h) / 2;
      if (first[m + 1] <= k) l = m + 1;
      else h = m;
    }
    a.block_group[k] = l;
  }
  for (long long s = threadIdx.x; s < (long long)a.num_blocks * a.t; s += blockDim.x)
    a.slot_roi[s] = -1;
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int key = i0 + lane < hi ? slab_key(a, i0 + lane) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0)
      a.slot_roi[(long long)first[key] * a.t + cnt[w * ng1 + key] + __popc(peers & below)] =
          i0 + lane;
    __syncwarp();
    if (key >= 0 && (peers & below) == 0) cnt[w * ng1 + key] += __popc(peers);
    __syncwarp();
  }
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; vec: channels per lane (bf16 8, 4, 2;
// f32 4, 2). Returns cudaGetLastError() after launch.
int oneshot_roi_align_v3_forward(const void* pyramid, int batch, int channels, int dtype,
                                 const void* rois, long long rs0, long long rs1,
                                 const void* block_group, const void* slot_roi,
                                 int num_blocks, int rois_per_block, int pooled_h,
                                 int pooled_w, int sampling_ratio, int vec, void* out,
                                 void* stream) {
  if (pooled_w > MAX_POOLED_W || sampling_ratio < 1 || sampling_ratio > MAX_G ||
      rois_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const BodyArgs a = body_args(pyramid, batch, channels, rois, rs0, rs1, block_group, slot_roi,
                               rois_per_block, pooled_h, pooled_w, sampling_ratio, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch_body<float, 4>(roi_align_v3_kernel<float, 4>, a, num_blocks, s);
  if (dtype == 0 && vec == 2)
    return launch_body<float, 2>(roi_align_v3_kernel<float, 2>, a, num_blocks, s);
  if (dtype == 1 && vec == 8)
    return launch_body<__nv_bfloat16, 8>(roi_align_v3_kernel<__nv_bfloat16, 8>, a, num_blocks, s);
  if (dtype == 1 && vec == 4)
    return launch_body<__nv_bfloat16, 4>(roi_align_v3_kernel<__nv_bfloat16, 4>, a, num_blocks, s);
  if (dtype == 1 && vec == 2)
    return launch_body<__nv_bfloat16, 2>(roi_align_v3_kernel<__nv_bfloat16, 2>, a, num_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// The block sort (see roi_slab_sort_kernel). valid may be null. Returns
// cudaGetLastError() after launch, or cudaErrorInvalidValue when B * L is too
// large for the block's shared memory.
int oneshot_roi_slab_sort(const void* rois, long long rs0, long long rs1, const void* levels,
                          int level_code, long long ls, const void* valid, long long vs, int n,
                          int batch, int n_levels, int rois_per_block, int num_blocks,
                          void* block_group, void* slot_roi, void* stream) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long ng1 = (long long)batch * n_levels + 1;
  const long long fit = ((long long)optin / 4 - ng1 - 1) / ng1;
  const int warps = (int)(fit < SORT_WARPS ? fit : SORT_WARPS);
  if (warps < 1 || rois_per_block < 1 || level_code < 0 || level_code > 5)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(warps * ng1 + ng1 + 1) * sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(roi_slab_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  SortArgs a;
  a.rois = static_cast<const float*>(rois);
  a.rs0 = rs0;
  a.rs1 = rs1;
  a.levels = levels;
  a.level_code = level_code;
  a.ls = ls;
  a.valid = static_cast<const unsigned char*>(valid);
  a.vs = vs;
  a.n = n;
  a.batch = batch;
  a.n_levels = n_levels;
  a.t = rois_per_block;
  a.num_blocks = num_blocks;
  a.block_group = static_cast<int*>(block_group);
  a.slot_roi = static_cast<int*>(slot_roi);
  roi_slab_sort_kernel<<<1, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* oneshot_roi_align_v3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
