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
// to its four bilinear corners with the weights of the forward
// (roi_align_common.cuh, shared with K1); clamped corners (low == high) land
// twice on one pixel; out-of-range samples and dead ROIs (valid = False, a
// level or batch index out of range) carry nothing. Its plain version is
// oneshotdet_tpu_torch/ops/roi_align.py::multilevel_roi_align_backward_plain.
//
// Design: the owner computes. Every level's (image, map) is cut into
// TILE x TILE pixel tiles, and each pixel's gradient is written once, by the
// block that owns its tile, as a sum over the ROIs that touch the tile in
// ascending ROI order: no atomic adds, no float32 workspace, no zeroing or
// cast pass, and the same bits on every run. Two launches:
//   1. roi_align_bwd_tiles_kernel, a block (32 warps) per 32 ROIs. Warp i
//      takes ROI 32 * block + i: lane s computes its y sample s and its x
//      sample s with K1's code, stores them for the body, and the warp ORs
//      the tiles of the in-range samples' corners of non-zero weight into
//      one 64-bit mask per axis. The weights are separable, so a live ROI
//      touches exactly the tiles (y mask) x (x mask) of its (image, level)
//      map. Then each thread takes tiles and writes one 32-bit word per
//      tile: bit i is set when ROI 32 * block + i touches it. Every word of
//      bits[ROI / 32][tile] is written, so nothing needs zeroing; a tile's set
//      bits in word order are its ROIs in ascending order
//      (ops/roi_align.py::roi_align_bwd_plan mirrors the lists).
//   2. roi_align_bwd_body_kernel, a block per (tile, slice of 64 channels);
//      a tile's slices are neighbouring blocks. A thread owns one column of
//      the tile, TR of its rows and one 16-byte vector (8 bf16 channels over
//      8 rows, or 4 fp32 channels over all 16), as 64 float32 registers.
//      Warp 0 lists the tile's ROIs (up to LIST_MAX at a time) in shared
//      memory. Per ROI, cp.async brings its grad_out slice (bins x SV
//      vectors) PF ROIs ahead into a ring of PF + 2 buffers, and its samples
//      one ROI further ahead. PF is PREFETCH where BODY_MIN_BLOCKS blocks
//      with that ring fit an SM's shared memory, else 1 where they fit with
//      that, else at one block an SM (`prefetch_depth`): a slice is
//      bins x 128 B in bf16 and bins x 256 B in fp32, so the 14 x 14 pools
//      of the mask and keypoint heads (196 bins, 25 KB a bf16 slice) run at
//      PF 1 in bf16 and at one block an SM in fp32. PF changes when the
//      copies land, never what is summed or in which order. From the
//      samples the block builds the tile's separable weights, yw[ph][row] = the summed weights of the
//      corners that bin row ph's in-range samples put on that row, xw[pw][col]
//      likewise, with ballots for the rows (columns) each ph (pw) reaches.
//      One barrier per ROI. A thread then takes each ph that reaches its
//      rows:
//        t = sum_pw xw[pw][col] * G[ph][pw],  acc[row] += yw[ph][row] * t
//      over the pw that reach its column and the rows that ph reaches. At the
//      end it divides by g^2, rounds once to the output dtype and stores 16
//      bytes per row; a tile no ROI touches writes zeros.
//
// Bound. The inputs read once (grad_out, the ROIs) and the gradient written
// once in the features' dtype; on the train path (batch 8, 832x1216 query,
// C = 256, R = 1024 proposals, bf16) that is 25.7 MB + 86.3 MB. What it
// moves: the gradient written once, and each ROI's grad_out slice read from
// L2 once per tile and slice it touches. What holds it back (H100,
// oneshotdet_tpu_torch/tools/ablate_roi_align_bwd.py --timeline): a block
// spends ~2-2.6 us per ROI on its list, half of it in the per-ROI copies,
// weights and barrier, half in the sums, at 2 resident blocks per SM (128
// registers a thread); a tile that 64 crowded ROIs share is one such chain.

#include <stdint.h>

#include "roi_align_common.cuh"

#define MAX_AXIS 32        // pooled * sampling_ratio on one axis, as roi_align.cu
#define MAX_BINS 256       // pooled_h * pooled_w (the 14x14 mask/keypoint pools: 196)
#define TILE 16            // pixels on a side of a tile
#define MAX_TILES 64       // tiles on one axis of a map (one 64-bit mask)
#define SV_BF16 8          // 16-byte channel vectors of a bf16 body block (64 channels)
#define TR_BF16 8          // tile rows of a bf16 body thread
#define SV_F32 16          // the same in fp32 (64 channels)
#define TR_F32 16
#define BODY_THREADS 256   // SV * TILE * (TILE / TR) in both
#define BODY_MIN_BLOCKS 2  // resident body blocks per SM the registers allow
#define PREFETCH 2         // grad_out slices in flight ahead of the ROI summed, at most
#define TILES_THREADS 1024
#define LIST_MAX 1024      // ROIs listed at a time: one warp's 32 words

// A body block's channel vectors (SV) and a thread's rows (TR): 64
// accumulators a thread and 64 channels a block in both dtypes.
template <typename T>
struct Body;
template <>
struct Body<__nv_bfloat16> {
  static constexpr int SV = SV_BF16, TR = TR_BF16;
};
template <>
struct Body<float> {
  static constexpr int SV = SV_F32, TR = TR_F32;
};

// Tile t of the maps, in the order level, image, tile row, tile column.
struct Tile {
  int level, image, ty, tx;
};

__device__ __forceinline__ Tile tile_of(const Pyramid& p, int batch, int t) {
  Tile o = {-1, 0, 0, 0};
  for (int l = 0; l < p.num_levels; ++l) {
    const int ty = (p.height[l] + TILE - 1) / TILE;
    const int tx = (p.width[l] + TILE - 1) / TILE;
    if (t < batch * ty * tx) {
      o.level = l;
      o.image = t / (ty * tx);
      t -= o.image * ty * tx;
      o.ty = t / tx;
      o.tx = t - o.ty * tx;
      return o;
    }
    t -= batch * ty * tx;
  }
  return o;
}

// Sample `lane` of one axis of a live ROI, stored for the body, and the
// tiles of that axis that the ROI's in-range samples put a corner of
// non-zero weight on, by the whole warp: the low cell always (its weight
// h = 1 - l > 0), the high cell when l != 0.
__device__ __forceinline__ unsigned long long axis_tiles(const float* roi, float scale, bool y,
                                                         int lane, int pooled, int grid,
                                                         int size, AxisSample* out) {
  unsigned long long m = 0;
  if (lane < pooled * grid) {
    const AxisSample a = roi_axis_sample(roi, scale, y, lane, pooled, grid, size);
    out[lane] = a;
    if (a.lo >= 0) {
      m |= 1ull << (a.lo / TILE);
      if (a.l != 0.f) m |= 1ull << (a.hi / TILE);
    }
  }
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
  return ((unsigned long long)hi << 32) | lo;
}

// samples: (R, 2, MAX_AXIS), each live ROI's y samples then its x samples.
__global__ void __launch_bounds__(TILES_THREADS)
    roi_align_bwd_tiles_kernel(Pyramid p, int batch, const float* __restrict__ rois,
                               const int* __restrict__ levels,
                               const unsigned char* __restrict__ valid, int num_rois,
                               int pooled_h, int pooled_w, int grid, int num_tiles,
                               AxisSample* __restrict__ samples, unsigned* __restrict__ bits) {
  __shared__ int s_key[32];
  __shared__ unsigned long long s_ym[32], s_xm[32];
  const int lane = threadIdx.x % 32;
  const int i = threadIdx.x / 32;
  const int r = blockIdx.x * 32 + i;
  int key = -1;
  unsigned long long ym = 0, xm = 0;
  if (r < num_rois) {
    const float* roi = rois + 5 * (int64_t)r;
    const int lvl = levels[r];
    const int b = (int)roi[0];
    if ((valid == nullptr || valid[r] != 0) && lvl >= 0 && lvl < p.num_levels && b >= 0 &&
        b < batch) {
      AxisSample* smp = samples + (int64_t)r * 2 * MAX_AXIS;
      ym = axis_tiles(roi, p.scale[lvl], true, lane, pooled_h, grid, p.height[lvl], smp);
      xm = axis_tiles(roi, p.scale[lvl], false, lane, pooled_w, grid, p.width[lvl],
                      smp + MAX_AXIS);
      if (ym != 0 && xm != 0) key = b * p.num_levels + lvl;
    }
  }
  if (lane == 0) {
    s_key[i] = key;
    s_ym[i] = ym;
    s_xm[i] = xm;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += TILES_THREADS) {
    const Tile o = tile_of(p, batch, t);
    const int k = o.image * p.num_levels + o.level;
    unsigned word = 0;
    for (int j = 0; j < 32; ++j)
      if (s_key[j] == k && ((s_ym[j] >> o.ty) & 1) && ((s_xm[j] >> o.tx) & 1)) word |= 1u << j;
    bits[(int64_t)blockIdx.x * num_tiles + t] = word;
  }
}

template <typename T, int PF>
__global__ void __launch_bounds__(BODY_THREADS, BODY_MIN_BLOCKS)
    roi_align_bwd_body_kernel(Pyramid out, int batch, int channels, int pooled_h, int pooled_w,
                              int grid, const T* __restrict__ grad_out,
                              const AxisSample* __restrict__ samples, int words, int num_tiles,
                              const unsigned* __restrict__ bits) {
  constexpr int N = Vec<T>::N;
  constexpr int SV = Body<T>::SV, TR = Body<T>::TR;
  static_assert(SV * TILE * (TILE / TR) == BODY_THREADS, "a thread per (column, rows, vector)");
  constexpr int NG = PF + 2;  // G buffers: ROI i + PF's lands in ROI i - 2's
  constexpr int NS = PF + 2;  // sample slots: ROI i + PF + 1's in ROI i - 1's
  extern __shared__ __align__(16) uint4 s_g[];  // NG x bins x SV
  __shared__ __align__(16) AxisSample s_smp[NS][2 * MAX_AXIS];
  __shared__ __align__(16) float s_yw[2][MAX_AXIS][TILE];
  __shared__ __align__(16) float s_xw[2][MAX_AXIS][TILE];
  __shared__ __align__(16) unsigned s_rows[2][MAX_AXIS + 4], s_cols[2][MAX_AXIS + 4];
  __shared__ int s_list[LIST_MAX];
  __shared__ int s_count;

  // a tile's channel slices are neighbouring blocks, so that they start
  // together
  const int vpp = channels / N;  // 16-byte vectors per pixel
  const int slices = (vpp + SV - 1) / SV;
  const int slice = blockIdx.x % slices;
  const int tile = blockIdx.x / slices;
  const Tile o = tile_of(out, batch, tile);
  const int height = out.height[o.level];
  const int width = out.width[o.level];
  const int y0 = o.ty * TILE, x0 = o.tx * TILE;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int v = tid % SV;
  const int col = (tid / SV) % TILE;
  const int row0 = (tid / (SV * TILE)) * TR;
  const int cv = slice * SV + v;
  const int bins = pooled_h * pooled_w;
  const int ny = TILE * pooled_h;
  const int kx0 = (ny + 31) / 32 * 32;  // the x entries start on a warp
  const int entries = kx0 + TILE * pooled_w;

  // ROI r's grad_out slice into G buffer `gb` (cp.async)
  auto stage_g = [&](int r, int gb) {
    for (int k = tid; k < bins * SV; k += BODY_THREADS) {
      const int c = slice * SV + k % SV;
      if (c < vpp)
        cp_async16(&s_g[gb * bins * SV + k],
                   grad_out + ((int64_t)r * bins + k / SV) * channels + c * N);
    }
  };
  // ROI r's samples into slot `sb` (cp.async)
  auto stage_samples = [&](int r, int sb) {
    if (tid < 2 * MAX_AXIS && tid % MAX_AXIS < (tid < MAX_AXIS ? pooled_h : pooled_w) * grid)
      cp_async16(&s_smp[sb][tid], samples + (int64_t)r * 2 * MAX_AXIS + tid);
  };
  // the tile's weights from the samples in slot `sb` into weight buffer `wb`,
  // and the rows (columns) each ph (pw) reaches
  auto weigh = [&](int sb, int wb) {
    for (int k0 = 0; k0 < entries; k0 += BODY_THREADS) {
      const int k = k0 + tid;
      const bool y = k < ny;
      float w = 0.f;
      if (y || (k >= kx0 && k < entries)) {
        const int kk = y ? k : k - kx0;
        const int p = kk / TILE;
        const int cell = (y ? y0 : x0) + kk % TILE;
        const AxisSample* a = &s_smp[sb][(y ? 0 : MAX_AXIS) + p * grid];
        for (int i = 0; i < grid; ++i) {
          if (a[i].lo >= 0) {
            if (a[i].lo == cell) w += a[i].h;
            if (a[i].hi == cell) w += a[i].l;
          }
        }
        (y ? s_yw : s_xw)[wb][p][kk % TILE] = w;
      }
      const unsigned m = __ballot_sync(0xffffffffu, w != 0.f);
      const int kw = k - lane;  // the warp's first entry, a multiple of 32
      if (lane == 0 && kw < entries) {
        unsigned* masks = kw < kx0 ? s_rows[wb] : s_cols[wb];
        const int p = (kw < kx0 ? kw : kw - kx0) / TILE;
        masks[p] = m & 0xffffu;
        masks[p + 1] = m >> 16;
      }
    }
  };

  float acc[TR][N];
#pragma unroll
  for (int yy = 0; yy < TR; ++yy)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[yy][j] = 0.f;

  for (int w0 = 0; w0 < words; w0 += 32) {
    if (tid < 32) {
      const unsigned word =
          w0 + tid < words ? bits[(int64_t)(w0 + tid) * num_tiles + tile] : 0u;
      const int n = __popc(word);
      int pos = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, pos, d);
        if (tid >= d) pos += u;
      }
      pos -= n;
      for (unsigned b = word; b != 0; b &= b - 1) s_list[pos++] = (w0 + tid) * 32 + __ffs(b) - 1;
      if (tid == 31) s_count = pos;
    }
    __syncthreads();
    const int n = s_count;
    if (n > 0) {
      // the samples first, then each G in a group of its own, so that the
      // first weights overlap the first copies of G
      for (int j = 0; j <= PF && j < n; ++j) stage_samples(s_list[j], j % NS);
      cp_async_commit();
      for (int j = 0; j < PF; ++j) {
        if (j < n) stage_g(s_list[j], j % NG);
        cp_async_commit();
      }
      cp_async_wait<PF>();
      __syncthreads();
      weigh(0, 0);
    }
    for (int i = 0; i < n; ++i) {
      // the buffers these copies land in were last read before the previous
      // barrier (G by ROI i - 2's sums, the samples by ROI i - 1's weights)
      if (i + PF < n) stage_g(s_list[i + PF], (i + PF) % NG);
      if (i + PF + 1 < n) stage_samples(s_list[i + PF + 1], (i + PF + 1) % NS);
      cp_async_commit();
      cp_async_wait<PF>();  // G of ROI i, the samples of ROI i + 1
      __syncthreads();            // ... and the weights of ROI i, for every thread
      const uint4* g_roi = s_g + (i % NG) * bins * SV;
      const int wb = i % 2;
      // the pw that reach this thread's column and the ph that reach its rows,
      // as bit masks, four masks a load
      unsigned pm = 0, phs = 0;
      for (int q = 0; q < pooled_w; q += 4) {
        const uint4 m = *reinterpret_cast<const uint4*>(&s_cols[wb][q]);
        const unsigned b = ((m.x >> col) & 1u) | ((m.y >> col) & 1u) << 1 |
                           ((m.z >> col) & 1u) << 2 | ((m.w >> col) & 1u) << 3;
        pm |= b << q;
      }
      for (int q = 0; q < pooled_h; q += 4) {
        const uint4 m = *reinterpret_cast<const uint4*>(&s_rows[wb][q]);
        const unsigned rows = (1u << TR) - 1;
        const unsigned b = (((m.x >> row0) & rows) != 0) | (((m.y >> row0) & rows) != 0) << 1 |
                           (((m.z >> row0) & rows) != 0) << 2 | (((m.w >> row0) & rows) != 0) << 3;
        phs |= b << q;
      }
      pm &= pooled_w == 32 ? ~0u : (1u << pooled_w) - 1;
      phs &= pooled_h == 32 ? ~0u : (1u << pooled_h) - 1;
      if (pm != 0 && cv < vpp) {
        const int pf = __ffs(pm) - 1, pl = 31 - __clz(pm);
        for (unsigned bits_ph = phs; bits_ph != 0; bits_ph &= bits_ph - 1) {
          const int ph = __ffs(bits_ph) - 1;
          const unsigned rm = (s_rows[wb][ph] >> row0) & ((1u << TR) - 1);
          float t[N];
#pragma unroll
          for (int j = 0; j < N; ++j) t[j] = 0.f;
          for (int pw = pf; pw <= pl; ++pw) {
            const float wx = s_xw[wb][pw][col];
            float g[N];
            Vec<T>::widen(g_roi[(ph * pooled_w + pw) * SV + v], g);
#pragma unroll
            for (int j = 0; j < N; ++j) t[j] = __fmaf_rn(wx, g[j], t[j]);
          }
#pragma unroll
          for (int q = 0; q < TR; q += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(&s_yw[wb][ph][row0 + q]);
            const float wy[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((rm >> (q + e)) & 1u)
#pragma unroll
                for (int j = 0; j < N; ++j)
                  acc[q + e][j] = __fmaf_rn(wy[e], t[j], acc[q + e][j]);
          }
        }
      }
      if (i + 1 < n) weigh((i + 1) % NS, (i + 1) % 2);
    }
    __syncthreads();  // every thread is done with the list and the buffers
  }

  const int x = x0 + col;
  if (cv >= vpp || x >= width) return;
  const float inv = 1.f / (float)(grid * grid);
  T* base = static_cast<T*>(const_cast<void*>(out.data[o.level])) +
            (int64_t)o.image * height * width * channels;
#pragma unroll
  for (int yy = 0; yy < TR; ++yy) {
    const int y = y0 + row0 + yy;
    if (y >= height) break;
    float f[N];
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = acc[yy][j] * inv;
    *reinterpret_cast<uint4*>(base + ((int64_t)y * width + x) * channels + cv * N) =
        Vec<T>::narrow(f);
  }
}

// The G ring's bytes at prefetch depth pf.
template <typename T>
size_t ring_bytes(int pf, int bins) {
  return (size_t)(pf + 2) * bins * Body<T>::SV * 16;
}

// The prefetch depth of a body block over `bins` bins on the current
// device: PREFETCH where BODY_MIN_BLOCKS blocks with its ring fit an SM's
// shared memory, else 1 where they fit with that; else the deepest that fits
// one block's limit (one block an SM), or -1 where none does.
template <typename T>
int prefetch_depth(int bins) {
  cudaFuncAttributes a;
  int dev = 0, per_sm = 0, per_block = 0, reserved = 0;
  if (cudaFuncGetAttributes(&a, roi_align_bwd_body_kernel<T, PREFETCH>) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
          cudaSuccess)
    return -1;
  for (int pf = PREFETCH; pf >= 1; --pf)
    if (BODY_MIN_BLOCKS * (a.sharedSizeBytes + reserved + ring_bytes<T>(pf, bins)) <=
        (size_t)per_sm)
      return pf;
  for (int pf = PREFETCH; pf >= 1; --pf)
    if (a.sharedSizeBytes + ring_bytes<T>(pf, bins) <= (size_t)per_block) return pf;
  return -1;
}

template <typename T, int PF>
cudaError_t launch_body_at(const Pyramid& p, int batch, int channels, int pooled_h, int pooled_w,
                           int g, const void* grad_out, const AxisSample* samples, int words,
                           int num_tiles, const unsigned* bits, cudaStream_t s) {
  constexpr int SV = Body<T>::SV;
  const size_t smem = ring_bytes<T>(PF, pooled_h * pooled_w);
  const cudaError_t e = cudaFuncSetAttribute(
      roi_align_bwd_body_kernel<T, PF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = num_tiles * ((channels / Vec<T>::N + SV - 1) / SV);
  roi_align_bwd_body_kernel<T, PF><<<blocks, BODY_THREADS, smem, s>>>(
      p, batch, channels, pooled_h, pooled_w, g, static_cast<const T*>(grad_out), samples, words,
      num_tiles, bits);
  return cudaSuccess;
}

// The body's launch: a block per (tile, channel slice), its G ring as
// dynamic shared memory, at the prefetch depth of the bin count.
template <typename T>
cudaError_t launch_body(const Pyramid& p, int batch, int channels, int pooled_h, int pooled_w,
                        int g, const void* grad_out, const AxisSample* samples, int words,
                        int num_tiles, const unsigned* bits, cudaStream_t s) {
  const int pf = prefetch_depth<T>(pooled_h * pooled_w);
  if (pf < 0) return cudaErrorInvalidValue;
  if (pf == 1)
    return launch_body_at<T, 1>(p, batch, channels, pooled_h, pooled_w, g, grad_out, samples,
                                words, num_tiles, bits, s);
  return launch_body_at<T, PREFETCH>(p, batch, channels, pooled_h, pooled_w, g, grad_out,
                                     samples, words, num_tiles, bits, s);
}

extern "C" {

// The kernels' limits, for the wrapper and its plan:
// {TILE, MAX_TILES, MAX_AXIS, MAX_BINS}.
void oneshot_roi_align_bwd_limits(int* out) {
  out[0] = TILE;
  out[1] = MAX_TILES;
  out[2] = MAX_AXIS;
  out[3] = MAX_BINS;
}

// `maps` is a Pyramid whose data pointers are the levels' gradients, each a
// contiguous (B, H, W, C) map in the dtype of grad_out (0 = float32, 1 =
// bfloat16). `scratch` holds R x 2 x MAX_AXIS samples (16 bytes each), then
// the tile bits: ceil(R / 32) x (the maps' tiles) uint32 words. Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// shapes beyond the limits.
int oneshot_roi_align_backward(const void* maps, int batch, int channels, int dtype,
                               const void* rois, const void* levels, const void* valid,
                               int num_rois, int pooled_h, int pooled_w, int sampling_ratio,
                               const void* grad_out, void* scratch, void* stream) {
  const Pyramid p = *static_cast<const Pyramid*>(maps);
  const int elt = dtype == 0 ? 4 : 2;
  const int g = sampling_ratio;
  if ((dtype != 0 && dtype != 1) || g <= 0 || pooled_h <= 0 || pooled_w <= 0 ||
      pooled_h * g > MAX_AXIS || pooled_w * g > MAX_AXIS || pooled_h * pooled_w > MAX_BINS ||
      channels <= 0 || (channels * elt) % 16 != 0 || batch <= 0 || num_rois < 0 ||
      p.num_levels < 1 || p.num_levels > ONESHOT_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  int num_tiles = 0;
  for (int l = 0; l < p.num_levels; ++l) {
    if (p.height[l] <= 0 || p.width[l] <= 0 || p.height[l] > TILE * MAX_TILES ||
        p.width[l] > TILE * MAX_TILES)
      return (int)cudaErrorInvalidValue;
    num_tiles += batch * ((p.height[l] + TILE - 1) / TILE) * ((p.width[l] + TILE - 1) / TILE);
  }
  const int words = (num_rois + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AxisSample* samples = static_cast<AxisSample*>(scratch);
  unsigned* bits = reinterpret_cast<unsigned*>(samples + (int64_t)num_rois * 2 * MAX_AXIS);
  if (words > 0)
    roi_align_bwd_tiles_kernel<<<words, TILES_THREADS, 0, s>>>(
        p, batch, static_cast<const float*>(rois), static_cast<const int*>(levels),
        static_cast<const unsigned char*>(valid), num_rois, pooled_h, pooled_w, g, num_tiles,
        samples, bits);
  const cudaError_t e =
      dtype == 0 ? launch_body<float>(p, batch, channels, pooled_h, pooled_w, g, grad_out,
                                      samples, words, num_tiles, bits, s)
                 : launch_body<__nv_bfloat16>(p, batch, channels, pooled_h, pooled_w, g, grad_out,
                                              samples, words, num_tiles, bits, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The body's prefetch depth for `bins` bins in dtype (0 = float32, 1 =
// bfloat16), or -1 on error.
int oneshot_roi_align_bwd_prefetch(int dtype, int bins) {
  return dtype == 0 ? prefetch_depth<float>(bins) : prefetch_depth<__nv_bfloat16>(bins);
}

const char* oneshot_roi_align_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
