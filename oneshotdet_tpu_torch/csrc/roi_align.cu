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
// have no counterpart here: a ROI of any width is exact.
//
// Bound. At least one read of the pyramid and one write of the output. On
// the main path (batch 8, 832x1216 query, C = 256, bf16, pyramid 86.3 MB)
// with the H100 SXM's 3.35 TB/s:
//   - R = 4096 ROIs (EVAL_ROI_TOPK = 512): 102.8 MB out + 86.3 MB in, ~56 us;
//   - R = 16000 ROIs (2000 per image):    401.4 MB out + 86.3 MB in, ~146 us.
// The arithmetic sets a higher floor. Each sample is w1*v1 + w2*v2 + w3*v3 +
// w4*v4 per channel, summed in (iy, ix) order, as in the plain version, and
// the file builds with -fmad=false so that the kernel equals the plain
// version bit for bit: 8 separate multiplies and adds per sample and
// channel, 6.4 G at R = 16 000, ~0.19 ms at the card's 33.5 T lane
// instructions/s, plus the bf16 widening and the shared-memory reads.
//
// Design. One thread block per ROI (a ROI is the unit of work).
//   1. The sample grid is separable: y depends only on (ph, iy), x only on
//      (pw, ix) (roi_align_common.cuh, shared with the backward kernel
//      roi_align_bwd.cu). Warp 0 computes the y samples' low/high rows,
//      weights and range test once per ROI, one lane per sample, and warp 1
//      the x samples', into shared memory (`AxisSample`). Every channel thread
//      forms w1..w4 from them with the same float operations as the plain
//      version.
//   2. The same warp lists the ROI's distinct rows (columns) that in-range
//      samples touch, ascending, and turns each sample's low/high cell into
//      an index (slot) in that list, by a ballot and a prefix sum: the
//      samples are monotone. An output row touches at most 2 * grid rows,
//      an output column at most 2 * grid columns, whatever the bin's size.
//   3. Thread 0 cuts the ROI into items: column chunks of whole output
//      columns, each cut into bands of whole output rows, so that an item's
//      rows x columns of pixels fit one staging buffer (STAGE_BYTES). An item
//      stages each pixel it needs once; a ROI of up to ~6 x 6 cells is one
//      item in bf16. Every item holds at least one whole bin, and one bin's
//      (2 grid)^2 pixels always fit, so a ROI has at most pooled_h x
//      pooled_w items: MAX_ITEMS takes the 14 x 14 pools of the mask and
//      keypoint heads (196 bins, 28 samples an axis), whose large ROIs cut
//      into many items of one bin each. The rule is mirrored in
//      oneshotdet_tpu_torch/ops/roi_align.py (`roi_align_plan`), which the
//      tests check on the CPU.
//   4. Each pixel (C contiguous channels) is copied from L2 into shared
//      memory by 16-byte cp.async, one warp per pixel; two buffers, so the
//      next item's copies overlap the current item's sums.
//   5. A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32) of
//      one output bin: it reads its four corners per sample as 16-byte
//      shared-memory loads (a warp reads 512 contiguous bytes), accumulates
//      in fp32 and stores the bin once with a 16-byte store. Warps split the
//      item's bins. Dead slots (valid = False, bad level or batch index)
//      only store zeros.
//   6. Channel slices. Where one bin's (2 grid)^2 pixels of all C channels
//      do not fit a staging buffer (C = 512 in fp32: 16 pixels of 2 KB), the
//      block cuts each pixel into the fewest equal channel slices that fit
//      (`channel_slices`) and plans the items for one slice's bytes; it then
//      stages and sums every item once per slice, slice-major, through the
//      same two buffers. A channel's sums do not depend on the other
//      channels, so a slice's output is the plain version's. With one slice
//      (C = 256 in both dtypes, C = 512 in bf16) the launch takes the
//      kernel's unsliced instance (SLICED = false), the code as it was
//      before slices: the slice loop's index arithmetic cost 2-3% at C = 256
//      (oneshotdet_tpu_torch/tools/ablate_roi_align.py --parent).
// Four blocks of 256 threads fit an SM (two 24 KB buffers each, at most 64
// registers). The five level base pointers and sizes are passed by value,
// so the pyramid is never concatenated. Tried and measured slower on the
// H100: persistent blocks that plan the next ROI while the current one's
// copies fly, with or without producer and consumer warps; reusing the
// corners that adjacent samples share; 512-thread blocks
// (oneshotdet_tpu_torch/tools/ablate_roi_align.py times the parts).
//
// The wrapper (oneshotdet_tpu_torch/ops/roi_align.py) checks shapes, dtypes,
// devices, 16-byte alignment, contiguity and the limits below, and
// allocates the output; this file launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_common.cuh"

#define STAGE_BYTES (24 * 1024)   // one staging buffer; a block has two
#define MAX_AXIS 32               // pooled * sampling_ratio on one axis: a warp
#define MAX_SLOTS (2 * MAX_AXIS)  // distinct rows (columns) of one ROI
#define MAX_ITEMS 256             // pooled_h * pooled_w: an item holds at least one
                                  // bin, so a ROI has at most one item per bin
#define THREADS 256

// Output rows [ph0, ph1) x columns [pw0, pw1), staged as row slots [r0, r1)
// x column slots [c0, c1).
struct Item {
  unsigned char ph0, ph1, pw0, pw1, r0, r1, c0, c1;
};

// Step 2 for one axis, by one warp (lane s = sample s, pooled * grid <= 32):
// the distinct cells of the in-range samples, ascending, into `list`; each
// sample's low/high cell becomes its slot in the list; per output index p,
// the slot range [first[p], end[p]) of its samples. The in-range samples
// are contiguous and their cells monotone, so a cell is new exactly when it
// exceeds every cell before it, and a cell that is not new is one of the
// last two listed before it. An output index without in-range samples gets
// the empty range at 0 (before them) or at the list's end (after them), so
// that first and end are monotone over all p.
__device__ __forceinline__ void axis_slots(AxisSample* s, int pooled, int grid, int* list,
                                           short* first, short* end) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int n = pooled * grid;
  AxisSample a = s[lane < n ? lane : 0];
  const bool ok = lane < n && a.lo >= 0;
  const unsigned ok_mask = __ballot_sync(full, ok);
  int prev_hi = __shfl_up_sync(full, a.hi, 1);
  if (lane == 0 || !(ok_mask >> (lane - 1) & 1u)) prev_hi = -1;
  const int new_lo = ok && a.lo > prev_hi;
  const int new_hi = ok && a.hi > max(a.lo, prev_hi);
  int incl = new_lo + new_hi;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(full, incl, 31);
  const int base = incl - new_lo - new_hi;
  if (new_lo) list[base] = a.lo;
  if (new_hi) list[base + new_lo] = a.hi;
  __syncwarp();
  if (ok) {
    int k = incl - 1;  // the last cell listed up to this sample
    while (list[k] != a.hi) --k;
    s[lane].hi = k;
    while (list[k] != a.lo) --k;
    s[lane].lo = k;
  }
  __syncwarp();
  if (lane < pooled) {
    int f = -1, e = -1;
    for (int i = 0; i < grid; ++i) {
      const AxisSample b = s[lane * grid + i];
      if (b.lo < 0) continue;
      if (f < 0) f = b.lo;
      e = b.hi + 1;
    }
    if (f < 0) f = e = (ok_mask & ((1u << (lane * grid)) - 1u)) ? total : 0;
    first[lane] = (short)f;
    end[lane] = (short)e;
  }
}

// Step 3 (one thread): the items, column chunks major. A chunk takes output
// columns while its columns times the tallest output row's rows fit the
// budget; within it a band takes output rows while its rows times the
// chunk's columns fit. One output row (column) touches at most 2 * grid
// rows (columns), so one bin always fits (`channel_slices` makes 4 grid^2
// <= budget); a ROI whose pixels all fit is one item. Returns the number of
// items and the staged pixels in *px.
__device__ __forceinline__ int plan_items(const short* yf, const short* ye, const short* xf,
                                          const short* xe, int pooled_h, int pooled_w,
                                          int budget, Item* items, int* px) {
  int max_rows = 1;
  for (int p = 0; p < pooled_h; ++p) max_rows = max(max_rows, ye[p] - yf[p]);
  const int cols_limit = budget / max_rows;
  int n = 0, staged = 0;
  for (int pw0 = 0; pw0 < pooled_w;) {
    int pw1 = pw0 + 1;
    const int c0 = xf[pw0];
    while (pw1 < pooled_w && xe[pw1] - c0 <= cols_limit) ++pw1;
    const int c1 = xe[pw1 - 1];
    for (int ph0 = 0; ph0 < pooled_h;) {
      int ph1 = ph0 + 1;
      const int r0 = yf[ph0];
      while (ph1 < pooled_h && (ye[ph1] - r0) * (c1 - c0) <= budget) ++ph1;
      const int r1 = ye[ph1 - 1];
      Item it;
      it.ph0 = (unsigned char)ph0;
      it.ph1 = (unsigned char)ph1;
      it.pw0 = (unsigned char)pw0;
      it.pw1 = (unsigned char)pw1;
      it.r0 = (unsigned char)r0;
      it.r1 = (unsigned char)r1;
      it.c0 = (unsigned char)c0;
      it.c1 = (unsigned char)c1;
      items[n++] = it;
      staged += (r1 - r0) * (c1 - c0);
      ph0 = ph1;
    }
    pw0 = pw1;
  }
  *px = staged;
  return n;
}

// Step 4: one channel slice of the item's pixels into `buf`, pixel-major,
// one warp per pixel. `base` points at the slice's first channel of the
// image's map; a pixel is `pixel_bytes` in the map, `slice_bytes` in `buf`.
__device__ __forceinline__ void stage_item(const Item it, const int* rows, const int* cols,
                                           const char* base, int width, int pixel_bytes,
                                           int slice_bytes, char* buf) {
  const int nc = it.c1 - it.c0;
  const int npx = (it.r1 - it.r0) * nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < npx; p += THREADS / 32) {
    const int pr = p / nc;
    const int pc = p - pr * nc;
    const char* src =
        base + ((int64_t)rows[it.r0 + pr] * width + cols[it.c0 + pc]) * pixel_bytes;
    char* dst = buf + p * slice_bytes;
    for (int o = 16 * lane; o < slice_bytes; o += 16 * 32) cp_async16(dst + o, src + o);
  }
  cp_async_commit();
}

// Step 5: every (bin, channel vector) of the item's staged channel slice,
// `vpp` vectors a pixel in `buf`; bin b's vectors go to out_roi[b * out_vpp
// + v] (`out_roi` at the slice's first vector). A thread steps through
// its (bin, vector) pairs without dividing. The mean divides by count, or
// multiplies by its reciprocal when count is a power of two, which rounds
// the same (a full-precision division per channel was an eighth of the
// sums). Every product and sum is the plain version's.
template <typename T>
__device__ __forceinline__ void sum_item(const Item it, const uint4* buf,
                                         const AxisSample* ys, const AxisSample* xs,
                                         int pooled_w, int grid, int vpp, int out_vpp,
                                         float count, uint4* out_roi) {
  constexpr int N = Vec<T>::N;
  const int nbw = it.pw1 - it.pw0;
  const int nbins = (it.ph1 - it.ph0) * nbw;
  const int nc = it.c1 - it.c0;
  const int step_bin = THREADS / vpp, step_v = THREADS - step_bin * vpp;
  const int n = grid * grid;
  const bool pow2 = (n & (n - 1)) == 0;
  const float inv = 1.f / count;
  int bin = threadIdx.x / vpp, v = threadIdx.x - bin * vpp;
  while (bin < nbins) {
    const int bh = bin / nbw;
    const int ph = it.ph0 + bh;
    const int pw = it.pw0 + bin - bh * nbw;
    float acc[N], v1[N], v2[N], v3[N], v4[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.f;
    for (int iy = 0; iy < grid; ++iy) {
      const AxisSample sy = ys[ph * grid + iy];
      if (sy.lo < 0) continue;
      const int ra = (sy.lo - it.r0) * nc - it.c0;
      const int rb = (sy.hi - it.r0) * nc - it.c0;
      for (int ix = 0; ix < grid; ++ix) {
        const AxisSample sx = xs[pw * grid + ix];
        if (sx.lo < 0) continue;
        const float w1 = sy.h * sx.h, w2 = sy.h * sx.l, w3 = sy.l * sx.h, w4 = sy.l * sx.l;
        Vec<T>::widen(buf[(ra + sx.lo) * vpp + v], v1);
        Vec<T>::widen(buf[(ra + sx.hi) * vpp + v], v2);
        Vec<T>::widen(buf[(rb + sx.lo) * vpp + v], v3);
        Vec<T>::widen(buf[(rb + sx.hi) * vpp + v], v4);
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += w1 * v1[j] + w2 * v2[j] + w3 * v3[j] + w4 * v4[j];
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = pow2 ? acc[j] * inv : acc[j] / count;
    out_roi[(ph * pooled_w + pw) * out_vpp + v] = Vec<T>::narrow(acc);
    bin += step_bin;
    v += step_v;
    if (v >= vpp) {
      v -= vpp;
      ++bin;
    }
  }
}

template <typename T, bool SLICED>
__global__ void __launch_bounds__(THREADS, 4)
    roi_align_kernel(Pyramid pyr, int batch, int channels, const float* __restrict__ rois,
                     const int* __restrict__ levels, const unsigned char* __restrict__ valid,
                     int pooled_h, int pooled_w, int grid, int slices,
                     T* __restrict__ out, int* __restrict__ stats) {
  extern __shared__ __align__(16) char stage[];  // 2 x STAGE_BYTES
  __shared__ AxisSample ys[MAX_AXIS], xs[MAX_AXIS];
  __shared__ int rows[MAX_SLOTS], cols[MAX_SLOTS];
  __shared__ short yf[MAX_AXIS], ye[MAX_AXIS], xf[MAX_AXIS], xe[MAX_AXIS];
  __shared__ Item items[MAX_ITEMS];
  __shared__ int n_items;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int vpp = channels / Vec<T>::N;  // 16-byte vectors per pixel
  const int bins = pooled_h * pooled_w;
  uint4* out_roi = reinterpret_cast<uint4*>(out + (int64_t)r * bins * channels);

  const float* roi = rois + 5 * (int64_t)r;
  const int lvl = levels[r];
  const int b = (int)roi[0];
  const bool live = (valid == nullptr || valid[r] != 0) && lvl >= 0 &&
                    lvl < pyr.num_levels && b >= 0 && b < batch;
  if (!live) {
    for (int k = tid; k < bins * vpp; k += THREADS) out_roi[k] = make_uint4(0, 0, 0, 0);
    if (stats != nullptr && tid == 0) {
      stats[2 * r] = 0;
      stats[2 * r + 1] = 0;
    }
    return;
  }

  const int height = pyr.height[lvl];
  const int width = pyr.width[lvl];
  const int pixel_bytes = channels * (int)sizeof(T);
  const int slice_bytes = SLICED ? pixel_bytes / slices : pixel_bytes;
  const int svpp = SLICED ? vpp / slices : vpp;  // 16-byte vectors of a slice of a pixel
  const char* base = static_cast<const char*>(pyr.data[lvl]) +
                     (int64_t)b * height * width * pixel_bytes;

  // steps 1-2: warp 0 the y axis, warp 1 the x axis, the plain version's
  // operations, then the distinct rows and columns
  if (tid < 64) {
    const float scale = pyr.scale[lvl];
    const bool y = tid < 32;
    const int s = tid % 32;
    const int pooled = y ? pooled_h : pooled_w;
    AxisSample* tab = y ? ys : xs;
    if (s < pooled * grid)
      tab[s] = roi_axis_sample(roi, scale, y, s, pooled, grid, y ? height : width);
    __syncwarp();
    axis_slots(tab, pooled, grid, y ? rows : cols, y ? yf : xf, y ? ye : xe);
  }
  __syncthreads();
  // step 3: the items
  if (tid == 0) {
    int px = 0;
    n_items = plan_items(yf, ye, xf, xe, pooled_h, pooled_w, STAGE_BYTES / slice_bytes,
                         items, &px);
    if (stats != nullptr) {
      stats[2 * r] = n_items;
      stats[2 * r + 1] = px;
    }
  }
  __syncthreads();

  const int n = n_items;
  const float count = (float)(grid * grid);
  if constexpr (!SLICED) {
    // steps 4-5: double-buffered items
    stage_item(items[0], rows, cols, base, width, pixel_bytes, pixel_bytes, stage);
    for (int k = 0; k < n; ++k) {
      if (k + 1 < n) {
        stage_item(items[k + 1], rows, cols, base, width, pixel_bytes, pixel_bytes,
                   stage + ((k + 1) & 1) * STAGE_BYTES);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      sum_item<T>(items[k], reinterpret_cast<const uint4*>(stage + (k & 1) * STAGE_BYTES), ys,
                  xs, pooled_w, grid, vpp, vpp, count, out_roi);
      __syncthreads();
    }
  } else {
    // steps 4-6: double-buffered units, unit k = item k % n of slice k / n
    const int units = n * slices;
    stage_item(items[0], rows, cols, base, width, pixel_bytes, slice_bytes, stage);
    int item = 0, slice = 0;  // unit k's
    for (int k = 0; k < units; ++k) {
      if (k + 1 < units) {
        const int next = item + 1 < n ? item + 1 : 0;
        const int next_slice = item + 1 < n ? slice : slice + 1;
        stage_item(items[next], rows, cols, base + next_slice * slice_bytes, width, pixel_bytes,
                   slice_bytes, stage + ((k + 1) & 1) * STAGE_BYTES);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      sum_item<T>(items[item], reinterpret_cast<const uint4*>(stage + (k & 1) * STAGE_BYTES), ys,
                  xs, pooled_w, grid, svpp, vpp, count, out_roi + slice * svpp);
      __syncthreads();
      if (++item == n) {
        item = 0;
        ++slice;
      }
    }
  }
}

// Step 6: the fewest equal channel slices s of a pixel (s divides C) whose
// bytes fill 16-byte vectors and of which one bin's (2 grid)^2 pixels fit
// one staging buffer; 0 where none does. Mirrored by
// ops/roi_align.py::channel_slices.
static int channel_slices(int channels, int elt, int grid) {
  for (int s = 1; s <= channels; ++s) {
    if (channels % s != 0 || (channels / s * elt) % 16 != 0) continue;
    if (4 * grid * grid * (channels / s) * elt <= STAGE_BYTES) return s;
  }
  return 0;
}

// Two staging buffers beyond the 48 KB default, and the largest shared
// memory carveout, so that four blocks fit an SM.
template <typename T, bool SLICED>
static cudaError_t set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(roi_align_kernel<T, SLICED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       2 * STAGE_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(roi_align_kernel<T, SLICED>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
static int launch(const Pyramid& pyr, int batch, int channels, const void* rois,
                  const void* levels, const void* valid, int num_rois, int pooled_h,
                  int pooled_w, int grid, int slices, void* out, void* stats,
                  cudaStream_t s) {
  cudaError_t e = slices > 1 ? set_attributes<T, true>() : set_attributes<T, false>();
  if (e != cudaSuccess) return (int)e;
  const int smem = 2 * STAGE_BYTES;
  auto kernel = slices > 1 ? roi_align_kernel<T, true> : roi_align_kernel<T, false>;
  kernel<<<num_rois, THREADS, smem, s>>>(
      pyr, batch, channels, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<const unsigned char*>(valid), pooled_h, pooled_w, grid, slices,
      static_cast<T*>(out), static_cast<int*>(stats));
  return (int)cudaGetLastError();
}

extern "C" {

// The kernel's limits, for the wrapper: {STAGE_BYTES, MAX_AXIS, MAX_ITEMS}.
void oneshot_roi_align_limits(int* out) {
  out[0] = STAGE_BYTES;
  out[1] = MAX_AXIS;
  out[2] = MAX_ITEMS;
}

// Resident blocks per SM of the kernel's unsliced instance for dtype (0 =
// float32, 1 = bfloat16), or -1 on error.
int oneshot_roi_align_blocks_per_sm(int dtype) {
  int n = -1;
  const size_t smem = 2 * STAGE_BYTES;
  if (dtype == 0) {
    if (set_attributes<float, false>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, roi_align_kernel<float, false>,
                                                      THREADS, smem) != cudaSuccess)
      return -1;
  } else if (set_attributes<__nv_bfloat16, false>() != cudaSuccess ||
             cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, roi_align_kernel<__nv_bfloat16, false>, THREADS, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

// dtype: 0 = float32, 1 = bfloat16. `stats`, when not null, receives per
// ROI (items, staged pixels) of one channel slice's plan as int32 (R, 2).
// Returns cudaGetLastError() after launch, or cudaErrorInvalidValue for
// shapes beyond the limits.
int oneshot_roi_align_forward(const void* pyramid, int batch, int channels, int dtype,
                              const void* rois, const void* levels, const void* valid,
                              int num_rois, int pooled_h, int pooled_w, int sampling_ratio,
                              void* out, void* stats, void* stream) {
  const Pyramid pyr = *static_cast<const Pyramid*>(pyramid);
  const int elt = dtype == 0 ? 4 : 2;
  const int g = sampling_ratio;
  if ((dtype != 0 && dtype != 1) || g <= 0 || pooled_h <= 0 || pooled_w <= 0 ||
      pooled_h * g > MAX_AXIS || pooled_w * g > MAX_AXIS || pooled_h * pooled_w > MAX_ITEMS ||
      channels <= 0 || (channels * elt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int slices = channel_slices(channels, elt, g);
  if (slices == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(pyr, batch, channels, rois, levels, valid, num_rois, pooled_h,
                         pooled_w, g, slices, out, stats, s);
  return launch<__nv_bfloat16>(pyr, batch, channels, rois, levels, valid, num_rois, pooled_h,
                               pooled_w, g, slices, out, stats, s);
}

const char* oneshot_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
