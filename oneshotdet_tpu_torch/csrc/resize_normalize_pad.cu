// Resize + normalize + pad of a batch of uint8 RGB images, for Hopper (sm_90a).
//
// Replaces oneshotdet_tpu/csrc/fast_collate.cpp::resize_normalize_pad (the
// JAX package's native host pass, one call per image, called at
// oneshotdet_tpu/data/collate.py:48). It computes exactly that pass, for
// every image of a batch in one launch:
//   - PIL's triangle (BILINEAR) filter coefficients in double, the support
//     widened by the scale when downsampling (fast_collate.cpp:30-63), each
//     output column's (row's) weights divided by their sum;
//   - a horizontal pass accumulated in double in tap order and stored as
//     float;
//   - a vertical pass in double in tap order, then ONE round half away from
//     zero (round(), not rint), a clamp to 0..255, the BGR swap (or the
//     1/255 scale) and (c - mean) / std in float;
//   - zeros in the rest of the image's (pad_h, pad_w) slot.
// The file builds with -fmad=false, so every multiply and add rounds on its
// own as in the plain version (oneshotdet_tpu_torch/ops/resize.py::
// resize_normalize_pad_plain), which equals this kernel bit for bit.
//
// Bound. Bytes: the uint8 sources read once and the float32 slots written
// once. At the eval path's batch of 8 VOC-sized queries (500 x 375) into
// 832 x 1216 slots: ~4.5 MB read, 97.1 MB written, ~30 us at the H100 SXM's
// 3.35 TB/s. The double arithmetic (about 40 operations per output pixel at
// that upscale) stays under it.
//
// Design. A block of 256 threads per (image, 8 output rows, 32 output
// columns) tile of the slot; a thread owns one output pixel (3 channels).
//   1. Lanes of warp 0 compute the tile's 32 column filters (first tap, tap
//      count, normalized weights) and lanes of warp 1 its 8 row filters, in
//      double, into shared memory.
//   2. The source rows the tile's output rows read are taken in chunks of
//      CHUNK_ROWS: the block resamples a chunk horizontally for its 32
//      columns into a float32 scratch in shared memory; each thread adds the
//      chunk's rows that its output row's filter covers, in ascending order,
//      so the taps keep the C++ order.
//   3. Each thread rounds, clamps, normalizes and stores its pixel; threads
//      outside the resampled (oh, ow) store zeros. A tile wholly in the
//      padding stores zeros and does nothing else.
// The weights' table takes TILE_W x (longest filter) doubles, so the shared
// memory grows with the downscale factor; the wrapper refuses a batch whose
// table does not fit.
//
// The wrapper (oneshotdet_tpu_torch/ops/resize.py) packs the sources back to
// back, checks the sizes, allocates the output and computes the longest
// filters; this file launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_W 32
#define TILE_H 8
#define THREADS (TILE_W * TILE_H)
#define CHUNK_ROWS 16
#define META_FIELDS 5   // per image: source byte offset, h0, w0, oh, ow

namespace {

struct Filter {
  int first;
  int count;
};

// PIL's precompute_coeffs for output index `o` of an in_size -> out_size
// resample: the first tap and the tap count, the weights into k[0..count).
__device__ Filter filter_taps(int o, int in_size, int out_size, double* k) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale > 1.0 ? scale : 1.0;
  const double support = 1.0 * filterscale;
  const double center = (o + 0.5) * scale;
  const double ss = 1.0 / filterscale;
  int xmin = static_cast<int>(center - support + 0.5);
  if (xmin < 0) xmin = 0;
  int xmax = static_cast<int>(center + support + 0.5);
  if (xmax > in_size) xmax = in_size;
  xmax -= xmin;
  double ww = 0.0;
  for (int x = 0; x < xmax; ++x) {
    const double arg = (x + xmin - center + 0.5) * ss;
    double w = arg < 0 ? arg + 1.0 : 1.0 - arg;
    if (w < 0) w = 0;
    k[x] = w;
    ww += w;
  }
  if (ww != 0.0) {
    for (int x = 0; x < xmax; ++x) k[x] /= ww;
  }
  return Filter{xmin, xmax};
}

__device__ __forceinline__ float to_u8_value(double acc) {
  return static_cast<float>(fmin(fmax(round(acc), 0.0), 255.0));
}

__global__ void __launch_bounds__(THREADS)
resize_normalize_pad_kernel(const uint8_t* __restrict__ src,
                            const long long* __restrict__ meta, int pad_h,
                            int pad_w, int kw, int kh, float m0, float m1,
                            float m2, float s0, float s1, float s2,
                            int to_bgr255, float* __restrict__ dst) {
  extern __shared__ double smem[];
  double* kx = smem;                                  // [TILE_W][kw]
  double* ky = kx + TILE_W * kw;                      // [TILE_H][kh]
  float* tmp = reinterpret_cast<float*>(ky + TILE_H * kh);  // [CHUNK_ROWS][TILE_W][3]
  __shared__ Filter fx[TILE_W];
  __shared__ Filter fy[TILE_H];

  const int b = blockIdx.z;
  const int tx = threadIdx.x % TILE_W;
  const int ty = threadIdx.x / TILE_W;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const long long* m = meta + static_cast<long long>(b) * META_FIELDS;
  const uint8_t* img = src + m[0];
  const int h0 = static_cast<int>(m[1]);
  const int w0 = static_cast<int>(m[2]);
  const int oh = static_cast<int>(m[3]);
  const int ow = static_cast<int>(m[4]);
  float* out = dst + ((static_cast<long long>(b) * pad_h + y) * pad_w + x) * 3;
  const bool in_slot = y < pad_h && x < pad_w;

  if (y0 >= oh || x0 >= ow) {   // the tile lies in the padding
    if (in_slot) out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const int ncols = min(TILE_W, ow - x0);
  const int nrows = min(TILE_H, oh - y0);

  // 1. the tile's column and row filters
  if (ty == 0 && tx < ncols) fx[tx] = filter_taps(x, w0, ow, kx + tx * kw);
  if (ty == 1 && tx < nrows) fy[tx] = filter_taps(y0 + tx, h0, oh, ky + tx * kh);
  __syncthreads();

  // the source rows the tile's rows read (first taps and ends both ascend)
  const int ys = fy[0].first;
  const int ye = fy[nrows - 1].first + fy[nrows - 1].count;
  const bool live = ty < nrows && tx < ncols;
  const Filter my = live ? fy[ty] : Filter{0, 0};
  const double* wy = ky + ty * kh;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;

  // 2. chunks of source rows: horizontal pass into tmp, then the vertical sums
  for (int c0 = ys; c0 < ye; c0 += CHUNK_ROWS) {
    const int nr = min(CHUNK_ROWS, ye - c0);
    for (int item = threadIdx.x; item < nr * TILE_W; item += THREADS) {
      const int r = item / TILE_W;
      const int cx = item % TILE_W;
      if (cx >= ncols) continue;
      const Filter f = fx[cx];
      const double* wx = kx + cx * kw;
      const uint8_t* p = img + (static_cast<long long>(c0 + r) * w0 + f.first) * 3;
      double h0a = 0.0, h1a = 0.0, h2a = 0.0;
      for (int i = 0; i < f.count; ++i, p += 3) {
        const double k = wx[i];
        h0a += k * p[0];
        h1a += k * p[1];
        h2a += k * p[2];
      }
      float* t = tmp + (r * TILE_W + cx) * 3;
      t[0] = static_cast<float>(h0a);
      t[1] = static_cast<float>(h1a);
      t[2] = static_cast<float>(h2a);
    }
    __syncthreads();
    if (live) {
      const int lo = max(c0, my.first);
      const int hi = min(c0 + nr, my.first + my.count);
      for (int r = lo; r < hi; ++r) {
        const double k = wy[r - my.first];
        const float* t = tmp + ((r - c0) * TILE_W + tx) * 3;
        a0 += k * t[0];
        a1 += k * t[1];
        a2 += k * t[2];
      }
    }
    __syncthreads();
  }

  // 3. round, clamp, normalize, store
  if (!in_slot) return;
  if (!live) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const float r = to_u8_value(a0);
  const float g = to_u8_value(a1);
  const float bl = to_u8_value(a2);
  float c0, c1, c2;
  if (to_bgr255) {
    c0 = bl; c1 = g; c2 = r;
  } else {
    const float inv255 = 1.0f / 255.0f;
    c0 = r * inv255; c1 = g * inv255; c2 = bl * inv255;
  }
  out[0] = (c0 - m0) / s0;
  out[1] = (c1 - m1) / s1;
  out[2] = (c2 - m2) / s2;
}

}  // namespace

extern "C" {

// Shared memory of one block for filters of at most kw column taps and kh
// row taps.
int oneshot_resize_smem_bytes(int kw, int kh) {
  return static_cast<int>((TILE_W * kw + TILE_H * kh) * sizeof(double) +
                          CHUNK_ROWS * TILE_W * 3 * sizeof(float));
}

// The tile shape, for the wrapper's check: (TILE_W, TILE_H, CHUNK_ROWS).
void oneshot_resize_tile(int* out) {
  out[0] = TILE_W;
  out[1] = TILE_H;
  out[2] = CHUNK_ROWS;
}

int oneshot_resize_normalize_pad(const uint8_t* src, const long long* meta,
                                 int batch, int pad_h, int pad_w, int kw,
                                 int kh, float m0, float m1, float m2,
                                 float s0, float s1, float s2, int to_bgr255,
                                 float* dst, void* stream) {
  const int smem = oneshot_resize_smem_bytes(kw, kh);
  cudaError_t e = cudaFuncSetAttribute(
      resize_normalize_pad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((pad_w + TILE_W - 1) / TILE_W, (pad_h + TILE_H - 1) / TILE_H,
                  batch);
  resize_normalize_pad_kernel<<<grid, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      src, meta, pad_h, pad_w, kw, kh, m0, m1, m2, s0, s1, s2, to_bgr255, dst);
  return static_cast<int>(cudaGetLastError());
}

const char* oneshot_resize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
