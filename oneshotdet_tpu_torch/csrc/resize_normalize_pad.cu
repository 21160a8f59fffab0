// Resize + normalize + pad of a batch of uint8 RGB images, for Hopper (sm_90a).
//
// Replaces oneshotdet_tpu/csrc/fast_collate.cpp::resize_normalize_pad (the
// JAX package's native host pass, one call per image, called at
// oneshotdet_tpu/data/collate.py:48). It computes exactly that pass, for
// every image of a batch in one launch, into one or more outputs (the data
// path's queries and supports), each with its own (pad_h, pad_w) slot and
// normalization:
//   - PIL's triangle (BILINEAR) filter coefficients in double, the support
//     widened by the scale when downsampling (fast_collate.cpp:30-63), each
//     output column's (row's) weights divided by their sum;
//   - a horizontal pass accumulated in double in tap order and stored as
//     float;
//   - a vertical pass in double in tap order, then ONE round half away from
//     zero, a clamp to 0..255, the BGR swap (or the 1/255 scale) and
//     (c - mean) / std in float;
//   - zeros in the rest of the image's slot.
// The file builds with -fmad=false, so every multiply and add rounds on its
// own as in the plain version (oneshotdet_tpu_torch/ops/resize.py::
// resize_normalize_pad_slots_plain), which equals this kernel bit for bit.
//
// Bound. Bytes: the uint8 sources read once and the float32 slots written
// once. 8 VOC-sized queries (500 x 375) into 1216 x 832 slots: ~4.5 MB read,
// 97.1 MB written, ~30 us at the H100 SXM's 3.35 TB/s. The float64 work (no
// contraction: ~0.17 G multiplies and adds at that 2.13x upscale) takes
// ~10 us at the data sheet's FP64 rate, under the bytes.
//
// Design. A block of 192 threads owns one image's strip of 64 output columns
// (fewer for a steep horizontal downscale) and walks down a run of its
// output's rows (64, or 32 for an output with a small grid), GROUP rows at a
// time.
//   1. Set-up, once per block: the strip's column filters (first tap, tap
//      count, weights) into shared memory, the row filters of the whole run
//      (or of one group at a time where a steep vertical downscale leaves no
//      room), and the 3 x 256 normalized values of the output's
//      normalization (output channel and uint8 value in, the stored float
//      out).
//   2. Source rows enter a ring of `ring_rows` horizontally resampled rows
//      (float rounded, held as double) in ascending order, each once per
//      block; a thread resamples one (column, channel) position of HROWS
//      rows at once and writes it at its output channel's place (the BGR
//      swap). A row's bytes [3 first, 3 end) are staged in shared memory by
//      16-byte cp.async copies of the aligned chunks that hold them (the
//      packed buffer is aligned and padded for that), `stage_rows` rows a
//      batch, double-buffered: the next batch's copies are issued before
//      the current batch is resampled, and the last batch of a group
//      prefetches the next group's rows.
//   3. A thread owns 4 consecutive floats of two of the group's rows (8
//      float64 chains, taps in ascending order), read from the ring by two
//      16-byte loads a tap. A group whose source rows outnumber the ring
//      takes them in chunks of `ring_rows`, the sums kept in registers.
//   4. It rounds (two directed-rounding adds), clamps, looks up the
//      normalized values and stores its 4 floats by one 16-byte store;
//      padding rows and columns get zeros the same way, and a strip wholly
//      in the padding only stores zeros.
// Two barriers a group: the copies landed (which also ends the last
// group's reads of the ring), and the ring written. What each step costs:
// oneshotdet_tpu_torch/tools/ablate_resize.py --variants.
// The wrapper (oneshotdet_tpu_torch/ops/resize.py) packs the sources and
// their meta into one upload, plans the strip width, ring, staging and the
// shared-memory layout (`launch_plan`), allocates the outputs and launches on
// the caller's stream; this file returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define STRIP_MAX 64
#define RUN_MAX 64      // output rows a block walks down, at most
#define GROUP 8         // output rows a thread sums at once
#define THREADS (STRIP_MAX * 3)
#define ROW_THREADS 64  // threads 64..127 build row filters
#define HROWS 4         // source rows a thread resamples at once
#define QUADS (STRIP_MAX * 3 / 4)  // 4-float pieces of a strip row
#define MAX_OUTPUTS 4
#define META_FIELDS 7   // per image: source byte offset, h0, w0, oh, ow, output, slot
#define OUT_FIELDS 7

namespace {

struct OutputArgs {
  float* dst;
  int pad_h, pad_w;
  int first_image, images;  // meta rows of this output
  int strips, runs;         // blocks per image: strips x runs
  int run;                  // output rows a block walks (a multiple of GROUP, <= RUN_MAX)
  int block_start;
  float m0, m1, m2, s0, s1, s2;
  int bgr;
};

struct Args {
  const uint8_t* src;
  const long long* meta;
  OutputArgs out[MAX_OUTPUTS];
  int outputs;
  int strip;        // output columns a block owns (a power of two, <= STRIP_MAX)
  int kw, kh;       // taps of the widest column and row filters
  int row_filters;  // row filters held at once: RUN_MAX, or GROUP
  int ring_rows;    // resampled source rows held (a power of two)
  int stage_rows;   // source rows a batch of copies stages (a power of two)
  int row_bytes;    // bytes of one staged row (a multiple of 16)
  int off_kx, off_ky, off_ring, off_stage;  // dynamic shared memory, bytes
};

struct Filter {
  int first;
  int count;
};

// PIL's precompute_coeffs for output index `o` of an in_size -> out_size
// resample: the first tap and the tap count, the weights into k[x * stride].
__device__ Filter filter_taps(int o, int in_size, int out_size, double* k, int stride) {
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
    k[x * stride] = w;
    ww += w;
  }
  if (ww != 0.0) {
    for (int x = 0; x < xmax; ++x) k[x * stride] /= ww;
  }
  return Filter{xmin, xmax};
}

constexpr double kTwo52 = 4503599627370496.0;

// A uint8 value as a double: 2^52 + b minus 2^52, both exact.
__device__ __forceinline__ double u8_to_double(uint8_t b) {
  return __dsub_rn(__hiloint2double(0x43300000, b), kTwo52);
}

// round(x) (half away from zero) clamped to 0..255, for 0 <= x < 2^31: that
// is floor(x + 0.5). x + 0.5 rounded down keeps its floor, and adding 2^52
// rounded down leaves that floor in the low word (the doubles in [2^52,
// 2^53) are the integers).
__device__ __forceinline__ int round_clamp_u8(double x) {
  return min(max(__double2loint(__dadd_rd(__dadd_rd(x, 0.5), kTwo52)), 0), 255);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Zeros into `rows` rows of `n` floats, row k at dst + k * pitch_g: 16-byte
// stores when `vec` (every row start 16-byte aligned, n a multiple of 4),
// else 4-byte ones.
__device__ __forceinline__ void store_zeros(float* dst, long long pitch_g, int rows, int n,
                                            bool vec) {
  if (vec) {
    const int q = n >> 2;
    for (int k = threadIdx.x; k < rows * q; k += THREADS) {
      const int r = k / q;
      reinterpret_cast<float4*>(dst + r * pitch_g)[k - r * q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int k = threadIdx.x; k < rows * n; k += THREADS) {
      const int r = k / n;
      dst[r * pitch_g + k - r * n] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)
resize_normalize_pad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lut[3][256];   // [output channel][uint8 value] -> the stored float
  __shared__ int fx_first[STRIP_MAX], fx_count[STRIP_MAX];
  __shared__ int fy_first[RUN_MAX], fy_count[RUN_MAX];
  // the plan in registers (the lambdas below capture these, never `a`)
  const int strip = a.strip;
  const int kh = a.kh;
  const int row_filters = a.row_filters;
  const int ring_rows = a.ring_rows;
  const int stage_rows = a.stage_rows;
  const int row_bytes = a.row_bytes;
  double* kx = reinterpret_cast<double*>(smem + a.off_kx);     // [kw][strip]
  double* ky = reinterpret_cast<double*>(smem + a.off_ky);     // [row_filters][kh]
  double* ring = reinterpret_cast<double*>(smem + a.off_ring); // [ring_rows][rp]
  unsigned char* stage = smem + a.off_stage;                   // [2 stage_rows][row_bytes]

  // the block's output, image, strip and run (static indices: no local copy)
  OutputArgs out = a.out[0];
#pragma unroll
  for (int k = 1; k < MAX_OUTPUTS; ++k)
    if (k < a.outputs && static_cast<int>(blockIdx.x) >= a.out[k].block_start) out = a.out[k];
  const int tid = threadIdx.x;
  const int local = blockIdx.x - out.block_start;
  const int per_image = out.strips * out.runs;
  const int image = out.first_image + local / per_image;
  const int tile = local - (local / per_image) * per_image;
  const int x0 = (tile % out.strips) * strip;
  const int y0 = (tile / out.strips) * out.run;
  const long long* m = a.meta + static_cast<long long>(image) * META_FIELDS;
  const uint8_t* img = a.src + m[0];
  const int h0 = static_cast<int>(m[1]);
  const int w0 = static_cast<int>(m[2]);
  const int oh = static_cast<int>(m[3]);
  const int ow = static_cast<int>(m[4]);
  const long long slot = m[6];
  const int ncols = min(strip, out.pad_w - x0);  // the strip's columns in the slot
  const int yend = min(y0 + out.run, out.pad_h);
  const long long pitch_g = static_cast<long long>(out.pad_w) * 3;
  float* dst = out.dst + (slot * out.pad_h + y0) * pitch_g + x0 * 3;
  const bool vec = (out.pad_w % 4 == 0) && (x0 % 4 == 0) && (ncols % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(out.dst) % 16 == 0);
  const int nc = max(0, min(ncols, ow - x0));    // resampled columns
  const int vend = min(yend, oh);                // resampled rows end
  if (nc == 0 || y0 >= oh) {                     // the strip's run lies in the padding
    store_zeros(dst, pitch_g, yend - y0, ncols * 3, vec);
    return;
  }

  // 1. filters of the strip's columns and of the first rows; the table of
  // normalized values: output channel, uint8 value -> the stored float
  if (tid < nc) {
    const Filter f = filter_taps(x0 + tid, w0, ow, kx + tid, strip);
    fx_first[tid] = f.first;
    fx_count[tid] = f.count;
  } else if (tid >= ROW_THREADS && tid - ROW_THREADS < min(row_filters, vend - y0)) {
    const int r = tid - ROW_THREADS;
    const Filter f = filter_taps(y0 + r, h0, oh, ky + r * kh, 1);
    fy_first[r] = f.first;
    fy_count[r] = f.count;
  }
  for (int e = tid; e < 3 * 256; e += THREADS) {
    const int oc = e >> 8;
    float v = static_cast<float>(e & 255);
    if (!out.bgr) v = v * (1.0f / 255.0f);
    const float mean = oc == 0 ? out.m0 : (oc == 1 ? out.m1 : out.m2);
    const float sd = oc == 0 ? out.s0 : (oc == 1 ? out.s1 : out.s2);
    lut[oc][e & 255] = (v - mean) / sd;
  }
  __syncthreads();

  const int sfirst = fx_first[0];
  const int span = 3 * (fx_first[nc - 1] + fx_count[nc - 1] - sfirst);  // staged bytes a row
  // the horizontal pass: thread = (column, source channel), written to the
  // ring at its output channel's place (the BGR swap)
  const int col = tid / 3;
  const int ch = tid - 3 * col;
  const bool active = tid < nc * 3;
  const int my_first = active ? 3 * (fx_first[col] - sfirst) + ch : 0;
  const int my_count = active ? fx_count[col] : 0;
  const double* my_kx = kx + col;
  const int ring_pos = 3 * col + (out.bgr ? 2 - ch : ch);
  const int rp = (strip * 3 + 3) & ~3;      // ring row pitch, doubles
  const int rmask = ring_rows - 1;
  const int smask = 2 * stage_rows - 1;
  const int chunks = (span + 30) >> 4;      // 16-byte copies a staged row takes at most
  const int chunk_bits = 32 - __clz(chunks - 1);   // a row's copies in 2^chunk_bits items
  const uintptr_t img_addr = reinterpret_cast<uintptr_t>(img);
  const uint8_t* src_row0 = img + 3 * sfirst;      // a staged row's first byte: + 3 w0 r
  // its offset in its 16-byte chunk: (base16 + step16 r) mod 16
  const unsigned base16 = static_cast<unsigned>(img_addr + 3 * sfirst) & 15u;
  const unsigned step16 = (3u * static_cast<unsigned>(w0)) & 15u;
  // the vertical pass: thread = 4 consecutive floats of a strip row (quad
  // q) of rows jr and jr + 4 of a group
  const int q = tid % QUADS;
  const int jr = tid / QUADS;
  const int k0 = 4 * q;
  const bool quad_live = k0 < ncols * 3;
  const int nvals = nc * 3;
  const float* lut_of[4];   // each float's output channel's table
#pragma unroll
  for (int i = 0; i < 4; ++i) lut_of[i] = lut[(k0 + i) % 3];

  // copies of source rows [r0, r1) into their stage slots, one commit group:
  // the 16-byte chunks that hold a row's bytes [g0, g1), whole (the wrapper
  // gives a 16-byte aligned buffer padded to a multiple of 16, so a chunk
  // never leaves it; the bytes beside a row's are never read)
  auto issue = [&](int r0, int r1) {
    for (int k = tid; k < ((r1 - r0) << chunk_bits); k += THREADS) {
      const int rr = r0 + (k >> chunk_bits);
      const int c = k & ((1 << chunk_bits) - 1);
      const uint8_t* g0 = src_row0 + static_cast<long long>(rr) * (3 * w0);
      const uint8_t* c0 = g0 - ((base16 + step16 * rr) & 15u) + 16 * c;
      if (c0 < g0 + span)
        cp_async16(stage + (rr & smask) * row_bytes + 16 * c, c0);
    }
    cp_async_commit();
  };

  // horizontal pass of staged source rows [r0, r1) into the ring, HROWS
  // rows' chains at once
  auto horizontal = [&](int r0, int r1) {
    if (!active) return;
    for (int r = r0; r < r1; r += HROWS) {
      const uint8_t* p[HROWS];
      double h[HROWS];
#pragma unroll
      for (int i = 0; i < HROWS; ++i) {
        const int rr = min(r + i, r1 - 1);
        p[i] = stage + (rr & smask) * row_bytes + ((base16 + step16 * rr) & 15u) + my_first;
        h[i] = 0.0;
      }
#pragma unroll 3
      for (int t = 0; t < my_count; ++t) {
        const double k = my_kx[t * strip];
#pragma unroll
        for (int i = 0; i < HROWS; ++i)
          h[i] = __dadd_rn(h[i], __dmul_rn(k, u8_to_double(p[i][3 * t])));
      }
#pragma unroll
      for (int i = 0; i < HROWS; ++i)
        if (r + i < r1)
          ring[((r + i) & rmask) * rp + ring_pos] = static_cast<double>(__double2float_rn(h[i]));
    }
  };

  int ring_lo = 0, ring_hi = 0;   // source rows the ring holds
  int st_lo = 0, st_hi = 0;       // source rows of the last copies issued
  int fy_base = y0;               // output row of fy_*[0] and ky's first filter
  for (int yg = y0; yg < yend; yg += GROUP) {
    const int nrows = min(GROUP, yend - yg);
    const int nv = min(nrows, vend - yg);
    if (nv <= 0) {   // this and every later group are padding rows
      store_zeros(dst + (yg - y0) * pitch_g, pitch_g, yend - yg, ncols * 3, vec);
      break;
    }
    if (yg - fy_base >= row_filters) {   // the next block of row filters
      __syncthreads();                   // the last group's sums read ky
      fy_base = yg;
      if (tid >= ROW_THREADS && tid - ROW_THREADS < min(row_filters, vend - yg)) {
        const int r = tid - ROW_THREADS;
        const Filter f = filter_taps(yg + r, h0, oh, ky + r * kh, 1);
        fy_first[r] = f.first;
        fy_count[r] = f.count;
      }
      __syncthreads();
    }
    const int jb = yg - fy_base;
    int f[2], n[2];
    double acc[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = jr + 4 * u;
      f[u] = j < nv ? fy_first[jb + j] : 0;
      n[u] = j < nv ? fy_count[jb + j] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] = 0.0;
    }
    const int lo = fy_first[jb];
    const int hi = fy_first[jb + nv - 1] + fy_count[jb + nv - 1];

    for (int c0 = lo; c0 < hi; c0 += ring_rows) {
      const int ce = min(hi, c0 + ring_rows);
      int r = ring_hi;
      if (c0 < ring_lo || c0 > ring_hi) {   // behind or past the ring: start it anew
        r = c0;
        ring_lo = ring_hi = c0;
      }
      if (r < ce) {
        // 2. resample rows [r, ce), a batch of stage_rows at a time; the
        // barrier at each batch also ends every thread's reads of the ring
        while (r < ce) {
          const int nb = min(ce - r, stage_rows);
          if (!(st_lo <= r && r + nb <= st_hi)) {
            cp_async_wait_all();   // a prefetch of other rows lands before its slots are reused
            __syncthreads();
            issue(r, r + nb);
            st_lo = r;
            st_hi = r + nb;
          }
          cp_async_wait_all();
          __syncthreads();
          const int p1 = min(r + nb + stage_rows, h0);
          if (r + nb < p1) {       // the next rows' copies overlap this batch's sums
            issue(r + nb, p1);
            st_lo = r + nb;
            st_hi = p1;
          }
          horizontal(r, r + nb);
          r += nb;
        }
        ring_hi = ce;
        ring_lo = max(ring_lo, ce - ring_rows);
        __syncthreads();
      }
      // 3. the vertical sums of the chunk's rows: row u's taps [t0, t1) lie
      // in the chunk; tap t of both rows at once (8 chains)
      if (quad_live) {
        const double* wy[2];
        int first[2], taps[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t0 = max(c0 - f[u], 0);
          taps[u] = min(ce - f[u], n[u]) - t0;
          wy[u] = ky + (jb + jr + 4 * u) * kh + t0;
          first[u] = f[u] + t0;
        }
        const int tmax = max(taps[0], taps[1]);
#pragma unroll 3
        for (int t = 0; t < tmax; ++t) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (t < taps[u]) {
              const double w = wy[u][t];
              const double* v = ring + ((first[u] + t) & rmask) * rp + k0;
              const double2 v01 = *reinterpret_cast<const double2*>(v);
              const double2 v23 = *reinterpret_cast<const double2*>(v + 2);
              acc[u][0] = __dadd_rn(acc[u][0], __dmul_rn(w, v01.x));
              acc[u][1] = __dadd_rn(acc[u][1], __dmul_rn(w, v01.y));
              acc[u][2] = __dadd_rn(acc[u][2], __dmul_rn(w, v23.x));
              acc[u][3] = __dadd_rn(acc[u][3], __dmul_rn(w, v23.y));
            }
          }
        }
      }
    }

    // 4. round, clamp, normalize and store the quad's floats of both rows
    if (quad_live) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = jr + 4 * u;
        if (j >= nrows) continue;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = (j < nv && k0 + i < nvals) ? lut_of[i][round_clamp_u8(acc[u][i])] : 0.0f;
        float* o = dst + (yg + j - y0) * pitch_g + k0;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < ncols * 3) o[i] = v[i];
        }
      }
    }
  }
  cp_async_wait_all();   // no copy outlives the block
}

int g_max_dynamic = -1;

}  // namespace

extern "C" {

// Once per device, before the first launch on it: lets the kernel take the
// most dynamic shared memory a block may have beside its static part, and
// returns that size (or -(CUDA error)).
int oneshot_resize_init() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, resize_normalize_pad_kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  e = cudaFuncSetAttribute(resize_normalize_pad_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return -static_cast<int>(e);
  g_max_dynamic = dyn;
  return dyn;
}

// The kernel's compile-time shape, for the wrapper's check: STRIP_MAX, RUN_MAX,
// GROUP, THREADS, MAX_OUTPUTS, META_FIELDS.
void oneshot_resize_shape(int* out) {
  out[0] = STRIP_MAX;
  out[1] = RUN_MAX;
  out[2] = GROUP;
  out[3] = THREADS;
  out[4] = MAX_OUTPUTS;
  out[5] = META_FIELDS;
}

// One launch for every image of every output.
//   dst[o]: output o's (images, pad_h, pad_w, 3) float32 tensor.
//   outs[o * OUT_FIELDS ...]: pad_h, pad_w, first meta row, images, strips,
//     runs, run.
//   norm[o * 7 ...]: mean (3), std (3), to_bgr255.
//   plan[11]: strip, kw, kh, row_filters, ring_rows, stage_rows, row_bytes,
//     off_kx, off_ky, off_ring, off_stage; `smem` the dynamic shared memory
//     in bytes.
int oneshot_resize_normalize_pad(const uint8_t* src, const long long* meta, int outputs,
                                 float* const* dst, const int* outs, const float* norm,
                                 const int* plan, int smem, void* stream) {
  if (outputs < 1 || outputs > MAX_OUTPUTS || smem > g_max_dynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.src = src;
  a.meta = meta;
  a.outputs = outputs;
  long long blocks = 0;
  for (int o = 0; o < MAX_OUTPUTS; ++o) {
    const int k = o < outputs ? o : outputs - 1;
    OutputArgs& d = a.out[o];
    d.dst = dst[k];
    d.pad_h = outs[k * OUT_FIELDS + 0];
    d.pad_w = outs[k * OUT_FIELDS + 1];
    d.first_image = outs[k * OUT_FIELDS + 2];
    d.images = outs[k * OUT_FIELDS + 3];
    d.strips = outs[k * OUT_FIELDS + 4];
    d.runs = outs[k * OUT_FIELDS + 5];
    d.run = outs[k * OUT_FIELDS + 6];
    d.m0 = norm[k * 7 + 0];
    d.m1 = norm[k * 7 + 1];
    d.m2 = norm[k * 7 + 2];
    d.s0 = norm[k * 7 + 3];
    d.s1 = norm[k * 7 + 4];
    d.s2 = norm[k * 7 + 5];
    d.bgr = norm[k * 7 + 6] != 0.0f;
    d.block_start = static_cast<int>(blocks);
    if (o < outputs) blocks += static_cast<long long>(d.images) * d.strips * d.runs;
  }
  if (blocks < 1 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  a.strip = plan[0];
  a.kw = plan[1];
  a.kh = plan[2];
  a.row_filters = plan[3];
  a.ring_rows = plan[4];
  a.stage_rows = plan[5];
  a.row_bytes = plan[6];
  a.off_kx = plan[7];
  a.off_ky = plan[8];
  a.off_ring = plan[9];
  a.off_stage = plan[10];
  resize_normalize_pad_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* oneshot_resize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
