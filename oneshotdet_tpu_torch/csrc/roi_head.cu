// Fused relation head (stage-2 box head, 'concat' method, eval) for Hopper
// (sm_90a), bf16 or fp32.
//
// Replaces oneshotdet_tpu/ops/pallas_roi_head.py::pallas_roi_head (the Pallas
// TPU kernel, body _make_kernel). Per ROI r of image r / per_image, with
// mm(a, w) = products of a and w rounded to the working type T, summed in
// float32, and GN = GroupNorm(32, eps 1e-5) with float32 statistics per
// (ROI, group) over the 49 positions (two-pass variance):
//   h = mm(x, c0a) + yb[image]                    yb = support half + bias
//   h = T(leaky(GN0(h)))                           slope 0.2
//   h = T(leaky(GN1(mm(h, c1) + c1b)))
//   a = T(leaky(GN(agb + sum_taps mm(shift(h) * inside_7x7, ag[tap]))))
//   f = T(relu(mm(a_pqc, fc6) + fc6b)); f = T(relu(mm(f, fc7) + fc7b))
//   logits, deltas = mm(f, pred) + predb           float32
// yb (the support half of compress_0, once per image) is computed by the
// wrapper. The TPU kernel's indicator-matmul GroupNorm, its block size T and
// its 128-lane output padding were layout devices of the TPU and have no
// counterpart here; the statistics are taken in float32.
//
// Bound. 34.8 M multiply-adds per ROI (compress 6.4 + 6.4, 3x3 14.5, fc6 6.4,
// fc7 1.0) against 25 KB of bf16 input: far above the H100's ~295 flops per
// byte, so the head is bound by tensor-core operations (bf16: 1.12 ms at
// R = 16 000 at 989 TFLOP/s; fp32 has no tensor-core path at parity: 16.6 ms
// at 67 TFLOP/s).
//
// Design, three kernels on the caller's stream:
//   1. head_front: one block of two warpgroups (8 warps) per ROI. The 49 rows
//      (padded to 64) stay in shared memory through compress_0, GN0,
//      compress_1, GN1, the 3x3 conv and its GN. compress_0 runs in four
//      128-column chunks (each holds whole GN0 groups), and each normalized
//      chunk is at once multiplied into compress_1's register accumulators,
//      so the 64x512 intermediate never exists in full. compress_1's output
//      is normalized in two 128-column halves into a zero-bordered 9x9 grid
//      that takes the place of the input tile; there each 3x3 tap is a
//      constant row offset (9 dy + dx), the border supplies the SAME padding,
//      and rows of one ROI never mix with another's. bf16 products are wgmma
//      (m64n64k16 / m64n128k16, each warpgroup half the columns) with A from
//      registers (ldmatrix) and B from shared memory: the weights, L2-resident
//      and stored transposed by the wrapper, stream by cp.async through a
//      120 KB ring of 32-deep slices laid out as wgmma core matrices. fp32
//      uses FMA loops (no TF32) on weights read from global memory.
//      Measured: streaming the 1.1 MB of weights per ROI from L2 is what
//      limits it (tools/ablate_roi_head.py); several ROIs per block, or
//      multicast across a cluster, would cut that traffic.
//   2. gemm_bias_relu (twice): fc6 over (R, 49 * 128) in (p, q, c) order
//      (fc6's rows are permuted to match by the wrapper) and fc7, 128x128
//      block tiles (bf16 WMMA; fp32 FMA) so that the weights are reused
//      across ROIs.
//   3. predictor: one warp per ROI for the two small output layers.
// The wrapper (oneshotdet_tpu_torch/ops/roi_head_fused.py) checks shapes,
// dtypes, devices and contiguity and allocates the outputs and scratch; this
// file launches and returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 256;          // ROI feature channels
constexpr int C2 = 2 * C;       // compress_0 width
constexpr int CA = C / 2;       // aggregation width
constexpr int NPOS = 49;        // 7 x 7 positions of a ROI
constexpr int ROWS = 64;        // positions padded to whole 16-row tiles
constexpr int GRID_ROWS = 84;   // 9 x 9 zero-bordered grid, + 3 rows the taps may read
constexpr int CHUNK = 128;      // compress_0 columns per pass
constexpr int THREADS = 256;
constexpr int MAX_PRED = 16;    // ncls + 4 * nreg

// Shared-memory layout of head_front, leading dimensions in elements. The
// bf16 rows of X, D and H are 16 bytes past a multiple of 128 bytes, so the 8
// rows an ldmatrix reads fall in distinct banks.
constexpr int LDX = C + 8;      // X: the ROI's 64 x C input
constexpr int LDS = CHUNK + 8;  // S: 64 x 128 float32 staging
constexpr int LDH = C + 8;      // H: the 9x9 grid of compress_1's output (aliases X)
// bf16 weights stream through a ring of KS-deep slices (cp.async), as many
// slices of N columns in flight as RING_BYTES holds
constexpr int KS = 32;
constexpr int RING_BYTES = 120 * 1024;

template <typename T>
struct Layout {
  // D holds the normalized compress_0 chunk in T; for fp32 it is S itself
  static constexpr bool kSeparateD = sizeof(T) != sizeof(float);
  static constexpr int LDD = kSeparateD ? CHUNK + 8 : LDS;
  static constexpr int kRegion1 =
      ROWS * LDX * (int)sizeof(T) > GRID_ROWS * LDH * (int)sizeof(T)
          ? ROWS * LDX * (int)sizeof(T) : GRID_ROWS * LDH * (int)sizeof(T);
  static constexpr int OFF_S = (kRegion1 + 127) / 128 * 128;
  static constexpr int OFF_D = kSeparateD ? OFF_S + ROWS * LDS * 4 : OFF_S;
  static constexpr int OFF_R = OFF_S + ROWS * LDS * 4 + (kSeparateD ? ROWS * LDD * (int)sizeof(T) : 0);
  static constexpr int BYTES = OFF_R + (kSeparateD ? RING_BYTES : 0);
};
static_assert(Layout<float>::BYTES <= 232448 - 1024, "fp32 head_front exceeds shared memory");
static_assert(Layout<bf16>::BYTES <= 232448 - 1024, "bf16 head_front exceeds shared memory");
static_assert(Layout<bf16>::OFF_D % 128 == 0 && Layout<bf16>::OFF_R % 128 == 0,
              "unaligned shared-memory regions");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A 64 x N float32 accumulator tile spread over the block's 256 threads:
// acc += A (64 x K in shared memory; a_at(k) points at row 0, column k; row
// stride lda) @ B, given as B_kn (K x N, row-major) and as B_nk (its
// transpose), both in global memory. Every thread of the block calls mma
// together.
template <typename T, int N> struct Acc;

// wgmma m64nNk16, A (64 x 16 bf16) from registers, B from shared memory, f32
// accumulators; d holds N / 2 floats per thread.
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Shared-memory descriptor of a K-major B tile without swizzle: 8 x 16-byte
// core matrices, lbo bytes apart along K, sbo bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// bf16: wgmma. Warpgroup g (warps 4g .. 4g + 3) owns columns g N/2 ..; its
// warp w holds rows 16 (w % 4) .. of A, loaded by ldmatrix. B, read from
// B_nk (N x K, K contiguous), streams through the shared-memory ring in
// KS-deep slices laid out as wgmma core matrices (n / 8, k / 8) of 8 rows x
// 16 bytes: STAGES - 2 slices in flight while one is multiplied.
template <int N>
struct Acc<bf16, N> {
  static constexpr int NW = N / 2;             // columns of one warpgroup
  static constexpr int SLOT = N * KS * 2;      // bytes of one slice
  static constexpr int STAGES = RING_BYTES / SLOT;
  static_assert(STAGES >= 4, "weight ring too small");
  static_assert(NW == 64 || NW == 128, "wgmma width");
  float d[NW / 2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0.f;
  }
  template <typename APtr>
  __device__ void mma(APtr a_at, int lda, const bf16* /*B_kn*/, int /*ld_kn*/,
                      const bf16* __restrict__ B_nk, int ld_nk, int K, bf16* ring) {
    const int slices = K / KS;
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    unsigned char* ring_b = reinterpret_cast<unsigned char*>(ring);
    auto issue = [&](int slice) {
      if (slice < slices) {
        unsigned char* dst = ring_b + (slice % STAGES) * SLOT;
        const bf16* src = B_nk + slice * KS;
        for (int i = threadIdx.x; i < N * (KS / 8); i += THREADS) {
          const int n = i / (KS / 8), kc = i % (KS / 8);
          cp_async16(dst + (n >> 3) * (KS * 16) + kc * 128 + (n & 7) * 16,
                     src + (int64_t)n * ld_nk + kc * 8);
        }
      }
      cp_async_commit();  // an empty group past the end keeps the counts uniform
    };
    for (int i = 0; i < STAGES - 2; ++i) issue(i);
    // this warp's 16 rows, ldmatrix x4 lane addresses: rows lane % 16, k + 8 (lane / 16)
    const int a_row = (16 * ((threadIdx.x >> 5) & 3) + (lane & 15)) * lda + (lane >> 4) * 8;
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) fence_reg(d[i]);
    // one slice; A registers alternate between two sets, since the wgmma of
    // the previous slice may still read its set
    auto step = [&](int slice, uint32_t (&af)[KS / 16][4]) {
      // the wgmma of slice - 2 is done: its ring slot and A registers are free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      cp_async_wait<STAGES - 3>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // every thread's part of the slice has landed
      issue(slice + STAGES - 2);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const uint32_t addr =
            (uint32_t)__cvta_generic_to_shared(a_at(slice * KS + kk * 16) + a_row);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(af[kk][0]), "=r"(af[kk][1]), "=r"(af[kk][2]), "=r"(af[kk][3])
                     : "r"(addr));
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const unsigned char* w = ring_b + (slice % STAGES) * SLOT + wg * (NW / 8) * (KS * 16);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const uint64_t desc = smem_desc(w + kk * 256, 128, KS * 16);
        if constexpr (NW == 64) wgmma_n64(d, af[kk], desc);
        else wgmma_n128(d, af[kk], desc);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) fence_reg(d[i]);
    };
    uint32_t a0[KS / 16][4], a1[KS / 16][4];
    for (int slice = 0; slice < slices; slice += 2) {
      step(slice, a0);
      if (slice + 1 < slices) step(slice + 1, a1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) fence_reg(d[i]);
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next product
  }
  // columns c0 .. c0 + 127 of the tile into S (columns 0 .. 127). Lane
  // 4 r + t of warp w holds rows 16 (w % 4) + r and + 8, and columns 8 j + 2 t
  // and + 1 of its warpgroup's block, j = 0 .. NW / 8 - 1.
  __device__ void store_cols(float* S, int lds, int c0) const {
    const int lane = threadIdx.x & 31;
    const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int col0 = (threadIdx.x >> 7) * NW + 2 * (lane & 3) - c0;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col < 0 || col >= 128) continue;
      S[row * lds + col] = d[4 * j];
      S[row * lds + col + 1] = d[4 * j + 1];
      S[(row + 8) * lds + col] = d[4 * j + 2];
      S[(row + 8) * lds + col + 1] = d[4 * j + 3];
    }
  }
};

// fp32: FMA, B read from global memory. Thread t owns rows 4 (t / 16) .. +3
// and columns t % 16 + 16 j.
template <int N>
struct Acc<float, N> {
  static constexpr int NJ = N / 16;
  float v[4][NJ];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[i][j] = 0.f;
  }
  template <typename APtr>
  __device__ void mma(APtr a_at, int lda, const float* __restrict__ B, int ldb,
                      const float* /*B_nk*/, int /*ld_nk*/, int K, float* /*ring*/) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    for (int k = 0; k < K; ++k) {
      const float* a_rows = a_at(k) + ty * 4 * lda;
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_rows[i * lda];
      const float* b = B + (int64_t)k * ldb + tx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bv = __ldg(b + 16 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i][j] = fmaf(a[i], bv, v[i][j]);
      }
    }
  }
  // columns c0 .. c0 + 127 of the tile into S (columns 0 .. 127)
  __device__ void store_cols(float* S, int lds, int c0) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j - c0;
      if (col < 0 || col >= 128) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) S[(ty * 4 + i) * lds + col] = v[i][j];
    }
  }
};

// Row of position p (0..48, p = 7 y + x) in the staging buffers: compact
// (row p), or the 3x3 conv's output tile, whose row m' is grid row m' + 10.
struct CompactRow {
  __device__ int operator()(int p) const { return p; }
};
struct ConvOutRow {
  __device__ int operator()(int p) const { return (p / 7) * 9 + p % 7; }
};
struct GridRow {  // position p in the zero-bordered 9x9 grid
  __device__ int operator()(int p) const { return (p / 7) * 9 + p % 7 + 10; }
};

// GroupNorm statistics of S's NCOLS columns (groups of GS) over the 49
// positions: mean and 1 / sqrt(var + eps), one warp per group, two passes.
template <int NCOLS, int GS, typename RowOf>
__device__ void group_stats(const float* S, int lds, RowOf row_of, float* mean_s,
                            float* rstd_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int n = NPOS * GS;
  for (int g = warp; g < NCOLS / GS; g += THREADS / 32) {
    const float* col = S + g * GS;
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) sum += col[row_of(i / GS) * lds + i % GS];
    const float mean = warp_sum(sum) / (float)n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = col[row_of(i / GS) * lds + i % GS] - mean;
      sq += d * d;
    }
    const float var = warp_sum(sq) / (float)n;
    if (lane == 0) {
      mean_s[g] = mean;
      rstd_s[g] = 1.f / sqrtf(var + 1e-5f);
    }
  }
}

// dst[dst_row(p)][c] = T(leaky((S[src_row(p)][c] - mean) * rstd * gamma + beta))
template <int NCOLS, int GS, typename T, typename SrcRow, typename DstRow>
__device__ void gn_leaky_store(const float* S, int lds, SrcRow src_row,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* mean_s, const float* rstd_s, T* dst, int ldd,
                               DstRow dst_row) {
  for (int i = threadIdx.x; i < NPOS * NCOLS; i += THREADS) {
    const int p = i / NCOLS, c = i % NCOLS, g = c / GS;
    float v = (S[src_row(p) * lds + c] - mean_s[g]) * rstd_s[g] * gamma[c] + beta[c];
    v = v >= 0.f ? v : v * 0.2f;
    dst[(int64_t)dst_row(p) * ldd + c] = from_f<T>(v);
  }
}

// Mirrors `struct HeadArgs` in oneshotdet_tpu_torch/ops/roi_head_fused.py.
struct HeadArgs {
  const void* x;      // (R, 7, 7, C) T
  const void* yb;     // (B, 49, 2C) T: support half of compress_0 plus its bias
  const void* c0a;    // (C, 2C) T: query half of compress_0
  const void* c0aT;   // (2C, C) T: its transpose
  const float* gn0g;
  const float* gn0b;
  const void* c1;     // (2C, C) T
  const void* c1T;    // (C, 2C) T
  const float* c1b;
  const float* gn1g;
  const float* gn1b;
  const void* ag;     // (9, C, C/2) T, taps in (ky, kx) order
  const void* agT;    // (C/2, 9 C) T: agT[n][C tap + c] = ag[tap][c][n]
  const float* agb;
  const float* gng;
  const float* gnb;
  const void* fc6;    // (49 C/2, hidden) T, rows in (p, q, c) order
  const float* fc6b;
  const void* fc7;    // (hidden, hidden) T
  const float* fc7b;
  const void* pred;   // (hidden, ncls + nreg4) T: cls_score | bbox_pred
  const float* predb;
  void* a;            // scratch (R, 49 C/2) T
  void* f6;           // scratch (R, hidden) T
  void* f7;           // scratch (R, hidden) T
  float* logits;      // (R, ncls)
  float* deltas;      // (R, nreg4)
  int rois;
  int per_image;
  int hidden;
  int ncls;
  int nreg4;
  int dtype;          // 0 = float32, 1 = bfloat16
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) head_front_kernel(HeadArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<T>;
  T* X = reinterpret_cast<T*>(smem);
  T* H = reinterpret_cast<T*>(smem);  // aliases X, written once X is no longer read
  float* S = reinterpret_cast<float*>(smem + L::OFF_S);
  T* D = reinterpret_cast<T*>(smem + L::OFF_D);
  T* ring = reinterpret_cast<T*>(smem + L::OFF_R);
  __shared__ float mean_s[32], rstd_s[32];

  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int img = r / args.per_image;
  const T* c0a = static_cast<const T*>(args.c0a);
  const T* c0aT = static_cast<const T*>(args.c0aT);
  const T* c1 = static_cast<const T*>(args.c1);
  const T* c1T = static_cast<const T*>(args.c1T);
  const T* ag = static_cast<const T*>(args.ag);
  const T* agT = static_cast<const T*>(args.agT);

  // X <- the ROI's 49 rows (rows 49..63 zero)
  {
    constexpr int VPR = C * (int)sizeof(T) / 16;  // 16-byte vectors per row
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(args.x) +
                                                      (int64_t)r * NPOS * C);
    for (int i = tid; i < ROWS * VPR; i += THREADS) {
      const int row = i / VPR, v = i - row * VPR;
      const uint4 val = row < NPOS ? src[row * VPR + v] : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(X) +
                                row * LDX * (int)sizeof(T) + v * 16) = val;
    }
  }
  __syncthreads();

  // compress_0 by 128-column chunks, each normalized and fed to compress_1
  Acc<T, C> h1;
  h1.zero();
  const T* yb = static_cast<const T*>(args.yb) + (int64_t)img * NPOS * C2;
  for (int chunk = 0; chunk < C2 / CHUNK; ++chunk) {
    {
      Acc<T, CHUNK> h0;
      h0.zero();
      h0.mma([&](int k) { return X + k; }, LDX, c0a + chunk * CHUNK, C2,
             c0aT + (int64_t)chunk * CHUNK * C, C, C, ring);
      h0.store_cols(S, LDS, 0);
    }
    __syncthreads();
    for (int i = tid; i < NPOS * CHUNK; i += THREADS) {
      const int p = i / CHUNK, c = i - p * CHUNK;
      S[p * LDS + c] += to_f(yb[p * C2 + chunk * CHUNK + c]);
    }
    __syncthreads();
    group_stats<CHUNK, 16>(S, LDS, CompactRow(), mean_s, rstd_s);
    __syncthreads();
    gn_leaky_store<CHUNK, 16>(S, LDS, CompactRow(), args.gn0g + chunk * CHUNK,
                              args.gn0b + chunk * CHUNK, mean_s, rstd_s, D, L::LDD,
                              CompactRow());
    for (int i = tid; i < (ROWS - NPOS) * CHUNK; i += THREADS)
      D[(NPOS + i / CHUNK) * L::LDD + i % CHUNK] = from_f<T>(0.f);
    __syncthreads();
    h1.mma([&](int k) { return D + k; }, L::LDD, c1 + (int64_t)chunk * CHUNK * C, C,
           c1T + chunk * CHUNK, C2, CHUNK, ring);
    __syncthreads();  // D (fp32: S) is read to the end before it is written again
  }

  // compress_1, by halves of 128 columns (whole GN1 groups): + bias, GN1,
  // leaky, into the zero-bordered 9x9 grid H
  {
    uint4* h = reinterpret_cast<uint4*>(H);
    for (int i = tid; i < GRID_ROWS * LDH * (int)sizeof(T) / 16; i += THREADS)
      h[i] = make_uint4(0, 0, 0, 0);
  }
  for (int half = 0; half < 2; ++half) {
    h1.store_cols(S, LDS, half * 128);
    __syncthreads();
    for (int i = tid; i < NPOS * 128; i += THREADS) {
      const int p = i / 128, c = i % 128;
      S[p * LDS + c] += args.c1b[half * 128 + c];
    }
    __syncthreads();
    group_stats<128, C / 32>(S, LDS, CompactRow(), mean_s, rstd_s);
    __syncthreads();
    gn_leaky_store<128, C / 32>(S, LDS, CompactRow(), args.gn1g + half * 128,
                                args.gn1b + half * 128, mean_s, rstd_s, H + half * 128, LDH,
                                GridRow());
    __syncthreads();
  }

  // 3x3 conv C -> C/2 over output grid rows 10..73 as one product of depth
  // 9 C: tap (ky, kx) = k / C reads grid row m + 9 (ky - 1) + (kx - 1)
  {
    Acc<T, CA> acc;
    acc.zero();
    acc.mma([&](int k) {
              const int tap = k / C;
              return H + (10 + 9 * (tap / 3 - 1) + tap % 3 - 1) * LDH + k % C;
            },
            LDH, ag, CA, agT, 9 * C, 9 * C, ring);
    acc.store_cols(S, LDS, 0);
  }
  __syncthreads();
  for (int i = tid; i < NPOS * CA; i += THREADS) {
    const int p = i / CA, c = i - p * CA;
    S[ConvOutRow()(p) * LDS + c] += args.agb[c];
  }
  __syncthreads();
  group_stats<CA, CA / 32>(S, LDS, ConvOutRow(), mean_s, rstd_s);
  __syncthreads();
  gn_leaky_store<CA, CA / 32>(S, LDS, ConvOutRow(), args.gng, args.gnb, mean_s, rstd_s,
                              static_cast<T*>(args.a) + (int64_t)r * NPOS * CA, CA,
                              CompactRow());
}

// out[M, N] = bf16(relu(A[M, K] @ B[K, N] + bias)), row-major; N % 128 == 0,
// K % 32 == 0. 128 x 128 block tile, 8 warps of 64 x 32, the next K-slice
// loaded into registers while the current one is multiplied.
constexpr int GBM = 128, GBN = 128, GBK = 32;

__global__ void __launch_bounds__(THREADS) gemm_bias_relu_bf16(
    const bf16* __restrict__ A, const bf16* __restrict__ B, const float* __restrict__ bias,
    bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[GBM][GBK + 8];
  __shared__ __align__(128) bf16 Bs[GBK][GBN + 8];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + tid / 4 + 64 * i;
      ra[i] = gm < M ? *reinterpret_cast<const uint4*>(A + (int64_t)gm * K + k0 + (tid % 4) * 8)
                     : make_uint4(0, 0, 0, 0);
      rb[i] = *reinterpret_cast<const uint4*>(B + (int64_t)(k0 + tid / 16 + 16 * i) * N + n0 +
                                              (tid % 16) * 8);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&As[tid / 4 + 64 * i][(tid % 4) * 8]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[tid / 16 + 16 * i][(tid % 16) * 8]) = rb[i];
    }
  };

  load(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += GBK) {
    const bool more = k0 + GBK < K;
    if (more) load(k0 + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], GBK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], GBN + 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

  // epilogue through a per-warp 16 x 16 tile: + bias, relu, 8 bf16 per lane
  const int row = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + row;
      const int gn = n0 + wn * 32 + j * 16 + c8;
      if (gm < M) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16_rn(fmaxf(Cs[warp][row * 16 + c8 + e] + bias[gn + e], 0.f));
        *reinterpret_cast<uint4*>(out + (int64_t)gm * N + gn) = *reinterpret_cast<uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// out[M, N] = relu(A[M, K] @ B[K, N] + bias) in fp32 FMA; N % 64 == 0,
// K % 16 == 0. 64 x 64 block tile, 4 x 4 outputs per thread.
constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(THREADS) gemm_bias_relu_f32(
    const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ bias,
    float* __restrict__ out, int M, int N, int K) {
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[FBK][FBN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    {
      const int am = tid >> 2, ak = (tid & 3) * 4;
      const float4 a = m0 + am < M
          ? *reinterpret_cast<const float4*>(A + (int64_t)(m0 + am) * K + k0 + ak)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      As[ak][am] = a.x;
      As[ak + 1][am] = a.y;
      As[ak + 2][am] = a.z;
      As[ak + 3][am] = a.w;
      const int bk = tid >> 4, bn = (tid & 15) * 4;
      *reinterpret_cast<float4*>(&Bs[bk][bn]) =
          *reinterpret_cast<const float4*>(B + (int64_t)(k0 + bk) * N + n0 + bn);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    const int gn = n0 + tx * 4;
    float4 v;
    v.x = fmaxf(acc[i][0] + bias[gn], 0.f);
    v.y = fmaxf(acc[i][1] + bias[gn + 1], 0.f);
    v.z = fmaxf(acc[i][2] + bias[gn + 2], 0.f);
    v.w = fmaxf(acc[i][3] + bias[gn + 3], 0.f);
    *reinterpret_cast<float4*>(out + (int64_t)gm * N + gn) = v;
  }
}

// logits | deltas = f @ pred + predb in float32, one warp per ROI.
template <typename T>
__global__ void __launch_bounds__(THREADS) predictor_kernel(HeadArgs args) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= args.rois) return;
  const int np = args.ncls + args.nreg4;
  const T* f = static_cast<const T*>(args.f7) + (int64_t)row * args.hidden;
  const T* w = static_cast<const T*>(args.pred);
  float acc[MAX_PRED];
#pragma unroll
  for (int n = 0; n < MAX_PRED; ++n) acc[n] = 0.f;
  for (int k = lane; k < args.hidden; k += 32) {
    const float fv = to_f(f[k]);
    const T* wr = w + (int64_t)k * np;
#pragma unroll
    for (int n = 0; n < MAX_PRED; ++n)
      if (n < np) acc[n] = fmaf(fv, to_f(wr[n]), acc[n]);
  }
#pragma unroll
  for (int n = 0; n < MAX_PRED; ++n) {
    if (n >= np) break;
    const float v = warp_sum(acc[n]) + args.predb[n];
    if (lane == 0) {
      if (n < args.ncls)
        args.logits[(int64_t)row * args.ncls + n] = v;
      else
        args.deltas[(int64_t)row * args.nreg4 + n - args.ncls] = v;
    }
  }
}

template <typename T>
int launch_front(const HeadArgs& args, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(head_front_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Layout<T>::BYTES);
  if (e != cudaSuccess) return (int)e;
  head_front_kernel<T><<<args.rois, THREADS, Layout<T>::BYTES, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs the whole head for args.rois ROIs. Returns the first non-zero
// cudaError_t of the four launches, or 0.
int oneshot_roi_head_forward(const void* argp, void* stream) {
  const HeadArgs args = *static_cast<const HeadArgs*>(argp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = args.rois, hid = args.hidden, k6 = NPOS * CA;
  if (m <= 0 || args.per_image <= 0 || args.ncls + args.nreg4 > MAX_PRED ||
      args.ncls + args.nreg4 <= 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (args.dtype == 1) {
    if (hid % GBN != 0 || k6 % GBK != 0 || hid % GBK != 0) return (int)cudaErrorInvalidValue;
    if ((rc = launch_front<bf16>(args, s)) != 0) return rc;
    const dim3 grid(hid / GBN, (m + GBM - 1) / GBM);
    gemm_bias_relu_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(args.a), static_cast<const bf16*>(args.fc6), args.fc6b,
        static_cast<bf16*>(args.f6), m, hid, k6);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    gemm_bias_relu_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(args.f6), static_cast<const bf16*>(args.fc7), args.fc7b,
        static_cast<bf16*>(args.f7), m, hid, hid);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    predictor_kernel<bf16><<<(m + 7) / 8, THREADS, 0, s>>>(args);
  } else if (args.dtype == 0) {
    if (hid % FBN != 0 || k6 % FBK != 0 || hid % FBK != 0) return (int)cudaErrorInvalidValue;
    if ((rc = launch_front<float>(args, s)) != 0) return rc;
    const dim3 grid(hid / FBN, (m + FBM - 1) / FBM);
    gemm_bias_relu_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(args.a), static_cast<const float*>(args.fc6), args.fc6b,
        static_cast<float*>(args.f6), m, hid, k6);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    gemm_bias_relu_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(args.f6), static_cast<const float*>(args.fc7), args.fc7b,
        static_cast<float*>(args.f7), m, hid, hid);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    predictor_kernel<float><<<(m + 7) / 8, THREADS, 0, s>>>(args);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oneshot_roi_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
