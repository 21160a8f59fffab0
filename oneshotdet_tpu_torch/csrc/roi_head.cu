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
// R = 16 000 at 989 TFLOP/s). fp32 at float32 accuracy takes three TF32
// products per product (3xTF32, below): 6.75 ms at R = 16 000 at
// 494.7 TFLOP/s, under the 16.6 ms of the same work as FP32 FMA at 67 TFLOP/s.
//
// bf16 design, four launches on the caller's stream:
//   1. head_front_bf16: G = 2 ROIs per block, one consumer warpgroup each
//      (the ROI's 49 rows padded to one 64-row wgmma tile), and a producer
//      warp. Every ROI needs the same 1.1 MB of compress and 3x3 weights; the
//      producer streams them once per block, as 136 slices of 8 KB that the
//      wrapper pre-tiled in wgmma's no-swizzle core-matrix order, each one
//      bulk copy (cp.async.bulk) into a 13-slot ring completed on an mbarrier;
//      both consumers multiply every slice, and release it on an "empty"
//      mbarrier. No barrier spans the block after the start. The producer
//      also copies each ROI's input rows and the GroupNorm parameters and
//      biases into shared memory first. compress_0 runs
//      in eight 64-column chunks (whole GN0 groups), each normalized and at
//      once multiplied into compress_1's 64 x 256 accumulator, so the 64 x 512
//      intermediate never exists. compress_1's output goes into a zero-bordered
//      9x9 grid that takes the place of the input tile: there each 3x3 tap is
//      a constant row offset (9 dy + dx), the border supplies the SAME padding,
//      and the conv is one product of depth 9 C. Products are wgmma with A from
//      registers (ldmatrix: any row offset) and B from the ring. GroupNorm
//      statistics come from the accumulator registers (lane shuffles, then the
//      warpgroup's 4 warps through shared memory), and the normalized bf16
//      values go straight to the next product's operand.
//   2. fc_gemm_bf16 (fc6, then fc7): persistent blocks over 128 x 256 output
//      tiles, a producer warp keeping 4 stages of A rows (one bulk copy per
//      row) and pre-tiled B in flight, two consumer warpgroups of 64 rows on
//      wgmma m64n256k16, a bias + ReLU + bf16 epilogue.
//   3. predictor: one warp per ROI for the two small output layers.
// fp32 design (3xTF32 on wgmma), the same four launches:
//   Every product a @ w runs on the tensor cores as wgmma .tf32 with float32
//   accumulators, in three passes: v = hi + lo with hi = v rounded to tf32
//   (cvt.rna) and lo = v - hi, and a @ w = a_lo w_hi + a_hi w_lo + a_hi w_hi,
//   the small cross terms first (CUTLASS's 3xTF32 order); only a_lo w_lo, of
//   relative size 2^-22, is dropped. The weights are split by the wrapper:
//   each slice is its hi tile followed by its lo tile (TILES' *S entries).
//   The activations are the register operand (A) and are split in registers.
//   1. head_front_tf32: G = 2 ROIs per block and the producer warp and ring
//      of the bf16 design, with 16 KB slices (hi | lo) in a 5-slot ring.
//      A float32 ROI tile takes 65 KB, so per ROI there is one 64 x 260
//      float32 region: X, then the 9x9 grid of half the channels (the 3x3
//      conv runs as two products of depth 9 C/2), then the output tile.
//      The normalized compress_0 chunk never leaves the registers: its
//      accumulator fragments are compress_1's A fragments, which reads each
//      8-column block in the order 0 2 4 6 1 3 5 7, and the wrapper permutes
//      compress_1's rows to match.
//   2. fc_gemm_tf32 (fc6, then fc7): fc_gemm_bf16's persistent form with
//      128 x 128 tiles, 16-deep stages (A 8 KB, B hi | lo 16 KB), A tiled by
//      a_tile_offset_f32 and split in registers; the tensor cores sum 64 of
//      K at a time, and the threads add these partial sums in float32.
//   3. predictor_kernel<float>.
// The wrapper (oneshotdet_tpu_torch/ops/roi_head_fused.py) checks shapes,
// dtypes, devices and contiguity and allocates the outputs and scratch; this
// file launches and returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 256;          // ROI feature channels
constexpr int C2 = 2 * C;       // compress_0 width
constexpr int CA = C / 2;       // aggregation width
constexpr int NPOS = 49;        // 7 x 7 positions of a ROI
constexpr int ROWS = 64;        // positions padded to one 64-row tile
constexpr int GRID_ROWS = 84;   // 9 x 9 zero-bordered grid, + 3 rows the taps may read
constexpr int MAX_PRED = 16;    // ncls + 4 * nreg
constexpr float EPS = 1e-5f;
constexpr float SLOPE = 0.2f;

// Mirrors `struct HeadArgs` in oneshotdet_tpu_torch/ops/roi_head_fused.py.
// The *T operands are the route's pre-tiled weights (tile_operand there):
// bf16 tiles (TILES' *T entries), or float32 hi | lo tile pairs (*S).
// Matrices: compress_0's query half (C, 2C); compress_1 (2C, C); the 3x3 conv
// (9 C, C/2), k = C tap + c, taps in (ky, kx) order; fc6 (49 C/2, hidden),
// rows in (p, q, c) order; fc7 (hidden, hidden).
struct HeadArgs {
  const void* x;      // (R, 7, 7, C) T
  const void* yb;     // (B, 49, 2C) T: support half of compress_0 plus its bias
  const void* c0aT;   // bf16 64 x 64 tiles, column-block major; f32 32 x 64
  const float* gn0g;
  const float* gn0b;
  const void* c1T;    // bf16 16 x 256 tiles; f32 8 x 256, rows permuted
  const float* c1b;
  const float* gn1g;
  const float* gn1b;
  const void* agT;    // bf16 32 x 128 tiles; f32 16 x 128 by channel half
  const float* agb;
  const float* gng;
  const float* gnb;
  const void* fc6T;   // bf16 64 x 256 tiles, column-block major; f32 16 x 128
  const float* fc6b;
  const void* fc7T;   // as fc6T
  const float* fc7b;
  const void* pred;   // (hidden, ncls + nreg4) T: cls_score | bbox_pred
  const float* predb;
  void* a;            // scratch (R, 49 C/2) T, tiled (a_tile_offset or
                      // a_tile_offset_f32), rows padded to a multiple of 128
  void* f6;           // scratch (R, hidden) T, tiled, as a
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * SLOPE; }

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, bulk copies, named barriers, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrives and adds `bytes` to the transfer count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// global -> shared copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) that completes its bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// synchronizes the 128 threads of one warpgroup on named barrier `id`
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory descriptor of a K-major B tile without swizzle: 8 x 16-byte
// core matrices, lbo bytes apart along K, sbo bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// wgmma m64nNk16, A (64 x 16 bf16) from registers, B from shared memory, f32
// accumulators: d holds N / 2 floats per thread. Thread t of the warpgroup
// holds, for j = 0 .. N/8 - 1, d[4 j + q] at row 16 (t / 32) + (t % 32) / 4 +
// 8 (q / 2) and column 8 j + 2 (t % 4) + q % 2.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc);

#define D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc) {
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
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef D8

// bf16 fc6 / fc7 tiles (below), and the tiled layout of their A operand:
// the rows padded to a multiple of GBM, cut into GBM x GBK blocks stored one
// after the other (row block major), each block row-major with its 16-byte
// chunks swizzled (chunk c of row r at c ^ (r % 8)), so that one bulk copy
// brings a block and ldmatrix reads it without bank conflicts.
constexpr int GBM = 128, GBN = 256, GBK = 64;

__device__ __forceinline__ int64_t a_tile_offset(int row, int col, int ksteps) {
  const int rr = row % GBM;
  return (((int64_t)(row / GBM) * ksteps + col / GBK) * GBM + rr) * GBK +
         ((((col % GBK) >> 3) ^ (rr & 7)) << 3) + (col & 7);
}

// ---------------------------------------------------------------------------
// bf16 head_front: G ROIs per block, one consumer warpgroup each, and a
// producer warp that streams the weight slices through the ring.

constexpr int G = 2;                          // ROIs per block
constexpr int FRONT_THREADS = 128 * (G + 1);  // G consumer warpgroups + the producer's
constexpr int LDX = C + 8;                    // X / H row stride, elements (16 bytes past
                                              // 512: ldmatrix's 8 rows in distinct banks)
constexpr int CH = 64;                        // compress_0 columns per chunk (4 GN0 groups)
constexpr int LDD = CH + 8;                   // D: the normalized chunk
constexpr int LDO = CA + 8;                   // the output tile staged for its store
constexpr int SLOT = 8192;                    // bytes of one weight slice
constexpr int STAGES = 13;                    // slices in the ring
constexpr int KD0 = SLOT / (2 * CH);          // 64: depth of a compress_0 slice (64 columns)
constexpr int KD1 = SLOT / (2 * C);           // 16: of a compress_1 slice (256 columns)
constexpr int KDA = SLOT / (2 * CA);          // 32: of a 3x3 slice (128 columns)
constexpr int S0 = C / KD0;                   // slices of one compress_0 chunk
constexpr int S1 = CH / KD1;                  // slices of compress_1 that one chunk feeds
constexpr int NCHUNK = C2 / CH;
constexpr int SA = 9 * C / KDA;               // slices of the 3x3 conv
constexpr int SLICES = NCHUNK * (S0 + S1) + SA;
// The GroupNorm parameters and biases, copied to shared memory once per
// block, at these offsets (floats)
constexpr int P_GN0G = 0, P_GN0B = C2, P_GN1G = 2 * C2, P_GN1B = P_GN1G + C, P_C1B = P_GN1B + C,
              P_GNG = P_C1B + C, P_GNB = P_GNG + CA, P_AGB = P_GNB + CA, PARAM_FLOATS = P_AGB + CA;
// shared memory, bytes: per ROI X (then H) and D; the ring; its barriers
// (full and empty per slot, one per consumer's X, one for the parameters);
// the parameters; per warpgroup the GN partials of its 4 warps, means and
// 1/std
constexpr int XH_BYTES = (GRID_ROWS * LDX * 2 + 127) / 128 * 128;
constexpr int D_BYTES = ROWS * LDD * 2;
constexpr int ROI_BYTES = XH_BYTES + D_BYTES;
constexpr int OFF_RING = G * ROI_BYTES;
constexpr int OFF_BAR = OFF_RING + STAGES * SLOT;
constexpr int OFF_PARAMS = (OFF_BAR + (2 * STAGES + G + 1) * 8 + 127) / 128 * 128;
constexpr int OFF_STATS = OFF_PARAMS + PARAM_FLOATS * 4;
constexpr int STATS_FLOATS = 4 * 32 + 2 * 32;
constexpr int FRONT_BYTES = OFF_STATS + G * STATS_FLOATS * 4;
static_assert(FRONT_BYTES <= 232448, "bf16 head_front exceeds shared memory");
static_assert(8 % G == 0, "the fused head takes multiples of 8 ROIs per image: a block of G "
                          "ROIs must not span two images");
static_assert(NPOS * LDO * 2 <= XH_BYTES, "output tile does not fit in X");
static_assert(XH_BYTES % 128 == 0 && D_BYTES % 128 == 0, "unaligned regions");
static_assert(S0 % 2 == 0 && S1 % 2 == 0 && SA % 2 == 0, "products run slices in pairs");

// Halves v (2H entries) over lanes `o` apart: afterwards v[0..H) holds the
// sums of the half that the lane's bit o selects (the upper one if set).
template <int H>
__device__ __forceinline__ void halve(float* v, int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// Groups of GS columns of a 64 x N accumulator tile. For GS >= 8 a column
// block j lies in one group, the same for every lane; for GS = 4 it holds two
// groups, and lane bit 1 says which of them the lane's columns are in.
template <int N, int GS>
struct TileGroups {
  static constexpr int NG = N / GS;                  // groups of the tile
  static constexpr int NE = GS >= 8 ? NG : N / 8;    // a thread's partial sums
  __device__ static int group(int j, int lane) {
    return GS >= 8 ? j * 8 / GS : 2 * j + ((lane >> 1) & 1);
  }
  __device__ static int entry(int j) { return GS >= 8 ? j * 8 / GS : j; }
};

// out[g] = scale * sum over the tile's valid rows and group g's columns of
// f(x, g), for g < NG, summed over the warpgroup's 128 threads. v0 and v1:
// whether the thread's two rows are valid. Two named-barrier waits; out is
// read by the whole warpgroup after the second.
template <int N, int GS, bool kRstd, typename F>
__device__ __forceinline__ void tile_group_sum(const float* d, bool v0, bool v1, F f, float* red,
                                               float* out, float scale, int bar) {
  using TG = TileGroups<N, GS>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float v[TG::NE];
#pragma unroll
  for (int e = 0; e < TG::NE; ++e) v[e] = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int g = TG::group(j, lane);
    float s = 0.f;
    if (v0) s += f(d[4 * j], g) + f(d[4 * j + 1], g);
    if (v1) s += f(d[4 * j + 2], g) + f(d[4 * j + 3], g);
    v[TG::entry(j)] += s;
  }
  int g;
  if constexpr (GS == 8) {  // 32 entries, one group each, over all 32 lanes
    static_assert(N == 256, "compress_1 tile");
    halve<16>(v, lane, 16);
    halve<8>(v, lane, 8);
    halve<4>(v, lane, 4);
    halve<2>(v, lane, 2);
    halve<1>(v, lane, 1);
    g = lane;
  } else if constexpr (GS == 4) {  // 16 entries (j) over the lanes of one lane bit 1
    static_assert(N == 128, "3x3 tile");
    halve<8>(v, lane, 16);
    halve<4>(v, lane, 8);
    halve<2>(v, lane, 4);
    halve<1>(v, lane, 1);
    const int j = (lane >> 4 & 1) << 3 | (lane >> 3 & 1) << 2 | (lane >> 2 & 1) << 1 | (lane & 1);
    g = 2 * j + ((lane >> 1) & 1);
  } else {  // a compress_0 chunk: 4 groups over all 32 lanes
    static_assert(N == 64 && GS == 16, "compress_0 chunk");
    halve<2>(v, lane, 16);
    halve<1>(v, lane, 8);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
    g = (lane >> 3) & 3;
  }
  if (TG::NG == 32 || (lane & 7) == 0) red[warp * 32 + g] = v[0];
  wg_sync(bar);
  const int t = threadIdx.x & 127;
  if (t < TG::NG) {
    const float s = (red[t] + red[32 + t] + red[64 + t] + red[96 + t]) * scale;
    out[t] = kRstd ? 1.f / sqrtf(s + EPS) : s;
  }
  wg_sync(bar);
}

// GroupNorm statistics of the tile (mean, then the mean squared deviation):
// st[128 + g] = mean, st[160 + g] = 1 / sqrt(var + eps); st[0..128) scratch.
template <int N, int GS>
__device__ __forceinline__ void tile_group_stats(const float* d, bool v0, bool v1, float* st,
                                                 int bar) {
  const float inv_n = 1.f / (float)(NPOS * GS);
  float* mean = st + 128;
  tile_group_sum<N, GS, false>(d, v0, v1, [](float x, int) { return x; }, st, mean, inv_n, bar);
  tile_group_sum<N, GS, true>(
      d, v0, v1,
      [&](float x, int g) {
        const float e = x - mean[g];
        return e * e;
      },
      st, st + 160, inv_n, bar);
}

// bf16(leaky((x - mean) * rstd * gamma + beta)) of the tile's rows into
// *dst(row, col) (two values), for the rows that w0 / w1 admit.
template <int N, int GS, typename Dst>
__device__ __forceinline__ void tile_gn_store(const float* d, const float* st,
                                              const float* gamma, const float* beta, bool w0,
                                              bool w1, Dst dst) {
  using TG = TileGroups<N, GS>;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int g = TG::group(j, lane), col = 8 * j + 2 * (lane & 3);
    const float m = st[128 + g], rs = st[160 + g];
    const float2 ga = *reinterpret_cast<const float2*>(gamma + col);
    const float2 be = *reinterpret_cast<const float2*>(beta + col);
    const float ga0 = ga.x, ga1 = ga.y, be0 = be.x, be1 = be.y;
    if (w0)
      *dst(r0, col) = __floats2bfloat162_rn(leaky((d[4 * j] - m) * rs * ga0 + be0),
                                            leaky((d[4 * j + 1] - m) * rs * ga1 + be1));
    if (w1)
      *dst(r0 + 8, col) = __floats2bfloat162_rn(leaky((d[4 * j + 2] - m) * rs * ga0 + be0),
                                                leaky((d[4 * j + 3] - m) * rs * ga1 + be1));
  }
}

// d (64 x N) += A @ B over the next NSL slices of the ring. Slice i holds a
// KD x N tile of B in wgmma core matrices; A's columns i KD .. come from
// shared memory, a_addr(k) = this lane's ldmatrix address at column k. Waits
// for each slice on its full barrier, and releases it (lane 0 of each warp
// arrives on its empty barrier) once its products are done.
template <int N, int KD, int NSL, typename AAddr>
__device__ __forceinline__ void front_product(float* d, AAddr a_addr, int& slice,
                                              const unsigned char* ring, uint64_t* full,
                                              uint64_t* empty) {
  constexpr int KK = KD / 16;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_reg(d[i]);
  // A registers alternate between two sets: the products of the previous
  // slice may still read its set
  auto step = [&](int i, uint32_t (&a)[KK][4]) {
    const int stage = slice % STAGES;
    mbar_wait(&full[stage], (slice / STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) ldmatrix_x4(a[kk], a_addr(i * KD + kk * 16));
    wgmma_fence();
    const unsigned char* w = ring + stage * SLOT;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs<N>(d, a[kk], smem_desc(w + kk * 256, 128, KD * 16));
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < N / 2; ++e) fence_reg(d[e]);
    wgmma_wait<1>();  // the previous slice's products are done: release it
    if (i > 0 && lane == 0) mbar_arrive(&empty[(slice + STAGES - 1) % STAGES]);
    ++slice;
  };
  uint32_t a0[KK][4], a1[KK][4];
#pragma unroll 1
  for (int i = 0; i < NSL; i += 2) {
    step(i, a0);
    step(i + 1, a1);
  }
  if constexpr (NSL > 0) {
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < N / 2; ++e) fence_reg(d[e]);
    if (lane == 0) mbar_arrive(&empty[(slice + STAGES - 1) % STAGES]);
  }
}

// The producer's slice s: compress_0 chunk by chunk (its S0 slices, then the
// S1 slices of compress_1 that the chunk feeds), then the 3x3 conv's.
__device__ __forceinline__ const unsigned char* slice_source(const HeadArgs& args, int s) {
  constexpr int PER_CHUNK = S0 + S1;
  if (s < NCHUNK * PER_CHUNK) {
    const int chunk = s / PER_CHUNK, i = s % PER_CHUNK;
    return i < S0
        ? static_cast<const unsigned char*>(args.c0aT) + (int64_t)(chunk * S0 + i) * SLOT
        : static_cast<const unsigned char*>(args.c1T) + (int64_t)(chunk * S1 + i - S0) * SLOT;
  }
  return static_cast<const unsigned char*>(args.agT) + (int64_t)(s - NCHUNK * PER_CHUNK) * SLOT;
}

// One consumer warpgroup: ROI r's whole front, from its input tile to its
// row of `a`.
__device__ __forceinline__ void front_consumer(const HeadArgs& args, unsigned char* smem,
                                               const unsigned char* ring, uint64_t* full,
                                               uint64_t* empty, uint64_t* xbar,
                                               uint64_t* pbar) {
  const int g = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int bar = 1 + g;
  const int r_raw = blockIdx.x * G + g;
  const bool live = r_raw < args.rois;           // a last group may be partial
  const int r = live ? r_raw : args.rois - 1;    // ... and then repeats the last ROI unstored
  const int img = r / args.per_image;
  unsigned char* xh = smem + g * ROI_BYTES;      // X, then H, then the output tile
  bf16* X = reinterpret_cast<bf16*>(xh);
  bf16* D = reinterpret_cast<bf16*>(xh + XH_BYTES);
  float* st = reinterpret_cast<float*>(smem + OFF_STATS) + g * STATS_FLOATS;
  const int r0 = 16 * warp + (lane >> 2);        // the thread's accumulator rows r0, r0 + 8
  // this lane's ldmatrix row and column half, as a byte offset at stride ld
  const int a_row = 16 * warp + (lane & 15), a_half = (lane >> 4) * 16;

  const float* P = reinterpret_cast<const float*>(smem + OFF_PARAMS);
  // X: the producer copies the ROI's 49 rows; rows 49..63 are zero
  for (int i = t; i < (ROWS - NPOS) * (C / 8); i += 128)
    *reinterpret_cast<uint4*>(xh + (NPOS + (i >> 5)) * LDX * 2 + (i & 31) * 16) =
        make_uint4(0, 0, 0, 0);
  mbar_wait(&xbar[g], 0);
  mbar_wait(pbar, 0);
  wg_sync(bar);

  int slice = 0;
  float h1[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) h1[i] = 0.f;
  const bf16* yb = static_cast<const bf16*>(args.yb) + (int64_t)img * NPOS * C2;
  const uint32_t x_lane = smem_u32(xh) + a_row * LDX * 2 + a_half;
  const uint32_t d_lane = smem_u32(D) + a_row * LDD * 2 + a_half;
#pragma unroll 1
  for (int chunk = 0; chunk < NCHUNK; ++chunk) {
    float h0[CH / 2];
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) h0[i] = 0.f;
    front_product<CH, KD0, S0>(h0, [&](int k) { return x_lane + 2 * k; }, slice, ring, full,
                               empty);
    // + the support half, GN0, leaky -> D
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      const int col = chunk * CH + 8 * j + 2 * (lane & 3);
      if (r0 < NPOS) {
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(yb + r0 * C2 + col));
        h0[4 * j] += y.x;
        h0[4 * j + 1] += y.y;
      }
      if (r0 + 8 < NPOS) {
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(yb + (r0 + 8) * C2 + col));
        h0[4 * j + 2] += y.x;
        h0[4 * j + 3] += y.y;
      }
    }
    // (its barriers also order the previous chunk's reads of D before the writes)
    tile_group_stats<CH, 16>(h0, r0 < NPOS, r0 + 8 < NPOS, st, bar);
    tile_gn_store<CH, 16>(h0, st, P + P_GN0G + chunk * CH, P + P_GN0B + chunk * CH, true, true,
                          [&](int row, int col) {
                            return reinterpret_cast<__nv_bfloat162*>(D + row * LDD + col);
                          });
    wg_sync(bar);
    front_product<C, KD1, S1>(h1, [&](int k) { return d_lane + 2 * k; }, slice, ring, full,
                              empty);
  }

  // compress_1: + bias, GN1, leaky into the 9x9 grid H (over X, read to the end)
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(P + P_C1B + col);
    const float b0 = b.x, b1 = b.y;
    h1[4 * j] += b0;
    h1[4 * j + 1] += b1;
    h1[4 * j + 2] += b0;
    h1[4 * j + 3] += b1;
  }
  tile_group_stats<C, C / 32>(h1, r0 < NPOS, r0 + 8 < NPOS, st, bar);
  bf16* H = X;
  // zero border: grid rows of y = 0 or 8 or x = 0 or 8, and rows 81..83
  for (int i = t; i < 35 * (C / 8); i += 128) {
    const int k = i >> 5;
    const int row = k < 9 ? k : k < 18 ? 63 + k : k < 25 ? (k - 17) * 9 : k < 32 ? (k - 24) * 9 + 8
                                                                                  : 49 + k;
    *reinterpret_cast<uint4*>(xh + row * LDX * 2 + (i & 31) * 16) = make_uint4(0, 0, 0, 0);
  }
  tile_gn_store<C, C / 32>(h1, st, P + P_GN1G, P + P_GN1B, r0 < NPOS, r0 + 8 < NPOS,
                           [&](int p, int col) {
                             return reinterpret_cast<__nv_bfloat162*>(
                                 H + ((p / 7) * 9 + p % 7 + 10) * LDX + col);
                           });
  wg_sync(bar);

  // 3x3 conv C -> C/2 over output grid rows 10..73 as one product of depth
  // 9 C: tap (ky, kx) = k / C reads grid row m + 10 + 9 (ky - 1) + (kx - 1)
  float acc[CA / 2];
#pragma unroll
  for (int i = 0; i < CA / 2; ++i) acc[i] = 0.f;
  {
    const uint32_t h_lane = smem_u32(H) + (a_row + 10) * LDX * 2 + a_half;
    front_product<CA, KDA, SA>(acc,
                               [&](int k) {
                                 const int tap = k >> 8;
                                 return h_lane + (9 * (tap / 3 - 1) + tap % 3 - 1) * LDX * 2 +
                                        2 * (k & (C - 1));
                               },
                               slice, ring, full, empty);
  }
#pragma unroll
  for (int j = 0; j < CA / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(P + P_AGB + col);
    const float b0 = b.x, b1 = b.y;
    acc[4 * j] += b0;
    acc[4 * j + 1] += b1;
    acc[4 * j + 2] += b0;
    acc[4 * j + 3] += b1;
  }
  // output tile row m is position (m / 9, m % 9) where m % 9 < 7
  const bool c0 = r0 < 63 && r0 % 9 < 7, c1 = r0 + 8 < 63 && (r0 + 8) % 9 < 7;
  tile_group_stats<CA, CA / 32>(acc, c0, c1, st, bar);  // H is read to the end
  bf16* O = X;
  tile_gn_store<CA, CA / 32>(acc, st, P + P_GNG, P + P_GNB, c0, c1, [&](int m, int col) {
    return reinterpret_cast<__nv_bfloat162*>(O + ((m / 9) * 7 + m % 9) * LDO + col);
  });
  wg_sync(bar);
  if (live) {  // into fc6's A, tiled (a_tile_offset); k = 128 p + c
    bf16* dst = static_cast<bf16*>(args.a);
    for (int i = t; i < NPOS * (CA / 8); i += 128)
      *reinterpret_cast<uint4*>(dst + a_tile_offset(r, 8 * i, NPOS * CA / GBK)) =
          *reinterpret_cast<const uint4*>(xh + (i >> 4) * LDO * 2 + (i & 15) * 16);
  }
}

__global__ void __launch_bounds__(FRONT_THREADS, 1) head_front_bf16(const HeadArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + OFF_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* xbar = empty + STAGES;  // consumer g's input rows have landed
  uint64_t* pbar = xbar + G;        // the parameters have landed
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * G);
    }
    for (int i = 0; i < G; ++i) mbar_init(&xbar[i], 1);
    mbar_init(pbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * G) {  // the producer: warp 4 G
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x - 128 * G >= 32) return;
    float* params = reinterpret_cast<float*>(smem + OFF_PARAMS);
    if (lane == 0) {
      mbar_expect_tx(pbar, PARAM_FLOATS * 4);
      bulk_load(params + P_GN0G, args.gn0g, C2 * 4, pbar);
      bulk_load(params + P_GN0B, args.gn0b, C2 * 4, pbar);
      bulk_load(params + P_GN1G, args.gn1g, C * 4, pbar);
      bulk_load(params + P_GN1B, args.gn1b, C * 4, pbar);
      bulk_load(params + P_C1B, args.c1b, C * 4, pbar);
      bulk_load(params + P_GNG, args.gng, CA * 4, pbar);
      bulk_load(params + P_GNB, args.gnb, CA * 4, pbar);
      bulk_load(params + P_AGB, args.agb, CA * 4, pbar);
      for (int g = 0; g < G; ++g) mbar_expect_tx(&xbar[g], NPOS * C * 2);
    }
    __syncwarp();
    // each consumer's 49 input rows, one copy per row (the last group may be
    // partial: its absent ROIs repeat the last one, unstored)
    for (int i = lane; i < G * NPOS; i += 32) {
      const int g = i / NPOS, row = i % NPOS;
      const int r = min((int)blockIdx.x * G + g, args.rois - 1);
      bulk_load(smem + g * ROI_BYTES + row * LDX * 2,
                static_cast<const bf16*>(args.x) + ((int64_t)r * NPOS + row) * C, C * 2,
                &xbar[g]);
    }
    if (lane == 0) {
      for (int s = 0; s < SLICES; ++s) {
        const int stage = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[stage], (s / STAGES - 1) & 1);
        const unsigned char* src = slice_source(args, s);
        mbar_expect_tx(&full[stage], SLOT);
        bulk_load(ring + stage * SLOT, src, SLOT, &full[stage]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    front_consumer(args, smem, ring, full, empty, xbar, pbar);
  }
}

// ---------------------------------------------------------------------------
// bf16 fc6 / fc7: out[M, N] = bf16(relu(A[M, K] @ B[K, N] + bias)), B
// pre-tiled (GBK x GBN tiles in core-matrix order, column-block major), A in
// the tiled layout of a_tile_offset, out tiled so too (fc6, whose output is
// fc7's A) or row-major (fc7). Persistent blocks walk the 128 x 256 output
// tiles, row-block major; each stage is two bulk copies, A's 16 KB and B's
// 32 KB.

constexpr int GEMM_THREADS = 384;
constexpr int GA_BYTES = GBM * GBK * 2;
constexpr int GB_BYTES = GBN * GBK * 2;
constexpr int GSTAGE = GA_BYTES + GB_BYTES;
constexpr int GSTAGES = 4;
constexpr int GEMM_BYTES = GSTAGES * GSTAGE + 2 * GSTAGES * 8;
static_assert(GEMM_BYTES <= 232448, "fc GEMM exceeds shared memory");

template <bool kTiledOut>
__global__ void __launch_bounds__(GEMM_THREADS, 1) fc_gemm_bf16(
    const bf16* __restrict__ A, const bf16* __restrict__ Bt, const float* __restrict__ bias,
    bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSTAGES * GSTAGE);
  uint64_t* empty = full + GSTAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < GSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_n = N / GBN, ksteps = K / GBK;
  const int tiles = (M + GBM - 1) / GBM * tiles_n;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 256) {  // the producer: one thread of warp 8
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mb = tile / tiles_n, nb = tile % tiles_n;
        for (int kb = 0; kb < ksteps; ++kb, ++it) {
          const int stage = it % GSTAGES;
          if (it >= GSTAGES) mbar_wait(&empty[stage], (it / GSTAGES - 1) & 1);
          unsigned char* sa = smem + stage * GSTAGE;
          mbar_expect_tx(&full[stage], GSTAGE);
          bulk_load(sa, A + ((int64_t)mb * ksteps + kb) * GBM * GBK, GA_BYTES, &full[stage]);
          bulk_load(sa + GA_BYTES, Bt + ((int64_t)nb * ksteps + kb) * GBN * GBK, GB_BYTES,
                    &full[stage]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    // ldmatrix row of this lane and its 16-byte chunk (lane / 16) before the swizzle
    const int a_row = 64 * wg + 16 * warp + (lane & 15), a_chunk = lane >> 4;
    float acc[GBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * GBM, n0 = tile % tiles_n * GBN;
#pragma unroll
      for (int i = 0; i < GBN / 2; ++i) {
        acc[i] = 0.f;
        fence_reg(acc[i]);
      }
      auto step = [&](int kb, uint32_t (&a)[GBK / 16][4]) {
        const int stage = it % GSTAGES;
        mbar_wait(&full[stage], (it / GSTAGES) & 1);
        const unsigned char* sa = smem + stage * GSTAGE;
        const uint32_t a_lane = smem_u32(sa) + a_row * GBK * 2;
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
          ldmatrix_x4(a[kk], a_lane + (((2 * kk + a_chunk) ^ (a_row & 7)) << 4));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
          wgmma_rs<GBN>(acc, a[kk], smem_desc(sa + GA_BYTES + kk * 256, 128, GBK * 16));
        wgmma_commit();
#pragma unroll
        for (int e = 0; e < GBN / 2; ++e) fence_reg(acc[e]);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kb > 0 && lane == 0) mbar_arrive(&empty[(it + GSTAGES - 1) % GSTAGES]);
        ++it;
      };
      uint32_t a0[GBK / 16][4], a1[GBK / 16][4];
#pragma unroll 1
      for (int kb = 0; kb < ksteps; kb += 2) {  // ksteps is even
        step(kb, a0);
        step(kb + 1, a1);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < GBN / 2; ++e) fence_reg(acc[e]);
      if (lane == 0) mbar_arrive(&empty[(it + GSTAGES - 1) % GSTAGES]);
      // epilogue: + bias, ReLU, bf16 (the producer already fills the next tile's
      // stages). Column block j of the thread's rows `row` and `row + 8`: in
      // the tiled layout, GBK-column block n0 / GBK + j / 8, 16-byte chunk j % 8
      // (rows 8 apart share the swizzle)
      const int row = m0 + 64 * wg + 16 * warp + (lane >> 2);
      bf16* base = kTiledOut ? out + a_tile_offset(row, n0, N / GBK) - ((row & 7) << 3)
                             : out + (int64_t)row * N + n0;
      const int stride8 = kTiledOut ? 8 * GBK : 8 * N;   // row + 8
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        const float2 b = *reinterpret_cast<const float2*>(bias + n0 + c);
        bf16* p = base + (kTiledOut ? (j / 8) * GBM * GBK + (((j % 8) ^ (row & 7)) << 3) +
                                          2 * (lane & 3)
                                    : c);
        if (kTiledOut || row < M)
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(fmaxf(acc[4 * j] + b.x, 0.f), fmaxf(acc[4 * j + 1] + b.y, 0.f));
        if (kTiledOut || row + 8 < M)
          *reinterpret_cast<__nv_bfloat162*>(p + stride8) =
              __floats2bfloat162_rn(fmaxf(acc[4 * j + 2] + b.x, 0.f),
                                    fmaxf(acc[4 * j + 3] + b.y, 0.f));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 route: 3xTF32 products on wgmma (see the design notes at the top).

// wgmma m64nNk8, A (64 x 8 tf32) from registers, B (8 x N tf32, K-major)
// from shared memory, f32 accumulators in the layout of wgmma_rs (d = A B
// + d, or d = A B where acc is 0). Thread t
// of warp w holds A rows 16 w + (t % 32) / 4 (+ 8 in a[1], a[3]) and columns
// t % 4 (+ 4 in a[2], a[3]): ldmatrix.x4 of b16 pairs at wgmma_rs's lane
// addresses yields exactly this fragment from 16-byte rows of 4 floats.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc, int acc);

#define D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a, uint64_t desc,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a, uint64_t desc,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<256>(float* d, const uint32_t* a, uint64_t desc,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}
#undef D8

// A float32 A fragment as tf32 hi (round to nearest, ties away: cvt.rna, low
// 13 bits cleared) and lo = v - hi (exact; wgmma reads its top 19 bits).
struct SplitFrag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void split_tf32(const uint32_t (&raw)[4], SplitFrag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(__uint_as_float(raw[i])));
    h &= 0xffffe000u;
    f.hi[i] = h;
    f.lo[i] = __float_as_uint(__uint_as_float(raw[i]) - __uint_as_float(h));
  }
}

// d += a @ b (d = a @ b where acc is 0) for one 8-deep block in three TF32
// products, cross terms first; b_hi and b_lo: descriptors of B's hi and lo
// tiles.
template <int N>
__device__ __forceinline__ void mma3(float* d, const SplitFrag& f, uint64_t b_hi, uint64_t b_lo,
                                     int acc) {
  wgmma_tf32<N>(d, f.lo, b_hi, acc);
  wgmma_tf32<N>(d, f.hi, b_lo, 1);
  wgmma_tf32<N>(d, f.hi, b_hi, 1);
}

// Float32 tiles of the front: rows of C + 4 (or C/2 + 4) floats, which puts
// ldmatrix's 8 rows of 16 bytes in distinct banks.
constexpr int T_LDX = C + 4;                  // X row stride, floats
constexpr int T_HALF = C / 2;                 // grid channels: the 3x3 conv by halves
constexpr int T_LDG = T_HALF + 4;             // grid row stride
constexpr int T_LDO = CA + 4;                 // output tile row stride
constexpr int T_TILE = 8192;                  // bytes of one hi (or lo) weight tile
constexpr int T_SLOT = 2 * T_TILE;            // a slice: its hi tile, then its lo tile
constexpr int T_STAGES = 5;                   // slices in the ring
constexpr int TKD0 = T_TILE / (4 * CH);       // 32: depth of a compress_0 slice
constexpr int TKD1 = T_TILE / (4 * C);        // 8: of a compress_1 slice
constexpr int TKDA = T_TILE / (4 * CA);       // 16: of a 3x3 slice
constexpr int TS0 = C / TKD0;                 // slices of one compress_0 chunk
constexpr int TS1 = CH / TKD1;                // slices of compress_1 that one chunk feeds
constexpr int TSA = 9 * T_HALF / TKDA;        // slices of one half of the 3x3 conv
constexpr int T_SLICES = NCHUNK * (TS0 + TS1) + 2 * TSA;
constexpr int T_X_BYTES = ROWS * T_LDX * 4;   // per ROI: X, then the grid, then the output
constexpr int T_OFF_RING = G * T_X_BYTES;
constexpr int T_OFF_BAR = T_OFF_RING + T_STAGES * T_SLOT;
constexpr int T_OFF_PARAMS = (T_OFF_BAR + (2 * T_STAGES + G + 1) * 8 + 127) / 128 * 128;
constexpr int T_OFF_STATS = T_OFF_PARAMS + PARAM_FLOATS * 4;
constexpr int T_FRONT_BYTES = T_OFF_STATS + G * STATS_FLOATS * 4;
static_assert(T_FRONT_BYTES <= 232448, "tf32 head_front exceeds shared memory");
static_assert(GRID_ROWS * T_LDG * 4 <= T_X_BYTES, "grid does not fit in X");
static_assert(NPOS * T_LDO * 4 <= T_X_BYTES, "output tile does not fit in X");
static_assert(T_X_BYTES % 128 == 0, "unaligned regions");
static_assert(TS0 % 2 == 0 && TS1 % 2 == 0 && TSA % 2 == 0, "products run slices in pairs");

// fc6 / fc7 (tf32): 128 x 128 output tiles, 16-deep stages; A tiled as
// a_tile_offset's layout with 16 floats (four 16-byte chunks) a row, chunk c
// of row r at c ^ ((r / 2) % 4): ldmatrix's 8 rows of a chunk then fall in
// distinct banks. The tensor cores' float32 sums of tf32 products truncate,
// which over K = 6272 leaves fc6 biased by ~1e-5 of its outputs: each group
// of T_PROMOTE stages is summed on its own on the tensor cores and then added
// to the thread's float32 total in registers (round to nearest), which the
// 64 x 128 tile a warpgroup holds leaves room for.
constexpr int TBM = 128, TBN = 128, TBK = 16;
constexpr int TA_BYTES = TBM * TBK * 4;
constexpr int TB_BYTES = TBN * TBK * 4;       // one of B's hi and lo tiles
constexpr int T_GSTAGE = TA_BYTES + 2 * TB_BYTES;
constexpr int T_GSTAGES = 8;
constexpr int T_PROMOTE = 4;                  // stages summed on the tensor cores at a time
constexpr int T_GEMM_BYTES = T_GSTAGES * T_GSTAGE + 2 * T_GSTAGES * 8;
static_assert(T_GEMM_BYTES <= 232448, "tf32 fc GEMM exceeds shared memory");
static_assert(TBM == GBM, "fc6's A rows are padded to GBM for both routes");

__device__ __forceinline__ int64_t a_tile_offset_f32(int row, int col, int ksteps) {
  const int rr = row % TBM;
  return (((int64_t)(row / TBM) * ksteps + col / TBK) * TBM + rr) * TBK +
         ((((col % TBK) >> 2) ^ ((rr >> 1) & 3)) << 2) + (col & 3);
}

// d (64 x N) += A @ B over the next NSL slices of the ring, one commit group
// per 8-deep block (two alternating fragment sets). a_frag(kb, raw) loads
// the raw float32 A fragment of the product's block kb. A slice is released
// (lane 0 of each warp arrives on its empty barrier) once the next slice's
// first block is issued and its own products are done. kUnroll: unroll
// every slice (a_frag indexes registers by kb).
template <int N, int KD, int NSL, bool kUnroll, typename AFrag>
__device__ __forceinline__ void tf32_product(float* d, AFrag a_frag, int& slice,
                                             const unsigned char* ring, uint64_t* full,
                                             uint64_t* empty) {
  constexpr int KB = KD / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_reg(d[i]);
  auto block = [&](int i, int kk, SplitFrag& f) {
    const int stage = slice % T_STAGES;
    if (kk == 0) mbar_wait(&full[stage], (slice / T_STAGES) & 1);
    uint32_t raw[4];
    a_frag(i * KB + kk, raw);
    split_tf32(raw, f);
    wgmma_fence();
    const unsigned char* w = ring + stage * T_SLOT + kk * 256;
    mma3<N>(d, f, smem_desc(w, 128, KD * 32), smem_desc(w + T_TILE, 128, KD * 32), 1);
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < N / 2; ++e) fence_reg(d[e]);
    wgmma_wait<1>();
    if (kk == 0 && i > 0 && lane == 0) mbar_arrive(&empty[(slice + T_STAGES - 1) % T_STAGES]);
    if (kk == KB - 1) ++slice;
  };
  SplitFrag f0, f1;
  auto pair = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) block(i, kk, (kk & 1) ? f1 : f0);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) block(i + 1, kk, ((KB + kk) & 1) ? f1 : f0);
  };
  if constexpr (kUnroll) {
#pragma unroll
    for (int i = 0; i < NSL; i += 2) pair(i);
  } else {
#pragma unroll 1
    for (int i = 0; i < NSL; i += 2) pair(i);
  }
  if constexpr (NSL > 0) {
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < N / 2; ++e) fence_reg(d[e]);
    if (lane == 0) mbar_arrive(&empty[(slice + T_STAGES - 1) % T_STAGES]);
  }
}

// d <- leaky((d - mean) * rstd * gamma + beta) in place, every row.
template <int N, int GS>
__device__ __forceinline__ void tile_gn_regs(float* d, const float* st, const float* gamma,
                                             const float* beta) {
  using TGr = TileGroups<N, GS>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int g = TGr::group(j, lane), col = 8 * j + 2 * (lane & 3);
    const float m = st[128 + g], rs = st[160 + g];
    const float2 ga = *reinterpret_cast<const float2*>(gamma + col);
    const float2 be = *reinterpret_cast<const float2*>(beta + col);
    d[4 * j] = leaky((d[4 * j] - m) * rs * ga.x + be.x);
    d[4 * j + 1] = leaky((d[4 * j + 1] - m) * rs * ga.y + be.y);
    d[4 * j + 2] = leaky((d[4 * j + 2] - m) * rs * ga.x + be.x);
    d[4 * j + 3] = leaky((d[4 * j + 3] - m) * rs * ga.y + be.y);
  }
}

// The producer's slice s: compress_0 chunk by chunk (its TS0 slices, then the
// TS1 slices of compress_1 that the chunk feeds), then the 3x3 conv's, the
// first channel half's taps, then the second's.
__device__ __forceinline__ const unsigned char* slice_source_tf32(const HeadArgs& args, int s) {
  constexpr int PER_CHUNK = TS0 + TS1;
  if (s < NCHUNK * PER_CHUNK) {
    const int chunk = s / PER_CHUNK, i = s % PER_CHUNK;
    return i < TS0
        ? static_cast<const unsigned char*>(args.c0aT) + (int64_t)(chunk * TS0 + i) * T_SLOT
        : static_cast<const unsigned char*>(args.c1T) + (int64_t)(chunk * TS1 + i - TS0) * T_SLOT;
  }
  return static_cast<const unsigned char*>(args.agT) + (int64_t)(s - NCHUNK * PER_CHUNK) * T_SLOT;
}

// One consumer warpgroup: ROI r's whole front in float32, from its input
// tile to its row of `a`.
__device__ __forceinline__ void front_consumer_tf32(const HeadArgs& args, unsigned char* smem,
                                                    const unsigned char* ring, uint64_t* full,
                                                    uint64_t* empty, uint64_t* xbar,
                                                    uint64_t* pbar) {
  const int g = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int bar = 1 + g;
  const int r_raw = blockIdx.x * G + g;
  const bool live = r_raw < args.rois;
  const int r = live ? r_raw : args.rois - 1;
  const int img = r / args.per_image;
  unsigned char* xh = smem + g * T_X_BYTES;      // X, then the grid, then the output tile
  float* st = reinterpret_cast<float*>(smem + T_OFF_STATS) + g * STATS_FLOATS;
  const int r0 = 16 * warp + (lane >> 2);
  const int a_row = 16 * warp + (lane & 15), a_half = (lane >> 4) * 16;
  const float* P = reinterpret_cast<const float*>(smem + T_OFF_PARAMS);

  // X: the producer copies the ROI's 49 rows; rows 49..63 are zero
  for (int i = t; i < (ROWS - NPOS) * (C / 4); i += 128)
    *reinterpret_cast<uint4*>(xh + (NPOS + (i >> 6)) * T_LDX * 4 + (i & 63) * 16) =
        make_uint4(0, 0, 0, 0);
  mbar_wait(&xbar[g], 0);
  mbar_wait(pbar, 0);
  wg_sync(bar);

  int slice = 0;
  float h1[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) h1[i] = 0.f;
  const float* yb = static_cast<const float*>(args.yb) + (int64_t)img * NPOS * C2;
  const uint32_t x_lane = smem_u32(xh) + a_row * T_LDX * 4 + a_half;
#pragma unroll 1
  for (int chunk = 0; chunk < NCHUNK; ++chunk) {
    float h0[CH / 2];
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) h0[i] = 0.f;
    tf32_product<CH, TKD0, TS0, false>(
        h0, [&](int kb, uint32_t(&raw)[4]) { ldmatrix_x4(raw, x_lane + kb * 32); }, slice, ring,
        full, empty);
    // + the support half, GN0, leaky, in place
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      const int col = chunk * CH + 8 * j + 2 * (lane & 3);
      if (r0 < NPOS) {
        const float2 y = *reinterpret_cast<const float2*>(yb + r0 * C2 + col);
        h0[4 * j] += y.x;
        h0[4 * j + 1] += y.y;
      }
      if (r0 + 8 < NPOS) {
        const float2 y = *reinterpret_cast<const float2*>(yb + (r0 + 8) * C2 + col);
        h0[4 * j + 2] += y.x;
        h0[4 * j + 3] += y.y;
      }
    }
    tile_group_stats<CH, 16>(h0, r0 < NPOS, r0 + 8 < NPOS, st, bar);
    tile_gn_regs<CH, 16>(h0, st, P + P_GN0G + chunk * CH, P + P_GN0B + chunk * CH);
    // the chunk's accumulator fragments are compress_1's A fragments: block
    // kb's columns 2q and 2q + 1 of rows r0, r0 + 8 (q = lane % 4) stand at
    // A columns q and q + 4 (c1T's rows are permuted to match)
    tf32_product<C, TKD1, TS1, true>(
        h1,
        [&](int kb, uint32_t(&raw)[4]) {
          raw[0] = __float_as_uint(h0[4 * kb]);
          raw[1] = __float_as_uint(h0[4 * kb + 2]);
          raw[2] = __float_as_uint(h0[4 * kb + 1]);
          raw[3] = __float_as_uint(h0[4 * kb + 3]);
        },
        slice, ring, full, empty);
  }

  // compress_1: + bias, GN1, leaky, in place
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(P + P_C1B + col);
    h1[4 * j] += b.x;
    h1[4 * j + 1] += b.y;
    h1[4 * j + 2] += b.x;
    h1[4 * j + 3] += b.y;
  }
  tile_group_stats<C, C / 32>(h1, r0 < NPOS, r0 + 8 < NPOS, st, bar);  // X is read to the end
  tile_gn_regs<C, C / 32>(h1, st, P + P_GN1G, P + P_GN1B);
  float* Hg = reinterpret_cast<float*>(xh);
  // zero border of the 9x9 grid (x or y = 0 or 8) and rows 81..83, once:
  // the interior stores of both halves leave it
  for (int i = t; i < 35 * (T_HALF / 4); i += 128) {
    const int k = i >> 5;
    const int row = k < 9 ? k : k < 18 ? 63 + k : k < 25 ? (k - 17) * 9 : k < 32 ? (k - 24) * 9 + 8
                                                                                  : 49 + k;
    *reinterpret_cast<uint4*>(xh + row * T_LDG * 4 + (i & 31) * 16) = make_uint4(0, 0, 0, 0);
  }
  // 3x3 conv C -> C/2 over output grid rows 10..73, by channel halves: in
  // each, block kb (k = 8 kb) is tap k / (C/2), channel k % (C/2), at grid
  // row m + 10 + 9 (ky - 1) + (kx - 1)
  float acc[CA / 2];
#pragma unroll
  for (int i = 0; i < CA / 2; ++i) acc[i] = 0.f;
  const uint32_t g_lane = smem_u32(xh) + (a_row + 10) * T_LDG * 4 + a_half;
  auto grid_frag = [&](int kb, uint32_t(&raw)[4]) {
    const int tap = kb >> 4, c = (kb & 15) * 8;
    ldmatrix_x4(raw, g_lane + ((9 * (tap / 3 - 1) + tap % 3 - 1) * T_LDG + c) * 4);
  };
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // the half's channels into the grid interior (row (p / 7) 9 + p % 7 + 10)
#pragma unroll
    for (int j = 16 * half; j < 16 * half + 16; ++j) {
      const int col = 8 * j + 2 * (lane & 3) - T_HALF * half;
      if (r0 < NPOS)
        *reinterpret_cast<float2*>(Hg + ((r0 / 7) * 9 + r0 % 7 + 10) * T_LDG + col) =
            make_float2(h1[4 * j], h1[4 * j + 1]);
      if (r0 + 8 < NPOS)
        *reinterpret_cast<float2*>(Hg + (((r0 + 8) / 7) * 9 + (r0 + 8) % 7 + 10) * T_LDG + col) =
            make_float2(h1[4 * j + 2], h1[4 * j + 3]);
    }
    wg_sync(bar);
    tf32_product<CA, TKDA, TSA, false>(acc, grid_frag, slice, ring, full, empty);
    wg_sync(bar);  // the half is read to the end before the next is stored
  }
#pragma unroll
  for (int j = 0; j < CA / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(P + P_AGB + col);
    acc[4 * j] += b.x;
    acc[4 * j + 1] += b.y;
    acc[4 * j + 2] += b.x;
    acc[4 * j + 3] += b.y;
  }
  // output tile row m is position (m / 9, m % 9) where m % 9 < 7
  const bool c0 = r0 < 63 && r0 % 9 < 7, c1 = r0 + 8 < 63 && (r0 + 8) % 9 < 7;
  tile_group_stats<CA, CA / 32>(acc, c0, c1, st, bar);
  tile_gn_regs<CA, CA / 32>(acc, st, P + P_GNG, P + P_GNB);
  float* O = reinterpret_cast<float*>(xh);
#pragma unroll
  for (int j = 0; j < CA / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (c0)
      *reinterpret_cast<float2*>(O + ((r0 / 9) * 7 + r0 % 9) * T_LDO + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (c1)
      *reinterpret_cast<float2*>(O + (((r0 + 8) / 9) * 7 + (r0 + 8) % 9) * T_LDO + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg_sync(bar);
  if (live) {  // into fc6's A, tiled (a_tile_offset_f32); k = 128 p + c
    float* dst = static_cast<float*>(args.a);
    for (int i = t; i < NPOS * (CA / 4); i += 128)
      *reinterpret_cast<uint4*>(dst + a_tile_offset_f32(r, 4 * i, NPOS * CA / TBK)) =
          *reinterpret_cast<const uint4*>(xh + (i >> 5) * T_LDO * 4 + (i & 31) * 16);
  }
}

__global__ void __launch_bounds__(FRONT_THREADS, 1) head_front_tf32(const HeadArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + T_OFF_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_OFF_BAR);
  uint64_t* empty = full + T_STAGES;
  uint64_t* xbar = empty + T_STAGES;  // consumer g's input rows have landed
  uint64_t* pbar = xbar + G;          // the parameters have landed
  if (threadIdx.x == 0) {
    for (int i = 0; i < T_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * G);
    }
    for (int i = 0; i < G; ++i) mbar_init(&xbar[i], 1);
    mbar_init(pbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * G) {  // the producer: warp 4 G
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x - 128 * G >= 32) return;
    float* params = reinterpret_cast<float*>(smem + T_OFF_PARAMS);
    if (lane == 0) {
      mbar_expect_tx(pbar, PARAM_FLOATS * 4);
      bulk_load(params + P_GN0G, args.gn0g, C2 * 4, pbar);
      bulk_load(params + P_GN0B, args.gn0b, C2 * 4, pbar);
      bulk_load(params + P_GN1G, args.gn1g, C * 4, pbar);
      bulk_load(params + P_GN1B, args.gn1b, C * 4, pbar);
      bulk_load(params + P_C1B, args.c1b, C * 4, pbar);
      bulk_load(params + P_GNG, args.gng, CA * 4, pbar);
      bulk_load(params + P_GNB, args.gnb, CA * 4, pbar);
      bulk_load(params + P_AGB, args.agb, CA * 4, pbar);
      for (int g = 0; g < G; ++g) mbar_expect_tx(&xbar[g], NPOS * C * 4);
    }
    __syncwarp();
    for (int i = lane; i < G * NPOS; i += 32) {
      const int g = i / NPOS, row = i % NPOS;
      const int r = min((int)blockIdx.x * G + g, args.rois - 1);
      bulk_load(smem + g * T_X_BYTES + row * T_LDX * 4,
                static_cast<const float*>(args.x) + ((int64_t)r * NPOS + row) * C, C * 4,
                &xbar[g]);
    }
    if (lane == 0) {
      for (int s = 0; s < T_SLICES; ++s) {
        const int stage = s % T_STAGES;
        if (s >= T_STAGES) mbar_wait(&empty[stage], (s / T_STAGES - 1) & 1);
        mbar_expect_tx(&full[stage], T_SLOT);
        bulk_load(ring + stage * T_SLOT, slice_source_tf32(args, s), T_SLOT, &full[stage]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    front_consumer_tf32(args, smem, ring, full, empty, xbar, pbar);
  }
}

// fp32 fc6 / fc7: out[M, N] = relu(A[M, K] @ B[K, N] + bias) in 3xTF32, B
// pre-tiled (TBK x TBN hi and lo tile pairs, column-block major), A in the
// tiled layout of a_tile_offset_f32, out tiled so too (fc6) or row-major
// (fc7). fc_gemm_bf16's persistent form; each stage is two bulk copies, A's
// 8 KB and B's hi | lo 16 KB.
template <bool kTiledOut>
__global__ void __launch_bounds__(GEMM_THREADS, 1) fc_gemm_tf32(
    const float* __restrict__ A, const float* __restrict__ Bs, const float* __restrict__ bias,
    float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_GSTAGES * T_GSTAGE);
  uint64_t* empty = full + T_GSTAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < T_GSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_n = N / TBN, ksteps = K / TBK;
  const int tiles = (M + TBM - 1) / TBM * tiles_n;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 256) {  // the producer: one thread of warp 8
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mb = tile / tiles_n, nb = tile % tiles_n;
        for (int kb = 0; kb < ksteps; ++kb, ++it) {
          const int stage = it % T_GSTAGES;
          if (it >= T_GSTAGES) mbar_wait(&empty[stage], (it / T_GSTAGES - 1) & 1);
          unsigned char* sa = smem + stage * T_GSTAGE;
          mbar_expect_tx(&full[stage], T_GSTAGE);
          bulk_load(sa, A + ((int64_t)mb * ksteps + kb) * TBM * TBK, TA_BYTES, &full[stage]);
          bulk_load(sa + TA_BYTES, Bs + ((int64_t)nb * ksteps + kb) * 2 * TBN * TBK,
                    2 * TB_BYTES, &full[stage]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    // ldmatrix row of this lane and its 16-byte chunk within a block before
    // the swizzle
    const int a_row = 64 * wg + 16 * warp + (lane & 15), a_chunk = lane >> 4;
    float acc[TBN / 2], tot[TBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * TBM, n0 = tile % tiles_n * TBN;
#pragma unroll
      for (int i = 0; i < TBN / 2; ++i) {
        acc[i] = 0.f;
        tot[i] = 0.f;
        fence_reg(acc[i]);
      }
      auto block = [&](int kb, int kk, SplitFrag& f, int keep) {
        const int stage = it % T_GSTAGES;
        if (kk == 0) mbar_wait(&full[stage], (it / T_GSTAGES) & 1);
        const unsigned char* sa = smem + stage * T_GSTAGE;
        uint32_t raw[4];
        ldmatrix_x4(raw, smem_u32(sa) + a_row * TBK * 4 +
                             (((2 * kk + a_chunk) ^ ((a_row >> 1) & 3)) << 4));
        split_tf32(raw, f);
        wgmma_fence();
        const unsigned char* b = sa + TA_BYTES + kk * 256;
        mma3<TBN>(acc, f, smem_desc(b, 128, TBK * 32), smem_desc(b + TB_BYTES, 128, TBK * 32),
                  keep);
        wgmma_commit();
#pragma unroll
        for (int e = 0; e < TBN / 2; ++e) fence_reg(acc[e]);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kk == 0 && kb > 0 && lane == 0) mbar_arrive(&empty[(it + T_GSTAGES - 1) % T_GSTAGES]);
        if (kk == 1) ++it;
      };
      SplitFrag f0, f1;
#pragma unroll 1
      for (int kb = 0; kb < ksteps; ++kb) {
        block(kb, 0, f0, kb % T_PROMOTE != 0);   // a group starts its own sum
        block(kb, 1, f1, 1);
        if (kb % T_PROMOTE == T_PROMOTE - 1) {
          wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < TBN / 2; ++e) {
            fence_reg(acc[e]);
            tot[e] += acc[e];
            fence_reg(acc[e]);
          }
        }
      }
      if (lane == 0) mbar_arrive(&empty[(it + T_GSTAGES - 1) % T_GSTAGES]);
      // epilogue: + bias, ReLU (the producer already fills the next tile's stages)
      const int row = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
      for (int j = 0; j < TBN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane & 3);
        const float2 b = *reinterpret_cast<const float2*>(bias + c);
        const float2 v0 = make_float2(fmaxf(tot[4 * j] + b.x, 0.f), fmaxf(tot[4 * j + 1] + b.y, 0.f));
        const float2 v1 =
            make_float2(fmaxf(tot[4 * j + 2] + b.x, 0.f), fmaxf(tot[4 * j + 3] + b.y, 0.f));
        if (kTiledOut) {
          *reinterpret_cast<float2*>(out + a_tile_offset_f32(row, c, N / TBK)) = v0;
          *reinterpret_cast<float2*>(out + a_tile_offset_f32(row + 8, c, N / TBK)) = v1;
        } else {
          if (row < M) *reinterpret_cast<float2*>(out + (int64_t)row * N + c) = v0;
          if (row + 8 < M) *reinterpret_cast<float2*>(out + (int64_t)(row + 8) * N + c) = v1;
        }
      }
    }
  }
}

// logits | deltas = f @ pred + predb in float32, one warp per ROI.
template <typename T>
__global__ void __launch_bounds__(256) predictor_kernel(HeadArgs args) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
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

int launch_front_bf16(const HeadArgs& args, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(head_front_bf16,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FRONT_BYTES);
  if (e != cudaSuccess) return (int)e;
  head_front_bf16<<<(args.rois + G - 1) / G, FRONT_THREADS, FRONT_BYTES, s>>>(args);
  return (int)cudaGetLastError();
}

// The current device's SM count (the persistent GEMMs' grid), or 0 and the
// error in *err.
int sm_count(cudaError_t* err) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    *err = cudaGetDevice(&dev);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
  }
  return sms;
}

template <bool kTiledOut>
int launch_gemm_bf16(const void* a, const void* bt, const float* bias, void* out, int m, int n,
                     int k, cudaStream_t s) {
  cudaError_t e = cudaSuccess;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fc_gemm_bf16<kTiledOut>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (m + GBM - 1) / GBM * (n / GBN);
  fc_gemm_bf16<kTiledOut><<<tiles < sms ? tiles : sms, GEMM_THREADS, GEMM_BYTES, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(bt), bias, static_cast<bf16*>(out), m,
      n, k);
  return (int)cudaGetLastError();
}

int launch_front_tf32(const HeadArgs& args, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(head_front_tf32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T_FRONT_BYTES);
  if (e != cudaSuccess) return (int)e;
  head_front_tf32<<<(args.rois + G - 1) / G, FRONT_THREADS, T_FRONT_BYTES, s>>>(args);
  return (int)cudaGetLastError();
}

template <bool kTiledOut>
int launch_gemm_tf32(const void* a, const void* bs, const float* bias, void* out, int m, int n,
                     int k, cudaStream_t s) {
  cudaError_t e = cudaSuccess;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fc_gemm_tf32<kTiledOut>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, T_GEMM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (m + TBM - 1) / TBM * (n / TBN);
  fc_gemm_tf32<kTiledOut><<<tiles < sms ? tiles : sms, GEMM_THREADS, T_GEMM_BYTES, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(bs), bias, static_cast<float*>(out),
      m, n, k);
  return (int)cudaGetLastError();
}

int launch_fc_tf32(const HeadArgs& args, cudaStream_t s) {
  int rc = launch_gemm_tf32<true>(args.a, args.fc6T, args.fc6b, args.f6, args.rois, args.hidden,
                                  NPOS * CA, s);
  if (rc != 0) return rc;
  return launch_gemm_tf32<false>(args.f6, args.fc7T, args.fc7b, args.f7, args.rois, args.hidden,
                                 args.hidden, s);
}

// fc6 (tiled out, fc7's A) then fc7 (row-major out, the predictor's input),
// each one persistent launch
int launch_fc(const HeadArgs& args, cudaStream_t s) {
  int rc = launch_gemm_bf16<true>(args.a, args.fc6T, args.fc6b, args.f6, args.rois, args.hidden,
                                  NPOS * CA, s);
  if (rc != 0) return rc;
  return launch_gemm_bf16<false>(args.f6, args.fc7T, args.fc7b, args.f7, args.rois, args.hidden,
                                 args.hidden, s);
}

}  // namespace

extern "C" {

// Runs the whole head for args.rois ROIs. Returns the first non-zero
// cudaError_t of the launches, or 0.
int oneshot_roi_head_forward(const void* argp, void* stream) {
  const HeadArgs args = *static_cast<const HeadArgs*>(argp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = args.rois, hid = args.hidden, k6 = NPOS * CA;
  if (m <= 0 || args.per_image <= 0 || args.ncls + args.nreg4 > MAX_PRED ||
      args.ncls + args.nreg4 <= 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (args.dtype == 1) {
    if (hid % GBN != 0 || k6 % (2 * GBK) != 0 || hid % (2 * GBK) != 0)
      return (int)cudaErrorInvalidValue;
    if ((rc = launch_front_bf16(args, s)) != 0) return rc;
    if ((rc = launch_fc(args, s)) != 0) return rc;
    predictor_kernel<bf16><<<(m + 7) / 8, 256, 0, s>>>(args);
  } else if (args.dtype == 0) {
    if (hid % TBN != 0 || k6 % (TBK * T_PROMOTE) != 0 || hid % (TBK * T_PROMOTE) != 0)
      return (int)cudaErrorInvalidValue;
    if ((rc = launch_front_tf32(args, s)) != 0) return rc;
    if ((rc = launch_fc_tf32(args, s)) != 0) return rc;
    predictor_kernel<float><<<(m + 7) / 8, 256, 0, s>>>(args);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* oneshot_roi_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
