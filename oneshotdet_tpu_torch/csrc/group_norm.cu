// GroupNorm + activation forward for Hopper (sm_90a), channels-last, fp32 or
// bf16 in and out, float32 statistics.
//
// Replaces oneshotdet_tpu/ops/pallas_groupnorm.py::_gn_pallas (the Pallas TPU
// kernels _moments_kernel and _make_normalize_kernel, with the per-group
// reduction XLA does between them). x is (B, S, C) with S every non-batch,
// non-channel position; for each (image, group of C / G adjacent channels):
//   mean = E[x], inv = rsqrt(max(E[x^2] - mean^2, 0) + eps)   (one pass, f32)
//   y = act(((x - mean) * inv) * gamma + beta), act none, ReLU or LeakyReLU.
// The one-pass formula is the JAX package's; it is kept although two-pass
// statistics are more accurate at a large input mean.
//
// Bound. A few flops per element: memory traffic bounds it. The least traffic
// is x read once and y written once; this design reads x twice (moments,
// normalize) and writes y once, as the Pallas pair does. At the FCOS tower's
// P3 (8 x 104 x 152 x 256, bf16): 64.8 MB in + 64.8 MB out, ~39 us at
// 3.35 TB/s; the second read of x may come from the 50 MB L2 on smaller maps.
//
// Design. Three launches on the caller's stream:
//   1. moments: grid (splits, B); each block sums x and x^2 per channel over
//      one run of rows of one image. Each thread owns two adjacent channels
//      (one 4-byte bf16x2 or 8-byte float2 load per row, so a warp reads one
//      contiguous run of a row) and `lanes` row lanes split the rows; the
//      lanes are summed in a fixed order and each block writes its partial
//      sums to `partial` (B, splits, 2, C). No atomics: the result does not
//      depend on the order the blocks run in.
// Built with -fmad=false: the plain version repeats these sums and divisions
// in this order and equals the kernels bit for bit.
//   2. stats: one block per image sums the partials in split order, then each
//      group's channels in channel order, and writes per-channel mean and inv.
//   3. normalize: elementwise over x with the per-(image, channel) mean, inv,
//      gamma and beta, the activation fused, stored in x's dtype.
//
// The wrapper (oneshotdet_tpu_torch/ops/group_norm.py) checks shapes, dtypes,
// devices and contiguity, allocates the outputs and `partial`, and picks the
// split; this file launches and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// blockDim.x = pairs * lanes, pairs = C / 2; dynamic shared memory holds
// 4 floats per thread.
template <typename T>
__global__ void gn_moments_kernel(const T* __restrict__ x, int64_t spatial,
                                  int channels, int rows_per_split,
                                  float* __restrict__ partial) {
  extern __shared__ float4 lane_sums[];
  const int pairs = channels / 2;
  const int lanes = blockDim.x / pairs;
  const int cp = threadIdx.x % pairs;
  const int lane = threadIdx.x / pairs;
  const int b = blockIdx.y;
  const int split = blockIdx.x;
  const int64_t s0 = (int64_t)split * rows_per_split;
  const int64_t s1 = s0 + rows_per_split < spatial ? s0 + rows_per_split : spatial;
  const T* base = x + (int64_t)b * spatial * channels + 2 * cp;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // (sum c, sum c+1, sq c, sq c+1)
  for (int64_t s = s0 + lane; s < s1; s += lanes) {
    const float2 v = load2(base + s * channels);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.x * v.x;
    acc.w += v.y * v.y;
  }
  lane_sums[threadIdx.x] = acc;
  __syncthreads();
  if (lane != 0) return;
  for (int l = 1; l < lanes; ++l) {
    const float4 o = lane_sums[l * pairs + cp];
    acc.x += o.x;
    acc.y += o.y;
    acc.z += o.z;
    acc.w += o.w;
  }
  float* out = partial + ((int64_t)b * gridDim.x + split) * 2 * channels + 2 * cp;
  store2(out, make_float2(acc.x, acc.y));
  store2(out + channels, make_float2(acc.z, acc.w));
}

// One block per image; dynamic shared memory holds 2 * C + 2 * G floats.
__global__ void gn_stats_kernel(const float* __restrict__ partial, int splits,
                                int channels, int groups, float count, float eps,
                                float* __restrict__ mean_c,
                                float* __restrict__ inv_c) {
  extern __shared__ float smem[];
  float* s1 = smem;
  float* s2 = s1 + channels;
  float* g_mean = s2 + channels;
  float* g_inv = g_mean + groups;
  const int b = blockIdx.x;
  const float* p = partial + (int64_t)b * splits * 2 * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      a += p[(int64_t)sp * 2 * channels + c];
      q += p[(int64_t)sp * 2 * channels + channels + c];
    }
    s1[c] = a;
    s2[c] = q;
  }
  __syncthreads();
  const int cpg = channels / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cpg; ++i) {
      a += s1[g * cpg + i];
      q += s2[g * cpg + i];
    }
    const float m = a / count;
    const float m2 = q / count;
    g_mean[g] = m;
    g_inv[g] = 1.f / sqrtf(fmaxf(m2 - m * m, 0.f) + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    mean_c[(int64_t)b * channels + c] = g_mean[c / cpg];
    inv_c[(int64_t)b * channels + c] = g_inv[c / cpg];
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
  if (ACT == 1) return fmaxf(y, 0.f);
  if (ACT == 2) return y >= 0.f ? y : y * slope;
  return y;
}

template <typename T, int ACT>
__global__ void gn_normalize_kernel(const T* __restrict__ x,
                                    const float* __restrict__ mean_c,
                                    const float* __restrict__ inv_c,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    int64_t spatial, int channels, float slope,
                                    int64_t num_pairs, T* __restrict__ y) {
  const int pairs = channels / 2;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < num_pairs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = 2 * (int)(i % pairs);
    const int64_t b = i / ((int64_t)pairs * spatial);
    const int64_t bc = b * channels + c;
    const float2 v = load2(x + 2 * i);
    const float2 m = load2(mean_c + bc);
    const float2 r = load2(inv_c + bc);
    const float2 g = load2(gamma + c);
    const float2 be = load2(beta + c);
    float2 o;
    o.x = activate<ACT>((v.x - m.x) * r.x * g.x + be.x, slope);
    o.y = activate<ACT>((v.y - m.y) * r.y * g.y + be.y, slope);
    store2(y + 2 * i, o);
  }
}

template <typename T>
static void launch_normalize(int act, dim3 grid, int threads, cudaStream_t s,
                             const T* x, const float* mean_c, const float* inv_c,
                             const float* gamma, const float* beta,
                             int64_t spatial, int channels, float slope,
                             int64_t num_pairs, T* y) {
  if (act == 1)
    gn_normalize_kernel<T, 1><<<grid, threads, 0, s>>>(
        x, mean_c, inv_c, gamma, beta, spatial, channels, slope, num_pairs, y);
  else if (act == 2)
    gn_normalize_kernel<T, 2><<<grid, threads, 0, s>>>(
        x, mean_c, inv_c, gamma, beta, spatial, channels, slope, num_pairs, y);
  else
    gn_normalize_kernel<T, 0><<<grid, threads, 0, s>>>(
        x, mean_c, inv_c, gamma, beta, spatial, channels, slope, num_pairs, y);
}

template <typename T>
static int run(const void* xv, int batch, int64_t spatial, int channels,
               int groups, float eps, int act, float slope, const float* gamma,
               const float* beta, float* partial, int splits, int rows_per_split,
               int lanes, float* mean_c, float* inv_c, void* yv, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int pairs = channels / 2;
  const int threads = pairs * lanes;
  gn_moments_kernel<T><<<dim3(splits, batch), threads, threads * sizeof(float4), s>>>(
      x, spatial, channels, rows_per_split, partial);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int stat_threads = channels < 1024 ? ((channels + 31) / 32) * 32 : 1024;
  gn_stats_kernel<<<batch, stat_threads, (2 * channels + 2 * groups) * sizeof(float), s>>>(
      partial, splits, channels, groups, (float)(spatial * (channels / groups)), eps,
      mean_c, inv_c);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t num_pairs = (int64_t)batch * spatial * pairs;
  const int64_t want = (num_pairs + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  launch_normalize<T>(act, dim3(blocks), 256, s, x, mean_c, inv_c, gamma, beta,
                      spatial, channels, slope, num_pairs, y);
  return (int)cudaGetLastError();
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 none, 1 ReLU, 2 LeakyReLU(slope).
// Returns the first nonzero cudaGetLastError() of the three launches.
int oneshot_group_norm_forward(const void* x, int dtype, int batch, int spatial,
                               int channels, int groups, float eps, int act,
                               float slope, const void* gamma, const void* beta,
                               void* partial, int splits, int rows_per_split,
                               int lanes, void* mean_c, void* inv_c, void* y,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* part = static_cast<float*>(partial);
  float* mc = static_cast<float*>(mean_c);
  float* ic = static_cast<float*>(inv_c);
  if (dtype == 0)
    return run<float>(x, batch, spatial, channels, groups, eps, act, slope, g, be,
                      part, splits, rows_per_split, lanes, mc, ic, y, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, batch, spatial, channels, groups, eps, act, slope,
                              g, be, part, splits, rows_per_split, lanes, mc, ic, y, s);
  return (int)cudaErrorInvalidValue;
}

const char* oneshot_group_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
