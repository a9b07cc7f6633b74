// Tiled distance matrix with the post-combine fused into the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/distance_matrix.py::distance_matrix
// (Pallas bodies _kernel_whole_k and _kernel_tiled_k, pallas_call at :119 and
// :138).  For queries q_rep (B, m') and database rows x_rep (N, m'), both
// row-major, it writes out (B, N) float32 with
//     out[b, i] = post(q_rep[b] . x_rep[i], x_bias[i], q_bias[b])
// where post is the combine of repro_torch/core/distances.py (POST_LINEAR /
// POST_RENYI / POST_NEG / POST_L2).  Inputs are float32 or bfloat16 (widened
// to float32 on load); the output is always float32.
//
// Bound: float32 operations.  2 B N m' flops against (B + N) m' input and
// B N output words: at m' = 128 that is 64 flops per output word, above the
// card's ~20 flop/byte float32 ridge, so the FMA pipe is the limit.
//
// Design: one block of 256 threads per 64 x 64 output tile; the k axis is
// walked in chunks of 32 staged in shared memory, transposed so that each
// thread reads its 4 query values and its 4 database values of one k as two
// float4 loads.  Each thread keeps a 4 x 4 register tile.  One k loop covers
// any m': the TPU's whole-k / tiled-k split sized blocks to VMEM, which does
// not apply here.  Ragged B, N and m' are bounds-checked (zeros are staged
// past the edge) instead of padded copies.  Accumulation is float32 FMA, not
// TF32 (the oracle holds it to 1e-5); each 32-wide chunk is summed on its own
// and then added to the running total, which keeps the rounding error of
// long reductions (m' of a few thousand) near that of a pairwise sum.  The
// epilogue uses __fadd_rn / __fmul_rn so that nvcc does not contract it into
// FMAs and it rounds like the plain PyTorch version.
//
// Not yet here (later work): tensor cores (wgmma, 3xTF32 or bf16 inputs),
// TMA staging and a multi-stage pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPostLinear = 0;
constexpr int kPostRenyi = 1;
constexpr int kPostNeg = 2;
constexpr int kPostL2 = 3;
constexpr float kTiny = 1e-30f;

constexpr int kTileB = 64;    // query rows per block
constexpr int kTileN = 64;    // database rows per block
constexpr int kTileK = 32;    // k staged per chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;       // keeps float4 alignment, spreads the transposed stores

__device__ __forceinline__ float post_combine(int post_id, float s, float xb, float qb,
                                              float c0) {
  switch (post_id) {
    case kPostLinear:
      return __fadd_rn(__fadd_rn(s, xb), qb);
    case kPostRenyi:
      return __fmul_rn(logf(fmaxf(s, kTiny)), c0);
    case kPostNeg:
      return -s;
    case kPostL2:
    default:
      return __fadd_rn(__fsub_rn(xb, __fmul_rn(2.0f, s)), qb);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage rows [row0, row0 + 64) x k [k0, k0 + 32) of a row-major (rows, m)
// matrix into tile[k][row], zero past the edges.  Consecutive threads read
// consecutive k of one row: 128-byte coalesced float32 reads.
template <typename T>
__device__ __forceinline__ void stage(float (*tile)[kTileB + kPad], const T* __restrict__ src,
                                      int rows, int m, int row0, int k0) {
#pragma unroll
  for (int l = 0; l < (kTileB * kTileK) / kThreads; ++l) {
    const int idx = threadIdx.x + l * kThreads;
    const int r = idx / kTileK;
    const int kk = idx % kTileK;
    const int row = row0 + r;
    const int k = k0 + kk;
    float v = 0.0f;
    if (row < rows && k < m) v = to_float(src[static_cast<int64_t>(row) * m + k]);
    tile[kk][r] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
distance_matrix_kernel(const T* __restrict__ q_rep, const T* __restrict__ x_rep,
                       const float* __restrict__ q_bias, const float* __restrict__ x_bias,
                       float* __restrict__ out, int B, int N, int m, int post_id, float c0) {
  __shared__ __align__(16) float q_s[kTileK][kTileB + kPad];
  __shared__ __align__(16) float x_s[kTileK][kTileN + kPad];

  const int tx = threadIdx.x % 16;  // database direction
  const int ty = threadIdx.x / 16;  // query direction
  const int b0 = blockIdx.y * kTileB;
  const int n0 = blockIdx.x * kTileN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += kTileK) {
    stage(q_s, q_rep, B, m, b0, k0);
    stage(x_s, x_rep, N, m, n0, k0);
    __syncthreads();

    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&q_s[kk][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&x_s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], cv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
    const float qb = q_bias[b];
    float* row = out + static_cast<int64_t>(b) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < N) row[c] = post_combine(post_id, acc[i][j], x_bias[c], qb, c0);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q_rep, const void* x_rep, const float* q_bias,
                   const float* x_bias, float* out, int B, int N, int m, int post_id, float c0,
                   cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB);
  distance_matrix_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q_rep), static_cast<const T*>(x_rep), q_bias, x_bias, out, B, N,
      m, post_id, c0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  dtype 0 = float32 reps, 1 = bfloat16
// reps (biases are float32 either way).  Returns the cudaError_t of the
// launch (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int distance_matrix_launch(const void* q_rep, const void* x_rep, const float* q_bias,
                                      const float* x_bias, float* out, int B, int N, int m,
                                      int dtype, int post_id, float c0, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if ((B + kTileB - 1) / kTileB > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id,
                                         c0, s)
                 : launch<float>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id, c0, s);
  return static_cast<int>(err);
}
