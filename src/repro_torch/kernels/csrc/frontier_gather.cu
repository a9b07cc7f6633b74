// Fused frontier gather + distance for the batched beam engine and NN-descent.
//
// Replaces the TPU kernel src/repro/kernels/frontier_gather.py::frontier_scores
// (Pallas body _kernel, pallas_call at :95).  For each query b it gathers the
// R database rows x_rep[ids[b, r]] and their biases x_bias[ids[b, r]], computes
// s = x_rep[id] . q_rep[b] in float32, applies the post-combine of
// repro_torch/core/distances.py (POST_LINEAR / POST_RENYI / POST_NEG / POST_L2)
// and writes +inf where id < 0.
//
// Bound: memory.  Every gathered row is m' floats read from device memory for
// 2 m' flops, far below the card's ~20 flop/byte float32 ridge, and rows are
// scattered, so reuse through L2 is what the data happens to give.
//
// Design: one block per query (grid B), 256 threads.  The block stages its
// query rep in shared memory; each warp takes rows r = warp, warp + 8, ...;
// the warp's lanes read a row coalesced (float4 when m' % 4 == 0 and the base
// pointers are 16-byte aligned, scalar otherwise), reduce with
// __shfl_xor_sync, and lane 0 applies the post-combine.  An id < 0 skips the
// row load.  Unlike the TPU kernel, x_bias is read as its own array: the TPU
// wrapper concatenated rep and bias into one (n, m'+1) copy on every call so
// that one DMA brought both, which at n = 1e6 would copy 516 MB per step.
//
// The epilogue uses __fadd_rn / __fmul_rn so that nvcc does not contract it
// into FMAs: it then rounds exactly like the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPostLinear = 0;
constexpr int kPostRenyi = 1;
constexpr int kPostNeg = 2;
constexpr int kPostL2 = 3;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
frontier_scores_kernel(const int32_t* __restrict__ ids, const float* __restrict__ q_rep,
                       const float* __restrict__ q_bias, const float* __restrict__ x_rep,
                       const float* __restrict__ x_bias, float* __restrict__ out, int R, int m,
                       int post_id, float c0) {
  extern __shared__ __align__(16) float q_s[];
  const int64_t b = blockIdx.x;
  const float* q = q_rep + b * m;
  for (int f = threadIdx.x; f < m; f += kThreads) q_s[f] = q[f];
  __syncthreads();

  const float qb = q_bias[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t* row_ids = ids + b * R;
  float* row_out = out + b * R;

  for (int r = warp; r < R; r += kWarps) {
    const int32_t id = row_ids[r];  // same address in every lane: one broadcast
    float acc = 0.0f;
    if (id >= 0) {  // uniform across the warp
      const float* x = x_rep + static_cast<int64_t>(id) * m;
      if (kVec4) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int f = lane; f < (m >> 2); f += 32) {
          const float4 a = __ldg(x4 + f);
          const float4 c = q4[f];
          acc += a.x * c.x;
          acc += a.y * c.y;
          acc += a.z * c.z;
          acc += a.w * c.w;
        }
      } else {
        for (int f = lane; f < m; f += 32) acc += __ldg(x + f) * q_s[f];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      row_out[r] = id >= 0 ? post_combine(post_id, acc, __ldg(x_bias + id), qb, c0) : INFINITY;
    }
  }
}

template <bool kVec4>
cudaError_t launch(const int32_t* ids, const float* q_rep, const float* q_bias,
                   const float* x_rep, const float* x_bias, float* out, int B, int R, int m,
                   int post_id, float c0, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(frontier_scores_kernel<kVec4>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  frontier_scores_kernel<kVec4><<<B, kThreads, smem, stream>>>(ids, q_rep, q_bias, x_rep,
                                                                x_bias, out, R, m, post_id, c0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int frontier_scores_launch(const int32_t* ids, const float* q_rep,
                                      const float* q_bias, const float* x_rep,
                                      const float* x_bias, float* out, int B, int R, int m,
                                      int post_id, float c0, void* stream) {
  if (B <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(x_rep) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      vec4 ? launch<true>(ids, q_rep, q_bias, x_rep, x_bias, out, B, R, m, post_id, c0, s)
           : launch<false>(ids, q_rep, q_bias, x_rep, x_bias, out, B, R, m, post_id, c0, s);
  return static_cast<int>(err);
}
