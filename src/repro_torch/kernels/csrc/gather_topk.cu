// Neighbor gather + distance, one warp per (query, candidate) cell.
//
// Replaces the TPU kernel src/repro/kernels/gather_topk.py::gather_scores
// (Pallas body _kernel, pallas_call at :79).  For ids (B, M) it writes
//     out[b, j] = post(x_rep[ids[b, j]] . q_rep[b], x_bias[ids[b, j]], q_bias[b])
// in float32, with the post-combine of repro_torch/core/distances.py, and
// +inf where ids[b, j] < 0.
//
// Bound: device-memory bytes.  Each cell reads one m'-float row for 2 m'
// flops, far below the float32 ridge, and rows are scattered.
//
// Design: the TPU kernel ran a (B, M) grid of scalar-prefetch steps, one
// DMA'd row per step.  Here each warp owns one cell (8 cells per 256-thread
// block): its lanes stride the m' axis of both the query row and the
// candidate row (float4 when m' % 4 == 0 and both bases are 16-byte
// aligned, scalar otherwise), reduce with __shfl_xor_sync, and lane 0
// applies the post-combine.  Unlike frontier_gather.cu (one block per query,
// the query staged in shared memory, warps looping over the row's
// candidates), no cell shares anything with another: the query row is read
// per cell and left to L1/L2.  Both layouts are kept so that their times at
// one shape can be compared.
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
gather_scores_kernel(const int32_t* __restrict__ ids, const float* __restrict__ q_rep,
                     const float* __restrict__ q_bias, const float* __restrict__ x_rep,
                     const float* __restrict__ x_bias, float* __restrict__ out, int64_t cells,
                     int M, int m, int post_id, float c0) {
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (cell >= cells) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int64_t b = cell / M;
  const int32_t id = ids[cell];  // same address in every lane: one broadcast
  if (id < 0) {
    if (lane == 0) out[cell] = INFINITY;
    return;
  }
  const float* q = q_rep + b * m;
  const float* x = x_rep + static_cast<int64_t>(id) * m;
  float acc = 0.0f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int f = lane; f < (m >> 2); f += 32) {
      const float4 a = __ldg(x4 + f);
      const float4 c = __ldg(q4 + f);
      acc += a.x * c.x;
      acc += a.y * c.y;
      acc += a.z * c.z;
      acc += a.w * c.w;
    }
  } else {
    for (int f = lane; f < m; f += 32) acc += __ldg(x + f) * __ldg(q + f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[cell] = post_combine(post_id, acc, __ldg(x_bias + id), q_bias[b], c0);
}

template <bool kVec4>
cudaError_t launch(const int32_t* ids, const float* q_rep, const float* q_bias,
                   const float* x_rep, const float* x_bias, float* out, int B, int M, int m,
                   int post_id, float c0, cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(B) * M;
  const int64_t blocks = (cells + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  gather_scores_kernel<kVec4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ids, q_rep, q_bias, x_rep, x_bias, out, cells, M, m, post_id, c0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int gather_scores_launch(const int32_t* ids, const float* q_rep, const float* q_bias,
                                    const float* x_rep, const float* x_bias, float* out, int B,
                                    int M, int m, int post_id, float c0, void* stream) {
  if (B <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(x_rep) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(q_rep) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      vec4 ? launch<true>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, m, post_id, c0, s)
           : launch<false>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, m, post_id, c0, s);
  return static_cast<int>(err);
}
