// Fused frontier gather + distance for the batched beam engine and NN-descent.
//
// Replaces the TPU kernel src/repro/kernels/frontier_gather.py::frontier_scores
// (Pallas body _kernel, pallas_call at :95).  Two entries:
//
// frontier_scores: for each query b it gathers the R database rows
// x_rep[ids[b, r]] and their biases x_bias[ids[b, r]], computes
// s = x_rep[id] . q_rep[b] in float32, applies the post-combine of
// repro_torch/core/distances.py (POST_LINEAR / POST_RENYI / POST_NEG /
// POST_L2) and writes +inf where id < 0.  ids and out may have row strides
// (ld_ids, ld_out), so a caller can score a column range of a wider block.
//   Bound: memory.  Every gathered row is m' floats for 2 m' flops, far
//   below the card's float32 ridge, and rows are scattered.
//   Design: block b stages q_rep[b] in shared memory and scores the row's R
//   candidates, one warp per candidate (float4 loads when m' % 4 == 0 and
//   the base is 16-byte aligned, scalar otherwise, reduced with
//   __shfl_xor_sync).  Its caller is NN-descent, where B = n fills the card
//   many times over; the batched search step (B = 64) goes through
//   gather_topk.cu's gather_scores, which keeps a run of rows in flight per
//   warp and, for 16-byte aligned reps, gives the same sums bit for bit.
//   An id < 0 skips the row load.  Unlike the TPU kernel, x_bias is read as
//   its own array: the TPU wrapper concatenated rep and bias into one
//   (n, m'+1) copy on every call so that one DMA brought both, which at
//   n = 1e6 copies 516 MB.
//
// two_hop_scores: the NN-descent round's join adj[adj[i]], grouped by the
// middle node.  For safe_adj (n, K) with ids in [0, n) it writes
//     out[i, a K + b] = post(x_rep[c] . q_rep[i], x_bias[c], q_bias[i]),
//     j = safe_adj[i, a], c = safe_adj[j, b],
// and +inf where c < 0 or c == i (the self loops the round drops).
//   Bound: memory.  Scoring the materialised join row by row fetches the
//   row x_rep[c] once per (i, a, b): each adj[j] block is read once for
//   every i that lists j (about K times per round).  Grouped by j, each
//   block of K rows is read once and each query row once per edge.
//   Design: the wrapper sorts the n K edges (i, a) by j and cuts each j's
//   edges into work items of at most 32 edges, so hubs spread over several
//   blocks and nodes that no edge names cost nothing.  One block per item
//   stages the K rows x_rep[adj[j]] and the item's query rows in shared
//   memory, 128 floats of m' at a time with cp.async (rows padded to an odd
//   number of 16-byte words: no bank conflicts), and computes the 32 x K dot products
//   as a small matrix product: thread (e, g) owns edge e and rows
//   b = g, g + 8, ... (K <= 64), float4 over k.  Each edge's K scores are one
//   contiguous run of its output row.
//
// The epilogues use __fadd_rn / __fmul_rn so that nvcc does not contract
// them into FMAs: they round like the plain PyTorch version.

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
                       int ld_ids, int ld_out, int post_id, float c0) {
  extern __shared__ __align__(16) float q_s[];
  const int64_t b = blockIdx.x;
  const float* q = q_rep + b * m;
  for (int f = threadIdx.x; f < m; f += kThreads) q_s[f] = q[f];
  __syncthreads();

  const float qb = q_bias[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t* row_ids = ids + b * ld_ids;
  float* row_out = out + b * ld_out;

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
                   int ld_ids, int ld_out, int post_id, float c0, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(frontier_scores_kernel<kVec4>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  frontier_scores_kernel<kVec4><<<B, kThreads, smem, stream>>>(
      ids, q_rep, q_bias, x_rep, x_bias, out, R, m, ld_ids, ld_out, post_id, c0);
  return cudaGetLastError();
}

constexpr int kEdges = 32;           // edges per work item (kThreads / 8)
constexpr int kChunk = 128;          // m' staged per pass
constexpr int kStride = kChunk + 4;  // 33 16-byte words: odd, so no bank conflicts

template <int U, bool kVec4>
__global__ void __launch_bounds__(kThreads)
two_hop_kernel(const int32_t* __restrict__ adj, const int32_t* __restrict__ edges,
               const int32_t* __restrict__ items, const float* __restrict__ q_rep,
               const float* __restrict__ q_bias, const float* __restrict__ x_rep,
               const float* __restrict__ x_bias, float* __restrict__ out, int K, int m,
               int ld_out, int post_id, float c0) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                     // (8 U) x kStride: the K rows x_rep[adj[j]]
  float* qs = sm + 8 * U * kStride;   // kEdges x kStride: the item's query rows
  __shared__ int32_t c_s[8 * U];
  __shared__ float xb_s[8 * U];
  __shared__ int32_t i_s[kEdges];
  __shared__ int32_t a_s[kEdges];
  __shared__ float qb_s[kEdges];

  const int tid = threadIdx.x;
  const int64_t j = items[3 * static_cast<int64_t>(blockIdx.x)];
  const int first = items[3 * static_cast<int64_t>(blockIdx.x) + 1];
  const int count = items[3 * static_cast<int64_t>(blockIdx.x) + 2];
  if (tid < K) {
    const int32_t c = adj[j * K + tid];
    c_s[tid] = c;
    xb_s[tid] = c >= 0 ? x_bias[c] : 0.0f;
  }
  if (tid < count) {
    const int32_t e = edges[first + tid];
    const int32_t i = e / K;
    i_s[tid] = i;
    a_s[tid] = e - i * K;
    qb_s[tid] = q_bias[i];
  }
  __syncthreads();

  const int e = tid / 8;  // edge of this thread
  const int g = tid % 8;  // rows g, g + 8, ...
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kc = min(kChunk, m - k0);
    const int kc4 = (kc + 3) / 4;  // float4 words to stage and multiply
    // stage, zero past kc (and for rows c < 0): zeros add nothing.  With
    // 16-byte rows every copy is a cp.async issued back to back (zero-filled
    // where c < 0), so a thread's loads are all in flight at once.
    for (int idx = tid; idx < (K + count) * kc4; idx += kThreads) {
      const int r = idx / kc4;
      const int w = idx % kc4;
      const int64_t src = r < K ? static_cast<int64_t>(c_s[r]) : i_s[r - K];
      const float* base = (r < K ? x_rep : q_rep) + (src < 0 ? 0 : src) * m + k0;
      float* dst = r < K ? xs + r * kStride : qs + (r - K) * kStride;
      if (kVec4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         static_cast<uint32_t>(__cvta_generic_to_shared(dst + 4 * w))),
                     "l"(base + 4 * w), "r"(src < 0 ? 0 : 16)
                     : "memory");
      } else {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (src >= 0) {
          const int k = 4 * w;
          v.x = __ldg(base + k);
          if (k + 1 < kc) v.y = __ldg(base + k + 1);
          if (k + 2 < kc) v.z = __ldg(base + k + 2);
          if (k + 3 < kc) v.w = __ldg(base + k + 3);
        }
        reinterpret_cast<float4*>(dst)[w] = v;
      }
    }
    if (kVec4) {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (e < count) {
      const float4* q4 = reinterpret_cast<const float4*>(qs + e * kStride);
      for (int w = 0; w < kc4; ++w) {
        const float4 a = q4[w];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int b = g + 8 * u;
          if (b < K) {
            const float4 x = reinterpret_cast<const float4*>(xs + b * kStride)[w];
            acc[u] += a.x * x.x;
            acc[u] += a.y * x.y;
            acc[u] += a.z * x.z;
            acc[u] += a.w * x.w;
          }
        }
      }
    }
    __syncthreads();
  }

  if (e < count) {
    const int32_t i = i_s[e];
    float* row = out + static_cast<int64_t>(i) * ld_out + a_s[e] * K;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = g + 8 * u;
      if (b < K) {
        const int32_t c = c_s[b];
        row[b] = (c < 0 || c == i) ? INFINITY : post_combine(post_id, acc[u], xb_s[b], qb_s[e], c0);
      }
    }
  }
}

template <int U, bool kVec4>
cudaError_t launch_two_hop(const int32_t* adj, const int32_t* edges, const int32_t* items,
                           int n_items, const float* q_rep, const float* q_bias,
                           const float* x_rep, const float* x_bias, float* out, int K, int m,
                           int ld_out, int post_id, float c0, cudaStream_t stream) {
  const int smem = (8 * U + kEdges) * kStride * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(two_hop_kernel<U, kVec4>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  two_hop_kernel<U, kVec4><<<n_items, kThreads, smem, stream>>>(
      adj, edges, items, q_rep, q_bias, x_rep, x_bias, out, K, m, ld_out, post_id, c0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries, loaded with ctypes.  Each returns the cudaError_t of the
// launch (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int frontier_scores_launch(const int32_t* ids, const float* q_rep,
                                      const float* q_bias, const float* x_rep,
                                      const float* x_bias, float* out, int B, int R, int m,
                                      int ld_ids, int ld_out, int post_id, float c0,
                                      void* stream) {
  if (B <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(x_rep) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      vec4 ? launch<true>(ids, q_rep, q_bias, x_rep, x_bias, out, B, R, m, ld_ids, ld_out,
                          post_id, c0, s)
           : launch<false>(ids, q_rep, q_bias, x_rep, x_bias, out, B, R, m, ld_ids, ld_out,
                           post_id, c0, s);
  return static_cast<int>(err);
}

// items: (n_items, 3) int32 rows (j, first edge, edge count <= 32) over
// edges, the n K edge ids i K + a sorted by j = adj[i, a].  K <= 64.
extern "C" int two_hop_scores_launch(const int32_t* adj, const int32_t* edges,
                                     const int32_t* items, int n_items, const float* q_rep,
                                     const float* q_bias, const float* x_rep,
                                     const float* x_bias, float* out, int K, int m, int ld_out,
                                     int post_id, float c0, void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || K > 64 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(x_rep) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(q_rep) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (K <= 32) {
    err = vec4 ? launch_two_hop<4, true>(adj, edges, items, n_items, q_rep, q_bias, x_rep,
                                         x_bias, out, K, m, ld_out, post_id, c0, s)
               : launch_two_hop<4, false>(adj, edges, items, n_items, q_rep, q_bias, x_rep,
                                          x_bias, out, K, m, ld_out, post_id, c0, s);
  } else {
    err = vec4 ? launch_two_hop<8, true>(adj, edges, items, n_items, q_rep, q_bias, x_rep,
                                         x_bias, out, K, m, ld_out, post_id, c0, s)
               : launch_two_hop<8, false>(adj, edges, items, n_items, q_rep, q_bias, x_rep,
                                          x_bias, out, K, m, ld_out, post_id, c0, s);
  }
  return static_cast<int>(err);
}
