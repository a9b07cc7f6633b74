// Neighbor gather + distance per (query, candidate) cell.
//
// Replaces the TPU kernel src/repro/kernels/gather_topk.py::gather_scores
// (Pallas body _kernel, pallas_call at :79).  For ids (B, M) it writes
//     out[b, j] = post(x_rep[ids[b, j]] . q_rep[b], x_bias[ids[b, j]], q_bias[b])
// in float32, with the post-combine of repro_torch/core/distances.py, and
// +inf where ids[b, j] < 0.
//
// Bound: device-memory bytes.  Each cell reads one m'-float row for 2 m'
// flops, far below the float32 ridge, and rows are scattered.  Reaching the
// bytes bound takes about (memory latency x 3.35 TB/s) ~ 2-3 MB of rows in
// flight at every moment; a search block (64 x 240 cells at m' = 128) is
// 7.9 MB in all, so the kernel's fixed costs (the launch, the ids' latency,
// the first row's latency) weigh as much as its bandwidth.
//
// Design.  The first design gave each cell a warp that loaded the cell's id,
// then its row and the query row, then reduced: one 512-byte row in flight
// per warp, two dependent latencies per row, the search block in two waves
// of warps.  This one has two kernels, chosen by the shape:
//   - Runs (gather_scores_kernel): rows of 17 or more words (16-byte words;
//     4-byte words when m' % 4 != 0 or a base is not 16-byte aligned) where
//     a row of ids holds a run of 8 cells (the batched search step's
//     candidate block, in the search and in the wave builder), and rows
//     wider than 32 words where it holds a run of 4.  A warp owns
//     a run of consecutive cells of one row of ids; lane l covers the words
//     l, l + 32, ... of each.  It stages the query's words first (they need
//     no id), loads the run's ids with one coalesced load and passes them to
//     every lane with __shfl_sync, then stages every row of the run in its
//     shared memory with cp.async (16-byte words .cg, past L1: a row is read
//     once) and waits once.  So a warp pays the id latency and the row
//     latency once per run, with 8 rows in flight.  Loads into registers
//     were tried first: ptxas placed each load's products right after it
//     (SASS), leaving about two rows in flight per warp; a copy writes no
//     register, so nothing is scheduled between two of them.  Runs of 16
//     spilled and ran slower than 8; 4 and 8 ran alike.
//   - Wide rows (more than 32 words): runs of 4 cells, staged in
//     chunks of 64 words per cell into two buffers, so that the next
//     chunk's copies are in flight while this chunk's products run.
//     Measured against a single buffer and against staging each row's chunk
//     with Hopper's 1-D bulk copy (cp.async.bulk onto an mbarrier, one
//     issuing lane per row, two buffers): this was the fastest of the three
//     (PERF.md, PR 14).
//   - Cells (gather_cells_kernel): everything else, above all the wave
//     builder's reverse edges (M = 1).  A cell gets G = the power of two >=
//     its words (<= 32) lanes, so a warp scores 32 / G cells per load
//     instruction (4 at m' = 32); each group loads its id, then its row and
//     its query row together into registers, as the first design did with
//     a whole warp.  Runs were measured slower there: at 960 cells their
//     longer per-warp chains (shuffles, staging) cost more than they save.
//     Rows of more than 32 words (G = 32) at M < 4 loop over words, lane l
//     covering l, l + 32, ...: a run there would stage one row beside
//     empty slots.
//   - Sums.  A group reduces with __shfl_xor_sync at offsets G/2 ... 1; a
//     run's sums are reduced by halving (9 shuffles for 8 cells, not 40).
//   - One wave.  The run kernel's grid holds at most the warps the card
//     keeps resident (blocks per SM from the occupancy API, times the SMs),
//     each warp striding over runs; a small grid uses fewer warps per block,
//     so that its warps reach more SMs.
//
// Same sums as the first design, bit for bit: each lane adds its products
// in the same order (four per float4, fused multiply-adds as nvcc contracts
// `acc += a * c`; zero words add exact zeros), the old 32-lane tree beyond
// lane G only added exact zeros, and each halving step adds own + partner's
// as the tree does.  The wave builder's W=1 build is held equal to the
// sequential one on the card; a change of rounding there could flip a
// near-tie.
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
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// One element of a cell's row into shared memory, asynchronously (cp.async;
// zero-filled where pred is false, from a safe address).  A copy writes no
// register, so no product can be scheduled between two of them: every copy
// of a chunk is in flight before the first wait.  16-byte words bypass L1
// (.cg: a database row is read once); 4-byte words may only use .ca.
__device__ __forceinline__ void copy_async(float4* dst, const float4* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the first design's per-lane order: four products per float4, x then y, z, w
__device__ __forceinline__ void dot_acc(float& acc, const float4& a, const float4& c) {
  acc += a.x * c.x;
  acc += a.y * c.y;
  acc += a.z * c.z;
  acc += a.w * c.w;
}

__device__ __forceinline__ void dot_acc(float& acc, float a, float c) { acc += a * c; }

__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }

// p ? a : b as one selp, so that the compiler cannot turn a choice between
// two slots of a register array into an index into local memory
__device__ __forceinline__ float pick(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.f32 %0, %1, %2, q;\n\t}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(p)));
  return r;
}

// a / b for a, b >= 0, in 32 bits where both fit (the common case: a 64-bit
// division is a long subroutine on the warp's critical path)
__device__ __forceinline__ int64_t div_nonneg(int64_t a, int64_t b) {
  if (((a | b) >> 32) == 0) return static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  return a / b;
}

// A warp scores a run of S consecutive cells of one row of ids (so they
// share their query), all 32 lanes on each cell: lane l covers the words l,
// l + 32, ...  V: float4 or float words; F: words per lane per chunk.
template <typename V, int S, int F>
__global__ void __launch_bounds__(kThreads)
gather_scores_kernel(const int32_t* __restrict__ ids, const V* __restrict__ q_rep,
                     const float* __restrict__ q_bias, const V* __restrict__ x_rep,
                     const float* __restrict__ x_bias, float* __restrict__ out, int B, int M,
                     int mv, int post_id, float c0) {
  static_assert(S >= 1 && S <= 32 && (S & (S - 1)) == 0, "a run is a power of two <= 32");
  constexpr int kChunk = 32 * F;  // words of a row per chunk
  const int lane = threadIdx.x & 31;
  const int64_t runs_per_row = (M + S - 1) / S;
  const int64_t runs = B * runs_per_row;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  // the warp's staging words, lane-major (conflict-free 16-byte reads), in
  // two buffers: the next chunk's copies are in flight while this chunk's
  // products run
  __shared__ V xs_all[kWarps][2][S][F][32];
  __shared__ V qs_all[kWarps][2][F][32];
  V(&xs)[2][S][F][32] = xs_all[threadIdx.x >> 5];
  V(&qs)[2][F][32] = qs_all[threadIdx.x >> 5];

  for (int64_t run = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       run < runs; run += warps) {
    // 1. the run: cells first .. first + n - 1 of query row b
    const int64_t b = div_nonneg(run, runs_per_row);
    const int j0 = static_cast<int>(run - b * runs_per_row) * S;
    const int64_t first = b * M + j0;
    const int n = min(S, M - j0);

    // 2. copies of query words need no id: the first chunk's are in flight
    // while the ids arrive
    auto copy_query = [&](int k0, int buf) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int f = k0 + lane + 32 * i;
        copy_async(&qs[buf][i][lane], q_rep + b * mv + (f < mv ? f : 0), f < mv);
      }
    };
    copy_query(0, 0);

    // 3. the run's ids, one per lane (lane t: cell first + t), passed on to
    // every lane; the biases
    const int32_t my_id = lane < n ? __ldg(ids + first + lane) : -1;
    int32_t id[S];
#pragma unroll
    for (int s = 0; s < S; ++s) id[s] = __shfl_sync(kFull, my_id, s);
    float xb = 0.0f, qb = 0.0f;
    if (lane < n) {
      if (my_id >= 0) xb = __ldg(x_bias + my_id);
      qb = __ldg(q_bias + b);
    }

    // 4. every copy of a chunk is issued before its products, and the next
    // chunk's before them too; a lane reads back only the words it copied
    auto copy_rows = [&](int k0, int buf) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int f = k0 + lane + 32 * i;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool ok = id[s] >= 0 && f < mv;
          copy_async(&xs[buf][s][i][lane],
                     x_rep + static_cast<int64_t>(ok ? id[s] : 0) * mv + (ok ? f : 0), ok);
        }
      }
      commit_copies();
    };
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.0f;
    copy_rows(0, 0);
    for (int k0 = 0, buf = 0; k0 < mv; k0 += kChunk, buf ^= 1) {
      if (k0 + kChunk < mv) {
        copy_query(k0 + kChunk, buf ^ 1);
        copy_rows(k0 + kChunk, buf ^ 1);
        wait_copies<1>();
      } else {
        wait_copies<0>();
      }
#pragma unroll
      for (int i = 0; i < F; ++i) {
#pragma unroll
        for (int s = 0; s < S; ++s) dot_acc(acc[s], xs[buf][s][i][lane], qs[buf][i][lane]);
      }
      __syncwarp();  // later copies land where these words were read
    }

    // 5. the sums by halving: at offset off a lane keeps half its slots and
    // adds its partner's sums of them, so S slots take S - 1 + log2(32 / S)
    // shuffles, not 5 S.  Each addition is the butterfly's (own partial +
    // partner's), so the sums are the butterfly's bit for bit.  Lane l ends
    // with slot l / (32 / S); lane t < n takes cell t's.
#pragma unroll
    for (int h = S / 2; h >= 1; h /= 2) {
      const int off = h * (32 / S);
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = pick(upper, acc[i], acc[i + h]);
        acc[i] = pick(upper, acc[i + h], acc[i]) + __shfl_xor_sync(kFull, send, off);
      }
    }
#pragma unroll
    for (int off = 16 / S; off > 0; off >>= 1) acc[0] += __shfl_xor_sync(kFull, acc[0], off);
    const float sum = __shfl_sync(kFull, acc[0], (lane * (32 / S)) & 31);
    if (lane < n) out[first + lane] = my_id < 0 ? INFINITY : post_combine(post_id, sum, xb, qb, c0);
  }
}

// One cell per group of G = 1 << log_g lanes (G = 32 for rows of more than
// 32 words).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_cells_kernel(const int32_t* __restrict__ ids, const V* __restrict__ q_rep,
                    const float* __restrict__ q_bias, const V* __restrict__ x_rep,
                    const float* __restrict__ x_bias, float* __restrict__ out, int64_t cells,
                    int M, int mv, int log_g, int post_id, float c0) {
  const int G = 1 << log_g;
  const int li = threadIdx.x & (G - 1);
  const int64_t cell = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> log_g;
  const bool live = cell < cells;
  const int32_t id = live ? __ldg(ids + cell) : -1;  // one address per group: a broadcast
  const int64_t b = M == 1 ? cell : div_nonneg(cell, M);
  const float xb = id >= 0 && li == 0 ? __ldg(x_bias + id) : 0.0f;
  const float qb = live && li == 0 ? __ldg(q_bias + b) : 0.0f;
  float acc = 0.0f;
  // lane li covers the words li, li + G, ...: one word when words <= G
  for (int f = li; f < mv; f += G) {
    V x, q;
    zero(x);
    zero(q);
    if (id >= 0) x = __ldg(x_rep + static_cast<int64_t>(id) * mv + f);
    if (live) q = __ldg(q_rep + b * mv + f);
    dot_acc(acc, x, q);
  }
  for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (live && li == 0) out[cell] = id < 0 ? INFINITY : post_combine(post_id, acc, xb, qb, c0);
}

// warps per block for a grid of `warps`: fewer for a small grid, so that its
// warps reach more SMs
int warps_per_block(int64_t warps, int sms) {
  const int64_t per = (warps + sms - 1) / sms;
  return per < 1 ? 1 : (per > kWarps ? kWarps : static_cast<int>(per));
}

template <typename V>
cudaError_t launch_cells(const int32_t* ids, const float* q_rep, const float* q_bias,
                         const float* x_rep, const float* x_bias, float* out, int B, int M,
                         int mv, int log_g, int post_id, float c0, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
  }
  const int64_t cells = static_cast<int64_t>(B) * M;
  const int64_t warps = ((cells << log_g) + 31) / 32;
  const int per_block = warps_per_block(warps, sms);
  const int64_t blocks = (warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  gather_cells_kernel<V><<<static_cast<unsigned>(blocks), per_block * 32, 0, stream>>>(
      ids, reinterpret_cast<const V*>(q_rep), q_bias, reinterpret_cast<const V*>(x_rep), x_bias,
      out, cells, M, mv, log_g, post_id, c0);
  return cudaGetLastError();
}

template <typename V, int S, int F>
cudaError_t launch(const int32_t* ids, const float* q_rep, const float* q_bias,
                   const float* x_rep, const float* x_bias, float* out, int B, int M, int mv,
                   int post_id, float c0, cudaStream_t stream) {
  static int resident = 0;  // warps of this instantiation the card holds at once
  static int sms = 0;
  if (resident == 0) {
    int device = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_scores_kernel<V, S, F>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * kWarps * sms;
  }
  const int64_t runs = static_cast<int64_t>(B) * ((M + S - 1) / S);
  const int warps = static_cast<int>(runs < resident ? runs : resident);
  const int per_block = warps_per_block(warps, sms);
  const int blocks = (warps + per_block - 1) / per_block;
  gather_scores_kernel<V, S, F><<<blocks, per_block * 32, 0, stream>>>(
      ids, reinterpret_cast<const V*>(q_rep), q_bias, reinterpret_cast<const V*>(x_rep), x_bias,
      out, B, M, mv, post_id, c0);
  return cudaGetLastError();
}

// Which path: rows of more than 32 words in runs of 4 cells, 2 words per
// lane per chunk, and rows of 17-32 words in runs of 8 cells, where a row of
// ids holds a run; else one cell per group of G lanes.
template <typename V>
cudaError_t launch_v(const int32_t* ids, const float* q_rep, const float* q_bias,
                     const float* x_rep, const float* x_bias, float* out, int B, int M, int mv,
                     int post_id, float c0, cudaStream_t stream) {
  if (mv > 32 && M >= 4) {
    return launch<V, 4, 2>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, mv, post_id, c0,
                           stream);
  }
  int log_g = 0;
  while (log_g < 5 && (1 << log_g) < mv) ++log_g;
  if (log_g == 5 && mv <= 32 && M >= 8) {
    return launch<V, 8, 1>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, mv, post_id, c0,
                           stream);
  }
  return launch_cells<V>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, mv, log_g, post_id, c0,
                         stream);
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
      vec4 ? launch_v<float4>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, m >> 2, post_id, c0, s)
           : launch_v<float>(ids, q_rep, q_bias, x_rep, x_bias, out, B, M, m, post_id, c0, s);
  return static_cast<int>(err);
}
