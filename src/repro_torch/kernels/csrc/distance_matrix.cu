// Distance matrix on Hopper tensor cores, with the post-combine fused into
// the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/distance_matrix.py::distance_matrix
// (Pallas bodies _kernel_whole_k and _kernel_tiled_k, pallas_call at :119 and
// :138).  For queries q_rep (B, m') and database rows x_rep (N, m'), both
// row-major, it writes out (B, N) float32 with
//     out[b, i] = post(q_rep[b] . x_rep[i], x_bias[i], q_bias[b])
// where post is the combine of repro_torch/core/distances.py (POST_LINEAR /
// POST_RENYI / POST_NEG / POST_L2).  Reps are float32 or bfloat16; biases and
// the output are float32.
//
// Bound: at m' = 128 a (B, N) block is 64 multiply-adds per output word, so
// the tensor cores bound it (3 x 2 B N m' operations at 495 TFLOP/s TF32)
// against (B + N) m' input and B N output words at 3.35 TB/s; which line is
// larger depends on the shape (chip_smoke.py's dm_bound prints both).
//
// Design.  out = q_rep @ x_rep^T with both operands K-major (m' contiguous),
// the only layout wgmma takes for tf32.
//   * Precision: float32 reps run as 3xTF32.  Each value x is split into
//     hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and the product
//     is lo.hi + hi.lo + hi.hi with wgmma m64nNk8 .tf32 into a float32
//     accumulator, which is within ~2^-22 of float32 per product.  bf16 reps
//     need no split: one pass of wgmma m64nNk16 .bf16.
//   * Staging: one producer warp keeps a ring of stages in flight with TMA
//     (2-D tiles 128 bytes deep in k, 128-byte swizzle, completion on an
//     mbarrier per stage).  For float32 the consumers rewrite each landed
//     tile as its hi part in place and its lo part beside it (the split is
//     elementwise, so the swizzled layout carries over), fence the generic
//     writes into the async proxy, and only then issue the wgmmas.  The
//     next stage is waited for and split while the current stage's wgmmas
//     run.
//   * Tiles: a 128 x BN output tile at a time, two consumer warpgroups of
//     m64nBN each; BN = 128, or 64 where N <= 64 (build_sharded's stitch has
//     N = 64; its 2-stage ring lets two blocks share an SM).  Blocks are
//     persistent (as many as the card holds at once) and walk the tiles;
//     the ring runs on across tiles, so the producer loads the next tile
//     while the consumers store the last one.
//   * Rounding: the tensor cores' float32 accumulation drifts with the number
//     of wgmma steps it spans (summed over all of m' = 2,100 it missed the
//     1e-5 check by 3x).  So each fold group of 4 k blocks (128 floats, 256
//     bf16 values of k) is summed by the tensor cores on its own and then
//     added to a float32 running sum with __fadd_rn.  Inside a group the
//     next k block's wgmmas are issued before the last one's are waited for.
//     Where m' fits one group (the main path's m' = 128) an instantiation
//     without the running sum runs: its 64 extra live registers spill in
//     the BN = 128 kernel.
//   * Ragged B, N and m' are TMA's out-of-bounds zero fill (zeros add
//     nothing to a dot product) and a masked epilogue; nothing is padded in
//     device memory.  TMA needs 16-byte row strides and bases; where the
//     reps have neither (m' % 4 != 0, bf16: m' % 8 != 0, or a base off a
//     16-byte boundary) the producer warp stages each tile itself: plain
//     loads, zeros out of bounds, stored in the same swizzled layout, fenced
//     into the async proxy before it arrives on the stage's barrier.
//   * Epilogue, one instance per post-combine (chosen once per tile, so the
//     executed code stays small enough for the instruction cache): for
//     BN = 128 and N % 4 == 0 the warpgroup writes 64 x 32 chunks into
//     shared memory in the output's swizzled TMA layout and one thread
//     stores each with TMA, asynchronously, while the next chunk and the
//     next tile are computed; otherwise float2 stores straight from the
//     registers.  The post-combine uses __fadd_rn / __fmul_rn so that nvcc
//     does not contract it into FMAs and it rounds like the plain version.
// The tensor map of each operand is encoded on the host per call, through
// cuTensorMapEncodeTiled taken with cudaGetDriverEntryPoint (no -lcuda), and
// passed as a __grid_constant__ parameter.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPostLinear = 0;
constexpr int kPostRenyi = 1;
constexpr int kPostNeg = 2;
constexpr int kPostL2 = 3;
constexpr float kTiny = 1e-30f;

constexpr int kBM = 128;              // query rows per block: two warpgroups of 64
constexpr int kConsumerWarps = 8;     // warps 0-7: the two consumer warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kRowBytes = 128;        // k depth of a stage: one 128-byte swizzle row
constexpr int kFold = 4;              // k blocks the tensor cores sum before a float32 add

template <typename T, int BN>
struct Config {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // 3xTF32
  static constexpr int kKB = kRowBytes / static_cast<int>(sizeof(T));  // k per stage
  static constexpr int kTileA = kBM * kRowBytes;
  static constexpr int kTileB = BN * kRowBytes;
  static constexpr int kStageBytes = (kTileA + kTileB) * (kSplit ? 2 : 1);
  static constexpr int kStages = BN == 64 ? 2 : (kSplit ? 3 : 4);
  // TMA-store epilogue (BN = 128): per warpgroup two 64 x 32 float buffers
  static constexpr bool kTmaStore = BN == 128;
  static constexpr int kChunkBytes = 64 * kRowBytes;
  static constexpr int kOutBytes = kTmaStore ? 2 * 2 * kChunkBytes : 0;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kOutBytes + 2 * kStages * 8;
  static_assert(kSmem + 2 * BN * 4 <= 232448, "stages exceed the block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One 2-D TMA tile: k coordinate c0 (elements), row coordinate c1.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// layout: 8-row atoms of 128-byte rows, 1024 bytes apart (SBO); the leading
// offset is unused for this layout.  Advancing k by 32 bytes inside the
// swizzle row adds 2 to the start address field.
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One 2-D TMA store of a 128-byte-swizzled box from shared memory, as its
// own bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
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

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


template <typename T, int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (BN == 128) wgmma_tf32_n128(d, da, db, scale_d);
    else wgmma_tf32_n64(d, da, db, scale_d);
  } else {
    if constexpr (BN == 128) wgmma_bf16_n128(d, da, db, scale_d);
    else wgmma_bf16_n64(d, da, db, scale_d);
  }
}

// cvt.rna.tf32.f32 in two integer operations (it is a slow conversion on
// the SM): round the 13 dropped mantissa bits to nearest, ties away from
// zero, on the sign-magnitude bits; a carry into the exponent is the right
// rounding, and inf stays inf.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// hi = tf32(x) written over x, lo = tf32(x - hi) into the twin buffer.
__device__ __forceinline__ void split_tf32(uint8_t* tile, uint8_t* twin, int bytes, int tid) {
  float4* hi = reinterpret_cast<float4*>(tile);
  float4* lo = reinterpret_cast<float4*>(twin);
  for (int i = tid; i < bytes / 16; i += kConsumers) {
    const float4 v = hi[i];
    float4 h, l;
    h.x = to_tf32(v.x);
    h.y = to_tf32(v.y);
    h.z = to_tf32(v.z);
    h.w = to_tf32(v.w);
    l.x = to_tf32(__fsub_rn(v.x, h.x));
    l.y = to_tf32(__fsub_rn(v.y, h.y));
    l.z = to_tf32(__fsub_rn(v.z, h.z));
    l.w = to_tf32(__fsub_rn(v.w, h.w));
    hi[i] = h;
    lo[i] = l;
  }
}

template <int POST>
__device__ __forceinline__ float post_t(float s, float xb, float qb, float c0) {
  if constexpr (POST == kPostLinear) return __fadd_rn(__fadd_rn(s, xb), qb);
  if constexpr (POST == kPostRenyi) return __fmul_rn(logf(fmaxf(s, kTiny)), c0);
  if constexpr (POST == kPostNeg) return -s;
  if constexpr (POST == kPostL2) return __fadd_rn(__fsub_rn(xb, __fmul_rn(2.0f, s)), qb);
  return s;
}

// The epilogue of one tile.  Accumulator layout of wgmma m64nBN: warp w of
// the warpgroup holds rows 16 w + lane / 4 (+ 8); register 4 j + 2 h + c is
// column 8 j + 2 (lane % 4) + c.  xb holds x_bias of the tile's columns,
// qb the thread's two q_bias values (rows row0 and row0 + 8).
template <typename Cfg, int BN, int POST>
__device__ __forceinline__ void store_tile(const float (&tot)[BN / 2], const float* xb,
                                           const float (&qb)[2],
                                           float* __restrict__ out, const CUtensorMap* tm_out,
                                           uint8_t* out_s, int B, int N, int m0, int n0, int tid,
                                           int tma_store_out, float c0) {
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int rl0 = (tid % 128) / 32 * 16 + lane / 4;  // row within the warpgroup's 64
  const int row0 = m0 + wg * 64 + rl0;
  if (Cfg::kTmaStore && tma_store_out) {
    // through shared memory in 64 x 32 chunks laid out as the output's
    // 128-byte-swizzled TMA box; each chunk's store runs asynchronously
    // while the next chunk, and the next tile, are computed
    const bool leader = tid % 128 == 0;
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      uint8_t* buf = out_s + (wg * 2 + (c & 1)) * Cfg::kChunkBytes;
      // the store that last read this buffer (two chunks ago) is done
      if (leader) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * c + jj;
        const int cl = 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = rl0 + 8 * h;
          const float v0 = post_t<POST>(tot[4 * j + 2 * h], xb[cl], qb[h], c0);
          const float v1 = post_t<POST>(tot[4 * j + 2 * h + 1], xb[cl + 1], qb[h], c0);
          const int chunk16 = (2 * jj + (lane % 4) / 2) ^ (rl % 8);
          *reinterpret_cast<float2*>(buf + rl * kRowBytes + chunk16 * 16 + (lane % 2) * 8) =
              make_float2(v0, v1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      // TMA clips rows >= B and columns >= N
      if (leader) tma_store(tm_out, buf, n0 + 32 * c, m0 + 64 * wg);
    }
    return;
  }
  const bool pairs = (N % 2) == 0;  // then (row, col) and (row, col + 1) are 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= B) continue;
    float* row = out + static_cast<int64_t>(r) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * (lane % 4);
      const int col = n0 + cl;
      if (col >= N) continue;
      const float v0 = post_t<POST>(tot[4 * j + 2 * h], xb[cl], qb[h], c0);
      if (col + 1 < N) {
        const float v1 = post_t<POST>(tot[4 * j + 2 * h + 1], xb[cl + 1], qb[h], c0);
        if (pairs) {
          *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          row[col] = v0;
          row[col + 1] = v1;
        }
      } else {
        row[col] = v0;
      }
    }
  }
}

// The producer warp's staging where TMA cannot read the reps: the
// (kRows, 128-byte) box at rows [r0, r0 + kRows) and k [k0, k0 + kKB) of the
// (rows, m) matrix src, zeros out of bounds, in TMA's 128-byte swizzle (the
// 16-byte chunk c of row r at chunk c ^ (r % 8)).  Consecutive lanes read
// consecutive k of a row; each lane keeps kUnroll loads in flight.
template <typename T, int kRows>
__device__ __forceinline__ void stage_box(uint8_t* dst, const T* __restrict__ src, int rows,
                                          int m, int r0, int k0, int lane) {
  using Bits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
  constexpr int kKB = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int kUnroll = 16;
  static_assert((kRows * kKB) % (32 * kUnroll) == 0, "the box is not whole rounds of loads");
  const Bits* in = reinterpret_cast<const Bits*>(src);
  for (int base = lane; base < kRows * kKB; base += 32 * kUnroll) {
    Bits v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + 32 * u;
      const int r = r0 + e / kKB, k = k0 + e % kKB;
      v[u] = r < rows && k < m ? __ldg(in + static_cast<int64_t>(r) * m + k) : Bits(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + 32 * u;
      const int r = e / kKB;
      const int byte = (e % kKB) * static_cast<int>(sizeof(T));
      *reinterpret_cast<Bits*>(dst + r * kRowBytes + (((byte >> 4) ^ (r % 8)) << 4) +
                               (byte & 15)) = v[u];
    }
  }
}

// One epilogue per post-combine, chosen once per tile: inlining all four for
// every output would overflow the instruction cache.
template <typename Cfg, int BN>
__device__ __forceinline__ void store_tile_post(int post_id, const float (&v)[BN / 2],
                                                const float* xb, const float (&qb)[2],
                                                float* __restrict__ out, const CUtensorMap* tm_out,
                                                uint8_t* out_s, int B, int N, int m0, int n0,
                                                int tid, int tma_store_out, float c0) {
  switch (post_id) {
    case kPostLinear:
      store_tile<Cfg, BN, kPostLinear>(v, xb, qb, out, tm_out, out_s, B, N, m0, n0, tid,
                                       tma_store_out, c0);
      break;
    case kPostRenyi:
      store_tile<Cfg, BN, kPostRenyi>(v, xb, qb, out, tm_out, out_s, B, N, m0, n0, tid,
                                      tma_store_out, c0);
      break;
    case kPostNeg:
      store_tile<Cfg, BN, kPostNeg>(v, xb, qb, out, tm_out, out_s, B, N, m0, n0, tid,
                                    tma_store_out, c0);
      break;
    default:
      store_tile<Cfg, BN, kPostL2>(v, xb, qb, out, tm_out, out_s, B, N, m0, n0, tid,
                                   tma_store_out, c0);
  }
}

// kFolds: m' spans more than one fold group, so the groups' sums are added
// in a second register array.  It is an instantiation of its own because
// those 64 extra live registers spill in the BN = 128 kernel, and the
// m' <= 128 kernel (the main path's) must not pay for the spills.
template <typename T, int BN, bool kFolds>
__global__ void __launch_bounds__(kThreads, 1)
distance_matrix_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_out,
                       const T* __restrict__ q_rep, const T* __restrict__ x_rep,
                       const float* __restrict__ q_bias, const float* __restrict__ x_bias,
                       float* __restrict__ out, int B, int N, int m, int by_tma,
                       int tma_store_out, int post_id, float c0) {
  using Cfg = Config<T, BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* out_s = smem + S * Cfg::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + Cfg::kOutBytes);
  uint64_t* empty = full + S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = (m + Cfg::kKB - 1) / Cfg::kKB;
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = tiles_n * ((B + kBM - 1) / kBM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: the block walks tiles blockIdx.x, + gridDim.x, ...; the ring
  // of stages runs on across tiles, so the producer fills the next tile's
  // stages while the consumers store the last one.
  if (warp == kConsumerWarps) {
    if (tma_store_out && lane == 0) prefetch_map(&tm_out);
    if (by_tma && lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_x);
    }
    if (!by_tma || lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM;
        const int n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          uint8_t* stage = smem + s * Cfg::kStageBytes;
          if (by_tma) {
            mbar_expect_tx(full + s, Cfg::kTileA + Cfg::kTileB);
            tma_load(stage, &tm_q, full + s, kb * Cfg::kKB, m0);
            tma_load(stage + Cfg::kTileA, &tm_x, full + s, kb * Cfg::kKB, n0);
          } else {
            // the whole warp stages the tiles; each lane makes its writes
            // visible to the wgmmas' async proxy before lane 0 arrives
            stage_box<T, kBM>(stage, q_rep, B, m, m0, kb * Cfg::kKB, lane);
            stage_box<T, BN>(stage + Cfg::kTileA, x_rep, N, m, n0, kb * Cfg::kKB, lane);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            if (lane == 0) mbar_arrive(full + s);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of a tile
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  float acc[BN / 2];                  // the tensor cores' sum over one fold group of k blocks
  float tot[kFolds ? BN / 2 : 1];     // the tile's sum of the fold groups
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  // wgmma groups left in flight when the next stage is taken up: one, where
  // the ring has a third stage for the split of the next k block to write
  constexpr int kDepth = S >= 3 ? 1 : 0;
  auto release = [&](int it) {  // this warp is done reading stage it % S
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + it % S);
  };

  // wait for stage it to land; for float32, split it into hi / lo and make
  // the generic writes visible to the async proxy (the caller then joins
  // both warpgroups on a named barrier before any wgmma reads it)
  auto prepare = [&](int it) {
    const int s = it % S;
    mbar_wait(full + s, (it / S) & 1);
    __syncwarp();
    if constexpr (Cfg::kSplit) {
      uint8_t* a = smem + s * Cfg::kStageBytes;
      uint8_t* b = a + Cfg::kTileA;
      split_tf32(a, b + Cfg::kTileB, Cfg::kTileA, tid);
      split_tf32(b, b + Cfg::kTileB + Cfg::kTileA, Cfg::kTileB, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  };
  auto join = [&]() {
    if constexpr (Cfg::kSplit) asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  };

  // x_bias of the current tile's columns, double-buffered by tile parity,
  // and this thread's two q_bias values: loaded at a tile's start, read in
  // its epilogue
  __shared__ float xb_s[2][BN];
  const int row0 = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;  // + m0: this thread's rows
  float qb[2];
  int it = 0;
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    const int m0 = (tile / tiles_n) * kBM;
    const int n0 = (tile % tiles_n) * BN;
    if constexpr (kFolds) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) tot[i] = 0.0f;
    }
    if (tid < BN) xb_s[parity][tid] = n0 + tid < N ? x_bias[n0 + tid] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qb[h] = m0 + row0 + 8 * h < B ? q_bias[m0 + row0 + 8 * h] : 0.0f;
    }
    prepare(it);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // xb_s and the split
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % S;
      const int g = kb % kFold;  // place in the fold group
      const bool fold = g == kFold - 1 || kb == nk - 1;
      uint8_t* a_hi = smem + s * Cfg::kStageBytes;
      uint8_t* b_hi = a_hi + Cfg::kTileA;
      const uint64_t da_hi = make_desc(a_hi + wg * 64 * kRowBytes);
      const uint64_t db_hi = make_desc(b_hi);
      wgmma_fence();
      fence_regs(acc);
      if constexpr (Cfg::kSplit) {
        uint8_t* a_lo = b_hi + Cfg::kTileB;
        const uint64_t da_lo = make_desc(a_lo + wg * 64 * kRowBytes);
        const uint64_t db_lo = make_desc(a_lo + Cfg::kTileA);
        // small terms first: lo.hi, hi.lo, then hi.hi; 4 steps of k = 8
#pragma unroll
        for (int k = 0; k < 4; ++k) mma<T, BN>(acc, da_lo + 2 * k, db_hi + 2 * k, g + k > 0);
#pragma unroll
        for (int k = 0; k < 4; ++k) mma<T, BN>(acc, da_hi + 2 * k, db_lo + 2 * k, 1);
#pragma unroll
        for (int k = 0; k < 4; ++k) mma<T, BN>(acc, da_hi + 2 * k, db_hi + 2 * k, 1);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) mma<T, BN>(acc, da_hi + 2 * k, db_hi + 2 * k, g + k > 0);
      }
      wgmma_commit();
      // the next stage lands and is split while the tensor cores work
      if (kb + 1 < nk) prepare(it + 1);
      if (fold) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (kDepth > 0 && g > 0) release(it - 1);
        release(it);
        if constexpr (kFolds) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
        }
      } else {
        wgmma_wait<kDepth>();
        if (kDepth == 0) release(it);
        else if (g > 0) release(it - 1);
      }
      if (kb + 1 < nk) join();
    }

    if constexpr (kFolds) {
      store_tile_post<Cfg, BN>(post_id, tot, xb_s[parity], qb, out, &tm_out, out_s, B, N, m0,
                               n0, tid, tma_store_out, c0);
    } else {
      store_tile_post<Cfg, BN>(post_id, acc, xb_s[parity], qb, out, &tm_out, out_s, B, N, m0,
                               n0, tid, tma_store_out, c0);
    }
  }
  // the block's shared memory must outlive its last stores' reads
  if (Cfg::kTmaStore && tma_store_out && tid % 128 == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (rows, m) row-major matrix as 2-D TMA tiles of box_rows x 128 bytes.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int rows, int m, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / sizeof(T)),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN, bool kFolds>
cudaError_t launch(const void* q_rep, const void* x_rep, const float* q_bias,
                   const float* x_bias, float* out, int B, int N, int m, int post_id, float c0,
                   cudaStream_t stream) {
  using Cfg = Config<T, BN>;
  CUtensorMap tm_q = {}, tm_x = {}, tm_out = {};
  // TMA reads the reps where their rows and bases are whole 16-byte words;
  // otherwise the producer warp stages them
  const int by_tma = (static_cast<size_t>(m) * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q_rep) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x_rep) % 16 == 0;
  if (by_tma && (!encode<T>(&tm_q, q_rep, B, m, kBM) || !encode<T>(&tm_x, x_rep, N, m, BN))) {
    return cudaErrorInvalidValue;
  }
  // the output goes out through TMA where its rows are whole 16-byte words
  const int tma_store_out = Cfg::kTmaStore && N % 4 == 0 &&
                            reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                            encode<float>(&tm_out, out, B, N, 64);
  static int resident = 0;  // blocks of this instantiation the card holds at once
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(distance_matrix_kernel<T, BN, kFolds>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg::kSmem);
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, distance_matrix_kernel<T, BN, kFolds>, kThreads, Cfg::kSmem);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int64_t tiles = static_cast<int64_t>((N + BN - 1) / BN) * ((B + kBM - 1) / kBM);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  distance_matrix_kernel<T, BN, kFolds><<<grid, kThreads, Cfg::kSmem, stream>>>(
      tm_q, tm_x, tm_out, static_cast<const T*>(q_rep), static_cast<const T*>(x_rep), q_bias,
      x_bias, out, B, N, m, by_tma, tma_store_out, post_id, c0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* q_rep, const void* x_rep, const float* q_bias,
                     const float* x_bias, float* out, int B, int N, int m, int post_id, float c0,
                     cudaStream_t stream) {
  const bool folds = (m + Config<T, 128>::kKB - 1) / Config<T, 128>::kKB > kFold;
  if (N <= 64) {
    return folds ? launch<T, 64, true>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id, c0,
                                       stream)
                 : launch<T, 64, false>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id, c0,
                                        stream);
  }
  return folds ? launch<T, 128, true>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id, c0,
                                      stream)
               : launch<T, 128, false>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id, c0,
                                       stream);
}

}  // namespace

// Plain C entry, loaded with ctypes.  dtype 0 = float32 reps, 1 = bfloat16
// reps (biases are float32 either way).  Returns the cudaError_t of the
// launch (0 = cudaSuccess); the launch is asynchronous on `stream`.  Any
// m' >= 1 and any element-aligned base.
extern "C" int distance_matrix_launch(const void* q_rep, const void* x_rep, const float* q_bias,
                                      const float* x_bias, float* out, int B, int N, int m,
                                      int dtype, int post_id, float c0, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch_n<__nv_bfloat16>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id,
                                           c0, s)
                 : launch_n<float>(q_rep, x_rep, q_bias, x_bias, out, B, N, m, post_id, c0, s);
  return static_cast<int>(err);
}
