// Flash attention for Hopper (sm_90a), for grouped K/V heads: the forward
// (out and lse) and the backward's dq (and delta), dk and dv, each without a
// bias, with a dense float32 bias or with T5's table.
//
// The forward:
//
//   s[i, j]  = scale q[i] . k[j]                            (fp32)
//   lse[i]   = log sum over visible j of exp(s[i, j])   (-1e30 if no key)
//   out[i]   = sum_j exp(s[i, j] - lse[i]) v[j]   (p rounded to bf16 first)
//
// Replaces pasero_tpu/ops/flash_attention.py:_fwd_packed_kernel (:261),
// through _fwd_packed (:342), and the bias-free mode of the streamed
// _fwd_stream (:544). What bounds it: operations, two products (QK^T, PV):
// 0.0695 ms at llama_1b's causal (4, 32/4, 2048, 64) against 0.0228 ms of
// bytes. At D = 64 the exponentials take as long again as the products (one
// per score on the special function unit, 16 a cycle per SM, against 4096
// flops a cycle), so the softmax has to overlap the tensor cores. The design
// (fwd_kernel): a block owns 64 NC queries of one query head (three consumer
// warpgroups of 64 rows at D <= 64, two at D = 128), Q resident; a producer
// warp streams the 64-key K and V tiles through a TMA ring with their key
// flags, read one tile ahead; per tile a consumer issues S = Q K^T (m64n64,
// both operands from shared memory) and then P V of the previous tile (P,
// rounded to bf16 as JAX does, as the register A operand in the accumulator
// layout, V read MN-major), and forms the online softmax of this tile (log2
// units, ex2.approx) while that product runs; P is packed, and O rescaled,
// with no product in flight, so ptxas serializes no wgmma. No score tile goes
// through shared memory. The grid runs the last (longest) causal query tiles
// first; key tiles past a consumer's diagonal or below its window are freed
// unread, and fully visible tiles skip the mask arithmetic. GQA: one block
// per query head, K/V re-read from L2 (the bytes bound lies far under the
// operations one). What holds it back: the m64n64 score products read both
// operands from shared memory, and a consumer's exponentials still wait on
// its own score product (the three warpgroups overlap one another only).
//
// The same kernel with T5's table (KIND = T5_BIAS) replaces
// pasero_tpu/ops/flash_attention.py:_fwd_stream_kernel (:474), through
// _fwd_stream (:544) and _flash_t5_fwd (:1369): JAX always streams T5. The
// producer warpgroup's idle warps 1-3 write each tile's bias by diagonal
// (64 NC + 63 values) from the head's table column, staged once per item,
// into the stage beside the K/V tiles, on that stage's barrier; the
// consumers add it to the scaled score and keep the max and lse in natural
// units, the lse that the T5 dq, dk/dv and demb kernels read. Two consumers
// (128 queries an item: a t5_base encoder's 512 queries are four items, its
// decoder's 128 one). At D <= 64 it is persistent, as the T5 backward is:
// one block per SM walks the items in a snake order, its Q tiles
// double-buffered so that the next item's Q loads while this one finishes,
// and each consumer stores its output by TMA from its own Q tile, which the
// item no longer reads; a t5_base encoder item has 8 key tiles and a decoder
// item 2, so filling and draining the pipeline is the cost to hide. The rule
// holds at every length: at 32768 keys an item's 512 tiles make the fill
// negligible, and every bidirectional item is as long as the next, so a
// fixed order loses nothing to the hardware's scheduler. At D = 128 one block
// per item, as in the T5 backward (the TMA-store epilogue takes one 64-column
// box per tile). The bias-free instances keep their code: every bias branch
// is compiled out.
//
// The same kernel with a dense float32 bias (KIND = DENSE_BIAS) replaces
// pasero_tpu/ops/flash_attention.py:_fwd_kernel (:186), through _fwd
// (:381), and the dense-bias mode of the streamed _fwd_stream (:544). What
// bounds it: bytes, the visible half of the bias (at bloom_560m's causal (4,
// 16, 2048) with a per-sample bias 537 MB; 0.1805 ms at 3.35 TB/s with q, k,
// v and out, against 0.0348 ms of products). So the bias streams with the
// K/V tiles, as the dense-bias dq kernel reads it (below): swizzled TMA
// boxes on the tile's barrier with an L2 evict-first hint, the boxes that no
// visible score needs skipped, or cp.async where its rows are not 16-byte
// aligned. Its 32 KB a stage leave room for two consumers and three stages at D <= 64 (two at D
// = 128); the consumers add it to the scaled score and keep natural units,
// as the T5 instance does, and one block per item, the last (longest)
// causal query tiles first, lets the hardware balance items of unequal
// length.
//
// The backward, from the forward's out and lse:
//
//   p[i, j]  = exp(scale q[i] . k[j] - lse[i]) where key j is visible, else 0
//   delta[i] = sum_d dO[i, d] out[i, d]             (fp32 over the bf16 out)
//   dS[i, j] = p[i, j] (dO[i] . v[j] - delta[i])
//   dq = scale dS . k,  dk = scale sum over the group of dS^T . q,
//   dv = sum over the group of p^T . dO           (p and dS rounded to bf16)
//
// with the visibility rules of flash_attention.cu (kv_mask, causal by slot
// index, a sliding window). Replaces the TPU kernels
// pasero_tpu/ops/flash_attention.py:_bwd_dq_packed_kernel (:963) and
// _bwd_dkv_packed_kernel (:1018), through _bwd_packed (:1086), and the
// bias-free mode of the streamed _bwd_stream (:738): one design takes any
// length, as its K/V and Q/dO tiles stream through shared memory.
//
// The same two kernels, instanced by bias kind (KIND, flash_attention.cu's
// NO_BIAS, DENSE_BIAS, T5_BIAS), compute the biased and the T5 backward, the
// bias re-added to the recomputed scores:
//
//   p[i, j]  = exp(scale q[i] . k[j] + bias[i, j] - lse[i])     (natural units)
//
// replacing _bwd_dq_kernel (:866) and _bwd_dkv_kernel (:911), through _bwd
// (:1398), and _bwd_dq_stream_kernel (:618) and _bwd_dkv_stream_kernel
// (:676), through _bwd_stream (:738). The bias is a float32 (b0 h0, Sq, Sk)
// bias read through its row strides (DENSE_BIAS, ALiBi), or T5's (nb, H)
// table and the host's bucket of every distance (T5_BIAS). With a bias the
// exponent is taken as exp2((s scale + b - lse) log2 e), lse unscaled: the
// encoder ALiBi's -1e9 has an ulp of 64, so a change of base before the
// subtraction would lose it (flash_attention.cu); the bias-free instances
// keep their log2 units, and their code: each bias branch is compiled out of
// them. A dense bias costs bytes (at bloom_560m's causal (4, 16, 2048) its
// visible half is 537 MB, 0.160 ms at 3.35 TB/s, per kernel), so it streams
// with the ring: the TMA thread copies each tile's bias with the K/V (dq) or
// Q/dO (dk/dv) tiles, in boxes of 64 rows x 32 keys of a float32 tensor map
// under the 128-byte swizzle (the swizzle keeps the consumers' reads of the
// accumulator layout free of, or at two-way, bank conflicts), with an L2
// evict-first hint, skipping boxes that no visible score needs. A tensor map
// needs 16-byte row strides; at others (rows ld floats apart, ld % 4 != 0;
// the model pads its ALiBi rows to a multiple of 4, ld = Sk otherwise) the
// producer warpgroup's warps 1-3, idle otherwise, copy the bias with 4-byte
// cp.async into the same swizzled layout, each thread's arrival on the
// stage's full barrier counted once its copies land. T5's table costs no
// bytes: per tile those warps write its diagonals (64 + 64 - 1 per 64 x 64)
// from the head's table column, staged once per item (dk/dv: the group's
// columns). The dense bias's 16 KB per 64 x 64 tile share the ring's stages
// with the operands: three stages at D <= 64 and two at D = 128, and two dq
// consumers, not three. The T5 instances at D <= 64 are persistent (see
// `persistent`): one block per SM walks the work items in a snake order,
// its resident tiles double-buffered, each item's outputs stored by TMA
// from the resident tiles it no longer reads, and the next item's per-row
// loads in flight meanwhile; a T5 encoder's 512 keys leave an item 8 tiles,
// and one block per item spent much of its time filling and draining the
// pipeline.
//
// The dbias and demb kernels are flash_attention.cu's; the float32 kernels
// of every kind flash_f32.cu's; the
// PTX wrappers for mbarriers, descriptors and the
// wgmma fences come from wgmma_gemm.cuh (the fused-CE mainloop).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace flash_bwd {

using wgmma_gemm::mbar_arrive;
using wgmma_gemm::mbar_expect_tx;
using wgmma_gemm::mbar_init;
using wgmma_gemm::mbar_wait;
using wgmma_gemm::smem_desc;
using wgmma_gemm::smem_u32;
using wgmma_gemm::wgmma_commit;
using wgmma_gemm::wgmma_fence;
using wgmma_gemm::wgmma_wait;

typedef __nv_bfloat16 bf16;

// What the scores get added, as flash_attention.cu names them: nothing, a
// dense float32 bias, or T5's table.
enum BiasKind : int { NO_BIAS = 0, DENSE_BIAS = 1, T5_BIAS = 2 };

constexpr int THREADS = 384;   // dk/dv: a producer and two consumer warpgroups
constexpr int ROWS = 128;      // dk/dv: a block's resident keys, 64 per consumer
constexpr int TILE = 64;       // rows of a streamed tile
constexpr int MAX_SMEM = 232448;   // shared memory a block can have
constexpr int MAX_BUCKETS = 128;
// Stages of the ring: four at D <= 64 (16 KB of tiles each), three at D =
// 128 (32 KB); with a dense bias, whose boxes ride the same stages (32 KB
// more each), three and two.
template <int DP, int KIND = NO_BIAS>
__host__ __device__ constexpr int stages() {
  return KIND == DENSE_BIAS ? (DP == 64 ? 3 : 2) : (DP == 64 ? 4 : 3);
}
// A stage's dense bias in shared memory: boxes of 64 rows (queries) x 32
// keys (8 KB) as a TMA box of a float32 tensor map lands them under the
// 128-byte swizzle (row r's 16-byte chunk c at chunk c ^ (r % 8)); dq's
// stage holds 2 NC boxes (the block's 64 NC queries x 64 keys), dk/dv's 4
// (64 queries x the block's 128 keys). The swizzle keeps the consumers'
// reads free of bank conflicts down a column (dk/dv) and at two ways for
// float2 pairs along a row (dq); rows without padding would take eight.
constexpr int BOX = 64 * 32;   // floats of a bias box
// Threads of the producer warpgroup's warps 1-3, which stage the bias.
constexpr int BIAS_THREADS = 96;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;   // the lse of a row that sees no key

// -- PTX wrappers ----------------------------------------------------------------

// A 3-D box (64 columns, 64 rows, 1) of a tensor map into shared memory,
// counted on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// tma_load_3d with an L2 cache policy (evict_first_policy).
__device__ __forceinline__ void tma_load_3d_hint(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                 int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "l"(policy)
      : "memory");
}

// A 3-D box (64 columns, 64 rows, 1) from shared memory into a tensor map's
// array, as one bulk group; the caller waits for its reads (store_wait_read)
// before the tile is written again.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// This thread's writes to shared memory made visible to the TMA unit.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The 128 threads of consumer warpgroup g only (named barrier 2 + g).
__device__ __forceinline__ void consumer_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16) . B (64 x 16)^T, both read from shared
// memory K-major; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers, the accumulator layout
// of a score tile packed by pack_a) . B (64 x 16)^T, B read from shared memory
// MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers, the accumulator layout
// of a score tile packed by pack_a) . B (128 x 16)^T, B read from shared memory
// MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, desc_b);
  else
    wgmma_rs_n128(d, a, desc_b);
}

// Keep the compiler from moving uses of registers across an asynchronous
// wgmma that reads or writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// -- tiles -----------------------------------------------------------------------

// A 64-row tile of DP bf16 columns: DP / 64 atoms of 64 rows x 128 bytes,
// 128-byte swizzled, 8 KB apart.
template <int DP>
__host__ __device__ constexpr int tile_bytes() { return 64 * DP * 2; }

// A consumer thread's part of a 64 x 64 fp32 accumulator (the m64n64 layout,
// its first eight rows times s0, the next eight times s1) as bf16 into the 64-row tile at `tile`, in the 128-byte
// swizzled layout that a tensor map's box holds (row r's 16-byte chunk j at
// chunk j ^ (r % 8); the eight rows of a warp's store fall on distinct
// chunks, so no bank conflicts).
__device__ __forceinline__ void stage_tile(unsigned char* tile, const float (&acc)[32], float s0,
                                           float s1, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + lane / 4 + 8 * r;
    const float scale = r ? s1 : s0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tile + row * 128 + ((j ^ (lane / 4)) << 4) +
                                          (lane % 4) * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}
__device__ __forceinline__ void stage_tile(unsigned char* tile, const float (&acc)[32], float scale,
                                           int warp, int lane) {
  stage_tile(tile, acc, scale, scale, warp, lane);
}

// Rows [r0, r0 + 64) of matrix z of a (D, rows, planes) tensor map.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int r0, int z) {
#pragma unroll
  for (int a = 0; a < DP / 64; ++a) tma_load_3d(dst + a * 8192, map, bar, a * 64, r0, z);
}

// The descriptor of a tile read K-major (its columns are the depth): the
// 16-column slice kd.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kd) {
  return smem_desc(tile + (kd >> 2) * 8192 + (kd & 3) * 32, 16, 1024);
}
// The descriptor of a tile read MN-major (its rows are the depth): the
// 16-row slice kr; the next 64 columns are the next atom.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kr) {
  return smem_desc(tile + kr * 2048, 8192, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The four 16-deep A slices (bf16) of a 64 x 64 fp32 score tile held in the
// wgmma accumulator layout: slice kk covers its columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Element i of a thread's accumulator of an m64nN tile lies at row
// 16 warp + lane / 4 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (lane % 4)
// + (i & 1) of its warpgroup's 64 rows.
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The dq kernel's consumer warpgroups: three at D <= 64, whose registers
// allow it (a producer with 24 and three consumers with 160 fill the SM's
// 65536), so two of them keep the tensor cores busy while one forms P and
// dS; two at D = 128 (232 registers each), two with a dense bias, whose
// 16 KB tile per consumer and stage leaves no room for a third, and two
// with T5's table (a persistent item's state does not fit 160 registers,
// and T5's 512 queries are four items of 128).
template <int DP, int KIND = NO_BIAS>
__host__ __device__ constexpr int dq_consumers() {
  return DP == 64 && KIND == NO_BIAS ? 3 : 2;
}

// Floats of a stage's bias: DENSE_BIAS the tile's float32 bias (padded rows),
// T5_BIAS its bias by diagonal (R + C - 1 values of an R x C tile, rounded
// up). dq's tile: the block's 64 NC queries x 64 keys; dk/dv's: 64 queries x
// the block's 128 keys.
template <int KIND, int NC>
__host__ __device__ constexpr int dq_bias_floats() {
  return KIND == DENSE_BIAS ? 2 * NC * BOX : KIND == T5_BIAS ? 64 * NC + 64 : 0;
}
template <int KIND>
__host__ __device__ constexpr int dkv_bias_floats() {
  return KIND == DENSE_BIAS ? ROWS / 32 * BOX : KIND == T5_BIAS ? 64 + ROWS : 0;
}
// Arrivals on a stage's full barrier besides the copies' and the producer
// warp's: each bias-copying thread's (DENSE_BIAS without a tensor map; with
// one the bias boxes count among the copies), each diagonal warp's
// (T5_BIAS).
template <int KIND>
__device__ __forceinline__ int bias_arrivals(bool tma) {
  return KIND == DENSE_BIAS ? (tma ? 0 : BIAS_THREADS) : KIND == T5_BIAS ? BIAS_THREADS / 32 : 0;
}

// Whether an instance is persistent: one block per SM walks the work items,
// its resident tiles double-buffered so that the next item's copies and the
// last item's stores overlap the products. The T5 instances at D <= 64 are:
// a T5 encoder's 512 keys leave an item 8 tiles, and one block per item
// spent much of its time filling and draining the pipeline. Otherwise one
// block per item: the dense bias's causal items differ in length, which the
// hardware's block scheduler balances better than a fixed order.
template <int KIND, int DP>
__host__ __device__ constexpr bool persistent() {
  return KIND == T5_BIAS && DP == 64;
}

// Shared memory of a kernel with NC consumer warpgroups: 2 NC resident tiles
// (a 64-row part of each of two operands per consumer; twice in a
// persistent instance), the stages of two streamed tiles each, BF floats of
// bias a stage, 128 floats a stage staged by the producer warp, the
// barriers, and 1024 bytes to align. T5's table columns come on top (nb
// floats each).
template <int KIND, int DP, int NC, int BF>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int ST = stages<DP, KIND>();
  constexpr int RB = persistent<KIND, DP>() ? 2 : 1;   // buffers of the resident tiles
  return (size_t)(2 * NC * RB + 2 * ST) * tile_bytes<DP>() + ST * BF * 4 + ST * 128 * 4 +
         8 * (2 * ST + (RB == 2 ? 4 : 1)) + 1024;
}

// The bias operands: a dense float32 bias of (b0 h0, Sq, Sk) rows ld floats
// apart (ld >= Sk), the rows of (b, h) from plane b bs + h hs, read by TMA
// boxes (tma: ld % 4 == 0, 16-byte aligned rows) or else by cp.async; or
// T5's float32 (nb, H) table and the int32
// bucket of every distance (Sq + Sk - 1 entries, entry k - q + Sq - 1 for
// query q and key k, from the host).
struct Bias {
  const float* rows;
  int bs, hs, ld, tma;
  const float* table;
  const int* index;
  int nb;
};

// A bias byte is read once: its copies ask L2 to evict it first, so that it
// does not push out the Q, K, V and dO tiles that other blocks read again.
// (The L2 policy operand of cp.async and of the TMA copies.)
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "l"(policy)
               : "memory");
}
// One arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// The bias-staging threads (the producer's warps 1-3) only.
__device__ __forceinline__ void bias_threads_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(BIAS_THREADS) : "memory");
}

// The float offset of element (row r, key c) of a stage's dense bias whose
// rows hold C keys, in the TMA boxes' swizzled layout.
template <int C>
__device__ __forceinline__ int bias_at(int r, int c) {
  const int rr = r % 64, cc = c % 32;
  return ((r / 64) * (C / 32) + c / 32) * BOX + rr * 32 + ((cc / 4) ^ (rr % 8)) * 4 + cc % 4;
}

// DENSE_BIAS by TMA: whether the bias box of rows (queries) [r, r + 64) and
// keys [c, c + 32) holds an element of a visible score. A box that does not
// is not copied: the consumers read only visible elements' bias.
__device__ __forceinline__ bool box_needed(int r, int c, int Sq, int Sk, int causal,
                                           int window) {
  bool need = r < Sq && c < Sk;
  if (causal) need = need && c <= r + 63;
  if (window > 0) need = need && r - (c + 31) < window;
  return need;
}

// DENSE_BIAS without a tensor map (ld % 4 != 0), by the bias-staging thread
// t: the R x C block at row r0 (a query), key c0 of the (Sq, Sk) float32
// bias `src`, its rows ld floats apart, into the boxes' layout at `dst`, by
// 4-byte cp.async; a warp
// copies 32 consecutive keys of a row, a thread keeps its keys and steps
// down the rows. Elements of no visible score are not copied.
template <int R, int C>
__device__ __forceinline__ void copy_bias(uint32_t dst, const float* __restrict__ src, int r0,
                                          int c0, int Sq, int Sk, int ld, int causal, int window,
                                          int t, uint64_t policy) {
  for (int c = t % 32; c < C; c += 32) {
    const int key = c0 + c;
    if (key >= Sk) break;
    for (int r = t / 32; r < R && r0 + r < Sq; r += BIAS_THREADS / 32) {
      const int row = r0 + r;
      bool need = true;
      if (causal) need = key <= row;
      if (window > 0) need = need && row - key < window;
      if (need) cp_async4(dst + bias_at<C>(r, c) * 4, src + (int64_t)row * ld + key, policy);
    }
  }
}

// T5_BIAS, by the bias-staging thread t: the n diagonals of a tile, bd[i] =
// col[index[base + i]] (0 where the distance falls outside the index's
// `length` entries: a slot past Sq or Sk, masked anyway), from a table column
// in shared memory.
__device__ __forceinline__ void t5_diagonals(float* bd, int n, const float* col,
                                             const int* __restrict__ index, int base, int length,
                                             int t) {
  for (int i = t; i < n; i += BIAS_THREADS) {
    const int at = base + i;
    const int bucket = at >= 0 && at < length ? index[at] : -1;
    bd[i] = bucket >= 0 ? col[bucket] : 0.f;
  }
}

// The bias of accumulator elements 2 j and 2 j + 1 of a dq consumer's thread
// (its row 8 (j & 1) past its first, keys 8 (j >> 1) and one more past its
// first), from the thread's pointer into a stage's bias: DENSE_BIAS a float2
// of the boxes' layout (off: the swizzled offsets of the thread's keys in
// each 32-key box, by 8-key group), T5_BIAS two diagonals.
template <int KIND>
__device__ __forceinline__ float2 dq_bias2(const float* bt, int j, const int (&off)[4]) {
  if constexpr (KIND == DENSE_BIAS)
    return *reinterpret_cast<const float2*>(bt + (j >> 3) * BOX + (j & 1) * 8 * 32 +
                                            off[(j >> 1) & 3]);
  else
    return make_float2(bt[8 * (j >> 1) - 8 * (j & 1)], bt[8 * (j >> 1) - 8 * (j & 1) + 1]);
}
// The bias of accumulator element i of a dk/dv consumer's thread (its key
// row 8 ((i >> 1) & 1) past its first, query column 8 (i >> 2) + (i & 1)
// past its first), from the thread's pointer into a stage's bias: DENSE_BIAS
// from the boxes' layout (off: the swizzled offsets by key row and query
// column parity), T5_BIAS a diagonal.
template <int KIND>
__device__ __forceinline__ float dkv_bias(const float* bt, int i, const int (&off)[4]) {
  if constexpr (KIND == DENSE_BIAS)
    return bt[8 * 32 * (i >> 2) + off[i & 3]];
  else
    return bt[8 * ((i >> 1) & 1) - 8 * (i >> 2) - (i & 1)];
}

// 2^x by the special function unit (ex2.approx.ftz: results below 2^-126
// flush to zero, far inside the error model).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- work items ----------------------------------------------------------------------

// The n-th work item of this block (> every item once the block has none
// left): one per block, or, persistent, items dealt to the G blocks in a
// snake order (block i takes i, 2 G - 1 - i, 2 G + i, ...), so that each
// block's items mix long and short ones.
template <bool PERSIST>
__device__ __forceinline__ int work_item(int n) {
  if (!PERSIST) return n == 0 ? (int)blockIdx.x : 0x7fffffff;
  const int G = gridDim.x;
  return n * G + (n & 1 ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// A work item of the forward and of dq: query head bh = w % (B H) = b H + h,
// the 64 NC queries q0 = (n - 1 - w / (B H)) 64 NC .. (the last, longest
// tiles first), their key tiles kt0 .. kt0 + iters.
struct QueryItem {
  int bh, b, h, bk, q0, kt0, iters;
};

__device__ __forceinline__ QueryItem query_item(int w, int B, int H, int Hkv, int Sq, int Sk,
                                                int rows, int causal, int window) {
  const int nqb = (Sq + rows - 1) / rows;
  QueryItem x;
  x.bh = w % (B * H);
  x.b = x.bh / H;
  x.h = x.bh % H;
  x.bk = x.b * Hkv + x.h / (H / Hkv);
  x.q0 = (nqb - 1 - w / (B * H)) * rows;
  int kt1 = (Sk + TILE - 1) / TILE;
  x.kt0 = 0;
  if (causal) kt1 = min(kt1, (x.q0 + rows - 1) / TILE + 1);
  if (window > 0) x.kt0 = max(0, (x.q0 - window + 1) / TILE);
  x.iters = max(0, kt1 - x.kt0);
  return x;
}

// -- forward -----------------------------------------------------------------------

// The forward's consumer warpgroups: three at D <= 64 without a bias (160
// registers hold a score tile, the packed P and the output), two at D = 128
// (232), two with a dense bias (its 16 KB a consumer and stage leave no room
// for a third), and two with T5's table (T5's 512 queries are four items of
// 128, and a persistent item's state does not fit 160 registers).
template <int DP, int KIND = NO_BIAS>
__host__ __device__ constexpr int fwd_consumers() { return DP == 64 && KIND == NO_BIAS ? 3 : 2; }

// Floats of a forward stage's bias, as dq's: a dense bias's boxes for the
// block's 64 NC queries x 64 keys, or T5's by diagonal (64 NC + 63, rounded
// up); none without a bias.
template <int KIND, int NC>
__host__ __device__ constexpr int fwd_bias_floats() {
  return dq_bias_floats<KIND, NC>();
}

// Shared memory of the forward: NC resident Q tiles (twice in a persistent
// instance), the stages of the K and V tiles, BF floats of bias a stage, 128
// ints a stage (the producer warp's key flags), the barriers, and 1024 bytes
// to align. T5's table column comes on top (nb floats).
template <int KIND, int DP, int NC>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  constexpr int ST = stages<DP, KIND>();
  constexpr int QB = persistent<KIND, DP>() ? 2 : 1;   // buffers of the resident Q tiles
  return (size_t)(NC * QB + 2 * ST) * tile_bytes<DP>() + ST * fwd_bias_floats<KIND, NC>() * 4 +
         ST * 128 * 4 + 8 * (QB + 2 * ST + (QB == 2 ? QB : 0)) + 1024;
}

// Item w (query_item): block tile t is key tile kt0 + t; consumer g reads
// the tiles [t0, t1) that its 64 rows can see and frees the others' stages
// unread. Per tile it runs S = Q K^T (m64n64, both operands from shared
// memory) and O += P V (P from registers in the accumulator layout, V read
// MN-major), with the online softmax between them; P V of tile t - 1 is in
// flight while it forms P of tile t. Without a bias the softmax runs in log2
// units. With T5's table (KIND = T5_BIAS) the producer warpgroup's warps 1-3
// write each tile's bias by diagonal (64 NC + 63 values) from the head's
// table column, staged once per item, into the stage beside the K/V tiles,
// on that stage's barrier; the consumers add it to the scaled score and keep
// the max and lse in natural units (exp2((s scale + b - m) log2 e)), the lse
// that dq_kernel, dkv_kernel and flash_attention.cu's demb_kernel read. The
// T5 instance at D <= 64 is persistent (see `persistent`): one block per SM
// walks the items in a snake order, its Q tiles double-buffered so that the
// next item's Q loads while this one finishes, and each consumer stores its
// output by TMA from its own Q tile, which the item no longer reads. With a
// dense bias (KIND = DENSE_BIAS) each K/V tile's bias rides its stage as in
// dq_kernel: the TMA thread copies the swizzled boxes that visible scores
// need on the tile's barrier, or, without a tensor map (ld % 4 != 0), the
// producer warpgroup's warps 1-3 copy the visible elements by cp.async; the
// consumers add it to the scaled score before the mask (an element of no
// visible score may hold bias never copied) and keep natural units, the lse
// that the dense-bias dq, dk/dv and flash_attention.cu's dbias_kernel read.
// One block per item: causal items differ in length.
template <int KIND, int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_o,
               const uint8_t* __restrict__ kv_mask, const Bias bias, bf16* __restrict__ out,
               float* __restrict__ lse, int B, int D, int H, int Hkv, int Sq, int Sk, float scale,
               int causal, int window) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int ACC = DP / 2;
  constexpr int STAGES = stages<DP, KIND>();
  constexpr int ROWS_NC = 64 * NC;
  constexpr int BF = fwd_bias_floats<KIND, NC>();
  constexpr bool PERSIST = persistent<KIND, DP>();
  constexpr int QB = PERSIST ? 2 : 1;   // buffers of the resident Q tiles
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // buffer p: NC Q tiles at q_s + NC p TB
  const uint32_t q_s = base, st_s = base + QB * NC * TB;
  // after the tiles: the stages' bias, the key flags, the barriers, T5's
  // table column
  const uint32_t bias_s = st_s + STAGES * 2 * TB;
  float* bias_f = reinterpret_cast<float*>(smem_raw + (bias_s - raw));
  int* flags = reinterpret_cast<int*>(smem_raw + (bias_s + STAGES * BF * 4 - raw));
  const uint32_t bars = bias_s + STAGES * BF * 4 + STAGES * 128 * 4;
  const uint32_t ready = bars, full = ready + 8 * QB, empty = full + 8 * STAGES;
  const uint32_t qfree = empty + 8 * STAGES;   // persistent: Q buffer p read
  float* col = reinterpret_cast<float*>(smem_raw + (qfree + 8 * (PERSIST ? QB : 0) - raw));

  const int items = B * H * ((Sq + ROWS_NC - 1) / ROWS_NC);
  auto item = [&](int w) {
    return query_item(w, B, H, Hkv, Sq, Sk, ROWS_NC, causal, window);
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < QB; ++p) {
      mbar_init(ready + 8 * p, 1);
      if (PERSIST) mbar_init(qfree + 8 * p, NC);   // each consumer's output store
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the copies' arrival, the key flags', the bias's
      mbar_init(full + 8 * s, 2 + bias_arrivals<KIND>(bias.tma));
      mbar_init(empty + 8 * s, 4 * NC);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) {
      // T5: the diagonal warps, each tile's bias by diagonal into its stage
      if constexpr (KIND == T5_BIAS) {
        const int t = threadIdx.x - 32;
        int gi = 0;   // the ring's tiles so far
        for (int n = 0;; ++n) {
          const int w = work_item<PERSIST>(n);
          if (w >= items) break;
          const QueryItem x = item(w);
          if (n > 0) bias_threads_sync();   // the last item's diagonals read the column
          for (int c = t; c < bias.nb; c += BIAS_THREADS) col[c] = bias.table[c * H + x.h];
          bias_threads_sync();
          for (int it = 0; it < x.iters; ++it, ++gi) {
            const int s = gi % STAGES, k0 = (x.kt0 + it) * TILE;
            mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
            t5_diagonals(bias_f + s * BF, ROWS_NC + TILE - 1, col, bias.index,
                         k0 - x.q0 - (ROWS_NC - 1) + Sq - 1, Sq + Sk - 1, t);
            __syncwarp();
            if (t % 32 == 0) mbar_arrive(full + 8 * s);
          }
        }
      }
      // a dense bias without a tensor map: the block's 64 NC x 64 bias of
      // each tile by cp.async (the TMA thread copies one that has a map)
      if constexpr (KIND == DENSE_BIAS) {
        if (!bias.tma) {
          const int t = threadIdx.x - 32;
          const uint64_t policy = evict_first_policy();
          const QueryItem x = item(blockIdx.x);
          const float* src =
              bias.rows + ((int64_t)x.b * bias.bs + (int64_t)x.h * bias.hs) * Sq * bias.ld;
          for (int it = 0; it < x.iters; ++it) {
            const int s = it % STAGES, k0 = (x.kt0 + it) * TILE;
            mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            copy_bias<ROWS_NC, TILE>(bias_s + s * BF * 4, src, x.q0, k0, Sq, Sk, bias.ld, causal,
                                     window, t, policy);
            cp_async_arrive(full + 8 * s);
          }
          cp_async_wait_all();
        }
      }
      return;
    }
    const int lane = threadIdx.x;
    uint64_t policy = 0;   // DENSE_BIAS by TMA: the bias's L2 policy
    if constexpr (KIND == DENSE_BIAS) policy = evict_first_policy();
    // the n-th item of the block, item w, its tiles from the gi-th on
    auto produce = [&](int n, int w, int& gi) {
      const QueryItem x = item(w);
      const int p = n % QB;
      if constexpr (PERSIST) mbar_wait(qfree + 8 * p, ((n / QB) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ready + 8 * p, NC * TB);
        for (int g = 0; g < NC; ++g)
          load_tile<DP>(q_s + (NC * p + g) * TB, &map_q, ready + 8 * p, x.q0 + 64 * g, x.bh);
      }
      const uint8_t* mg = kv_mask + (int64_t)x.b * Sk;
      const int plane = x.b * bias.bs + x.h * bias.hs;   // DENSE_BIAS by TMA
      // the lane's keys of item tile it, read a tile ahead so that their
      // latency hides behind the wait for a free stage
      auto keys = [&](int it, bool (&ok)[2]) {
        const int k0 = (x.kt0 + it) * TILE;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = k0 + lane + 32 * j;
          ok[j] = it < x.iters && i < Sk && mg[i];
        }
      };
      bool ok[2], next[2];
      keys(0, ok);
      for (int it = 0; it < x.iters; ++it, ++gi) {
        const int s = gi % STAGES, k0 = (x.kt0 + it) * TILE;
        keys(it + 1, next);
        mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
        if (lane == 0) {
          // DENSE_BIAS by TMA: the boxes (consumer g, 32-key half hf) that
          // visible scores need, on the K/V tiles' barrier
          uint32_t boxes = 0;
          if constexpr (KIND == DENSE_BIAS) {
            if (bias.tma)
              for (int g = 0; g < NC; ++g)
                for (int hf = 0; hf < 2; ++hf)
                  if (box_needed(x.q0 + 64 * g, k0 + 32 * hf, Sq, Sk, causal, window))
                    boxes |= 1u << (2 * g + hf);
          }
          mbar_expect_tx(full + 8 * s, 2 * TB + __popc(boxes) * BOX * 4);
          load_tile<DP>(st_s + s * 2 * TB, &map_k, full + 8 * s, k0, x.bk);
          load_tile<DP>(st_s + s * 2 * TB + TB, &map_v, full + 8 * s, k0, x.bk);
          if constexpr (KIND == DENSE_BIAS) {
            for (int b2 = 0; b2 < 2 * NC; ++b2)
              if (boxes >> b2 & 1)
                tma_load_3d_hint(bias_s + (s * BF + b2 * BOX) * 4, &map_b, full + 8 * s,
                                 k0 + 32 * (b2 & 1), x.q0 + 64 * (b2 >> 1), plane, policy);
          }
        }
        bool all = true;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          flags[s * 128 + lane + 32 * j] = ok[j];
          all = all && ok[j];
          ok[j] = next[j];
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) flags[s * 128 + TILE] = all;   // no key of the tile masked
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * s);
      }
    };
    int gi = 0;   // the ring's tiles so far
    if constexpr (PERSIST) {
      for (int n = 0, w = work_item<true>(0); w < items; w = work_item<true>(++n))
        produce(n, w, gi);
    } else {
      produce(0, blockIdx.x, gi);
    }
    return;
  }

  if constexpr (NC == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // the thread's bias in stage 0, as in dq_kernel: DENSE_BIAS its first row
  // in its consumer's boxes and the swizzled offsets of its keys by 8-key
  // group of a box, T5_BIAS the diagonal of its first element
  const float* bias_t = bias_f;
  int boff[4] = {0, 0, 0, 0};
  if constexpr (KIND == DENSE_BIAS) {
    bias_t += 2 * g * BOX + (16 * warp + lane / 4) * 32;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      boff[a] = ((2 * a + (lane % 4) / 2) ^ (lane / 4)) * 4 + (lane % 2) * 2;
  }
  if constexpr (KIND == T5_BIAS)
    bias_t += 2 * (lane % 4) - (64 * g + 16 * warp + lane / 4) + ROWS_NC - 1;
  const float sl2 = scale * LOG2E;

  // The n-th item of the block, item w: its tiles through the ring from the
  // gi-th on; persistent, the output stored by TMA and the Q buffer released.
  auto consume = [&](int n, int w, int& gi) {
    const QueryItem x = item(w);
    const int p = n % QB;
    const int row0 = x.q0 + 64 * g + 16 * warp + lane / 4;   // rows row0, row0 + 8
    // the key tiles this consumer's rows can see, as item tiles [t0, t1)
    const int first = x.q0 + 64 * g;
    int c0 = x.kt0, c1 = x.kt0 + x.iters;
    if (causal) c1 = min(c1, (first + 63) / TILE + 1);
    if (window > 0) c0 = max(c0, (first - window + 1) / TILE);
    if (first >= Sq) c1 = c0;
    const int t0 = min(c0 - x.kt0, x.iters), t1 = max(t0, min(c1 - x.kt0, x.iters));
    // a tile read by no product of this consumer: its stage is freed once it
    // has landed (so the arrival counts for this tile's phase)
    auto pass = [&](int t) {
      const int s = (gi + t) % STAGES;
      mbar_wait(full + 8 * s, ((gi + t) / STAGES) & 1);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    };
    for (int t = 0; t < t0; ++t) pass(t);

    float o[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) o[i] = 0.f;
    // running row max: log2 units without a bias, natural units with one
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};   // this thread's part of the row sum
    const uint32_t qt = q_s + (NC * p + g) * TB;
    // the Q tile's descriptors, computed once for the item's tiles and held
    // in registers (left to itself ptxas recomputes them before every score
    // product, between the wgmmas)
    uint64_t qd[DP / 16];
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      qd[kd] = desc_k(qt, kd);
      asm volatile("" : "+l"(qd[kd]));
    }
    uint32_t pa[4][4];
    float sc[32];
    float alpha[2];

    // the softmax of tile t over its scores S(t) in sc: P(t) in sc (fp32), l
    // and m updated, alpha the factor that takes O to the new max
    auto softmax = [&](int t) {
      const int s = (gi + t) % STAGES, k0 = (x.kt0 + t) * TILE;
      const int* fl = flags + s * 128;
      if constexpr (KIND == DENSE_BIAS) {
        // the scaled score plus the bias, natural units, before the mask
        const float* bt = bias_t + s * BF;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bb = dq_bias2<KIND>(bt, j, boff);
          sc[2 * j] = fmaf(sc[2 * j], scale, bb.x);
          sc[2 * j + 1] = fmaf(sc[2 * j + 1], scale, bb.y);
        }
      }
      // no element of the warp's rows masked: every key present, rows inside
      // Sq, the causal edge and the window clear of the tile
      bool clear = fl[TILE] && row0 + 8 < Sq;
      if (causal) clear = clear && k0 + TILE - 1 <= row0;
      if (window > 0) clear = clear && row0 + 8 - k0 < window;
      if (!__all_sync(0xffffffffu, clear)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1, ci = acc_col(i, lane);
          const int row = row0 + 8 * r, col = k0 + ci;
          bool ok = fl[ci] && row < Sq;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && row - col < window;
          if (!ok) sc[i] = -INFINITY;
        }
      }
      if constexpr (KIND == T5_BIAS) {
        // the scaled score plus the bias, natural units (a masked score
        // stays -inf)
        const float* bt = bias_t + s * BF;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bb = dq_bias2<KIND>(bt, j, boff);
          sc[2 * j] = fmaf(sc[2 * j], scale, bb.x);
          sc[2 * j + 1] = fmaf(sc[2 * j + 1], scale, bb.y);
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (KIND == NO_BIAS) {
          const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
          mu[r] = mn == -INFINITY ? 0.f : mn;   // no visible key yet
          alpha[r] = exp2_approx(m[r] - mu[r]);
          m[r] = mn;
        } else {
          const float mn = fmaxf(m[r], quad_max(mx[r]));
          mu[r] = mn == -INFINITY ? 0.f : mn;
          alpha[r] = exp2_approx((m[r] - mu[r]) * LOG2E);
          m[r] = mn;
        }
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (KIND == NO_BIAS)
          sc[i] = exp2_approx(fmaf(sc[i], sl2, -mu[(i >> 1) & 1]));
        else
          sc[i] = exp2_approx((sc[i] - mu[(i >> 1) & 1]) * LOG2E);
        l[(i >> 1) & 1] += sc[i];
      }
    };
    auto issue_s = [&](int t) {
      const int s = (gi + t) % STAGES;
      mbar_wait(full + 8 * s, ((gi + t) / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd)
        wgmma_ss_n64(sc, qd[kd], desc_k(st_s + s * 2 * TB, kd), kd);
      wgmma_commit();
    };
    // O taken to the max of the last softmax's tile, before any product that
    // follows is issued
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < ACC; ++i) o[i] *= alpha[(i >> 1) & 1];
      fence_regs(o);
    };
    // O += P(t) V(t)
    auto issue_pv = [&](int t) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DP>(o, pa[kk], desc_mn(st_s + ((gi + t) % STAGES) * 2 * TB + TB, kk));
      wgmma_commit();
    };

    mbar_wait(ready + 8 * p, (n / QB) & 1);
    if (t0 < t1) {
      issue_s(t0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(t0);
      pack_a(pa, sc);
      fence_regs(pa);
      // S(t) is issued before P V(t - 1) and retires first; the softmax of
      // tile t runs while P V(t - 1) is in flight. P is packed, and O
      // rescaled, with no product in flight.
      for (int t = t0 + 1; t < t1; ++t) {
        rescale();
        issue_s(t);
        issue_pv(t - 1);
        wgmma_wait<1>();
        fence_regs(sc);
        softmax(t);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(empty + 8 * ((gi + t - 1) % STAGES));
        pack_a(pa, sc);
        fence_regs(pa);
      }
      rescale();
      issue_pv(t1 - 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty + 8 * ((gi + t1 - 1) % STAGES));
    }
    for (int t = t1; t < x.iters; ++t) pass(t);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float lr = quad_sum(l[r]);
      inv[r] = lr == 0.f ? 0.f : 1.f / lr;
      if (row >= Sq || lane % 4 != 0) continue;
      if constexpr (KIND == NO_BIAS)
        lse[(int64_t)x.bh * Sq + row] = lr == 0.f ? NEG_INF : m[r] * LN2 + logf(lr);
      else
        lse[(int64_t)x.bh * Sq + row] = lr == 0.f ? NEG_INF : m[r] + logf(lr);
    }
    if constexpr (PERSIST) {
      // out through the consumer's own Q tile, which no product reads any
      // more, by a TMA store (rows past Sq and columns past D are not
      // written); the Q buffer released once every consumer's store has
      // read its tile
      static_assert(DP == 64, "one 64-column box per tile");
      stage_tile(smem_raw + (qt - raw), o, inv[0], inv[1], warp, lane);
      fence_async_shared();
      consumer_sync(g);
      if (threadIdx.x % 128 == 0) {
        if (first < Sq) tma_store_3d(&map_o, qt, 0, first, x.bh);
        store_wait_read();
        mbar_arrive(qfree + 8 * p);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        bf16* go = out + ((int64_t)x.bh * Sq + row) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(go + col) = __floats2bfloat162_rn(
                o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
    gi += x.iters;
  };
  int gi = 0;   // the ring's tiles so far
  if constexpr (PERSIST) {
    for (int n = 0, w = work_item<true>(0); w < items; w = work_item<true>(++n)) consume(n, w, gi);
  } else {
    consume(0, blockIdx.x, gi);
  }
}

// -- dq (and delta) ----------------------------------------------------------------

// Work items: query_item, as the forward's.

// With a bias, the producer's warps 1-3 stage each K/V tile's bias beside it
// in the ring (T5_BIAS: its 64 NC + 63 values by diagonal from the head's
// table column; DENSE_BIAS without a tensor map: the block's 64 NC x 64
// float32 bias by cp.async), or the TMA thread copies the bias boxes with
// the tiles (DENSE_BIAS); the scores then stay in natural units.
template <int KIND, int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_o,
              const uint8_t* __restrict__ kv_mask, const Bias bias, const bf16* __restrict__ out,
              const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
              int B, int D, int H, int Hkv, int Sq, int Sk, float scale, int causal,
              int window) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int ACC = DP / 2;
  constexpr int STAGES = stages<DP, KIND>();
  constexpr int ROWS_NC = 64 * NC;
  constexpr int BF = dq_bias_floats<KIND, NC>();
  constexpr bool PERSIST = persistent<KIND, DP>();
  constexpr int QB = PERSIST ? 2 : 1;   // buffers of the resident Q and dO tiles
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // buffer p: NC Q tiles, then NC dO tiles, at qd_s + 2 NC p TB
  const uint32_t qd_s = base, st_s = base + QB * 2 * NC * TB;
  // after the tiles: the stages' bias (BF floats each, 1024-byte aligned
  // for the TMA boxes), the key flags, the barriers, T5's table column
  const uint32_t bias_s = st_s + STAGES * 2 * TB;
  float* bias_f = reinterpret_cast<float*>(smem_raw + (bias_s - raw));
  int* flags = reinterpret_cast<int*>(smem_raw + (bias_s + STAGES * BF * 4 - raw));
  const uint32_t bars = bias_s + STAGES * BF * 4 + STAGES * 128 * 4;
  const uint32_t ready = bars, full = ready + 8 * QB, empty = full + 8 * STAGES;
  const uint32_t qfree = empty + 8 * STAGES;   // persistent: Q, dO buffer p read
  float* col = reinterpret_cast<float*>(
      smem_raw + (qfree + 8 * (PERSIST ? QB : 0) - raw));

  const int items = B * H * ((Sq + ROWS_NC - 1) / ROWS_NC);
  auto item = [&](int w) {
    return query_item(w, B, H, Hkv, Sq, Sk, ROWS_NC, causal, window);
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < QB; ++p) {
      mbar_init(ready + 8 * p, 1);
      if (PERSIST) mbar_init(qfree + 8 * p, NC);   // each consumer's output store
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the copies' arrival, the key flags', the bias's
      mbar_init(full + 8 * s, 2 + bias_arrivals<KIND>(bias.tma));
      mbar_init(empty + 8 * s, 4 * NC);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) {
      // the bias-staging warps: T5's diagonals, a dense bias that has no
      // tensor map (the TMA thread copies one that has)
      if constexpr (KIND == T5_BIAS || KIND == DENSE_BIAS) {
        if (KIND == DENSE_BIAS && bias.tma) return;
        const int t = threadIdx.x - 32;
        uint64_t policy = 0;
        if constexpr (KIND == DENSE_BIAS) policy = evict_first_policy();
        int gi = 0;   // the ring's tiles so far
        for (int n = 0;; ++n) {
          const int w = work_item<PERSIST>(n);
          if (w >= items) break;
          const QueryItem x = item(w);
          if constexpr (KIND == T5_BIAS) {   // the head's table column
            if (n > 0) bias_threads_sync();   // the last item's diagonals read it
            for (int c = t; c < bias.nb; c += BIAS_THREADS) col[c] = bias.table[c * H + x.h];
            bias_threads_sync();
          }
          const float* src = nullptr;   // DENSE_BIAS: the head's rows
          if constexpr (KIND == DENSE_BIAS)
            src = bias.rows + ((int64_t)x.b * bias.bs + (int64_t)x.h * bias.hs) * Sq * bias.ld;
          for (int it = 0; it < x.iters; ++it, ++gi) {
            const int s = gi % STAGES, k0 = (x.kt0 + it) * TILE;
            mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
            if constexpr (KIND == DENSE_BIAS) {
              copy_bias<ROWS_NC, TILE>(bias_s + s * BF * 4, src, x.q0, k0, Sq, Sk, bias.ld,
                                       causal, window, t, policy);
              cp_async_arrive(full + 8 * s);
            } else {
              t5_diagonals(bias_f + s * BF, ROWS_NC + TILE - 1, col, bias.index,
                           k0 - x.q0 - (ROWS_NC - 1) + Sq - 1, Sq + Sk - 1, t);
              __syncwarp();
              if (t % 32 == 0) mbar_arrive(full + 8 * s);
            }
          }
        }
        if constexpr (KIND == DENSE_BIAS) cp_async_wait_all();
      }
      return;
    }
    const int lane = threadIdx.x;
    uint64_t policy = 0;   // DENSE_BIAS by TMA: the bias's L2 policy
    if constexpr (KIND == DENSE_BIAS) policy = evict_first_policy();
    // the n-th item of the block, item w, its tiles from the gi-th on
    auto produce = [&](int n, int w, int& gi) {
      const QueryItem x = item(w);
      const int p = n % QB;
      if constexpr (PERSIST) mbar_wait(qfree + 8 * p, ((n / QB) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ready + 8 * p, 2 * NC * TB);
        for (int g = 0; g < NC; ++g) {
          load_tile<DP>(qd_s + (2 * NC * p + g) * TB, &map_q, ready + 8 * p, x.q0 + 64 * g, x.bh);
          load_tile<DP>(qd_s + (2 * NC * p + NC + g) * TB, &map_do, ready + 8 * p, x.q0 + 64 * g,
                        x.bh);
        }
      }
      const uint8_t* mg = kv_mask + (int64_t)x.b * Sk;
      const int plane = x.b * bias.bs + x.h * bias.hs;   // DENSE_BIAS by TMA
      for (int it = 0; it < x.iters; ++it, ++gi) {
        const int s = gi % STAGES, k0 = (x.kt0 + it) * TILE;
        mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
        if (lane == 0) {
          // DENSE_BIAS by TMA: the boxes (consumer g, 32-key half hf) that
          // visible scores need, on the K/V tiles' barrier
          uint32_t boxes = 0;
          if constexpr (KIND == DENSE_BIAS) {
            if (bias.tma)
              for (int g = 0; g < NC; ++g)
                for (int hf = 0; hf < 2; ++hf)
                  if (box_needed(x.q0 + 64 * g, k0 + 32 * hf, Sq, Sk, causal, window))
                    boxes |= 1u << (2 * g + hf);
          }
          mbar_expect_tx(full + 8 * s, 2 * TB + __popc(boxes) * BOX * 4);
          load_tile<DP>(st_s + s * 2 * TB, &map_k, full + 8 * s, k0, x.bk);
          load_tile<DP>(st_s + s * 2 * TB + TB, &map_v, full + 8 * s, k0, x.bk);
          if constexpr (KIND == DENSE_BIAS) {
            for (int b2 = 0; b2 < 2 * NC; ++b2)
              if (boxes >> b2 & 1)
                tma_load_3d_hint(bias_s + (s * BF + b2 * BOX) * 4, &map_b, full + 8 * s,
                                 k0 + 32 * (b2 & 1), x.q0 + 64 * (b2 >> 1), plane, policy);
          }
        }
        bool all = true;
        for (int i = lane; i < TILE; i += 32) {
          const bool ok = k0 + i < Sk && mg[k0 + i];
          flags[s * 128 + i] = ok;
          all = all && ok;
        }
        all = __all_sync(0xffffffffu, all);
        if (lane == 0) flags[s * 128 + TILE] = all;   // no key of the tile masked
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * s);
      }
    };
    int gi = 0;   // the ring's tiles so far
    if constexpr (PERSIST) {
      for (int n = 0, w = work_item<true>(0); w < items; w = work_item<true>(++n))
        produce(n, w, gi);
    } else {
      produce(0, blockIdx.x, gi);
    }
    return;
  }

  if constexpr (NC == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // the thread's bias in stage 0: DENSE_BIAS its first row in its
  // consumer's boxes and the swizzled offsets of its keys by 8-key group of
  // a box, T5_BIAS the diagonal of its first element
  const float* bias_t = bias_f;
  int boff[4];
  if constexpr (KIND == DENSE_BIAS) {
    bias_t += 2 * g * BOX + (16 * warp + lane / 4) * 32;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      boff[a] = ((2 * a + (lane % 4) / 2) ^ (lane / 4)) * 4 + (lane % 2) * 2;
  }
  if constexpr (KIND == T5_BIAS)
    bias_t += 2 * (lane % 4) - (64 * g + 16 * warp + lane / 4) + ROWS_NC - 1;
  const float sl2 = scale * LOG2E;
  // delta (written for dk/dv; a quad per row) and lse of the thread's two
  // rows of item wi
  float dl[2], lse2[2];
  auto row_stats = [&](int wi) {
    const QueryItem x = item(wi);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = x.q0 + 64 * g + 16 * warp + lane / 4 + 8 * r;
      float acc = 0.f;
      if (row < Sq) {
        const bf16* og = out + ((int64_t)x.bh * Sq + row) * D;
        const bf16* dg = dout + ((int64_t)x.bh * Sq + row) * D;
        auto add = [&](int d) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(og + d));
          const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dg + d));
          acc += a.x * c.x + a.y * c.y;
        };
        if constexpr (PERSIST) {   // unrolled: the loads are in flight together
#pragma unroll
          for (int d = 2 * (lane % 4); d < DP; d += 8)
            if (d < D) add(d);
        } else {
          for (int d = 2 * (lane % 4); d < D; d += 8) add(d);
        }
      }
      dl[r] = quad_sum(acc);
      if constexpr (KIND == NO_BIAS)
        lse2[r] = row < Sq ? lse[(int64_t)x.bh * Sq + row] * LOG2E : 0.f;
      else   // natural units: the bias is added to the scaled score
        lse2[r] = row < Sq ? lse[(int64_t)x.bh * Sq + row] : 0.f;
      if (lane % 4 == 0 && row < Sq) delta[(int64_t)x.bh * Sq + row] = dl[r];
    }
  };
  // The n-th item of the block, item w: its tiles through the ring from the
  // gi-th on; persistent, then the item's last stage and buffers released
  // and the next item's row statistics loaded while its stores drain.
  auto consume = [&](int n, int w, int next, int& gi) {
    const QueryItem x = item(w);
    const int p = n % QB;
    const int row0 = x.q0 + 64 * g + 16 * warp + lane / 4;   // rows row0, row0 + 8
    float dqa[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) dqa[i] = 0.f;
    const uint32_t qt = qd_s + (2 * NC * p + g) * TB, dot = qd_s + (2 * NC * p + NC + g) * TB;
    mbar_wait(ready + 8 * p, (n / QB) & 1);

    // Each tile's dq product is left in flight: the next tile's waits and
    // score products queue behind it, and its stage is freed once they have
    // retired it.
    uint32_t da[4][4];
    for (int it = 0; it < x.iters; ++it, ++gi) {
      const int s = gi % STAGES, k0 = (x.kt0 + it) * TILE;
      const uint32_t kst = st_s + s * 2 * TB, vst = kst + TB;
      mbar_wait(full + 8 * s, (gi / STAGES) & 1);
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(sc, desc_k(qt, kd), desc_k(kst, kd), kd);
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(dp, desc_k(dot, kd), desc_k(vst, kd), kd);
      wgmma_commit();
      wgmma_wait<1>();   // the last tile's dq product and this tile's S
      fence_regs(sc);
      fence_regs(da);    // the last product's A registers live until here
      if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((gi - 1) % STAGES));
      const int* fl = flags + s * 128;
      // no element of the warp's rows masked: every key present, rows inside
      // Sq, the causal edge and the window clear of the tile
      bool clear = fl[TILE] && row0 + 8 < Sq;
      if (causal) clear = clear && k0 + TILE - 1 <= row0;
      if (window > 0) clear = clear && row0 + 8 - k0 < window;
      if constexpr (KIND == NO_BIAS) {
        if (__all_sync(0xffffffffu, clear)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = exp2_approx(sc[i] * sl2 - lse2[(i >> 1) & 1]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, ci = acc_col(i, lane);
            const int row = row0 + 8 * r, col = k0 + ci;
            bool ok = fl[ci] && row < Sq;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            sc[i] = ok ? exp2_approx(sc[i] * sl2 - lse2[r]) : 0.f;
          }
        }
      } else {
        // p = exp(s scale + bias - lse), the sum in natural units (an ALiBi
        // score near -1e9 keeps its bits), then to base 2
        const float* bt = bias_t + s * BF;
        if (__all_sync(0xffffffffu, clear)) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 bb = dq_bias2<KIND>(bt, j, boff);
            sc[2 * j] = exp2_approx((fmaf(sc[2 * j], scale, bb.x) - lse2[j & 1]) * LOG2E);
            sc[2 * j + 1] =
                exp2_approx((fmaf(sc[2 * j + 1], scale, bb.y) - lse2[j & 1]) * LOG2E);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 bb = dq_bias2<KIND>(bt, j, boff);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * j + e, r = j & 1, ci = acc_col(i, lane);
              const int row = row0 + 8 * r, col = k0 + ci;
              bool ok = fl[ci] && row < Sq;
              if (causal) ok = ok && col <= row;
              if (window > 0) ok = ok && row - col < window;
              const float pr =
                  exp2_approx((fmaf(sc[i], scale, e ? bb.y : bb.x) - lse2[r]) * LOG2E);
              sc[i] = ok ? pr : 0.f;
            }
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);   // dS
      pack_a(da, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(dqa, da[kk], desc_mn(kst, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(da);
    if constexpr (PERSIST) {
      // the item's last stage released; dq through the consumer's own Q tile,
      // which no product reads any more, by a TMA store (rows past Sq and
      // columns past D are not written); the Q, dO buffer released once
      // every consumer's store has read its tile; the next item's row
      // statistics load meanwhile
      static_assert(DP == 64, "one 64-column box per tile");
      if (lane == 0 && x.iters > 0) mbar_arrive(empty + 8 * ((gi - 1) % STAGES));
      stage_tile(smem_raw + (qt - raw), dqa, scale, warp, lane);
      fence_async_shared();
      consumer_sync(g);
      if (threadIdx.x % 128 == 0) {
        tma_store_3d(&map_o, qt, 0, x.q0 + 64 * g, x.bh);
        store_wait_read();
        mbar_arrive(qfree + 8 * p);
      }
      if (next < items) row_stats(next);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        bf16* gq = dq + ((int64_t)x.bh * Sq + row) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(gq + c) = __floats2bfloat162_rn(
                dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
        }
      }
    }
  };
  int gi = 0;   // the ring's tiles so far
  if constexpr (PERSIST) {
    int w = work_item<true>(0);
    if (w < items) row_stats(w);
    for (int n = 0; w < items; ++n) {
      const int next = work_item<true>(n + 1);
      consume(n, w, next, gi);
      w = next;
    }
  } else {
    row_stats(blockIdx.x);
    consume(0, blockIdx.x, items, gi);
  }
}

// -- dk, dv ------------------------------------------------------------------------

// Work item w: K/V head bk = w % (B Hkv) = b Hkv + hk, the 128 keys j0 = 128
// (w / (B Hkv)) .. (the first, longest tiles first under a causal mask).
// Inner tile it: query head hk G + it / ntiles, query tile it0 + it %
// ntiles.
struct DkvItem {
  int bk, b, hk, j0, it0, ntiles, iters;
};

// With a bias, each Q/dO tile's bias rides beside it, as in dq_kernel: its
// query head's 64 x 128 float32 bias (DENSE_BIAS) or its 64 + 127 values by
// diagonal from that head's table column, the item's group's columns
// staged once (T5_BIAS).
template <int KIND, int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_dk,
               const __grid_constant__ CUtensorMap map_dv, const uint8_t* __restrict__ kv_mask,
               const Bias bias, const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int D, int H, int Hkv, int Sq,
               int Sk, float scale, int causal, int window) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int ACC = DP / 2;
  constexpr int STAGES = stages<DP, KIND>();
  constexpr int BF = dkv_bias_floats<KIND>();
  constexpr bool PERSIST = persistent<KIND, DP>();
  constexpr int KB = PERSIST ? 2 : 1;   // buffers of the resident K and V tiles
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // buffer p: 2 K tiles, then 2 V tiles, at kv_s + 4 p TB
  const uint32_t kv_s = base, st_s = base + KB * 4 * TB;
  // after the tiles: the stages' bias (BF floats each, 1024-byte aligned
  // for the TMA boxes), lse and delta, the barriers, the group's T5 table
  // columns
  const uint32_t bias_s = st_s + STAGES * 2 * TB;
  float* bias_f = reinterpret_cast<float*>(smem_raw + (bias_s - raw));
  float* rows = reinterpret_cast<float*>(smem_raw + (bias_s + STAGES * BF * 4 - raw));
  const uint32_t bars = bias_s + STAGES * BF * 4 + STAGES * 128 * 4;
  const uint32_t ready = bars, full = ready + 8 * KB, empty = full + 8 * STAGES;
  const uint32_t kvfree = empty + 8 * STAGES;   // persistent: K, V buffer p read
  float* cols = reinterpret_cast<float*>(
      smem_raw + (kvfree + 8 * (PERSIST ? KB : 0) - raw));

  const int group = H / Hkv;
  const int nkb = (Sk + ROWS - 1) / ROWS, items = B * Hkv * nkb;
  auto item = [&](int w) {
    DkvItem x;
    x.bk = w % (B * Hkv);
    x.b = x.bk / Hkv;
    x.hk = x.bk % Hkv;
    x.j0 = w / (B * Hkv) * ROWS;
    x.it0 = causal ? x.j0 / TILE : 0;
    int it1 = (Sq + TILE - 1) / TILE;
    if (window > 0) it1 = min(it1, (x.j0 + ROWS + window - 2) / TILE + 1);
    x.ntiles = max(0, it1 - x.it0);
    x.iters = group * x.ntiles;
    return x;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < KB; ++p) {
      mbar_init(ready + 8 * p, 1);
      if (PERSIST) mbar_init(kvfree + 8 * p, 2);   // each consumer's output stores
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the copies' arrival, lse and delta's, the bias's
      mbar_init(full + 8 * s, 2 + bias_arrivals<KIND>(bias.tma));
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) {
      // the bias-staging warps: T5's diagonals, a dense bias that has no
      // tensor map (the TMA thread copies one that has)
      if constexpr (KIND == T5_BIAS || KIND == DENSE_BIAS) {
        if (KIND == DENSE_BIAS && bias.tma) return;
        const int t = threadIdx.x - 32;
        uint64_t policy = 0;
        if constexpr (KIND == DENSE_BIAS) policy = evict_first_policy();
        int gi = 0;   // the ring's tiles so far
        for (int n = 0;; ++n) {
          const int w = work_item<PERSIST>(n);
          if (w >= items) break;
          const DkvItem x = item(w);
          if constexpr (KIND == T5_BIAS) {   // the group's table columns
            if (n > 0) bias_threads_sync();   // the last item's diagonals read them
            for (int c = t; c < group * bias.nb; c += BIAS_THREADS)
              cols[c] = bias.table[(c % bias.nb) * H + x.hk * group + c / bias.nb];
            bias_threads_sync();
          }
          for (int it = 0; it < x.iters; ++it, ++gi) {
            const int s = gi % STAGES;
            const int hh = x.hk * group + it / x.ntiles, i0 = (x.it0 + it % x.ntiles) * TILE;
            mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
            if constexpr (KIND == DENSE_BIAS) {
              const float* src =
                  bias.rows + ((int64_t)x.b * bias.bs + (int64_t)hh * bias.hs) * Sq * bias.ld;
              copy_bias<TILE, ROWS>(bias_s + s * BF * 4, src, i0, x.j0, Sq, Sk, bias.ld, causal,
                                    window, t, policy);
              cp_async_arrive(full + 8 * s);
            } else {
              t5_diagonals(bias_f + s * BF, ROWS + TILE - 1, cols + (it / x.ntiles) * bias.nb,
                           bias.index, x.j0 - i0 - (TILE - 1) + Sq - 1, Sq + Sk - 1, t);
              __syncwarp();
              if (t % 32 == 0) mbar_arrive(full + 8 * s);
            }
          }
        }
        if constexpr (KIND == DENSE_BIAS) cp_async_wait_all();
      }
      return;
    }
    const int lane = threadIdx.x;
    uint64_t policy = 0;   // DENSE_BIAS by TMA: the bias's L2 policy
    if constexpr (KIND == DENSE_BIAS) policy = evict_first_policy();
    // the n-th item of the block, item w, its tiles from the gi-th on
    auto produce = [&](int n, int w, int& gi) {
      const DkvItem x = item(w);
      const int p = n % KB;
      if constexpr (PERSIST) mbar_wait(kvfree + 8 * p, ((n / KB) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ready + 8 * p, 4 * TB);
        for (int g = 0; g < 2; ++g) {
          load_tile<DP>(kv_s + (4 * p + g) * TB, &map_k, ready + 8 * p, x.j0 + 64 * g, x.bk);
          load_tile<DP>(kv_s + (4 * p + 2 + g) * TB, &map_v, ready + 8 * p, x.j0 + 64 * g, x.bk);
        }
      }
      for (int it = 0; it < x.iters; ++it, ++gi) {
        const int s = gi % STAGES;
        const int hh = x.hk * group + it / x.ntiles, i0 = (x.it0 + it % x.ntiles) * TILE;
        const int bh = x.b * H + hh;
        mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
        if (lane == 0) {
          // DENSE_BIAS by TMA: the boxes (32-key quarter q4 of the item's
          // keys) of the query head's bias rows that visible scores need
          uint32_t boxes = 0;
          if constexpr (KIND == DENSE_BIAS) {
            if (bias.tma)
              for (int q4 = 0; q4 < ROWS / 32; ++q4)
                if (box_needed(i0, x.j0 + 32 * q4, Sq, Sk, causal, window)) boxes |= 1u << q4;
          }
          mbar_expect_tx(full + 8 * s, 2 * TB + __popc(boxes) * BOX * 4);
          load_tile<DP>(st_s + s * 2 * TB, &map_q, full + 8 * s, i0, bh);
          load_tile<DP>(st_s + s * 2 * TB + TB, &map_do, full + 8 * s, i0, bh);
          if constexpr (KIND == DENSE_BIAS) {
            const int plane = x.b * bias.bs + hh * bias.hs;
            for (int q4 = 0; q4 < ROWS / 32; ++q4)
              if (boxes >> q4 & 1)
                tma_load_3d_hint(bias_s + (s * BF + q4 * BOX) * 4, &map_b, full + 8 * s,
                                 x.j0 + 32 * q4, i0, plane, policy);
          }
        }
        // lse (in log2 units without a bias, natural with one) and delta of
        // the tile's 64 queries
        for (int i = lane; i < TILE; i += 32) {
          const bool ok = i0 + i < Sq;
          const int64_t at = (int64_t)bh * Sq + i0 + i;
          if constexpr (KIND == NO_BIAS)
            rows[s * 128 + i] = ok ? lse[at] * LOG2E : 0.f;
          else
            rows[s * 128 + i] = ok ? lse[at] : 0.f;
          rows[s * 128 + 64 + i] = ok ? delta[at] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * s);
      }
    };
    int gi = 0;   // the ring's tiles so far
    if constexpr (PERSIST) {
      for (int n = 0, w = work_item<true>(0); w < items; w = work_item<true>(++n))
        produce(n, w, gi);
    } else {
      produce(0, blockIdx.x, gi);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // the thread's bias in stage 0: DENSE_BIAS the box of its keys and the
  // swizzled offsets of its elements by key row and query column parity,
  // T5_BIAS the diagonal of its first element
  const float* bias_t = bias_f;
  int boff[4];
  if constexpr (KIND == DENSE_BIAS) {
    bias_t += (2 * g + warp / 2) * BOX + (lane / 4) % 4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {   // a = 2 (key row 8 past) + (query column parity)
      const int c = 2 * (lane % 4) + (a & 1);
      boff[a] = ((4 * (warp % 2) + 2 * (a >> 1) + lane / 16) ^ c) * 4 + c * 32;
    }
  }
  if constexpr (KIND == T5_BIAS)
    bias_t += 64 * g + 16 * warp + lane / 4 + TILE - 1 - 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  // whether the thread's two keys of item wi are present
  bool key_ok[2];
  auto key_flags = [&](int wi) {
    const DkvItem x = item(wi);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = x.j0 + 64 * g + 16 * warp + lane / 4 + 8 * r;
      key_ok[r] = key < Sk && kv_mask[(int64_t)x.b * Sk + key];
    }
  };
  // The n-th item of the block, item w, as in dq_kernel; persistent, the
  // next item's key flags load while its stores drain.
  auto consume = [&](int n, int w, int next, int& gi) {
    const DkvItem x = item(w);
    const int p = n % KB;
    const int key0 = x.j0 + 64 * g + 16 * warp + lane / 4;   // rows key0, key0 + 8
    float dka[ACC], dva[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t kt = kv_s + (4 * p + g) * TB, vt = kv_s + (4 * p + 2 + g) * TB;
    mbar_wait(ready + 8 * p, (n / KB) & 1);

    // Each tile's dk and dv products are left in flight, as in dq_kernel.
    uint32_t pa[4][4], da[4][4];
    for (int it = 0; it < x.iters; ++it, ++gi) {
      const int s = gi % STAGES, i0 = (x.it0 + it % x.ntiles) * TILE;
      const uint32_t qst = st_s + s * 2 * TB, dost = qst + TB;
      mbar_wait(full + 8 * s, (gi / STAGES) & 1);
      float st[32], dpt[32];   // transposed: rows are keys, columns queries
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(st, desc_k(kt, kd), desc_k(qst, kd), kd);
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd)
        wgmma_ss_n64(dpt, desc_k(vt, kd), desc_k(dost, kd), kd);
      wgmma_commit();
      wgmma_wait<1>();   // the last tile's dk, dv products and this tile's S^T
      fence_regs(st);
      fence_regs(pa);    // the last products' A registers live until here
      fence_regs(da);
      if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((gi - 1) % STAGES));
      const float* rl = rows + s * 128;
      // no element of the thread's keys masked, for the whole warp
      bool clear = key_ok[0] && key_ok[1] && i0 + TILE <= Sq;
      if (causal) clear = clear && key0 + 8 <= i0;
      if (window > 0) clear = clear && i0 + TILE - 1 - key0 < window;
      if constexpr (KIND == NO_BIAS) {
        if (__all_sync(0xffffffffu, clear)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) st[i] = exp2_approx(st[i] * sl2 - rl[acc_col(i, lane)]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, ci = acc_col(i, lane);
            const int key = key0 + 8 * r, row = i0 + ci;
            bool ok = key_ok[r] && row < Sq;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && row - key < window;
            st[i] = ok ? exp2_approx(st[i] * sl2 - rl[ci]) : 0.f;
          }
        }
      } else {
        // p = exp(s scale + bias - lse) in natural units, as in dq_kernel
        const float* bt = bias_t + s * BF;
        if (__all_sync(0xffffffffu, clear)) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            st[i] = exp2_approx(
                (fmaf(st[i], scale, dkv_bias<KIND>(bt, i, boff)) - rl[acc_col(i, lane)]) *
                LOG2E);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, ci = acc_col(i, lane);
            const int key = key0 + 8 * r, row = i0 + ci;
            bool ok = key_ok[r] && row < Sq;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && row - key < window;
            const float pr =
                exp2_approx((fmaf(st[i], scale, dkv_bias<KIND>(bt, i, boff)) - rl[ci]) * LOG2E);
            st[i] = ok ? pr : 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - rl[64 + acc_col(i, lane)]);
      pack_a(pa, st);
      pack_a(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(dva, pa[kk], desc_mn(dost, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(dka, da[kk], desc_mn(qst, kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    if constexpr (PERSIST) {
      // as in dq_kernel: dk and dv through the consumer's own K and V tiles
      // by TMA stores, the K, V buffer released once both consumers' stores
      // have read them, the next item's key flags loading meanwhile
      static_assert(DP == 64, "one 64-column box per tile");
      if (lane == 0 && x.iters > 0) mbar_arrive(empty + 8 * ((gi - 1) % STAGES));
      stage_tile(smem_raw + (kt - raw), dka, scale, warp, lane);
      stage_tile(smem_raw + (vt - raw), dva, 1.f, warp, lane);
      fence_async_shared();
      consumer_sync(g);
      if (threadIdx.x % 128 == 0) {
        tma_store_3d(&map_dk, kt, 0, x.j0 + 64 * g, x.bk);
        tma_store_3d(&map_dv, vt, 0, x.j0 + 64 * g, x.bk);
        store_wait_read();
        mbar_arrive(kvfree + 8 * p);
      }
      if (next < items) key_flags(next);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        bf16* gk = dk + ((int64_t)x.bk * Sk + key) * D;
        bf16* gv = dv + ((int64_t)x.bk * Sk + key) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          if (c >= D) continue;
          *reinterpret_cast<__nv_bfloat162*>(gk + c) = __floats2bfloat162_rn(
              dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(gv + c) =
              __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      }
    }
  };
  int gi = 0;   // the ring's tiles so far
  if constexpr (PERSIST) {
    int w = work_item<true>(0);
    if (w < items) key_flags(w);
    for (int n = 0; w < items; ++n) {
      const int next = work_item<true>(n + 1);
      consume(n, w, next, gi);
      w = next;
    }
  } else {
    key_flags(blockIdx.x);
    consume(0, blockIdx.x, items, gi);
  }
}

// -- host side ---------------------------------------------------------------------

// The tensor map of a contiguous bf16 (planes, rows, D) array read in boxes
// of 64 columns x 64 rows of one plane, 128-byte swizzled; columns past D and
// rows past `rows` read as zeros.
bool tile_map(CUtensorMap* map, const void* ptr, int64_t planes, int64_t rows, int D) {
  wgmma_gemm::EncodeTiled fn = wgmma_gemm::encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, dO (and out) are (B H, Sq, D); k, v (B Hkv, Sk, D); a dense bias's
// (planes, Sq, Sk) rows where they take a tensor map (bias_map); the outputs
// (dq, or dk and dv) that a persistent instance stores by TMA.
struct Maps {
  CUtensorMap q, dout, k, v, bias, out0, out1;
};

// The tensor map of a float32 (planes, Sq, Sk) bias, its rows ld floats
// apart, read in boxes of 32 keys x 64 rows of one plane, 128-byte swizzled;
// rows past Sq and keys past Sk read as zeros. Needs ld % 4 == 0 and 16-byte
// aligned rows (the global strides are multiples of 16 bytes).
bool bias_map(CUtensorMap* map, const float* ptr, int64_t planes, int Sq, int Sk, int ld) {
  wgmma_gemm::EncodeTiled fn = wgmma_gemm::encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Sk, (cuuint64_t)Sq, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)Sq * ld * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operands of a bias: a dense bias's map where its rows allow one (its
// planes are the rows of the last (b, h)), else the cp.async copies.
bool bias_operands(Bias* out, Maps* m, const float* bias, int bs, int hs, int ld,
                   const float* table, const int* index, int nb, int B, int H, int Sq, int Sk) {
  *out = Bias{bias, bs, hs, ld, 0, table, index, nb};
  if (bias == nullptr) return true;
  if (ld < Sk) return false;
  if (ld % 4 != 0 || reinterpret_cast<uintptr_t>(bias) % 16 != 0) return true;
  out->tma = 1;
  return bias_map(&m->bias, bias, (int64_t)(B - 1) * bs + (int64_t)(H - 1) * hs + 1, Sq, Sk, ld);
}

bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, int B,
               int H, int Hkv, int Sq, int Sk, int D) {
  return tile_map(&m->q, q, (int64_t)B * H, Sq, D) &&
         tile_map(&m->dout, dout, (int64_t)B * H, Sq, D) &&
         tile_map(&m->k, k, (int64_t)B * Hkv, Sk, D) && tile_map(&m->v, v, (int64_t)B * Hkv, Sk, D);
}

// Above 48 KB a kernel opts in to dynamic shared memory, once per instance,
// so later launches (and CUDA graph captures) make no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// The card's SMs: a persistent instance's grid.
int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

bool bad_args(int B, int H, int Hkv, int Sq, int Sk, int D, int window) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
         (D != 32 && D != 64 && D != 128) || window < 0 || (Sq + ROWS - 1) / ROWS > 65535 ||
         (Sk + ROWS - 1) / ROWS > 65535;
}

template <int KIND, int DP>
cudaError_t launch_fwd(const Maps& m, const uint8_t* mask, const Bias& bias, void* out, float* lse,
                       int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
                       int window, cudaStream_t stream) {
  constexpr int NC = fwd_consumers<DP, KIND>();
  auto kernel = fwd_kernel<KIND, DP, NC>;
  // T5: the head's table column on top
  const size_t bytes =
      fwd_smem_bytes<KIND, DP, NC>() + (KIND == T5_BIAS ? bias.nb * sizeof(float) : 0);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, KIND == T5_BIAS ? MAX_SMEM : bytes, done);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((Sq + 64 * NC - 1) / (64 * NC));
  const int grid = persistent<KIND, DP>() && num_sms() < items ? num_sms() : items;
  kernel<<<grid, 128 * (NC + 1), bytes, stream>>>(m.q, m.k, m.v, m.bias, m.out0, mask, bias,
                                                  static_cast<bf16*>(out), lse, B, D, H, Hkv, Sq,
                                                  Sk, scale, causal, window);
  return cudaGetLastError();
}

// A dense bias and a T5 table exclude each other; a table has 1 to
// MAX_BUCKETS buckets and comes with its index.
bool bad_bias(const float* rows, const float* table, const int* index, int nb) {
  if (table == nullptr) return false;
  return rows != nullptr || index == nullptr || nb <= 0 || nb > MAX_BUCKETS;
}

template <int KIND, int DP>
cudaError_t launch_dq(const Maps& m, const uint8_t* mask, const Bias& bias, const void* out,
                      const void* dout, const float* lse, float* delta, void* dq, int B, int H,
                      int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
                      cudaStream_t stream) {
  constexpr int NC = dq_consumers<DP, KIND>();
  auto kernel = dq_kernel<KIND, DP, NC>;
  // T5: the head's table column on top
  const size_t bytes = smem_bytes<KIND, DP, NC, dq_bias_floats<KIND, NC>()>() +
                       (KIND == T5_BIAS ? bias.nb * sizeof(float) : 0);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, KIND == T5_BIAS ? MAX_SMEM : bytes, done);
  if (err != cudaSuccess) return err;
  const int items = B * H * ((Sq + 64 * NC - 1) / (64 * NC));
  const int grid = persistent<KIND, DP>() && num_sms() < items ? num_sms() : items;
  kernel<<<grid, 128 * (NC + 1), bytes, stream>>>(
      m.q, m.dout, m.k, m.v, m.bias, m.out0, mask, bias, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), B, D, H, Hkv, Sq, Sk,
      scale, causal, window);
  return cudaGetLastError();
}

template <int KIND, int DP>
cudaError_t launch_dkv(const Maps& m, const uint8_t* mask, const Bias& bias, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, int D, float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = dkv_kernel<KIND, DP>;
  // T5: the group's table columns on top
  const size_t bytes = smem_bytes<KIND, DP, 2, dkv_bias_floats<KIND>()>() +
                       (KIND == T5_BIAS ? (size_t)(H / Hkv) * bias.nb * sizeof(float) : 0);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, KIND == T5_BIAS ? MAX_SMEM : bytes, done);
  if (err != cudaSuccess) return err;
  const int items = B * Hkv * ((Sk + ROWS - 1) / ROWS);
  const int grid = persistent<KIND, DP>() && num_sms() < items ? num_sms() : items;
  kernel<<<grid, THREADS, bytes, stream>>>(
      m.q, m.dout, m.k, m.v, m.bias, m.out0, m.out1, mask, bias, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, D, H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

// The call of LAUNCH's instance for the bias kind (T5_BIAS with a table,
// DENSE_BIAS with a bias, else NO_BIAS) and the head dim (the 64 instance
// takes D = 32 and 64).
#define BWD_BY_DIM(LAUNCH, KIND, ...) \
  (D == 128 ? LAUNCH<KIND, 128>(__VA_ARGS__) : LAUNCH<KIND, 64>(__VA_ARGS__))
#define BWD_DISPATCH(LAUNCH, ...)                                  \
  (t5_table ? BWD_BY_DIM(LAUNCH, T5_BIAS, __VA_ARGS__)             \
   : bias   ? BWD_BY_DIM(LAUNCH, DENSE_BIAS, __VA_ARGS__)          \
            : BWD_BY_DIM(LAUNCH, NO_BIAS, __VA_ARGS__))

}  // namespace flash_bwd

using namespace flash_bwd;

extern "C" {

// The forward of every bias kind: q (B, H, Sq, D) and k, v (B, Hkv, Sk, D)
// bfloat16, contiguous, 16-byte aligned; kv_mask (B, Sk) uint8 (1 = key
// present). D is 32, 64 or 128; window 0 means none. Writes out (B, H, Sq,
// D) bfloat16 and lse (B, H, Sq) f32 (natural log; -1e30 and out = 0 for a
// row that sees no key). The bias operands as for bwd_dq. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int fwd(const void* q, const void* k, const void* v, const uint8_t* kv_mask, const float* bias,
        int bs, int hs, int ld, const float* t5_table, const int* t5_index, int nb, void* out,
        float* lse, int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
        int window, void* stream) {
  Maps m{};
  Bias b;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      !tile_map(&m.q, q, (int64_t)B * H, Sq, D) || !tile_map(&m.k, k, (int64_t)B * Hkv, Sk, D) ||
      !tile_map(&m.v, v, (int64_t)B * Hkv, Sk, D) ||
      !bias_operands(&b, &m, bias, bs, hs, ld, t5_table, t5_index, nb, B, H, Sq, Sk) ||
      !tile_map(&m.out0, out, (int64_t)B * H, Sq, D))
    return (int)cudaErrorInvalidValue;
  return (int)BWD_DISPATCH(launch_fwd, m, kv_mask, b, out, lse, B, H, Hkv, Sq, Sk, D, scale,
                           causal, window, static_cast<cudaStream_t>(stream));
}

// q, out, dout (B, H, Sq, D) and k, v (B, Hkv, Sk, D): bfloat16, contiguous,
// 16-byte aligned; kv_mask (B, Sk) uint8 (1 = key present); lse (B, H, Sq)
// f32 from the forward of the same bias. D is 32, 64 or 128; window 0 means
// none. Writes dq (B, H, Sq, D) bfloat16 and delta (B, H, Sq) f32 for
// bwd_dkv (and the dbias and demb kernels of flash_attention.cu). Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
//
// bias is nullptr or a float32 bias (b0 h0, Sq, Sk) whose rows lie ld >= Sk
// floats apart (ld = Sk when contiguous; a multiple of 4 and 16-byte aligned
// rows let TMA read it), with b0 in {1, B} and h0 in {1, H}, and the plane
// strides bs (0 when b0 = 1, else h0) and hs (0 when h0 = 1, else 1): the
// rows of (b, h) are plane b bs + h hs, Sq ld floats a plane.
// t5_table is nullptr or T5's float32 (nb, H) table, with t5_index the int32
// bucket of every distance (Sq + Sk - 1 entries, entry k - q + Sq - 1 for
// query slot q and key slot k) and 1 <= nb <= 128; never with a bias. With
// neither, the bias-free backward.
int bwd_dq(const void* q, const void* k, const void* v, const uint8_t* kv_mask, const float* bias,
           int bs, int hs, int ld, const float* t5_table, const int* t5_index, int nb,
           const void* out, const void* dout, const float* lse, float* delta, void* dq, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
           void* stream) {
  Maps m{};
  Bias b;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      !make_maps(&m, q, k, v, dout, B, H, Hkv, Sq, Sk, D) ||
      !bias_operands(&b, &m, bias, bs, hs, ld, t5_table, t5_index, nb, B, H, Sq, Sk) ||
      !tile_map(&m.out0, dq, (int64_t)B * H, Sq, D))
    return (int)cudaErrorInvalidValue;
  return (int)BWD_DISPATCH(launch_dq, m, kv_mask, b, out, dout, lse, delta, dq, B, H, Hkv, Sq,
                           Sk, D, scale, causal, window, static_cast<cudaStream_t>(stream));
}

// dk, dv (B, Hkv, Sk, D) bfloat16, summed over each K/V head's query heads,
// from bwd_dq's delta; the bias operands as for bwd_dq.
int bwd_dkv(const void* q, const void* k, const void* v, const uint8_t* kv_mask,
            const float* bias, int bs, int hs, int ld, const float* t5_table,
            const int* t5_index, int nb, const void* dout, const float* lse, const float* delta,
            void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
            int causal, int window, void* stream) {
  Maps m{};
  Bias b;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      !make_maps(&m, q, k, v, dout, B, H, Hkv, Sq, Sk, D) ||
      !bias_operands(&b, &m, bias, bs, hs, ld, t5_table, t5_index, nb, B, H, Sq, Sk) ||
      !tile_map(&m.out0, dk, (int64_t)B * Hkv, Sk, D) ||
      !tile_map(&m.out1, dv, (int64_t)B * Hkv, Sk, D))
    return (int)cudaErrorInvalidValue;
  return (int)BWD_DISPATCH(launch_dkv, m, kv_mask, b, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, D,
                           scale, causal, window, static_cast<cudaStream_t>(stream));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
