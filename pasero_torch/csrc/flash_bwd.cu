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
// units, the lse that the T5 dq and dk/dv kernels read. Two consumers
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
// where key j is visible from row i when kv_mask[b, j] is set, j <= i
// (causal, by slot index) and i - j < window (a sliding window), as
// pasero_tpu/ops/flash_attention.py applies them. Replaces the TPU kernels
// pasero_tpu/ops/flash_attention.py:_bwd_dq_packed_kernel (:963) and
// _bwd_dkv_packed_kernel (:1018), through _bwd_packed (:1086), and the
// bias-free mode of the streamed _bwd_stream (:738): one design takes any
// length, as its K/V and Q/dO tiles stream through shared memory.
//
// The same two kernels, instanced by bias kind (KIND: NO_BIAS, DENSE_BIAS,
// T5_BIAS), compute the biased and the T5 backward, the bias re-added to the
// recomputed scores:
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
// subtraction would lose it; the bias-free instances keep their log2 units,
// and their code: each bias branch is compiled out of them. A dense bias
// costs bytes (at bloom_560m's causal (4, 16, 2048) its visible half is 537
// MB, 0.160 ms at 3.35 TB/s, per kernel), so it streams
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
// T5's table gradient (demb, replacing _demb_kernel :1255 through
// _compute_demb :1318) is the T5 dq kernel's DEMB instance: demb[n, h] =
// sum over b and the (i, j) of bucket n of the float32 dS, which the dq
// kernel holds anyway, so no second pass recomputes QK^T and dO V^T. Far
// tiles (every distance in the index's first or last bucket, by the host's
// plan) a consumer thread sums in a register; a near tile's dS goes by
// diagonal through shared memory to the producer warpgroup's idle warps,
// which sum it by bucket (DEMB_LD, t5_diagonals_and_demb). What bounds the
// kernel: the dq's own products. What demb adds to it is CUDA-core work
// whose floor is one float32 add of each visible dS and the partial rows'
// writes; it stays several times above that floor (chip_smoke.py's
// adds_ms against adds_bound_ms).
//
// The dense bias's gradient (dbias, replacing _dbias_kernel :1160 through
// _compute_dbias :1213) is dbias_kernel, on the dense-bias dq kernel's ring
// (stream_tile): dS = P (dP - delta) in float32, written whole. What bounds
// it: bytes. At bloom_560m's causal (4, 16, 2048) with a per-sample bias it
// reads the visible half of the bias (537 MB) and writes dbias whole (1.07
// GB), 0.5012 ms at 3.35 TB/s with the operands, against 0.0348 ms of
// products. So each tile's dS leaves by TMA stores from the bias boxes it
// was formed beside, the tiles no row sees as TMA stores of a zeroed box,
// and a bias shared over the batch is summed in registers, batch by batch,
// and written once (see dbias_kernel). The float32 kernels of every kind
// are flash_f32.cu's; the PTX wrappers for mbarriers, descriptors, the
// wgmma fences and the wgmma with A from registers come from wgmma_gemm.cuh
// (the fused-CE mainloop).

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
using wgmma_gemm::wgmma_rs;
using wgmma_gemm::wgmma_wait;

typedef __nv_bfloat16 bf16;

// What the scores get added: nothing, a dense float32 bias, or T5's table.
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

// A 3-D box (a tensor map's box, from shared memory) into the map's array,
// as one bulk group; the caller waits for its reads (store_wait_read) before
// the box is written again.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}
// Until every bulk group of this thread but the newest N has read its
// shared memory.
template <int N = 0>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
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

// T5's table gradient inside the T5 dq kernel (demb). Per 64 x 64 tile a
// consumer thread holds 32 elements of the float32 dS; its elements (r, c)
// and (r + 8, c + 8) share a diagonal, so it first adds those pairs down to
// 18 partial sums, diagonals 8 m + e + 2 t - g - 16 w (m in -1 .. 7, e in 0,
// 1; lane (g, t) of warp w). It stores them into its consumer's skew buffer:
// row d + 63 for diagonal d, column 8 w + g, one row of DEMB_LD floats a
// diagonal (the 32 columns, 16-byte aligned rows; a warp's 32 stores fall on
// distinct banks). Each (diagonal, column) has at most one writer and a
// column no element reaches stays 0 from the kernel's start. A warp of the
// producer warpgroup then sums each row (8 float4 reads) into the tile's
// 127 diagonal sums, and the diagonals of each bucket (a bucket's distances
// are one contiguous run, as T5's are: monotone in |distance| on each side)
// into the consumer's bucket sums, in a fixed order
// (t5_diagonals_and_demb): no atomics, the same bits from two calls.
constexpr int DEMB_LD = 36;    // floats of a skew row
constexpr int DEMB_DIAG = 127; // diagonals of a 64 x 64 tile

// Bytes of the demb area of an NC-consumer T5 dq kernel with `stages`
// stages and nb buckets: two barriers a consumer, NC skew buffers, each
// stage's buckets by diagonal (64 NC + 63, and one to pad) and its facts
// (an int4, t5_diagonals_and_demb), NC x nb bucket
// sums of near tiles and 2 x NC x 4 x nb of far ones (by item parity and
// consumer warp), and 16 to align. One set of far sums would be enough: a
// consumer adds into them only at an item's last tile, after the reducing
// warp has written and zeroed the last item's. With one set, ptxas spills
// more in this kernel (scripts/ptxas_report.py: 248 against 140 bytes at D
// = 64, 144 against 28 at D = 128) and the dq with demb runs 1-2 % slower
// on the H100, so the sums alternate by item.
__host__ __device__ constexpr size_t demb_bytes(int NC, int stages, int nb) {
  return 16 * NC + (size_t)NC * DEMB_DIAG * DEMB_LD * 4 + (size_t)stages * (64 * NC + 64) * 4 +
         (size_t)stages * 16 + (size_t)9 * NC * nb * 4 + 16;
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
// that dq_kernel and dkv_kernel read. The
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
// that the dense-bias dq, dk/dv and dbias_kernel read.
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
        wgmma_rs<DP, 1>(o, pa[kk], desc_mn(st_s + ((gi + t) % STAGES) * 2 * TB + TB, kk));
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

// The producer warpgroup's warps 1-3 of the T5 dq kernel when the table
// needs a gradient (demb). Per K/V tile they write its bias by diagonal into
// its stage, as without it, and beside it the bucket of each of its
// diagonals (the index clamped to its ends: a slot past Sq or Sk is masked,
// its dS 0) and the tile's facts for the reduction (meta: which consumers'
// tiles are far, whether it is its item's last tile and the item's parity,
// the item's first row of `partial` and how many of its consumers have
// rows). The warps pass a barrier before each tile's writes: a reducing
// warp reads facts another warp wrote, before it decides whether to wait
// for its consumer, so every warp must have written them.
//
// A far tile, one whose every diagonal lies in the index's first or last
// bucket (by its offset k0 - q0 against the host's plan `far`: at most
// far.x, bucket far.z; at least far.y, bucket far.w), the consumer sums
// itself (a running sum a thread and side, into its warp's sums at the
// item's end). A near tile, and an item's last, it hands over on its own
// pair of barriers: STAGES - 1 tiles behind, warp 1 + c sums consumer c's
// skew buffer (DEMB_LD): lane l takes diagonals l, l + 32, l + 64, l + 96,
// each a row of 32 partial sums (four float4 chains), frees the buffer once
// they are read, then per 32 diagonals a segmented scan by bucket across
// the lanes (a bucket is one run of diagonals), whose last lane of each run
// adds the run into the consumer's bucket sum. After an item's last tile
// the warp writes its consumer's near and far sums, row (b H + h) ceil(Sq /
// 64) + q0 / 64 + c of `partial`, zeroes them, and only then frees the
// buffer; an item of no tile gets rows of zeros at once. Every sum has a
// fixed order; no sum is shared between warps.
template <int NC, int STAGES, int BF, bool PERSIST>
__device__ __forceinline__ void t5_diagonals_and_demb(
    const Bias& bias, float* col, float* bias_f, int* stage_bk, int4* meta, uint32_t full,
    uint32_t empty, uint32_t dfull, uint32_t dempty, const float* skew, float* dacc, float* facc,
    float* __restrict__ partial, const int4 far, int items, int B, int H, int Hkv, int Sq, int Sk,
    int causal, int window) {
  constexpr int ROWS_NC = 64 * NC, ND = ROWS_NC + TILE - 1;   // a stage's diagonals
  static_assert(NC <= BIAS_THREADS / 32, "a reducing warp per consumer");
  const int t = threadIdx.x - 32, c = t / 32, lane = t % 32;
  const int qtiles = (Sq + 63) / 64;
  int rgi = 0, hs = 0;   // tiles reduced; tiles consumer c handed over
  // tile rgi: warp c takes consumer c's if the consumer handed it over
  auto reduce = [&]() {
    const int4 m = meta[rgi % STAGES];
    const bool far = m.x >> c & 1, last = m.y & 1;
    if (c < NC && (!far || last)) {
      const int nb = bias.nb;
      const int* bk = stage_bk + (rgi % STAGES) * (ND + 1) + 64 * (NC - 1 - c);
      mbar_wait(dfull + 16 * c, hs & 1);
      float v[4];
      int b[4];
      if (!far) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = 32 * k + lane;
          v[k] = 0.f;
          b[k] = -1;
          if (r < DEMB_DIAG) {
            const float4* row =
                reinterpret_cast<const float4*>(skew + (c * DEMB_DIAG + r) * DEMB_LD);
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
            for (int j = 0; j < 8; ++j) {
              const float4 x = row[j];
              a0 += x.x;
              a1 += x.y;
              a2 += x.z;
              a3 += x.w;
            }
            v[k] = (a0 + a1) + (a2 + a3);
            b[k] = bk[r];
          }
        }
      }
      __syncwarp();
      // the skew buffer is read: the consumer may write its next one,
      // except after an item's last tile, whose sums are written first
      if (!last && lane == 0) mbar_arrive(dempty + 16 * c);
      if (!far) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float x = v[k];
#pragma unroll
          for (int off = 1; off < 32; off *= 2) {
            const float y = __shfl_up_sync(0xffffffffu, x, off);
            const int by = __shfl_up_sync(0xffffffffu, b[k], off);
            if (lane >= off && by == b[k]) x += y;
          }
          const int bn = __shfl_down_sync(0xffffffffu, b[k], 1);
          if (b[k] >= 0 && (lane == 31 || bn != b[k])) dacc[c * nb + b[k]] += x;
          __syncwarp();
        }
      }
      if (last) {   // the row: near sums and the far sums of the item's parity
        float* fs = facc + ((m.y >> 1) * NC + c) * 4 * nb;
        for (int n = lane; n < nb; n += 32) {
          float sum = dacc[c * nb + n];
          dacc[c * nb + n] = 0.f;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            sum += fs[w * nb + n];
            fs[w * nb + n] = 0.f;
          }
          if (c < m.w) partial[(int64_t)(m.z + c) * nb + n] = sum;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(dempty + 16 * c);
      }
      ++hs;
    }
    ++rgi;
  };
  int gi = 0;   // the ring's tiles so far
  for (int n = 0;; ++n) {
    const int w = work_item<PERSIST>(n);
    if (w >= items) break;
    const QueryItem x = query_item(w, B, H, Hkv, Sq, Sk, ROWS_NC, causal, window);
    const int row = x.bh * qtiles + x.q0 / 64, rows = min(NC, (Sq - x.q0 + 63) / 64);
    if (x.iters == 0) {   // no tile: rows of zeros
      if (c < rows)
        for (int i = lane; i < bias.nb; i += 32)
          partial[(int64_t)(row + c) * bias.nb + i] = 0.f;
      continue;
    }
    if (n > 0) bias_threads_sync();   // the last item's diagonals read the column
    for (int i = t; i < bias.nb; i += BIAS_THREADS) col[i] = bias.table[i * H + x.h];
    bias_threads_sync();
    for (int it = 0; it < x.iters; ++it, ++gi) {
      const int s = gi % STAGES, k0 = (x.kt0 + it) * TILE;
      const int base = k0 - x.q0 - (ROWS_NC - 1) + Sq - 1, length = Sq + Sk - 1;
      mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
      // every warp has written the last tile's facts (reduce reads them) and
      // reduced the tile whose facts this stage held
      bias_threads_sync();
      int bucket[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (t + BIAS_THREADS * h < ND)
          bucket[h] = bias.index[min(max(base + t + BIAS_THREADS * h, 0), length - 1)];
      if (t == 0) {   // the consumers' far tiles, as they decide them
        int fars = 0;
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const int delta = k0 - x.q0 - 64 * g;
          fars |= (delta >= far.y || delta <= far.x) << g;
        }
        meta[s] = make_int4(fars, (it == x.iters - 1) | (n % 2) << 1, row, rows);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = t + BIAS_THREADS * h, at = base + i;
        if (i < ND) {
          bias_f[s * BF + i] = at >= 0 && at < length ? col[bucket[h]] : 0.f;
          stage_bk[s * (ND + 1) + i] = bucket[h];
        }
      }
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(full + 8 * s);
      while (rgi + STAGES - 1 <= gi) reduce();
    }
  }
  // every warp has written the last tile's facts before any reads them
  bias_threads_sync();
  while (rgi < gi) reduce();
}

// The producer warp's step of dq and dbias: key tile k0 of K/V plane bk
// into a stage once the consumers have freed it (its empty barrier's phase
// `phase`): K and V at kst, and with a dense bias by TMA the boxes at bst
// (plane `plane`, L2 policy `policy`) that visible scores of the 64 NC
// queries from q0 need, all counted on its full barrier; then the tile's key
// flags (fl; mg the batch's key mask) and the warp's arrival.
template <int KIND, int DP, int NC>
__device__ __forceinline__ void stream_tile(const CUtensorMap* map_k, const CUtensorMap* map_v,
                                            const CUtensorMap* map_b, const Bias& bias,
                                            uint32_t kst, uint32_t bst, int* fl, uint32_t full,
                                            uint32_t empty, int phase, int k0, int q0, int bk,
                                            int plane, const uint8_t* mg, int Sq, int Sk,
                                            int causal, int window, uint64_t policy, int lane) {
  constexpr int TB = tile_bytes<DP>();
  mbar_wait(empty, phase);
  if (lane == 0) {
    // DENSE_BIAS by TMA: the boxes (consumer g, 32-key half hf) that
    // visible scores need, on the K/V tiles' barrier
    uint32_t boxes = 0;
    if constexpr (KIND == DENSE_BIAS) {
      if (bias.tma)
        for (int g = 0; g < NC; ++g)
          for (int hf = 0; hf < 2; ++hf)
            if (box_needed(q0 + 64 * g, k0 + 32 * hf, Sq, Sk, causal, window))
              boxes |= 1u << (2 * g + hf);
    }
    mbar_expect_tx(full, 2 * TB + __popc(boxes) * BOX * 4);
    load_tile<DP>(kst, map_k, full, k0, bk);
    load_tile<DP>(kst + TB, map_v, full, k0, bk);
    if constexpr (KIND == DENSE_BIAS) {
      for (int b2 = 0; b2 < 2 * NC; ++b2)
        if (boxes >> b2 & 1)
          tma_load_3d_hint(bst + b2 * BOX * 4, map_b, full, k0 + 32 * (b2 & 1),
                           q0 + 64 * (b2 >> 1), plane, policy);
    }
  }
  bool all = true;
  for (int i = lane; i < TILE; i += 32) {
    const bool ok = k0 + i < Sk && mg[k0 + i];
    fl[i] = ok;
    all = all && ok;
  }
  all = __all_sync(0xffffffffu, all);
  if (lane == 0) fl[TILE] = all;   // no key of the tile masked
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// With a bias, the producer's warps 1-3 stage each K/V tile's bias beside it
// in the ring (T5_BIAS: its 64 NC + 63 values by diagonal from the head's
// table column; DENSE_BIAS without a tensor map: the block's 64 NC x 64
// float32 bias by cp.async), or the TMA thread copies the bias boxes with
// the tiles (DENSE_BIAS); the scores then stay in natural units. The DEMB
// instance (T5_BIAS) also sums the table's gradient from the float32 dS
// (see DEMB_LD and t5_diagonals_and_demb); every other instance compiles
// none of it.
template <int KIND, int DP, int NC, bool DEMB = false>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_o,
              const uint8_t* __restrict__ kv_mask, const Bias bias, const bf16* __restrict__ out,
              const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
              float* __restrict__ partial, const int4 far, int B, int D, int H, int Hkv, int Sq,
              int Sk, float scale, int causal, int window) {
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
  // T5 with the table's gradient (DEMB, given `partial`): after the column,
  // the demb area (demb_bytes): a full and an empty barrier a consumer, the
  // consumers' skew buffers, each stage's buckets by diagonal and facts, the
  // bucket sums of near tiles and of far ones
  static_assert(!DEMB || KIND == T5_BIAS, "demb is T5's table's gradient");
  constexpr bool demb = DEMB;
  const uint32_t dbar = (qfree + 8 * (PERSIST ? QB : 0) + 4 * bias.nb + 15u) & ~15u;
  const uint32_t dfull = dbar, dempty = dbar + 8;   // consumer c's at + 16 c
  float* skew = reinterpret_cast<float*>(smem_raw + (dbar + 16 * NC - raw));
  int* stage_bk = reinterpret_cast<int*>(skew + NC * DEMB_DIAG * DEMB_LD);
  int4* meta = reinterpret_cast<int4*>(stage_bk + STAGES * (ROWS_NC + TILE));
  float* dacc = reinterpret_cast<float*>(meta + STAGES);
  float* facc = dacc + NC * bias.nb;   // far tiles' sums: item parity, consumer, warp, bucket

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
    if (demb)
      for (int c = 0; c < NC; ++c) {   // consumer c and its reducing warp
        mbar_init(dfull + 16 * c, 4);
        mbar_init(dempty + 16 * c, 1);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (demb) {   // the skew buffers' unwritten columns and the bucket sums start at 0
    for (int i = threadIdx.x; i < NC * DEMB_DIAG * DEMB_LD; i += 128 * (NC + 1)) skew[i] = 0.f;
    for (int i = threadIdx.x; i < 9 * NC * bias.nb; i += 128 * (NC + 1)) dacc[i] = 0.f;
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NC == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (KIND == T5_BIAS) {
      if (demb && threadIdx.x >= 32) {
        t5_diagonals_and_demb<NC, STAGES, BF, PERSIST>(
            bias, col, bias_f, stage_bk, meta, full, empty, dfull, dempty, skew, dacc, facc,
            partial, far, items, B, H, Hkv, Sq, Sk, causal, window);
        return;
      }
    }
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
        const int s = gi % STAGES;
        stream_tile<KIND, DP, NC>(&map_k, &map_v, &map_b, bias, st_s + s * 2 * TB,
                                  bias_s + s * BF * 4, flags + s * 128, full + 8 * s,
                                  empty + 8 * s, ((gi / STAGES) & 1) ^ 1, (x.kt0 + it) * TILE,
                                  x.q0, x.bk, plane, mg, Sq, Sk, causal, window, policy, lane);
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
  int hs = 0;   // demb: the tiles handed to the reducing warp so far
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
    float far_sum[2] = {0.f, 0.f};   // demb: the thread's sums of far tiles by side
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
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP, 1>(dqa, da[kk], desc_mn(kst, kk));
      wgmma_commit();
      if constexpr (KIND == T5_BIAS) {
        if (demb) {
          // while the dq product runs: a far tile (every diagonal in the
          // index's first bucket, offset k0 - q0 <= far.x, or in its last, >=
          // far.y; the host's plan) into the thread's running sum of that
          // side, a near one's float32 dS by diagonal into the skew buffer
          // (see DEMB_LD) once the reducing warp has read the last one; the
          // running sums into the warp's sums of this item (buffer n % 2) at
          // the item's end. Near tiles and an item's last tile are handed to
          // the reducing warp (hs of them so far).
          const int delta = k0 - x.q0 - 64 * g;
          const int side = delta >= far.y ? 1 : delta <= far.x ? 0 : -1;
          const bool last = it == x.iters - 1, hand = side < 0 || last;
          if (hand) mbar_wait(dempty + 16 * g, (hs & 1) ^ 1);
          if (side >= 0) {
            float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
#pragma unroll
            for (int i = 0; i < 32; i += 4) {
              v0 += dp[i];
              v1 += dp[i + 1];
              v2 += dp[i + 2];
              v3 += dp[i + 3];
            }
            far_sum[side] += (v0 + v1) + (v2 + v3);
          } else {
            float* o = skew + g * DEMB_DIAG * DEMB_LD +
                       DEMB_LD * (2 * (lane % 4) - lane / 4 - 16 * warp + 63) + 8 * warp +
                       lane / 4;
#pragma unroll
            for (int m = -1; m < 8; ++m)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float v = 0.f;
                if (m >= 0) v = dp[4 * m + e];
                if (m < 7) v += dp[4 * m + 6 + e];
                o[DEMB_LD * (8 * m + e)] = v;
              }
          }
          if (last) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = far_sum[h];
#pragma unroll
              for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
              if (lane == 0)
                facc[((n % 2 * NC + g) * 4 + warp) * bias.nb + (h ? far.w : far.z)] += v;
              far_sum[h] = 0.f;
            }
          }
          if (hand) {
            __syncwarp();
            if (lane == 0) mbar_arrive(dfull + 16 * g);
            ++hs;
          }
        }
      }
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
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP, 1>(dva, pa[kk], desc_mn(dost, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP, 1>(dka, da[kk], desc_mn(qst, kk));
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

// -- dbias ---------------------------------------------------------------------------

// The keys a block of a bias shared over the batch takes (KT = 2 tiles): its
// dS sums stay in a consumer thread's registers across the batch (64 floats).
constexpr int DBIAS_KEYS = 128;

// The resident Q and dO buffers of dbias: two where a block walks the batch
// at D <= 64 (the next batch's tiles load while this one's run), else one
// (at D = 128 two do not fit beside the stages).
template <int DP, bool SUM>
__host__ __device__ constexpr int dbias_buffers() { return SUM && DP == 64 ? 2 : 1; }

// Shared memory of dbias: dq's with a dense bias (two consumers), QB resident
// buffers, a zeroed bias box, the barriers (ready and released per buffer,
// full and empty per stage) and 1024 bytes to align.
template <int DP, bool SUM>
__host__ __device__ constexpr size_t dbias_smem_bytes() {
  constexpr int ST = stages<DP, DENSE_BIAS>(), QB = dbias_buffers<DP, SUM>();
  return (size_t)(4 * QB + 2 * ST) * tile_bytes<DP>() +
         (size_t)(ST * dq_bias_floats<DENSE_BIAS, 2>() + BOX + ST * 128) * 4 +
         8 * (2 * QB + 2 * ST) + 1024;
}

// A shared bias is read once per batch: its boxes keep L2's normal policy.
__device__ __forceinline__ uint64_t evict_normal_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// dbias = dS = P (dP - delta), float32 and unrounded, zero where a key is
// not visible, on dq's ring with a dense bias (two consumers of 64 query
// rows; the producer thread streams K, V and the bias boxes by TMA, or warps
// 1-3 copy the bias by cp.async where its rows are not 16-byte aligned).
// Block (output plane o, 128-query block, key range): the output planes vary
// fastest and the last (longest causal) query blocks come first, so every
// plane's longest block starts before any plane's next. Per tile a consumer
// issues S = Q K^T and dP = dO V^T (m64n64) and forms dS in its registers,
// in natural units against the forward's lse, as the forward adds the bias.
//   A per-sample bias (SUM false): o = b H + h and every key tile. The
// consumer writes each tile's dS into the bias boxes it has just read (the
// same swizzled layout) and stores them by TMA; its stage is freed once the
// next tile's stores are issued and these have been read. The producer
// warpgroup's warps 1-3 store the key tiles that no row of the block sees
// from a zeroed box.
//   A bias shared over the batch (SUM true, B > 1): o = h and the KT tiles
// of keys [z DBIAS_KEYS, ...); for each batch in order 0 .. B - 1 the
// producer loads its Q and dO and streams its K and V tiles (the bias's
// boxes again, from L2), and each tile's dS is added to the thread's
// registers (0 + dS first), stored once with the last batch: no atomics,
// and the batches summed in the order of the plain version.
// Without a tensor map (Sk % 4 != 0) the dS leaves by plain stores from the
// registers and the zeros by plain stores of warps 1-3.
template <int DP, bool SUM>
__global__ void __launch_bounds__(384, 1)
    dbias_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_db,
                 const uint8_t* __restrict__ kv_mask, const Bias bias,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dbias, int B, int H, int Hkv, int Sq, int Sk, float scale,
                 int causal, int window) {
  constexpr int NC = 2, ROWS_NC = 64 * NC, TB = tile_bytes<DP>();
  constexpr int STAGES = stages<DP, DENSE_BIAS>(), BF = dq_bias_floats<DENSE_BIAS, NC>();
  constexpr int QB = dbias_buffers<DP, SUM>();
  constexpr int KT = SUM ? DBIAS_KEYS / TILE : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // buffer p: NC Q tiles, then NC dO tiles; the stages' K and V tiles, their
  // bias boxes, the zeroed box, the key flags, the barriers
  const uint32_t qd_s = base, st_s = base + QB * 2 * NC * TB;
  const uint32_t bias_s = st_s + STAGES * 2 * TB, zero_s = bias_s + STAGES * BF * 4;
  float* bias_f = reinterpret_cast<float*>(smem_raw + (bias_s - raw));
  int* flags = reinterpret_cast<int*>(smem_raw + (zero_s + BOX * 4 - raw));
  const uint32_t ready = zero_s + BOX * 4 + STAGES * 128 * 4, qfree = ready + 8 * QB;
  const uint32_t full = qfree + 8 * QB, empty = full + 8 * STAGES;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS_NC;
  const int o = blockIdx.x, h = SUM ? o : o % H;
  const int b_begin = SUM ? 0 : o / H, b_end = SUM ? B : b_begin + 1;
  const int nkt = (Sk + TILE - 1) / TILE;
  const int ka = SUM ? blockIdx.z * KT : 0, kb = SUM ? min(ka + KT, nkt) : nkt;
  // the key tiles some row of the block sees (query_item's), and of those
  // the block's: streamed for each batch; [ka, lo) and [hi, kb) are zeros
  int kt0 = 0, kt1 = nkt;
  if (causal) kt1 = min(kt1, (q0 + ROWS_NC - 1) / TILE + 1);
  if (window > 0) kt0 = max(0, (q0 - window + 1) / TILE);
  const int lo = min(max(kt0, ka), kb), hi = max(lo, min(kt1, kb));
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < QB; ++p) {
      mbar_init(ready + 8 * p, 1);
      mbar_init(qfree + 8 * p, NC);   // each consumer, done with the buffer
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 2 + bias_arrivals<DENSE_BIAS>(bias.tma));
      mbar_init(empty + 8 * s, NC);   // each consumer, its stores read
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* zf = reinterpret_cast<float*>(smem_raw + (zero_s - raw));
  for (int i = threadIdx.x; i < BOX; i += 384) zf[i] = 0.f;
  fence_async_shared();
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) {
      // warps 1-3: the bias by cp.async where it has no tensor map, then the
      // zeros of the key tiles no row of the block sees
      const int t = threadIdx.x - 32;
      if (!bias.tma && lo < hi) {
        const uint64_t policy = SUM ? evict_normal_policy() : evict_first_policy();
        int gi = 0;
        for (int b = b_begin; b < b_end; ++b) {
          const float* src =
              bias.rows + ((int64_t)b * bias.bs + (int64_t)h * bias.hs) * Sq * bias.ld;
          for (int kt = lo; kt < hi; ++kt, ++gi) {
            const int s = gi % STAGES;
            mbar_wait(empty + 8 * s, ((gi / STAGES) & 1) ^ 1);
            copy_bias<ROWS_NC, TILE>(bias_s + s * BF * 4, src, q0, kt * TILE, Sq, Sk, bias.ld,
                                     causal, window, t, policy);
            cp_async_arrive(full + 8 * s);
          }
        }
        cp_async_wait_all();
      }
      if (bias.tma) {
        if (t == 0) {
          auto zeros = [&](int kt) {
            for (int g = 0; g < NC && q0 + 64 * g < Sq; ++g)
              for (int hf = 0; hf < 2; ++hf)
                tma_store_3d(&map_db, zero_s, kt * TILE + 32 * hf, q0 + 64 * g, o);
          };
          for (int kt = ka; kt < lo; ++kt) zeros(kt);
          for (int kt = hi; kt < kb; ++kt) zeros(kt);
          store_wait_read();
        }
      } else {
        float* og = dbias + (int64_t)o * Sq * Sk;
        const int c1 = min(kb * TILE, Sk);
        for (int r = q0; r < min(q0 + ROWS_NC, Sq); ++r)
          for (int c = ka * TILE + t; c < c1; c += BIAS_THREADS)
            if (c < lo * TILE || c >= hi * TILE) og[(int64_t)r * Sk + c] = 0.f;
      }
      return;
    }
    const int lane = threadIdx.x;
    const uint64_t policy = SUM ? evict_normal_policy() : evict_first_policy();
    int gi = 0;   // the ring's tiles so far
    for (int n = 0, b = b_begin; b < b_end && lo < hi; ++n, ++b) {
      const int p = n % QB, bh = b * H + h, bk = b * Hkv + h / (H / Hkv);
      mbar_wait(qfree + 8 * p, ((n / QB) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ready + 8 * p, 2 * NC * TB);
        for (int g = 0; g < NC; ++g) {
          load_tile<DP>(qd_s + (2 * NC * p + g) * TB, &map_q, ready + 8 * p, q0 + 64 * g, bh);
          load_tile<DP>(qd_s + (2 * NC * p + NC + g) * TB, &map_do, ready + 8 * p, q0 + 64 * g,
                        bh);
        }
      }
      const uint8_t* mg = kv_mask + (int64_t)b * Sk;
      const int plane = b * bias.bs + h * bias.hs;
      for (int kt = lo; kt < hi; ++kt, ++gi) {
        const int s = gi % STAGES;
        stream_tile<DENSE_BIAS, DP, NC>(&map_k, &map_v, &map_b, bias, st_s + s * 2 * TB,
                                        bias_s + s * BF * 4, flags + s * 128, full + 8 * s,
                                        empty + 8 * s, ((gi / STAGES) & 1) ^ 1, kt * TILE, q0,
                                        bk, plane, mg, Sq, Sk, causal, window, policy, lane);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;   // stores, frees the stage
  const int row0 = q0 + 64 * g + 16 * warp + lane / 4;   // rows row0, row0 + 8
  const int first = q0 + 64 * g, last = min(first + 63, Sq - 1);
  // the thread's bias and dS in stage 0's boxes: its first row in its
  // consumer's boxes, the swizzled offsets of its keys by 8-key group
  float* bias_t = bias_f + 2 * g * BOX + (16 * warp + lane / 4) * 32;
  int boff[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    boff[a] = ((2 * a + (lane % 4) / 2) ^ (lane / 4)) * 4 + (lane % 2) * 2;
  float* og = dbias + (int64_t)o * Sq * Sk;
  float acc[KT][32];   // SUM: the tiles' dS summed over the batch
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  int gi = 0, held = -1;   // the ring's tiles so far; the stage of the stores in flight

  // tile kt of batch n (stage gi % STAGES): its dS into ds, with the rows'
  // lse and delta ls, dl and the batch's resident Q and dO at qt, dot
  auto tile_ds = [&](float (&ds)[32], int kt, int s, uint32_t qt, uint32_t dot,
                     const float (&ls)[2], const float (&dl)[2]) {
    const int k0 = kt * TILE;
    const bool skip = first >= Sq || (causal && k0 > last) ||
                      (window > 0 && k0 + TILE - 1 <= first - window);
    if (skip) {
#pragma unroll
      for (int i = 0; i < 32; ++i) ds[i] = 0.f;
      return;
    }
    const uint32_t kst = st_s + s * 2 * TB, vst = kst + TB;
    float dp[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(ds, desc_k(qt, kd), desc_k(kst, kd), kd);
    wgmma_commit();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(dp, desc_k(dot, kd), desc_k(vst, kd), kd);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(ds);
    // p = exp(s scale + bias - lse) in natural units, zero where a key is
    // not visible
    const float* bt = bias_t + s * BF;
    const int* fl = flags + s * 128;
    bool clear = fl[TILE] && row0 + 8 < Sq;
    if (causal) clear = clear && k0 + TILE - 1 <= row0;
    if (window > 0) clear = clear && row0 + 8 - k0 < window;
    if (__all_sync(0xffffffffu, clear)) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = dq_bias2<DENSE_BIAS>(bt, j, boff);
        ds[2 * j] = exp2f((fmaf(ds[2 * j], scale, bb.x) - ls[j & 1]) * LOG2E);
        ds[2 * j + 1] = exp2f((fmaf(ds[2 * j + 1], scale, bb.y) - ls[j & 1]) * LOG2E);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = dq_bias2<DENSE_BIAS>(bt, j, boff);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e, r = j & 1, ci = acc_col(i, lane);
          const int row = row0 + 8 * r, col = k0 + ci;
          bool ok = fl[ci] && row < Sq;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && row - col < window;
          const float pr = exp2f((fmaf(ds[i], scale, e ? bb.y : bb.x) - ls[r]) * LOG2E);
          ds[i] = ok ? pr : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) ds[i] *= dp[i] - dl[(i >> 1) & 1];
  };
  // tile kt's result x out of stage s: by TMA from its bias boxes (the
  // stage freed once the next tile's stores are issued and these read), or
  // by plain stores; with `store` false only the stage freed
  auto finish = [&](const float (&x)[32], int kt, int s, bool store) {
    if (store && bias.tma) {
      float* bt = bias_t + s * BF;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(bt + (j >> 3) * BOX + (j & 1) * 8 * 32 + boff[(j >> 1) & 3]) =
            make_float2(x[2 * j], x[2 * j + 1]);
      fence_async_shared();
      consumer_sync(g);
      if (leader) {
        for (int hf = 0; hf < 2; ++hf)
          tma_store_3d(&map_db, bias_s + (s * BF + (2 * g + hf) * BOX) * 4,
                       kt * TILE + 32 * hf, first, o);
        if (held >= 0) {   // the last tile's two groups read
          store_wait_read<2>();
          mbar_arrive(empty + 8 * held);
        }
      }
      held = s;
      return;
    }
    if (store) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = row0 + 8 * ((i >> 1) & 1), col = kt * TILE + acc_col(i, lane);
        if (row < Sq && col < Sk) og[(int64_t)row * Sk + col] = x[i];
      }
    }
    consumer_sync(g);
    if (leader) mbar_arrive(empty + 8 * s);
  };

  for (int n = 0, b = b_begin; b < b_end && lo < hi; ++n, ++b) {
    const int p = n % QB, bh = b * H + h;
    const bool store = !SUM || b == b_end - 1;
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      ls[r] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
      dl[r] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
    }
    const uint32_t qt = qd_s + (2 * NC * p + g) * TB, dot = qd_s + (2 * NC * p + NC + g) * TB;
    mbar_wait(ready + 8 * p, (n / QB) & 1);
    if constexpr (SUM) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int kt = ka + j, s = gi % STAGES;
        if (kt < lo || kt >= hi) continue;
        mbar_wait(full + 8 * s, (gi / STAGES) & 1);
        float ds[32];
        tile_ds(ds, kt, s, qt, dot, ls, dl);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] += ds[i];
        finish(acc[j], kt, s, store);
        ++gi;
      }
    } else {
      for (int kt = lo; kt < hi; ++kt, ++gi) {
        const int s = gi % STAGES;
        mbar_wait(full + 8 * s, (gi / STAGES) & 1);
        float ds[32];
        tile_ds(ds, kt, s, qt, dot, ls, dl);
        finish(ds, kt, s, true);
      }
    }
    // every tile's products have read the buffer (each ended in consumer_sync)
    if (leader) mbar_arrive(qfree + 8 * p);
  }
  if (leader && held >= 0) store_wait_read();
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
                      const void* dout, const float* lse, float* delta, void* dq, float* partial,
                      int4 far, int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                      int causal, int window, cudaStream_t stream) {
  constexpr int NC = dq_consumers<DP, KIND>();
  if (KIND != T5_BIAS && partial) return cudaErrorInvalidValue;
  // T5: the head's table column on top, and with the table's gradient (its
  // own instance) the demb area
  const size_t bytes = smem_bytes<KIND, DP, NC, dq_bias_floats<KIND, NC>()>() +
                       (KIND == T5_BIAS ? bias.nb * sizeof(float) : 0) +
                       (partial ? demb_bytes(NC, stages<DP, KIND>(), bias.nb) : 0);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  const int items = B * H * ((Sq + 64 * NC - 1) / (64 * NC));
  const int grid = persistent<KIND, DP>() && num_sms() < items ? num_sms() : items;
  auto go = [&](auto kernel, bool& done) {
    cudaError_t err = allow_smem(kernel, KIND == T5_BIAS ? MAX_SMEM : bytes, done);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 128 * (NC + 1), bytes, stream>>>(
        m.q, m.dout, m.k, m.v, m.bias, m.out0, mask, bias, static_cast<const bf16*>(out),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), partial, far, B, D,
        H, Hkv, Sq, Sk, scale, causal, window);
    return cudaGetLastError();
  };
  static bool done = false;
  if constexpr (KIND == T5_BIAS) {
    static bool done_demb = false;
    if (partial) return go(dq_kernel<KIND, DP, NC, true>, done_demb);
  }
  return go(dq_kernel<KIND, DP, NC>, done);
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

template <int DP, bool SUM>
cudaError_t launch_dbias_as(const Maps& m, const uint8_t* mask, const Bias& bias, const float* lse,
                            const float* delta, float* dbias, int B, int H, int Hkv, int Sq,
                            int Sk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = dbias_smem_bytes<DP, SUM>();
  static_assert(bytes <= MAX_SMEM, "dbias's shared memory");
  static bool done = false;
  cudaError_t err = allow_smem(dbias_kernel<DP, SUM>, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(SUM ? H : B * H, (Sq + 127) / 128, SUM ? (Sk + DBIAS_KEYS - 1) / DBIAS_KEYS : 1);
  dbias_kernel<DP, SUM><<<grid, 384, bytes, stream>>>(m.q, m.dout, m.k, m.v, m.bias, m.out0, mask,
                                                      bias, lse, delta, dbias, B, H, Hkv, Sq, Sk,
                                                      scale, causal, window);
  return cudaGetLastError();
}

// A bias shared over a batch of more than one (bs == 0) sums it inside the
// kernel, one output plane per head; otherwise one per (batch, head).
template <int DP>
cudaError_t launch_dbias(const Maps& m, const uint8_t* mask, const Bias& bias, const float* lse,
                         const float* delta, float* dbias, int B, int H, int Hkv, int Sq, int Sk,
                         float scale, int causal, int window, cudaStream_t stream) {
  if (bias.bs == 0 && B > 1)
    return launch_dbias_as<DP, true>(m, mask, bias, lse, delta, dbias, B, H, Hkv, Sq, Sk, scale,
                                     causal, window, stream);
  return launch_dbias_as<DP, false>(m, mask, bias, lse, delta, dbias, B, H, Hkv, Sq, Sk, scale,
                                    causal, window, stream);
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
// bwd_dkv and bwd_dbias. With T5's table,
// partial (B, H, ceil(Sq / 64), nb) f32 is nullptr or receives the table's
// gradient summed per (batch, head, 64-row query tile), for the caller to sum
// over the batch and the tiles (demb; nullptr for every other bias kind),
// given the host's plan of far tiles (models/positional.py t5_far_tiles):
// a 64 x 64 tile of key offset k and query offset q with k - q <= far_neg
// has every diagonal in bucket b_neg, the index's first; with k - q >=
// far_pos in bucket b_pos, its last.
// Returns cudaGetLastError() after the launch (0 on success), or
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
           const void* out, const void* dout, const float* lse, float* delta, void* dq,
           float* partial, int far_neg, int far_pos, int b_neg, int b_pos, int B, int H, int Hkv,
           int Sq, int Sk, int D, float scale, int causal, int window, void* stream) {
  Maps m{};
  Bias b;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      !make_maps(&m, q, k, v, dout, B, H, Hkv, Sq, Sk, D) ||
      !bias_operands(&b, &m, bias, bs, hs, ld, t5_table, t5_index, nb, B, H, Sq, Sk) ||
      !tile_map(&m.out0, dq, (int64_t)B * H, Sq, D))
    return (int)cudaErrorInvalidValue;
  if (partial && (b_neg < 0 || b_neg >= nb || b_pos < 0 || b_pos >= nb))
    return (int)cudaErrorInvalidValue;
  return (int)BWD_DISPATCH(launch_dq, m, kv_mask, b, out, dout, lse, delta, dq, partial,
                           make_int4(far_neg, far_pos, b_neg, b_pos), B, H, Hkv, Sq, Sk, D,
                           scale, causal, window, static_cast<cudaStream_t>(stream));
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

// dbias f32: (H, Sq, Sk) summed over the batch when bs == 0 and B > 1 (a
// bias shared over the batch), else (B, H, Sq, Sk); per query head either
// way (the caller sums over the heads for h0 = 1). bias must not be nullptr,
// and is contiguous (ld = Sk); dout, lse and delta as for bwd_dkv. Where Sk
// % 4 == 0 and bias and dbias are 16-byte aligned, the bias is read and
// dbias written by TMA, else by cp.async and plain stores.
int bwd_dbias(const void* q, const void* k, const void* v, const uint8_t* kv_mask,
              const float* bias, int bs, int hs, const void* dout, const float* lse,
              const float* delta, float* dbias, int B, int H, int Hkv, int Sq, int Sk, int D,
              float scale, int causal, int window, void* stream) {
  Maps m{};
  Bias b;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bias == nullptr ||
      !make_maps(&m, q, k, v, dout, B, H, Hkv, Sq, Sk, D) ||
      !bias_operands(&b, &m, bias, bs, hs, Sk, nullptr, nullptr, 0, B, H, Sq, Sk))
    return (int)cudaErrorInvalidValue;
  b.tma = b.tma && reinterpret_cast<uintptr_t>(dbias) % 16 == 0;
  const int64_t planes = (int64_t)(bs == 0 && B > 1 ? 1 : B) * H;
  if (b.tma && !bias_map(&m.out0, dbias, planes, Sq, Sk, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 128 ? launch_dbias<128>(m, kv_mask, b, lse, delta, dbias, B, H, Hkv, Sq, Sk,
                                            scale, causal, window, s)
                        : launch_dbias<64>(m, kv_mask, b, lse, delta, dbias, B, H, Hkv, Sq, Sk,
                                           scale, causal, window, s));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
