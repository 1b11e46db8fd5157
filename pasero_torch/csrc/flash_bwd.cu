// The bias-free flash attention for Hopper (sm_90a), for grouped K/V heads:
// the forward (out and lse), then the backward's dq (and delta), dk and dv.
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
// What bounds it: operations. The function needs five products (QK^T and
// dO V^T recomputed, P^T dO, dS K, dS^T Q); at llama_1b's causal (4, 32/4,
// 2048, 64) one product is 34.4 GFLOP, so five take 0.174 ms at 989 TFLOP/s
// (bf16 dense), against 0.05 ms of bytes. This design runs seven, two
// kernels that each write their outputs once (dq; dk and dv), so no float
// atomics and no fp32 scratch, and the same inputs give the same bits: the
// dq kernel recomputes QK^T and dO V^T (three products), the dk/dv kernel
// recomputes them transposed (four).
//
// Design, for this card: every product is a wgmma (bf16 in, fp32 sums in
// registers). A block is a producer warpgroup (one thread issues TMA copies
// into a ring of shared-memory stages, its warp stages the per-row or per-key
// values beside them; setmaxnreg leaves it 40 registers, 24 beside three
// consumers) and two consumer warpgroups (232 registers), or three in the dq
// kernel at D <= 64 (160 registers), each owning 64 of the block's resident
// rows.
// - dk/dv (dkv_kernel): a block owns 128 keys of one K/V head; K and V stay
//   in shared memory; the 64-query tiles of every query head of its GQA group
//   stream through the ring (Q, dO, and lse and delta staged by the producer
//   warp). Per tile a consumer computes S^T = K Q^T and dP^T = V dO^T
//   (m64n64, both operands from shared memory), then P^T and dS^T in
//   registers, and dv += P^T dO, dk += dS^T Q with P^T and dS^T as the A
//   operand from registers (the accumulator layout of a 64 x 64 score tile is
//   the register layout of a 64 x 16 A slice), B the same Q and dO tiles read
//   transposed: no score tile goes through shared memory.
// - dq (dq_kernel): a block owns 128 or 192 queries of one query head, Q
//   and dO resident, the 64-key K and V tiles streamed with their key-mask
//   bits; S = Q K^T, dP = dO V^T, dS in registers, dq += dS K (A from
//   registers, K read transposed). Its consumers compute delta for their
//   rows from out and dO first, and write it for the dk/dv kernel.
// In both, a tile's gradient products stay in flight while the consumer
// waits for the next tile and issues its score products; the wait for
// those scores retires them and frees the tile's stage.
// Tiles are 64 rows by 64 (D = 32, 64) or 128 (D = 128) bf16 columns in 8 KB
// swizzled atoms of 64 columns (128-byte swizzle), copied by 3-D tensor maps
// (D, rows, batch x head), so a ragged tail, and the columns past D = 32, are
// filled with zeros by the copy and masked here. Causal balance: the grid's
// slow dimension runs the longest tiles first (the last query tiles for dq,
// the first key tiles for dk/dv), so the short ones fill in behind them on
// the 132 SMs; causal tiles past the diagonal and tiles outside a window are
// skipped. What holds it back: inside a warpgroup a tile's exponentials wait
// for its score products (the warpgroups overlap one another only), the
// m64n64 score products read both operands from shared memory, and ptxas
// serializes the wgmmas of dkv_kernel<64> (its note C7515) and, for want of
// registers, of dkv_kernel<128> (C7512).
//
// The biased and T5 kernels (flash_attention.cu, DENSE_BIAS and T5_BIAS
// instances of fwd_kernel / bwd_dq_kernel / bwd_dkv_kernel) are not these; the
// PTX wrappers for mbarriers, descriptors and the wgmma fences come from
// wgmma_gemm.cuh (the fused-CE mainloop).

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

constexpr int THREADS = 384;   // dk/dv: a producer and two consumer warpgroups
constexpr int ROWS = 128;      // dk/dv: a block's resident keys, 64 per consumer
constexpr int TILE = 64;       // rows of a streamed tile
// stages of the ring: four at D <= 64 (16 KB each), three at D = 128 (32 KB)
template <int DP>
__host__ __device__ constexpr int stages() { return DP == 64 ? 4 : 3; }
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

// Shared memory of a kernel with NC consumer warpgroups: 2 NC resident tiles
// (a 64-row part of each of two operands per consumer), the stages of two
// streamed tiles each, 128 floats a stage staged by the producer warp, the
// barriers, and 1024 bytes to align.
template <int DP, int NC>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int ST = stages<DP>();
  return (size_t)(2 * NC + 2 * ST) * tile_bytes<DP>() + ST * 128 * 4 + 8 * (1 + 2 * ST) + 1024;
}

// The dq kernel's consumer warpgroups: three at D <= 64, whose registers
// allow it (a producer with 24 and three consumers with 160 fill the SM's
// 65536), so two of them keep the tensor cores busy while one forms P and
// dS; two at D = 128 (232 registers each).
template <int DP>
__host__ __device__ constexpr int dq_consumers() { return DP == 64 ? 3 : 2; }

// 2^x by the special function unit (ex2.approx.ftz: results below 2^-126
// flush to zero, far inside the error model).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- forward -----------------------------------------------------------------------

// The forward's consumer warpgroups: three at D <= 64 (160 registers hold a
// score tile, the packed P and the output), two at D = 128 (232).
template <int DP>
__host__ __device__ constexpr int fwd_consumers() { return DP == 64 ? 3 : 2; }

// Shared memory of the forward: NC resident Q tiles, the stages of the K and
// V tiles, 128 ints a stage (the producer warp's key flags), the barriers,
// and 1024 bytes to align.
template <int DP, int NC>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  constexpr int ST = stages<DP>();
  return (size_t)(NC + 2 * ST) * tile_bytes<DP>() + ST * 128 * 4 + 8 * (1 + 2 * ST) + 1024;
}

// Block (bh, y): query head bh = b H + h, the 64 NC queries q0 = (n - 1 - y)
// 64 NC .. (the last, longest tiles first). Block tile t is key tile kt0 + t;
// consumer g reads the tiles [t0, t1) that its 64 rows can see and frees the
// others' stages unread. Per tile it runs S = Q K^T (m64n64, both operands
// from shared memory) and O += P V (P from registers in the
// accumulator layout, V read MN-major), with the online softmax in log2 units
// between them; P V of tile t - 1 is in flight while it forms P of tile t.
template <int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ kv_mask,
               bf16* __restrict__ out, float* __restrict__ lse, int D, int H, int Hkv, int Sq,
               int Sk, float scale, int causal, int window) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int ACC = DP / 2;
  constexpr int STAGES = stages<DP>();
  constexpr int ROWS_NC = 64 * NC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, st_s = base + NC * TB;
  int* flags = reinterpret_cast<int*>(smem_raw + (st_s + STAGES * 2 * TB - raw));
  const uint32_t bars = st_s + STAGES * 2 * TB + STAGES * 128 * 4;
  const uint32_t ready = bars, full = bars + 8, empty = full + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bk = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS_NC;
  int kt0 = 0, kt1 = (Sk + TILE - 1) / TILE;
  if (causal) kt1 = min(kt1, (q0 + ROWS_NC - 1) / TILE + 1);
  if (window > 0) kt0 = max(0, (q0 - window + 1) / TILE);
  const int iters = max(0, kt1 - kt0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(ready, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 2);    // the copies' arrival, the key flags'
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
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(ready, NC * TB);
      for (int g = 0; g < NC; ++g) load_tile<DP>(q_s + g * TB, &map_q, ready, q0 + 64 * g, bh);
    }
    const uint8_t* mg = kv_mask + (int64_t)b * Sk;
    // the lane's keys of block tile it, read a tile ahead so that their
    // latency hides behind the wait for a free stage
    auto keys = [&](int it, bool (&ok)[2]) {
      const int k0 = (kt0 + it) * TILE;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = k0 + lane + 32 * j;
        ok[j] = it < iters && i < Sk && mg[i];
      }
    };
    bool ok[2], next[2];
    keys(0, ok);
    for (int it = 0; it < iters; ++it) {
      const int s = it % STAGES, k0 = (kt0 + it) * TILE;
      keys(it + 1, next);
      mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, 2 * TB);
        load_tile<DP>(st_s + s * 2 * TB, &map_k, full + 8 * s, k0, bk);
        load_tile<DP>(st_s + s * 2 * TB + TB, &map_v, full + 8 * s, k0, bk);
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
    return;
  }

  if constexpr (NC == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * g + 16 * warp + lane / 4;   // rows row0, row0 + 8
  // the key tiles this consumer's rows can see, as block tiles [t0, t1)
  const int first = q0 + 64 * g;
  int c0 = kt0, c1 = kt1;
  if (causal) c1 = min(c1, (first + 63) / TILE + 1);
  if (window > 0) c0 = max(c0, (first - window + 1) / TILE);
  if (first >= Sq) c1 = c0;
  const int t0 = min(c0 - kt0, iters), t1 = max(t0, min(c1 - kt0, iters));
  // a tile read by no product of this consumer: its stage is freed once it
  // has landed (so the arrival counts for this tile's phase)
  auto pass = [&](int t) {
    const int s = t % STAGES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  };
  for (int t = 0; t < t0; ++t) pass(t);

  float o[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running row max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's part of the row sum
  const float sl2 = scale * LOG2E;
  const uint32_t qt = q_s + g * TB;
  uint32_t pa[4][4];
  float sc[32];
  float alpha[2];

  // the softmax of tile t over its scores S(t) in sc: P(t) in sc (fp32), l
  // and m updated, alpha the factor that takes O to the new max
  auto softmax = [&](int t) {
    const int s = t % STAGES, k0 = (kt0 + t) * TILE;
    const int* fl = flags + s * 128;
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
    float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
      mu[r] = mn == -INFINITY ? 0.f : mn;   // no visible key yet
      alpha[r] = exp2_approx(m[r] - mu[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2_approx(fmaf(sc[i], sl2, -mu[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
  };
  auto issue_s = [&](int t) {
    const int s = t % STAGES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      wgmma_ss_n64(sc, desc_k(qt, kd), desc_k(st_s + s * 2 * TB, kd), kd);
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
      wgmma_rs<DP>(o, pa[kk], desc_mn(st_s + (t % STAGES) * 2 * TB + TB, kk));
    wgmma_commit();
  };

  mbar_wait(ready, 0);
  if (t0 < t1) {
    issue_s(t0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(t0);
    pack_a(pa, sc);
    fence_regs(pa);
    // S(t) is issued before P V(t - 1) and retires first; the softmax of tile
    // t runs while P V(t - 1) is in flight. P is packed, and O rescaled, with
    // no product in flight.
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
      if (lane == 0) mbar_arrive(empty + 8 * ((t - 1) % STAGES));
      pack_a(pa, sc);
      fence_regs(pa);
    }
    rescale();
    issue_pv(t1 - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(empty + 8 * ((t1 - 1) % STAGES));
  }
  for (int t = t1; t < iters; ++t) pass(t);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row >= Sq) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
    bf16* go = out + ((int64_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(go + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[(int64_t)bh * Sq + row] = lr == 0.f ? NEG_INF : m[r] * LN2 + logf(lr);
  }
}

// -- dq (and delta) ----------------------------------------------------------------

// Block (bh, y): query head bh = b H + h, the 64 NC queries q0 = (n - 1 - y)
// 64 NC .. (the last, longest tiles first).
template <int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const uint8_t* __restrict__ kv_mask, const bf16* __restrict__ out,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int D, int H, int Hkv, int Sq,
              int Sk, float scale, int causal, int window) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int ACC = DP / 2;
  constexpr int STAGES = stages<DP>();
  constexpr int ROWS_NC = 64 * NC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + NC * TB, st_s = base + 2 * NC * TB;
  int* flags = reinterpret_cast<int*>(smem_raw + (st_s + STAGES * 2 * TB - raw));
  const uint32_t bars = st_s + STAGES * 2 * TB + STAGES * 128 * 4;
  const uint32_t ready = bars, full = bars + 8, empty = full + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bk = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS_NC;
  int kt0 = 0, kt1 = (Sk + TILE - 1) / TILE;
  if (causal) kt1 = min(kt1, (q0 + ROWS_NC - 1) / TILE + 1);
  if (window > 0) kt0 = max(0, (q0 - window + 1) / TILE);
  const int iters = max(0, kt1 - kt0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(ready, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 2);    // the copies' arrival, the key flags'
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
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(ready, 2 * NC * TB);
      for (int g = 0; g < NC; ++g) {
        load_tile<DP>(q_s + g * TB, &map_q, ready, q0 + 64 * g, bh);
        load_tile<DP>(do_s + g * TB, &map_do, ready, q0 + 64 * g, bh);
      }
    }
    const uint8_t* mg = kv_mask + (int64_t)b * Sk;
    for (int it = 0; it < iters; ++it) {
      const int s = it % STAGES, k0 = (kt0 + it) * TILE;
      mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, 2 * TB);
        load_tile<DP>(st_s + s * 2 * TB, &map_k, full + 8 * s, k0, bk);
        load_tile<DP>(st_s + s * 2 * TB + TB, &map_v, full + 8 * s, k0, bk);
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
    return;
  }

  if constexpr (NC == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * g + 16 * warp + lane / 4;   // rows row0, row0 + 8
  // delta of the thread's two rows, a quad per row, written for dk/dv
  float dl[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.f;
    if (row < Sq) {
      const bf16* og = out + ((int64_t)bh * Sq + row) * D;
      const bf16* dg = dout + ((int64_t)bh * Sq + row) * D;
      for (int d = 2 * (lane % 4); d < D; d += 8) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(og + d));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dg + d));
        acc += a.x * c.x + a.y * c.y;
      }
    }
    dl[r] = quad_sum(acc);
    lse2[r] = row < Sq ? lse[(int64_t)bh * Sq + row] * LOG2E : 0.f;
    if (lane % 4 == 0 && row < Sq) delta[(int64_t)bh * Sq + row] = dl[r];
  }

  float dqa[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) dqa[i] = 0.f;
  const float sl2 = scale * LOG2E;
  const uint32_t qt = q_s + g * TB, dot = do_s + g * TB;
  mbar_wait(ready, 0);

  // Each tile's dq product is left in flight: the next tile's waits and
  // score products queue behind it, and its stage is freed once they have
  // retired it.
  uint32_t da[4][4];
  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES, k0 = (kt0 + it) * TILE;
    const uint32_t kst = st_s + s * 2 * TB, vst = kst + TB;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
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
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    const int* fl = flags + s * 128;
    // no element of the warp's rows masked: every key present, rows inside
    // Sq, the causal edge and the window clear of the tile
    bool clear = fl[TILE] && row0 + 8 < Sq;
    if (causal) clear = clear && k0 + TILE - 1 <= row0;
    if (window > 0) clear = clear && row0 + 8 - k0 < window;
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* gq = dq + ((int64_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(gq + col) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
    }
  }
}

// -- dk, dv ------------------------------------------------------------------------

// Block (bk, y): K/V head bk = b Hkv + hk, the 128 keys j0 = 128 y .. (the
// first, longest tiles first under a causal mask). Inner tile it: query
// head hk G + it / ntiles, query tile it0 + it % ntiles.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const uint8_t* __restrict__ kv_mask, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
               int D, int H, int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int ACC = DP / 2;
  constexpr int STAGES = stages<DP>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + 2 * TB, st_s = base + 4 * TB;
  float* rows = reinterpret_cast<float*>(smem_raw + (st_s + STAGES * 2 * TB - raw));
  const uint32_t bars = st_s + STAGES * 2 * TB + STAGES * 128 * 4;
  const uint32_t ready = bars, full = bars + 8, empty = full + 8 * STAGES;

  const int bk = blockIdx.x, b = bk / Hkv, hk = bk % Hkv;
  const int group = H / Hkv;
  const int j0 = blockIdx.y * ROWS;
  const int it0 = causal ? j0 / TILE : 0;
  int it1 = (Sq + TILE - 1) / TILE;
  if (window > 0) it1 = min(it1, (j0 + ROWS + window - 2) / TILE + 1);
  const int ntiles = max(0, it1 - it0);
  const int iters = group * ntiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(ready, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 2);    // the copies' arrival, lse and delta's
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(ready, 4 * TB);
      for (int g = 0; g < 2; ++g) {
        load_tile<DP>(k_s + g * TB, &map_k, ready, j0 + 64 * g, bk);
        load_tile<DP>(v_s + g * TB, &map_v, ready, j0 + 64 * g, bk);
      }
    }
    for (int it = 0; it < iters; ++it) {
      const int s = it % STAGES;
      const int bh = b * H + hk * group + it / ntiles, i0 = (it0 + it % ntiles) * TILE;
      mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, 2 * TB);
        load_tile<DP>(st_s + s * 2 * TB, &map_q, full + 8 * s, i0, bh);
        load_tile<DP>(st_s + s * 2 * TB + TB, &map_do, full + 8 * s, i0, bh);
      }
      // lse in log2 units and delta of the tile's 64 queries
      for (int i = lane; i < TILE; i += 32) {
        const bool ok = i0 + i < Sq;
        const int64_t at = (int64_t)bh * Sq + i0 + i;
        rows[s * 128 + i] = ok ? lse[at] * LOG2E : 0.f;
        rows[s * 128 + 64 + i] = ok ? delta[at] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full + 8 * s);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int key0 = j0 + 64 * g + 16 * warp + lane / 4;   // rows key0, key0 + 8
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    key_ok[r] = key < Sk && kv_mask[(int64_t)b * Sk + key];
  }
  float dka[ACC], dva[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) dka[i] = dva[i] = 0.f;
  const float sl2 = scale * LOG2E;
  const uint32_t kt = k_s + g * TB, vt = v_s + g * TB;
  mbar_wait(ready, 0);

  // Each tile's dk and dv products are left in flight, as in dq_kernel.
  uint32_t pa[4][4], da[4][4];
  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES, i0 = (it0 + it % ntiles) * TILE;
    const uint32_t qst = st_s + s * 2 * TB, dost = qst + TB;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    float st[32], dpt[32];   // transposed: rows are keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(st, desc_k(kt, kd), desc_k(qst, kd), kd);
    wgmma_commit();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) wgmma_ss_n64(dpt, desc_k(vt, kd), desc_k(dost, kd), kd);
    wgmma_commit();
    wgmma_wait<1>();   // the last tile's dk, dv products and this tile's S^T
    fence_regs(st);
    fence_regs(pa);    // the last products' A registers live until here
    fence_regs(da);
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    const float* rl = rows + s * 128;
    // no element of the thread's keys masked, for the whole warp
    bool clear = key_ok[0] && key_ok[1] && i0 + TILE <= Sq;
    if (causal) clear = clear && key0 + 8 <= i0;
    if (window > 0) clear = clear && i0 + TILE - 1 - key0 < window;
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    bf16* gk = dk + ((int64_t)bk * Sk + key) * D;
    bf16* gv = dv + ((int64_t)bk * Sk + key) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(gk + col) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(gv + col) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
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

// q, dO (and out) are (B H, Sq, D); k, v (B Hkv, Sk, D).
struct Maps {
  CUtensorMap q, dout, k, v;
};

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

bool bad_args(int B, int H, int Hkv, int Sq, int Sk, int D, int window) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
         (D != 32 && D != 64 && D != 128) || window < 0 || (Sq + ROWS - 1) / ROWS > 65535 ||
         (Sk + ROWS - 1) / ROWS > 65535;
}

template <int DP>
cudaError_t launch_fwd(const CUtensorMap& map_q, const CUtensorMap& map_k, const CUtensorMap& map_v,
                       const uint8_t* mask, void* out, float* lse, int B, int H, int Hkv, int Sq,
                       int Sk, int D, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int NC = fwd_consumers<DP>();
  constexpr size_t bytes = fwd_smem_bytes<DP, NC>();
  static bool done = false;
  cudaError_t err = allow_smem(fwd_kernel<DP, NC>, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + 64 * NC - 1) / (64 * NC));
  fwd_kernel<DP, NC><<<grid, 128 * (NC + 1), bytes, stream>>>(
      map_q, map_k, map_v, mask, static_cast<bf16*>(out), lse, D, H, Hkv, Sq, Sk, scale, causal,
      window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const Maps& m, const uint8_t* mask, const void* out, const void* dout,
                      const float* lse, float* delta, void* dq, int B, int H, int Hkv, int Sq,
                      int Sk, int D, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int NC = dq_consumers<DP>();
  constexpr size_t bytes = smem_bytes<DP, NC>();
  static bool done = false;
  cudaError_t err = allow_smem(dq_kernel<DP, NC>, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + 64 * NC - 1) / (64 * NC));
  dq_kernel<DP, NC><<<grid, 128 * (NC + 1), bytes, stream>>>(
      m.q, m.dout, m.k, m.v, mask, static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      lse, delta, static_cast<bf16*>(dq), D, H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const Maps& m, const uint8_t* mask, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
                       float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP, 2>();
  static bool done = false;
  cudaError_t err = allow_smem(dkv_kernel<DP>, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hkv, (Sk + ROWS - 1) / ROWS);
  dkv_kernel<DP><<<grid, THREADS, bytes, stream>>>(
      m.q, m.dout, m.k, m.v, mask, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), D,
      H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace flash_bwd

using namespace flash_bwd;

extern "C" {

// The bias-free forward: q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) bfloat16,
// contiguous, 16-byte aligned; kv_mask (B, Sk) uint8 (1 = key present). D is
// 32, 64 or 128; window 0 means none. Writes out (B, H, Sq, D) bfloat16 and
// lse (B, H, Sq) f32 (natural log; -1e30 and out = 0 for a row that sees no
// key). Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int fwd(const void* q, const void* k, const void* v, const uint8_t* kv_mask, void* out, float* lse,
        int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
        void* stream) {
  CUtensorMap mq, mk, mv;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || !tile_map(&mq, q, (int64_t)B * H, Sq, D) ||
      !tile_map(&mk, k, (int64_t)B * Hkv, Sk, D) || !tile_map(&mv, v, (int64_t)B * Hkv, Sk, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 128 ? launch_fwd<128>(mq, mk, mv, kv_mask, out, lse, B, H, Hkv, Sq, Sk, D,
                                          scale, causal, window, s)
                        : launch_fwd<64>(mq, mk, mv, kv_mask, out, lse, B, H, Hkv, Sq, Sk, D,
                                         scale, causal, window, s));
}

// q, out, dout (B, H, Sq, D) and k, v (B, Hkv, Sk, D): bfloat16, contiguous,
// 16-byte aligned; kv_mask (B, Sk) uint8 (1 = key present); lse (B, H, Sq)
// f32 from the bias-free forward. D is 32, 64 or 128; window 0 means none.
// Writes dq (B, H, Sq, D) bfloat16 and delta (B, H, Sq) f32 for bwd_dkv.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int bwd_dq(const void* q, const void* k, const void* v, const uint8_t* kv_mask, const void* out,
           const void* dout, const float* lse, float* delta, void* dq, int B, int H, int Hkv,
           int Sq, int Sk, int D, float scale, int causal, int window, void* stream) {
  Maps m;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || !make_maps(&m, q, k, v, dout, B, H, Hkv, Sq, Sk, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 128 ? launch_dq<128>(m, kv_mask, out, dout, lse, delta, dq, B, H, Hkv, Sq, Sk,
                                         D, scale, causal, window, s)
                        : launch_dq<64>(m, kv_mask, out, dout, lse, delta, dq, B, H, Hkv, Sq, Sk,
                                        D, scale, causal, window, s));
}

// dk, dv (B, Hkv, Sk, D) bfloat16, summed over each K/V head's query heads,
// from bwd_dq's delta.
int bwd_dkv(const void* q, const void* k, const void* v, const uint8_t* kv_mask,
            const void* dout, const float* lse, const float* delta, void* dk, void* dv, int B,
            int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
            void* stream) {
  Maps m;
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || !make_maps(&m, q, k, v, dout, B, H, Hkv, Sq, Sk, D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 128 ? launch_dkv<128>(m, kv_mask, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, D,
                                          scale, causal, window, s)
                        : launch_dkv<64>(m, kv_mask, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, D,
                                         scale, causal, window, s));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
