// The two mainloops that stream a weight W (N, K) against a few rows of x
// (M, K) bfloat16 with the operands swapped, y^T = W . x^T: W's rows are the
// m side of the tensor cores' products and x's rows the n side. W is int8
// (converted to bfloat16 on the chip, exactly) or bfloat16, row-major in the
// port's (out, in) layout. int8_matmul.cu (the weight product) and
// fused_head.cu (the greedy head's per-tile argmax partials) run them, each
// with its own epilogue; the mainloops know nothing of what is done with the
// float32 sums.
//
// What bounds them: bytes at decode rows, operations at prompt rows. A
// weight is read once per decoder call, so the decode mainloop must stream
// it at HBM's rate; at a prompt the tensor cores' full rate, which only
// wgmma reaches, decides it.
//
// Decode rows (M <= SMALL_MAX_M: a decode step, a speculative chunk),
// decode_kernel. Three things keep a small product from the memory rate: a
// tile with half its rows empty, too few blocks to have enough bytes in
// flight (a 2048 x 256 K/V projection is 0.5 MB), and the fixed cost of a
// launch and of merging partial sums. So:
// - The operands are swapped: the weight's rows fill the m16 side of
//   mma.sync m16n8k16 and x's rows the n8 side, 8 NT columns of the output,
//   so no tile is multiplied half empty at M = 8, and M = 72 reads W once.
// - K is split across the blocks of a thread-block cluster (up to 8) so that
//   every shape spreads over about two blocks an SM (decode_plan: tiles of
//   64 weight rows, 16 for a narrow weight at up to 16 rows of x). Each
//   block stores its partial sums into the shared memory of the cluster
//   rank that finishes their rows, by st.async counted in bytes on that
//   rank's barrier, and the rank adds them in a fixed order (rank, then
//   warp): one launch, no atomics, the same bits from two calls, and no
//   cluster barrier at the end (a relaxed one at the start tells a block
//   that the others run). A wide weight (the vocabulary head's 500 tiles)
//   takes no split.
// - A producer thread streams the block's share of the weight through a
//   ring of up to 8 stages by TMA, boxes of 128 bytes x 64 (or 16) rows of
//   its tensor map (128 k of int8, 64 k of bfloat16) counted in bytes on the
//   stage's mbarrier, with an L2 evict-first hint (a weight is read once per
//   decoder call). x's rows of the same k ride the stage beside it in boxes
//   of 64 k; every block reads its k slice of x once, as a resident copy
//   would (a resident 80 x 2048 x would not fit). A stage is 256 k deep at
//   up to 16 rows of x and 128 above, so that two blocks fit an SM at M =
//   80. (One cp.async.bulk per 256-byte row, 72 to 136 copies a stage, is
//   bound by the count of its copies, not by their bytes.)
// - The four consumer warps convert each int8 weight word to bfloat16 as
//   they read it (int8x4_to_bf16x4). The boxes land under the 128-byte
//   swizzle, so the eight rows of a warp's fragment read fall on distinct
//   16-byte chunks; rows past N and M read as zeros and the last stage's k
//   is cut to K. At up to 16 rows a warp keeps two chains of
//   sums; above, one, and the next step's words in flight while this step's
//   products run.
// The epilogue gets each rank's finished rows: their sums over the ranks and
// warps in recv, and the rows' scales.
//
// Prompts (M > SMALL_MAX_M), prompt_kernel, int8 weights: the weight's rows
// are wgmma's A side, 64 a consumer warpgroup, and x's rows its B side (64,
// 128, 192 or 256 of them, prompt_bx), read K-major from shared memory as x
// lies in device memory. Each consumer reads its int8 A fragment from the
// stage, converts it to bf16 in registers (int8x4_to_bf16x4) and issues
// wgmma with A from registers: the conversion costs registers and a few
// instructions a 16-deep step, and no shared-memory write. A producer thread
// feeds a ring of 4-8 stages by TMA, the weight's box under the 64-byte
// swizzle (its eight rows of a fragment read fall on distinct banks) and x's
// under the 128-byte one, so a weight tile is read once per x tile and x
// once per weight tile; a persistent grid walks the tiles with the x tiles of
// one weight tile together, so the blocks that share a weight tile read it
// from device memory once. No atomics and no split of K: two calls give the
// same bits. The epilogue gets each consumer thread's accumulators, their
// rows' scales and 32 KB of shared memory.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace weight_gemm {

using wgmma_gemm::mbar_arrive;
using wgmma_gemm::mbar_expect_tx;
using wgmma_gemm::mbar_init;
using wgmma_gemm::mbar_wait;
using wgmma_gemm::smem_u32;
using wgmma_gemm::wgmma_commit;
using wgmma_gemm::wgmma_fence;
using wgmma_gemm::wgmma_wait;
namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

// x's rows up to which a product takes the decode mainloop (a decode step, a
// speculative chunk); more rows take the prompt's.
constexpr int SMALL_MAX_M = 80;

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one 32-bit word, lowest byte first) -> four bf16 in two words,
// exactly: byte v + 128 becomes the mantissa of the float 2^23 + v + 128, the
// subtraction leaves v, and v (|v| <= 128) has at most 8 significant bits, so
// its float's upper half is its bf16.
__device__ inline void int8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Dynamic shared memory above 48 KB, once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// -- decode rows -------------------------------------------------------------------

constexpr int DEC_WARPS = 4;                        // consumer warps
constexpr int DEC_THREADS = 32 * (DEC_WARPS + 1);   // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;                      // the portable cluster size
constexpr int STAGE_BUDGET = 48 * 1024;             // two or more blocks an SM
constexpr int BLOCKS_PER_SM = 2;                    // the blocks a layout aims at
constexpr int NARROW_MAX_M = 16;                    // rows that may take 16-row tiles
constexpr int DEEP_MAX_NT = 2;                      // n8 tiles that take 256-deep stages
constexpr int MAX_PROMPT_SMEM = 232448;            // shared memory a block can have

// The k of a stage: 256 at decode rows (up to 8 DEEP_MAX_NT), whose stages
// are small; 128 above, so that two blocks of 8 NT rows of x fit an SM.
template <int NT>
__host__ __device__ constexpr int stage_k() { return NT <= DEEP_MAX_NT ? 256 : 128; }

// A 2-D box of a tensor map into shared memory, counted on `bar`, with an L2
// cache policy; c0 runs along the contiguous dimension.
__device__ __forceinline__ void tma_load_hint(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "l"(policy)
      : "memory");
}
// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col), as
// mma but not volatile: the compiler may move the surrounding shared-memory
// reads across it.
__device__ __forceinline__ void mma_sched(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The two halves of a cluster barrier: an arrival that orders nothing (the
// barriers' initialization is published by its own fence; a release here
// would hold the producer until its first copies land), and the wait for
// every thread of the cluster's arrival. A block touches another's shared
// memory only once that block is known to run, with its barriers set.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this block's shared-memory address `a` in cluster rank r.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}
// 4 bytes into cluster shared memory, counted in bytes on the receiver's
// barrier (both addresses from cluster_addr).
__device__ __forceinline__ void store_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
// A weight byte is read once a decoder call: its copies ask L2 to evict it
// first, so that it does not push out x, which every column block reads.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// The weight's element type in a decode stage. A box row is 128 bytes: 128 k
// of int8 or 64 k of bfloat16. Lane (g, t) of a warp takes, in a 16-deep
// step, the step's columns 4t .. 4t + 3 of rows g and g + 8 of its slice (one
// Word each: a 32-bit word of int8, a 64-bit one of bfloat16) as mma's A
// slots k = 2t, 2t + 1, 2t + 8, 2t + 9; `at` is the step's offset from the
// lane's first byte (lane(t)) of row g, under the 128-byte swizzle (row r's
// 16-byte chunk c at chunk c ^ (r % 8)); wb is a box's bytes.
struct Int8Weight {
  typedef int8_t T;
  typedef uint32_t Word;
  static constexpr int BOX_K = 128;
  static constexpr bool SCALED = true;   // a float32 scale per row
  __device__ static __forceinline__ int lane(int t) { return 4 * t; }
  __device__ static __forceinline__ int at(int ks, int g, int t, int wb) {
    return (ks / 8) * wb + (((ks % 8) ^ g) << 4);
  }
  __device__ static __forceinline__ void frag(const Word (&wv)[2], uint32_t (&a)[4]) {
    int8x4_to_bf16x4(wv[0], a[0], a[2]);
    int8x4_to_bf16x4(wv[1], a[1], a[3]);
  }
};
struct Bf16Weight {
  typedef bf16 T;
  typedef uint2 Word;
  static constexpr int BOX_K = 64;
  static constexpr bool SCALED = false;
  __device__ static __forceinline__ int lane(int t) { return (t % 2) * 8; }
  __device__ static __forceinline__ int at(int ks, int g, int t, int wb) {
    return (ks / 4) * wb + (((2 * (ks % 4) + t / 2) ^ g) << 4);
  }
  __device__ static __forceinline__ void frag(const Word (&wv)[2], uint32_t (&a)[4]) {
    a[0] = wv[0].x;
    a[2] = wv[0].y;
    a[1] = wv[1].x;
    a[3] = wv[1].y;
  }
};

// Bytes of a stage of k BK: BK / BOX_K weight boxes (BOX_K k x bn rows) and
// BK / 64 x boxes (64 k x 8 NT rows), each row 128 bytes, 128-byte swizzled,
// so every box starts 1024-byte aligned.
template <class W>
__host__ __device__ constexpr int stage_bytes(int bk, int bn, int mp) {
  return bk * (bn * (int)sizeof(typename W::T) + 2 * mp);
}

// The (bn, 8 NT) tile y[:, n0 .. n0 + bn) of x's rows (NT = ceil(M / 8)) at
// column block blockIdx.y, its k split over the cluster along x: cluster
// rank c sums k steps [c S / cs, (c + 1) S / cs) of the S = ceil(K / BK).
// bn = 64: warp w owns weight rows 16 w ..; bn = 16: every warp owns the 16
// rows and takes every fourth 16-deep step of a stage (wk_n = 4 ways).
// Rows [o R, o R + R) of the tile (R = ceil(bn / cs)) are cluster rank o's
// to finish: every warp stores its partial sums of them into rank o's shared
// memory by st.async, counted on rank o's receiving barrier, and rank o hands
// them to the epilogue once they have all landed; no cluster barrier waits
// at the end. Shared memory: the stages (1024-byte aligned), a full and an
// empty barrier per stage, the receiving barrier, the partial sums received,
// ((c wk_n + w) 8 NT + m) R + r for rank c, warp split w, x row m and row r,
// and the R rows' scales (1 for a weight without them, 0 past N).
//
// The epilogue, called by all DEC_THREADS threads after a __syncthreads():
// epi(recv, row_scale, parts = cs wk_n, MP = 8 NT, R, nr, n = the first of
// the rank's nr rows, M, N, part = blockIdx.y cs + rank), which sums each
// output over the parts in order.
template <int NT, class W, class Epi>
__global__ void __launch_bounds__(DEC_THREADS, 3)
    decode_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const float* __restrict__ scale,
                  const Epi epi, int M, int N, int K, int bn, int stages) {
  extern __shared__ __align__(1024) unsigned char dec_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  constexpr int MP = 8 * NT;
  constexpr int BK = stage_k<NT>(), KS = BK / 16, WBOX = BK / W::BOX_K, XBOX = BK / 64;
  // decode rows: two chains of accumulators (a stage's even and odd steps,
  // added at the end), each step's words read as it runs; more rows: one
  // chain, the next step's words read while this one's products run
  constexpr bool PIPE = NT > DEEP_MAX_NT;
  constexpr int CH = PIPE ? 1 : 2;
  const int sb = stage_bytes<W>(BK, bn, MP), wb = 128 * bn;   // a stage, a weight box
  const int wk_n = DEC_WARPS * 16 / bn;                       // warps splitting a stage's k
  const int R = (bn + cs - 1) / cs;                           // rows a rank finishes
  const int r0 = rank * R, nr = min(R, bn - r0);              // this rank's
  const uint32_t raw = smem_u32(dec_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ring = dec_smem + (base - raw);
  // stage s: full at 16 s, empty at 16 s + 8; then the receiving barrier
  const uint32_t bars = base + stages * sb, rbar = bars + 16 * stages;
  float* recv = reinterpret_cast<float*>(ring + stages * (sb + 16) + 16);
  float* row_scale = recv + cs * wk_n * MP * R;
  const int n0 = blockIdx.y * bn;
  const int steps = (K + BK - 1) / BK;
  const int s0 = rank * steps / cs, n_steps = (rank + 1) * steps / cs - s0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the producer: a stage's weight and x boxes (none wholly past K); its
  // thread initializes the barriers and fills the ring before the block's
  // first barrier, so that the copies start at once
  const bool producer = threadIdx.x == 32 * DEC_WARPS;
  uint64_t policy = 0;
  auto produce = [&](int i) {
    const int s = i % stages, k0 = (s0 + i) * BK;
    const uint32_t full = bars + 16 * s, ws = base + s * sb, xs = ws + WBOX * wb;
    const int wboxes = min(WBOX, (K - k0 + W::BOX_K - 1) / W::BOX_K);
    const int xboxes = min(XBOX, (K - k0 + 63) / 64);
    mbar_wait(full + 8, ((i / stages) & 1) ^ 1);
    mbar_expect_tx(full, wboxes * wb + xboxes * MP * 128);
    for (int b = 0; b < wboxes; ++b)
      tma_load_hint(ws + b * wb, &map_w, full, k0 + W::BOX_K * b, n0, policy);
    for (int a = 0; a < xboxes; ++a)
      wgmma_gemm::tma_load(xs + a * MP * 128, &map_x, full, k0 + 64 * a, 0);
  };
  if (producer) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_w) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_x) : "memory");
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 16 * s, 1);              // the producer's arrival and the bytes
      mbar_init(bars + 16 * s + 8, DEC_WARPS);  // lane 0 of each consumer warp
    }
    // the receiving barrier: this thread's arrival and every partial sum
    // of the rank's rows, from each rank and warp split
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(rbar, max(nr, 0) * MP * 4 * cs * wk_n);
    policy = evict_first_policy();
    for (int i = 0; i < min(stages, n_steps); ++i) produce(i);
  }
  __syncthreads();
  cluster_arrive_relaxed();   // waited for before the partial sums are stored

  if (warp == DEC_WARPS) {
    if (producer)
      for (int i = stages; i < n_steps; ++i) produce(i);
    __syncwarp();
    cluster_wait();
  } else {
    // a consumer: lane (g, t) holds weight rows g, g + 8 of its slice and x
    // row 8 j + g of each n8 tile j; within a 16-deep step its A and B slots
    // k = 2t, 2t + 1, 2t + 8, 2t + 9 take the step's columns 4t .. 4t + 3
    // (the same order for both operands), so a lane reads one Word of a
    // weight row and one 64-bit word of an x row; with the swizzle the
    // eight rows of a warp's read fall on distinct 16-byte chunks
    typedef typename W::Word Word;
    const int wn = warp / wk_n, wk = warp % wk_n;
    const int g = lane / 4, t = lane % 4;
    float acc[CH][NT][4];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % stages, kc = min(BK, K - (s0 + i) * BK);
      mbar_wait(bars + 16 * s, (i / stages) & 1);
      const unsigned char* wr = ring + s * sb + (16 * wn + g) * 128 + W::lane(t);
      const unsigned char* xr = ring + s * sb + WBOX * wb + g * 128 + (t % 2) * 8;
      // the operands of the 16-deep step ks of the stage: the weight's two
      // Words (rows g and g + 8); x box ks / 4, chunk 2 (ks % 4) + t / 2 (a
      // 64-bit word per n8 tile)
      auto load = [&](int ks, Word (&wv)[2], uint2 (&xv)[NT]) {
        const unsigned char* w = wr + W::at(ks, g, t, wb);
        wv[0] = *reinterpret_cast<const Word*>(w);
        wv[1] = *reinterpret_cast<const Word*>(w + 8 * 128);
        const unsigned char* xk = xr + (ks / 4) * MP * 128 + (((2 * (ks % 4) + t / 2) ^ g) << 4);
#pragma unroll
        for (int j = 0; j < NT; ++j) xv[j] = *reinterpret_cast<const uint2*>(xk + j * 8 * 128);
      };
      // their products into chain d, an int8 weight converted to bf16 first
      auto multiply = [&](const Word (&wv)[2], const uint2 (&xv)[NT], float (&d)[NT][4]) {
        uint32_t a[4];
        W::frag(wv, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (PIPE)
            mma_sched(d[j], a, xv[j].x, xv[j].y);
          else
            mma(d[j], a, xv[j].x, xv[j].y);
        }
      };
      // a whole stage: this warp's P of its KS steps, unrolled
      auto whole = [&](auto p) {
        constexpr int P = decltype(p)::value;
        if constexpr (PIPE) {
          Word wv[2][2];
          uint2 xv[2][NT];
          load(wk, wv[0], xv[0]);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            if (i + 1 < P) load(wk + (KS / P) * (i + 1), wv[(i + 1) % 2], xv[(i + 1) % 2]);
            multiply(wv[i % 2], xv[i % 2], acc[i % CH]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < P; ++i) {
            Word wv[2];
            uint2 xv[NT];
            load(wk + (KS / P) * i, wv, xv);
            multiply(wv, xv, acc[i % CH]);
          }
        }
      };
      if (kc == BK && wk_n == 1)
        whole(std::integral_constant<int, KS>());
      else if (kc == BK && wk_n == 4)
        whole(std::integral_constant<int, KS / 4>());
      else
        for (int ks = wk; ks < kc / 16; ks += wk_n) {
          Word wv[2];
          uint2 xv[NT];
          load(ks, wv, xv);
          multiply(wv, xv, acc[0]);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 16 * s + 8);
    }
    // the warp's partial sums of rows nl = 16 wn + g (+ 8), into the
    // memory of the rank that finishes them
    cluster_wait();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nl = 16 * wn + g + 8 * h, o = nl / R;
      const int at = ((rank * wk_n + wk) * MP + 2 * t) * R + nl - o * R;
      const uint32_t dst = cluster_addr(smem_u32(recv + at), o), bar = cluster_addr(rbar, o);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v0 = acc[0][j][2 * h], v1 = acc[0][j][2 * h + 1];
        if constexpr (CH == 2) {
          v0 += acc[1][j][2 * h];
          v1 += acc[1][j][2 * h + 1];
        }
        store_async(dst + 4 * 8 * j * R, v0, bar);
        store_async(dst + 4 * (8 * j + 1) * R, v1, bar);
      }
    }
  }
  // this rank's rows [r0, r0 + nr) of the tile: their scales staged while
  // the sums arrive, then the epilogue
  if (threadIdx.x < nr) {
    const int n = n0 + r0 + (int)threadIdx.x;
    if constexpr (W::SCALED)
      row_scale[threadIdx.x] = n < N ? scale[n] : 0.f;
    else
      row_scale[threadIdx.x] = n < N ? 1.f : 0.f;
  }
  mbar_wait(rbar, 0);   // every partial sum of these rows landed
  __syncthreads();      // and every scale staged
  epi(recv, row_scale, cs * wk_n, MP, R, nr, n0 + r0, M, N, (int)blockIdx.y * cs + rank);
}

// The card's SMs.
inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// How a decode product is laid out: about BLOCKS_PER_SM blocks an SM.
// Weight tiles of 64 rows, or, at up to NARROW_MAX_M rows, 16 where 64-row
// tiles would leave fewer blocks than SMs even split 8 ways (16-row tiles
// re-read x once per 16 rows); the cluster (the k split) as wide as that
// target asks, at most 8 and at most the k steps; as many stages as a
// block's steps, within STAGE_BUDGET (at least two).
struct DecodePlan {
  int bn, tiles, cs, stages;
  size_t smem;
};

template <int NT, class W>
DecodePlan decode_plan(int M, int N, int K) {
  constexpr int BK = stage_k<NT>();
  const int steps = (K + BK - 1) / BK;
  const int sms = num_sms();
  DecodePlan p;
  p.bn = M <= NARROW_MAX_M && (N + 63) / 64 * std::min(MAX_CLUSTER, steps) < sms ? 16 : 64;
  p.tiles = (N + p.bn - 1) / p.bn;
  p.cs = std::max(1, std::min({MAX_CLUSTER, steps,
                               (BLOCKS_PER_SM * sms + p.tiles - 1) / p.tiles}));
  const int sb = stage_bytes<W>(BK, p.bn, 8 * NT);
  p.stages = std::min({MAX_STAGES, (steps + p.cs - 1) / p.cs, std::max(2, STAGE_BUDGET / sb)});
  // the partial sums a rank receives (from each rank and warp split, its R
  // rows of 8 NT columns) and its rows' scales
  const int R = (p.bn + p.cs - 1) / p.cs, wk_n = DEC_WARPS * 16 / p.bn;
  p.smem = 1024 + (size_t)p.stages * (sb + 16) + 16 + ((size_t)p.cs * wk_n * 8 * NT + 1) * R * 4;
  return p;
}

// The tensor map of x (rows M, K) bf16, boxes of 64 k x box (8 NT) rows,
// or of the weight (rows N, K), boxes of 128 bytes (BOX_K k) x box (bn)
// rows, all 128-byte swizzled (rows past the last read as zeros).
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int K, int box, bool int8) {
  if (!int8) return wgmma_gemm::operand_map(map, ptr, rows, K, K, false, box);
  wgmma_gemm::EncodeTiled fn = wgmma_gemm::encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t boxes[2] = {128, (cuuint32_t)box};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, boxes,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One decode launch by decode_plan<NT, W>'s layout: x (M, K) bf16, w (N,
// K) of W's type, scale (N,) float32 for an int8 weight.
template <int NT, class W, class Epi>
cudaError_t launch_decode(const void* x, const void* w, const float* scale, int M, int N, int K,
                          const Epi& epi, cudaStream_t stream) {
  const DecodePlan p = decode_plan<NT, W>(M, N, K);
  CUtensorMap mx, mw;
  if (!make_map(&mx, x, M, K, 8 * NT, false) ||
      !make_map(&mw, w, N, K, p.bn, std::is_same<W, Int8Weight>::value))
    return cudaErrorInvalidValue;
  auto kernel = decode_kernel<NT, W, Epi>;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, MAX_PROMPT_SMEM, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, p.tiles);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mx, mw, scale, epi, M, N, K, p.bn, p.stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// f(std::integral_constant<int, NT>()) for x's M <= SMALL_MAX_M rows, NT =
// ceil(M / 8) n8 tiles: the decode instances.
template <class F>
auto with_nt(int M, F f) -> decltype(f(std::integral_constant<int, 1>())) {
  switch ((M + 7) / 8) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    case 9: return f(std::integral_constant<int, 9>());
    default: return f(std::integral_constant<int, 10>());
  }
}
static_assert(SMALL_MAX_M == 80, "decode instances for M <= 80");

// -- prompt rows -------------------------------------------------------------------

constexpr int PR_THREADS = 384;          // a producer and two consumer warpgroups
constexpr int PR_ROWS = 128;             // weight rows of a tile, 64 per consumer
constexpr int PR_BK = 64;                // k of a stage
constexpr int PR_WBOX = PR_ROWS * PR_BK; // bytes of a stage's weight box
constexpr int PR_OUT = 32 * 1024;        // bytes of a consumer's epilogue staging
constexpr int PR_MAX_STAGES = 8;

// Stages of the ring for x tiles of BX rows: as many as fit beside the two
// consumers' epilogue staging, at most PR_MAX_STAGES.
template <int BX>
__host__ __device__ constexpr int prompt_stages() {
  return (MAX_PROMPT_SMEM - 1024 - 2 * PR_OUT - 16 * PR_MAX_STAGES) / (PR_WBOX + 128 * BX) <
                 PR_MAX_STAGES
             ? (MAX_PROMPT_SMEM - 1024 - 2 * PR_OUT - 16 * PR_MAX_STAGES) / (PR_WBOX + 128 * BX)
             : PR_MAX_STAGES;
}
template <int BX>
__host__ __device__ constexpr size_t prompt_smem() {
  return 1024 + (size_t)prompt_stages<BX>() * (PR_WBOX + 128 * BX) + 2 * PR_OUT +
         16 * prompt_stages<BX>();
}

// The A fragment of one 16-deep step from a stage's int8 weight box (PR_BK
// = 64 bytes a row, the 64-byte swizzle: row r's 16-byte chunk c at chunk c
// ^ ((r / 2) % 4)), converted to bf16: lane (g, t) of warp w takes rows r =
// 16 w + g and r + 8 of its consumer's 64 and, in step ks, k = 2t, 2t + 1
// (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]) of chunk ks, two 32-bit words
// a row whose halves prmt selects. The eight rows of a read fall on distinct
// banks; lanes 2u and 2u + 1 share a word.
__device__ __forceinline__ void weight_frag(const unsigned char* rows, int g, uint32_t sel,
                                            int ks, uint32_t (&a)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const unsigned char* c = rows + r * PR_BK + ((ks ^ ((r >> 1) & 3)) << 4);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(c);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(c + 8);
    int8x4_to_bf16x4(__byte_perm(w0, w1, sel), a[h], a[h + 2]);
  }
}

// The 128 threads of consumer warpgroup g only (named barrier 1 + g).
__device__ __forceinline__ void consumer_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The consumer thread's place in a tile, for the epilogue: element i of its
// accumulators lies at weight row n0 + wrow + gl + 8 ((i >> 1) & 1) and x
// row m0 + 8 (i >> 2) + 2 t + (i & 1); sc[h] is the scale of its row h (0
// past N). `staging` is the consumer's PR_OUT bytes of shared memory
// (`staging_s` its shared-memory address), g the consumer, warp its warp in
// it (wrow = 64 g + 16 warp).
struct PromptTile {
  int n0, m0, g, warp, lane, gl, t, wrow;
  float sc[2];
  unsigned char* staging;
  uint32_t staging_s;
};

// yT = q . xT by tiles of PR_ROWS weight rows x BX rows of x, walked by a
// persistent grid (block b takes tiles b, b + gridDim.x, ...; the x tiles of
// one weight tile are consecutive, so the blocks that read a weight tile run
// together and it comes from device memory once). Warpgroup 0's first
// thread streams each tile's k-steps through the ring by TMA: the int8
// weight box (64 k x 128 rows, 64-byte swizzle) and x's box (64 k x BX rows,
// bf16, 128-byte swizzle), counted in bytes on the stage's full barrier;
// rows past N or M and k past K land as zeros. Consumer g (warpgroups 1, 2)
// owns weight rows 64 g ..: per stage it converts its four A fragments
// (weight_frag) and issues four m64nBXk16 wgmmas with x as B, keeping
// NB - 1 stages' groups in flight while it converts the next (NB fragment
// buffers), and frees a stage once the group that read it has retired. Then
// each consumer thread calls epi(d, tile, M, N) with its BX / 2 sums.
template <int BX, class Epi>
__global__ void __launch_bounds__(PR_THREADS, 1)
    prompt_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const __grid_constant__ Epi epi,
                  const float* __restrict__ scale, int M, int N, int tiles_x, int tiles,
                  int k_steps) {
  constexpr int STAGES = prompt_stages<BX>();
  constexpr int SB = PR_WBOX + 128 * BX;                 // bytes of a stage
  constexpr int ACC = BX / 2;
  // fragment buffers: three (two groups in flight) where the sums leave
  // room; at 256 x rows two, or ptxas serializes the wgmmas (C7512)
  constexpr int NB = BX == 256 ? 2 : 3;
  extern __shared__ __align__(1024) unsigned char pr_smem[];
  const uint32_t raw = smem_u32(pr_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ring = pr_smem + (base - raw);
  const uint32_t out_s = base + STAGES * SB;
  const uint32_t full = out_s + 2 * PR_OUT, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `it` counts the stages this block has passed through the ring
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_w) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_x) : "memory");
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile / tiles_x * PR_ROWS, m0 = tile % tiles_x * BX;
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t st = base + s * SB;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, SB);
          wgmma_gemm::tma_load(st, &map_w, full + 8 * s, kt * PR_BK, n0);
          wgmma_gemm::tma_load(st + PR_WBOX, &map_x, full + 8 * s, kt * PR_BK, m0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gl = lane / 4, t = lane % 4;
  const uint32_t sel = t & 1 ? 0x7632u : 0x5410u;   // the halves of lane t's k
  const int wrow = 64 * g + 16 * warp;                // the warp's first weight row
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    PromptTile at;
    at.n0 = tile / tiles_x * PR_ROWS;
    at.m0 = tile % tiles_x * BX;
    at.g = g, at.warp = warp, at.lane = lane, at.gl = gl, at.t = t, at.wrow = wrow;
    at.staging = pr_smem + (out_s - raw) + g * PR_OUT;
    at.staging_s = out_s + g * PR_OUT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = at.n0 + wrow + gl + 8 * h;
      at.sc[h] = n < N ? scale[n] : 0.f;
    }
    float d[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0.f;
    uint32_t a[NB][4][4];
    // stage kt of the tile: its fragments into buffer B = kt % NB, then its
    // four products; NB - 1 groups stay in flight, so the group NB - 1
    // steps back has retired, its buffer is free and its stage is freed
    auto step = [&](int kt, auto buf) {
      constexpr int B = decltype(buf)::value;
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const unsigned char* w = ring + s * SB + wrow * PR_BK + 4 * (t >> 1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) weight_frag(w, gl, sel, ks, a[B][ks]);
      const uint32_t xs = base + s * SB + PR_WBOX;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_gemm::wgmma_rs<BX, 0>(d, a[B][ks], wgmma_gemm::smem_desc(xs + 32 * ks, 16, 1024));
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<NB - 1>();
      fence_acc(d);
      fence_frag(a[(B + 1) % NB]);
      if (kt >= NB - 1 && lane == 0)
        mbar_arrive(empty + 8 * ((it + STAGES - (NB - 1)) % STAGES));
      ++it;
    };
    int kt = 0;
    for (; kt + NB - 1 < k_steps; kt += NB) {
      step(kt, std::integral_constant<int, 0>());
      step(kt + 1, std::integral_constant<int, 1>());
      if constexpr (NB == 3) step(kt + 2, std::integral_constant<int, 2>());
    }
    if (kt < k_steps) step(kt, std::integral_constant<int, 0>());
    if constexpr (NB == 3)
      if (kt + 1 < k_steps) step(kt + 1, std::integral_constant<int, 1>());
    wgmma_wait<0>();
    fence_acc(d);
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_frag(a[b]);
    if (lane == 0)   // the stages of the last NB - 1 steps
      for (int j = max(0, k_steps - (NB - 1)); j < k_steps; ++j)
        mbar_arrive(empty + 8 * ((it - k_steps + j) % STAGES));
    epi(d, at, M, N);
  }
  // the epilogue's last bulk stores, if any, have read their staging
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The x tile of a prompt product: BX in {64, 128, 192, 256} rows, the one
// whose tiles, dealt to the SMs in waves, take the least time by the model
// waves x (BX + 48) (a tile's time grows with its rows, plus a fixed part).
inline int prompt_bx(int M, int N) {
  const int sms = num_sms(), tn = (N + PR_ROWS - 1) / PR_ROWS;
  int best = 64;
  long best_cost = -1;
  for (int bx : {64, 128, 192, 256}) {
    const long tiles = (long)tn * ((M + bx - 1) / bx);
    const long cost = (tiles + sms - 1) / sms * (bx + 48);
    if (best_cost < 0 || cost < best_cost) best = bx, best_cost = cost;
  }
  return best;
}

// f(std::integral_constant<int, BX>()) for prompt_bx(M, N).
template <class F>
auto with_bx(int M, int N, F f) -> decltype(f(std::integral_constant<int, 64>())) {
  switch (prompt_bx(M, N)) {
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
    default: return f(std::integral_constant<int, 256>());
  }
}

// One prompt launch: x (M, K) bf16, q (N, K) int8, scale (N,) float32, on
// at most one block an SM.
template <int BX, class Epi>
cudaError_t launch_prompt(const void* x, const int8_t* q, const float* scale, int M, int N, int K,
                          const Epi& epi, cudaStream_t stream) {
  CUtensorMap mx, mw;
  if (!wgmma_gemm::operand_map(&mx, x, M, K, K, false, BX)) return cudaErrorInvalidValue;
  wgmma_gemm::EncodeTiled fn = wgmma_gemm::encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {PR_BK, PR_ROWS};
  const cuuint32_t one[2] = {1, 1};
  if (fn(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(q), dims, strides, box, one,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = prompt_kernel<BX, Epi>;
  constexpr size_t bytes = prompt_smem<BX>();
  static_assert(bytes <= MAX_PROMPT_SMEM, "the ring and the staging fit");
  static bool done = false;
  cudaError_t err = allow_smem(kernel, (int)bytes, done);
  if (err != cudaSuccess) return err;
  const int tiles_x = (M + BX - 1) / BX;
  const long tiles = (long)((N + PR_ROWS - 1) / PR_ROWS) * tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = tiles < num_sms() ? (int)tiles : num_sms();
  kernel<<<grid, PR_THREADS, bytes, stream>>>(mx, mw, epi, scale, M, N, tiles_x, (int)tiles,
                                              (K + PR_BK - 1) / PR_BK);
  return cudaGetLastError();
}

}  // namespace weight_gemm
