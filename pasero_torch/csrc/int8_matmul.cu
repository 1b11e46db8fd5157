// Weight-only int8 matrix product:
//
//   y[m, n] = (sum_k x[m, k] * q[n, k]) * scale[n]
//
// x (M, K) bfloat16, q (N, K) int8 with one float32 scale per row n (the
// port's (out, in) layout: a Linear weight, or the tied (vocab, embed) table);
// float32 sums of exact products, rounded once to y's type (bfloat16 for a
// Linear, float32 for the tied head). It replaces the Pallas kernel
// _int8_matmul_2d (pasero_tpu/ops/quantize.py:245, body _kernel :227), which
// serves both int8_matmul and int8_matmul_t there. The weight is read from
// device memory as int8 only and converted to bfloat16 on the chip, exactly,
// as the Pallas kernel converts it in VMEM: no bfloat16 copy of a weight
// exists in device memory.
//
// What bounds it: bytes at decode, operations at a prompt. At llama_1b's
// decode (M = 8 rows) each call must read its int8 weight once: fc1's 2048 x
// 5632 is 11.5 MB, 3.4 us at 3.35 TB/s, and the 154 products of one decoder
// call 1.03 GB, 0.31 ms. At the 8 x 128-token prompt (M = 1024), fc1 is 23.6
// GFLOP, 24 us at 989 TFLOP/s (bf16 dense).
//
// Decode rows (M <= SMALL_MAX_M: a decode step, a speculative chunk),
// decode_kernel. Three things keep a small product from the memory rate: a
// tile with half its rows empty, too few blocks to have enough bytes in
// flight (a 2048 x 256 K/V projection is 0.5 MB), and the fixed cost of a
// launch and of merging partial sums. So:
// - The operands are swapped: the weight's rows fill the m16 side of
//   mma.sync m16n8k16 and x's rows the n8 side, 8 NT columns of the output,
//   so no tile is multiplied half empty at M = 8.
// - K is split across the blocks of a thread-block cluster (up to 8) so that
//   every shape spreads over about two blocks an SM (decode_plan: tiles of
//   64 weight rows, 16 for a narrow weight at up to 16 rows of x). Each
//   block stores its partial sums into the shared memory of the cluster
//   rank that finishes their rows, by st.async counted in bytes on that
//   rank's barrier, and the rank adds them in a fixed order (rank, then
//   warp): one launch, no atomics, the same bits from two calls, and no
//   cluster barrier at the end (a relaxed one at the start tells a block
//   that the others run).
// - A producer thread streams the block's share of the weight through a
//   ring of up to 8 stages by TMA, boxes of 128 k x 64 (or 16) rows of an
//   int8 tensor map counted in bytes on the stage's mbarrier, with an L2
//   evict-first hint (a weight is read once per decoder call). x's rows of
//   the same k ride the stage beside it in boxes of 64 k; every block reads
//   its k slice of x once, as a resident copy would. A stage is 256 k deep
//   at up to 16 rows of x and 128 above, so that two blocks fit an SM at M
//   = 80. (One cp.async.bulk per 256-byte row, 72 to 136 copies a stage,
//   is bound by the count of its copies, not by their bytes.)
// - The four consumer warps convert each weight word to bfloat16 as they
//   read it (gemm_tile.cuh's int8x4_to_bf16x4). The boxes land under the
//   128-byte swizzle, so the eight rows of a warp's fragment read fall on
//   distinct 16-byte chunks; rows past N and M read as zeros (their outputs
//   are dropped) and the last stage's k is cut to K. At up to 16 rows a
//   warp keeps two chains of sums; above, one, and the next step's words
//   in flight while this step's products run.
// The scale multiplies the float32 sums once, in the merge.
//
// Prompts (M > SMALL_MAX_M), int8_matmul_kernel on gemm_tile.cuh's Large
// tiles: 64 x 128 tiles of x and q staged in shared memory by cp.async,
// three deep, and multiplied with mma.sync m16n8k16. What holds it back:
// mma.sync instead of wgmma, and x re-read from L2 by every column block.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "gemm_tile.cuh"
#include "wgmma_gemm.cuh"

namespace int8mm {

using namespace gemm_tile;
using wgmma_gemm::mbar_arrive;
using wgmma_gemm::mbar_expect_tx;
using wgmma_gemm::mbar_init;
using wgmma_gemm::mbar_wait;
namespace cg = cooperative_groups;

// -- decode rows -------------------------------------------------------------------

constexpr int DEC_WARPS = 4;                        // consumer warps
constexpr int DEC_THREADS = 32 * (DEC_WARPS + 1);   // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;                      // the portable cluster size
constexpr int STAGE_BUDGET = 48 * 1024;             // two or more blocks an SM
constexpr int BLOCKS_PER_SM = 2;                    // the blocks a layout aims at
constexpr int NARROW_MAX_M = 16;                    // rows that may take 16-row tiles
constexpr int DEEP_MAX_NT = 2;                      // n8 tiles that take 256-deep stages

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
// gemm_tile.cuh's mma but not volatile: the compiler may move the
// surrounding shared-memory reads across it.
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

// Bytes of a stage of k BK: BK / 128 weight boxes (128 k x bn rows) and BK
// / 64 x boxes (64 k x 8 NT rows), each row 128 bytes, 128-byte swizzled
// (row r's 16-byte chunk c at chunk c ^ (r % 8)), so every box starts
// 1024-byte aligned.
__host__ __device__ constexpr int stage_bytes(int bk, int bn, int mp) { return bk * (bn + 2 * mp); }

// The (bn, 8 NT) tile y[:, n0 .. n0 + bn) of x's rows (NT = ceil(M / 8)) at
// column block blockIdx.y, its k split over the cluster along x: cluster
// rank c sums k steps [c S / cs, (c + 1) S / cs) of the S = ceil(K / BK).
// bn = 64: warp w owns weight rows 16 w ..; bn = 16: every warp owns the 16
// rows and takes every fourth 16-deep step of a stage (wk_n = 4 ways).
// Rows [o R, o R + R) of the tile (R = ceil(bn / cs)) are cluster rank o's
// to finish: every warp stores its partial sums of them into rank o's shared
// memory by st.async, counted on rank o's receiving barrier, and rank o adds
// them in a fixed order (rank, then warp) from its own memory once they have
// all landed; no cluster barrier waits at the end. Shared memory: the stages
// (1024-byte aligned), a full and an empty barrier per stage, the receiving
// barrier, the partial sums received, ((c wk_n + w) 8 NT + m) R + r for rank
// c, warp split w, x row m and row r, and the R rows' scales.
template <int NT, typename OutT>
__global__ void __launch_bounds__(DEC_THREADS, 3)
    decode_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w, const float* __restrict__ scale,
                  OutT* __restrict__ y, int M, int N, int K, int bn, int stages) {
  extern __shared__ __align__(1024) unsigned char dec_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  constexpr int MP = 8 * NT;
  constexpr int BK = stage_k<NT>(), KS = BK / 16, WBOX = BK / 128, XBOX = BK / 64;
  // decode rows: two chains of accumulators (a stage's even and odd steps,
  // added at the end), each step's words read as it runs; more rows: one
  // chain, the next step's words read while this one's products run
  constexpr bool PIPE = NT > DEEP_MAX_NT;
  constexpr int CH = PIPE ? 1 : 2;
  const int sb = stage_bytes(BK, bn, MP), wb = 128 * bn;   // a stage, a weight box
  const int wk_n = DEC_WARPS * 16 / bn;                    // warps splitting a stage's k
  const int R = (bn + cs - 1) / cs;                        // rows a rank finishes
  const int r0 = rank * R, nr = min(R, bn - r0);           // this rank's
  const uint32_t raw = smem_addr(dec_smem);
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
    const int wboxes = min(WBOX, (K - k0 + 127) / 128), xboxes = min(XBOX, (K - k0 + 63) / 64);
    mbar_wait(full + 8, ((i / stages) & 1) ^ 1);
    mbar_expect_tx(full, wboxes * wb + xboxes * MP * 128);
    for (int b = 0; b < wboxes; ++b)
      tma_load_hint(ws + b * wb, &map_w, full, k0 + 128 * b, n0, policy);
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
    // (the same order for both operands), so a lane reads one 32-bit word
    // of a weight row and one 64-bit word of an x row; with the swizzle the
    // eight rows of a warp's read fall on distinct 16-byte chunks
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
      const unsigned char* wr = ring + s * sb + (16 * wn + g) * 128 + 4 * t;
      const unsigned char* xr = ring + s * sb + WBOX * wb + g * 128 + (t % 2) * 8;
      // the operands of the 16-deep step ks of the stage: weight box ks / 8,
      // chunk ks % 8 (two words, rows g and g + 8); x box ks / 4, chunk
      // 2 (ks % 4) + t / 2 (a 64-bit word per n8 tile)
      auto load = [&](int ks, uint32_t (&wv)[2], uint2 (&xv)[NT]) {
        const unsigned char* w = wr + (ks / 8) * wb + (((ks % 8) ^ g) << 4);
        wv[0] = *reinterpret_cast<const uint32_t*>(w);
        wv[1] = *reinterpret_cast<const uint32_t*>(w + 8 * 128);
        const unsigned char* xk = xr + (ks / 4) * MP * 128 + (((2 * (ks % 4) + t / 2) ^ g) << 4);
#pragma unroll
        for (int j = 0; j < NT; ++j) xv[j] = *reinterpret_cast<const uint2*>(xk + j * 8 * 128);
      };
      // their products into chain d, the weight converted to bf16 first
      auto multiply = [&](const uint32_t (&wv)[2], const uint2 (&xv)[NT], float (&d)[NT][4]) {
        uint32_t a[4];
        int8x4_to_bf16x4(wv[0], a[0], a[2]);
        int8x4_to_bf16x4(wv[1], a[1], a[3]);
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
          uint32_t wv[2][2];
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
            uint32_t wv[2];
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
          uint32_t wv[2];
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
      const uint32_t dst = cluster_addr(smem_addr(recv + at), o), bar = cluster_addr(rbar, o);
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
  // the sums arrive, then each output the sum over the ranks in order, then
  // over the warps of their k split
  if (threadIdx.x < nr) row_scale[threadIdx.x] = n0 + r0 + (int)threadIdx.x < N
                                                    ? scale[n0 + r0 + threadIdx.x]
                                                    : 0.f;
  mbar_wait(rbar, 0);   // every partial sum of these rows landed
  __syncthreads();      // and every scale staged
  for (int e = threadIdx.x; e < nr * M; e += DEC_THREADS) {
    const int m = e / nr, r = e % nr, n = n0 + r0 + r;
    if (n >= N) continue;
    float sum = 0.f;
    for (int c = 0; c < cs * wk_n; ++c) sum += recv[(c * MP + m) * R + r];
    const float v = sum * row_scale[r];
    if constexpr (sizeof(OutT) == 4)
      y[(int64_t)m * N + n] = v;
    else
      y[(int64_t)m * N + n] = __float2bfloat16_rn(v);
  }
}

// The card's SMs.
int num_sms() {
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

template <int NT>
DecodePlan decode_plan(int M, int N, int K) {
  constexpr int BK = stage_k<NT>();
  const int steps = (K + BK - 1) / BK;
  const int sms = num_sms();
  DecodePlan p;
  p.bn = M <= NARROW_MAX_M && (N + 63) / 64 * std::min(MAX_CLUSTER, steps) < sms ? 16 : 64;
  p.tiles = (N + p.bn - 1) / p.bn;
  p.cs = std::max(1, std::min({MAX_CLUSTER, steps,
                               (BLOCKS_PER_SM * sms + p.tiles - 1) / p.tiles}));
  const int sb = stage_bytes(BK, p.bn, 8 * NT);
  p.stages = std::min({MAX_STAGES, (steps + p.cs - 1) / p.cs, std::max(2, STAGE_BUDGET / sb)});
  // the partial sums a rank receives (from each rank and warp split, its R
  // rows of 8 NT columns) and its rows' scales
  const int R = (p.bn + p.cs - 1) / p.cs, wk_n = DEC_WARPS * 16 / p.bn;
  p.smem = 1024 + (size_t)p.stages * (sb + 16) + 16 + ((size_t)p.cs * wk_n * 8 * NT + 1) * R * 4;
  return p;
}

// The tensor map of x (rows M, K) bf16, boxes of 64 k x box (8 NT) rows,
// or of the weight (rows N, K) int8, boxes of 128 k x box (bn) rows, both
// 128-byte swizzled (rows past the last read as zeros).
bool make_map(CUtensorMap* map, const void* ptr, int rows, int K, int box, bool weight) {
  if (!weight) return wgmma_gemm::operand_map(map, ptr, rows, K, K, false, box);
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

template <int NT, typename OutT>
cudaError_t launch_decode(const void* x, const int8_t* q, const float* scale, void* y, int M,
                          int N, int K, cudaStream_t stream) {
  const DecodePlan p = decode_plan<NT>(M, N, K);
  CUtensorMap mx, mw;
  if (!make_map(&mx, x, M, K, 8 * NT, false) || !make_map(&mw, q, N, K, p.bn, true))
    return cudaErrorInvalidValue;
  auto kernel = decode_kernel<NT, OutT>;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, 232448, done);
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
  err = cudaLaunchKernelEx(&cfg, kernel, mx, mw, scale, static_cast<OutT*>(y), M, N, K, p.bn,
                           p.stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The decode instance of x's rows (M <= 80: NT = ceil(M / 8) n8 tiles).
template <typename OutT>
cudaError_t decode(const void* x, const int8_t* q, const float* scale, void* y, int M, int N,
                   int K, cudaStream_t s) {
  switch ((M + 7) / 8) {
    case 1: return launch_decode<1, OutT>(x, q, scale, y, M, N, K, s);
    case 2: return launch_decode<2, OutT>(x, q, scale, y, M, N, K, s);
    case 3: return launch_decode<3, OutT>(x, q, scale, y, M, N, K, s);
    case 4: return launch_decode<4, OutT>(x, q, scale, y, M, N, K, s);
    case 5: return launch_decode<5, OutT>(x, q, scale, y, M, N, K, s);
    case 6: return launch_decode<6, OutT>(x, q, scale, y, M, N, K, s);
    case 7: return launch_decode<7, OutT>(x, q, scale, y, M, N, K, s);
    case 8: return launch_decode<8, OutT>(x, q, scale, y, M, N, K, s);
    case 9: return launch_decode<9, OutT>(x, q, scale, y, M, N, K, s);
    case 10: return launch_decode<10, OutT>(x, q, scale, y, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(SMALL_MAX_M == 80, "decode instances for M <= 80");

// -- prompt rows -------------------------------------------------------------------

template <class C, typename OutT>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, OutT* __restrict__ y, int M,
                       int N, int K) {
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  float* red;
  tile_product<C, Int8W>(x, q, M, N, K, m0, n0, smem, red);
  for (int i = threadIdx.x; i < C::BM * C::BN; i += THREADS) {
    const int r = i / C::BN, c = i % C::BN;
    if (m0 + r < M && n0 + c < N) {
      const float v = tile_sum<C>(red, r, c) * scale[n0 + c];
      if constexpr (sizeof(OutT) == 4)
        y[(int64_t)(m0 + r) * N + n0 + c] = v;
      else
        y[(int64_t)(m0 + r) * N + n0 + c] = __float2bfloat16_rn(v);
    }
  }
}

template <class C, typename OutT>
cudaError_t launch(const void* x, const int8_t* q, const float* scale, void* y, int M,
                   int N, int K, cudaStream_t stream) {
  constexpr int bytes = Smem<C, Int8W>::BYTES;
  auto kernel = int8_matmul_kernel<C, OutT>;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const bf16*>(x), q, scale,
                                          static_cast<OutT*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace int8mm

extern "C" {

// x (M, K) bfloat16, q (N, K) int8, scale (N,) float32, y (M, N) bfloat16
// (out_f32 = 0) or float32 (out_f32 = 1); all contiguous and 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int int8_matmul(const void* x, const int8_t* q, const float* scale, void* y, int M,
                int N, int K, int out_f32, void* stream) {
  using namespace int8mm;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (int64_t)(N + Large::BN - 1) / Large::BN > 65535 || (int64_t)(N + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= SMALL_MAX_M)
    return (int)(out_f32 ? decode<float>(x, q, scale, y, M, N, K, s)
                         : decode<bf16>(x, q, scale, y, M, N, K, s));
  return (int)(out_f32 ? launch<Large, float>(x, q, scale, y, M, N, K, s)
                       : launch<Large, bf16>(x, q, scale, y, M, N, K, s));
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
