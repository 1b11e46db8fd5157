// Flash attention in float32 for grouped K/V heads, without a bias, with an
// additive float32 bias or with T5's relative-position table: the forward
// (out and lse), the backward's dq (and delta), dk and dv, and the gradients
// of a dense bias (dbias) and of T5's table (demb):
//
//   s[i, j]  = scale q[i] . k[j] (+ bias[i, j] | + table[index[j - i + Sq - 1], h])
//   lse[i]   = log sum over visible j of exp(s[i, j])    (-1e30 if no key)
//   p[i, j]  = exp(s[i, j] - lse[i]) where key j is visible, else 0
//   out[i]   = sum_j p[i, j] v[j]
//   delta[i] = sum_d dO[i, d] out[i, d]
//   dS[i, j] = p[i, j] (dO[i] . v[j] - delta[i])
//   dq = scale dS . k,  dk = scale sum over the group of dS^T . q,
//   dv = sum over the group of p^T . dO,  dbias = dS,
//   demb[n, h] = sum over b and the (i, j) of bucket n of dS[b, h, i, j]
//
// with G = H / Hkv query heads per K/V head and the visibility rules of
// flash_attention.cu (kv_mask, causal by slot index, a sliding window). Every
// operand, P and dS stay float32, as pasero_tpu/ops/flash_attention.py
// computes with float32 operands: there p.astype(v.dtype) (:228, :309, :534),
// pc = p.astype(do.dtype) and ds.astype(q.dtype) (:723-728, :944-949) and
// ds.astype(k.dtype) (:899, :998) change nothing. The products keep
// float32's accuracy: the forward, dbias and demb take float32 FMAs on the
// CUDA cores; dq and dk/dv take the tensor cores in split TF32 (below), never
// a single TF32 product (which keeps about three decimal digits). The max
// and lse are kept in natural units for every bias kind, as the biased
// kernels keep them (the encoder ALiBi's -1e9 survives).
//
// Kernels, instanced by bias kind (KIND: NO_BIAS, DENSE_BIAS, T5_BIAS, as in
// flash_attention.cu and flash_bwd.cu) and head dim D (32, 64, 128; the
// wrapper pads other head dims), and the TPU kernels whose float32 mode they
// replace:
//   fwd_kernel   _fwd_packed_kernel (:261, through _fwd_packed, :342),
//                _fwd_kernel (:186, through _fwd, :381) and
//                _fwd_stream_kernel (:474, through _fwd_stream, :544);
//   dq_kernel    _bwd_dq_packed_kernel (:963), _bwd_dq_kernel (:866),
//                _bwd_dq_stream_kernel (:618);
//   dkv_kernel   _bwd_dkv_packed_kernel (:1018), _bwd_dkv_kernel (:911),
//                _bwd_dkv_stream_kernel (:676);
//   dbias_kernel _dbias_kernel (:1160, through _compute_dbias, :1213);
//   demb_kernel  _demb_kernel (:1255, through _compute_demb, :1318).
//
// What bounds them: operations. One causal product at (2, 8, 2048, 64) is 2
// B H S^2 D / 2 = 4.3 GFLOP: 0.064 ms at the card's float32 rate outside the
// tensor cores (67 TFLOP/s), 0.026 ms as split TF32 (three products at 495
// TFLOP/s); the forward does two, dq three, dk/dv four.
//
// The forward, dbias and demb, simple and right first: 256 threads (a 16 x
// 16 grid) per block, one block per 64-row query tile. The block's own rows
// stay in shared memory; the streamed K and V tiles are staged by 16-byte
// cp.async, double-buffered, the next tile's copies in flight while this one
// is used; rows are padded by 16 bytes, so a warp's float4 reads down the
// rows are free of bank conflicts. Thread (ty, tx) holds the scores of rows
// ty + 16 i and columns tx + 16 j (i, j < 4) in registers, each a float32
// FMA chain over d in order; the online softmax runs there (a row's 64
// scores lie in 16 neighbouring lanes). P goes through shared memory once
// per tile for the next product. A dense bias is read straight from device
// memory, a row's keys by neighbouring lanes; T5's table column is staged
// once per block and the tile's bias written by diagonal (64 + 64 - 1
// values). dq and dk/dv: see "the backward on the tensor cores" below. No
// atomics: dbias sums a bias shared over the batch inside the block, batch
// by batch, demb writes a row of partial sums per (batch, head, query tile)
// for the wrapper to sum, and dk/dv sums a cluster's partials in rank order,
// so the same inputs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma_gemm.cuh"

namespace flash_f32 {

using wgmma_gemm::mbar_arrive;
using wgmma_gemm::mbar_init;
using wgmma_gemm::mbar_wait;
using wgmma_gemm::smem_desc;
using wgmma_gemm::wgmma_commit;
using wgmma_gemm::wgmma_fence;
using wgmma_gemm::wgmma_wait;

constexpr int THREADS = 256;    // a 16 x 16 grid of threads
constexpr int TILE = 64;        // rows and columns of a score tile
constexpr int LDP = TILE + 4;   // floats of a score tile's row in shared memory
constexpr int MAX_BUCKETS = 128;
constexpr size_t MAX_SMEM = 232448;   // shared memory a block can have
constexpr float NEG_INF = -1e30f;   // the lse of a row that sees no key

enum BiasKind : int { NO_BIAS = 0, DENSE_BIAS = 1, T5_BIAS = 2 };

// Floats of a 64-row operand tile in shared memory: rows of D + 4.
template <int D>
__host__ __device__ constexpr int tile_floats() { return TILE * (D + 4); }

// A dense float32 bias of (b0 h0, Sq, Sk) rows ld floats apart, the rows of
// (b, h) from plane b bs + h hs;
// or T5's float32 (nb, H) table and the int32 bucket of every distance (Sq +
// Sk - 1 entries, entry k - q + Sq - 1 for query q and key k, from the host).
struct Bias {
  const float* rows;
  int bs, hs, ld;
  const float* table;
  const int* index;
  int nb;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; valid = false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a row-major (nrows, D) float32 matrix into shared
// memory with rows of D + 4, zeros past nrows. Issues cp.async copies only;
// the caller commits and waits.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int nrows) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * (D + 4) + c, ok ? src + (int64_t)(r0 + r) * D + c : src, ok);
  }
}

// The sum over the 16 lanes that hold one row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Is key `col` visible from query row `row`?
__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk,
                                        const uint8_t* __restrict__ mask, int causal,
                                        int window) {
  bool ok = row < Sq && col < Sk && mask[col];
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D (two 64-row tiles in shared
// memory, rows of D + 4): one FMA chain per score, d in order.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B, int ty,
                                         int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// o[i][c] += sum_k P[ty + 16 i][k] M[k][tx + 16 c]: P a 64 x 64 tile (rows of
// LDP), M a 64-row operand tile (rows of D + 4), k in order.
template <int D>
__device__ __forceinline__ void tile_pm(float (&o)[4][D / 16], const float* P, const float* M,
                                        int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + k);
      p[i][0] = v.x, p[i][1] = v.y, p[i][2] = v.z, p[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* m = M + (k + kk) * LD + tx;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float mv = m[16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i][kk], mv, o[i][c]);
      }
    }
  }
}

// The T5 bias of the 64 x 64 tile at query q0, key k0 by diagonal: bd[c - r +
// 63] for tile row r and column c is col[index[k - q + Sq - 1]] of query q0 +
// r and key k0 + c, from a table column in shared memory; 0 where the
// distance falls outside the index (a slot past Sq or Sk, masked anyway).
// With `bucket`, the bucket ids by diagonal too (-1 outside). Plain stores:
// the caller synchronises before reading.
__device__ __forceinline__ void t5_diagonals(float* bd, int* bucket, const float* col,
                                             const int* __restrict__ index, int q0, int k0,
                                             int Sq, int Sk) {
  const int base = k0 - q0 - (TILE - 1) + Sq - 1;
  for (int t = threadIdx.x; t < 2 * TILE - 1; t += THREADS) {
    const int g = base + t;
    const int n = g >= 0 && g < Sq + Sk - 1 ? index[g] : -1;
    bd[t] = n >= 0 ? col[n] : 0.f;
    if (bucket) bucket[t] = n;
  }
}

// The bias of the visible score (row, col) of the tile at (q0, k0): a dense
// bias from the head's rows `rows`, ld floats apart, T5's from the tile's
// diagonals `bd`.
template <int KIND>
__device__ __forceinline__ float bias_at(const float* __restrict__ rows, const float* bd, int row,
                                         int col, int q0, int k0, int ld) {
  if constexpr (KIND == DENSE_BIAS)
    return __ldg(rows + (int64_t)row * ld + col);
  else if constexpr (KIND == T5_BIAS)
    return bd[(col - k0) - (row - q0) + TILE - 1];
  else
    return 0.f;
}

// The bias rows of (batch b, query head h) of a dense bias.
__device__ __forceinline__ const float* bias_rows(const Bias& bias, int b, int h, int Sq) {
  return bias.rows + ((int64_t)b * bias.bs + (int64_t)h * bias.hs) * Sq * bias.ld;
}

// The key tiles of tn keys, [kt0, kt1), that the query rows [q0, q0 + rows)
// can see.
__device__ __forceinline__ void key_tiles(int q0, int rows, int tn, int Sk, int causal,
                                          int window, int& kt0, int& kt1) {
  kt0 = 0;
  kt1 = (Sk + tn - 1) / tn;
  if (causal) kt1 = min(kt1, (q0 + rows - 1) / tn + 1);
  if (window > 0) kt0 = max(0, (q0 - window + 1) / tn);
}

// -- forward -----------------------------------------------------------------------

// Block (query tile, b H + h), the last (longest causal) query tiles first.
template <int KIND, int D>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
               float* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
               float scale, int causal, int window) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TF;         // [2][TF]
  float* Vs = Ks + 2 * TF;     // [2][TF]
  float* Ps = Vs + 2 * TF;     // [TILE][LDP]
  float* Bd = Ps + TILE * LDP; // [2 TILE] T5: the tile's bias by diagonal
  float* col = Bd + 2 * TILE;  // [nb] T5: the head's table column

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
  const float* kg = k + kv_off;
  const float* vg = v + kv_off;
  const uint8_t* mg = kv_mask + (int64_t)b * Sk;
  const float* bg = KIND == DENSE_BIAS ? bias_rows(bias, b, h, Sq) : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int kt0, kt1;
  key_tiles(q0, TILE, TILE, Sk, causal, window, kt0, kt1);

  load_rows<D>(Qs, q + (int64_t)bh * Sq * D, q0, Sq);
  if (kt0 < kt1) {
    load_rows<D>(Ks, kg, kt0 * TILE, Sk);
    load_rows<D>(Vs, vg, kt0 * TILE, Sk);
  }
  cp_async_commit();
  if constexpr (KIND == T5_BIAS)
    for (int c = threadIdx.x; c < bias.nb; c += THREADS) col[c] = bias.table[c * H + h];

  float o[4][D / 16];
  float m[4], l[4];   // the running row max (natural units); this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[i][c] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1, k0 = kt * TILE;
    if (kt + 1 < kt1) {
      load_rows<D>(Ks + (st ^ 1) * TF, kg, k0 + TILE, Sk);
      load_rows<D>(Vs + (st ^ 1) * TF, vg, k0 + TILE, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (KIND == T5_BIAS) {
      __syncthreads();   // the table column, on the first tile
      t5_diagonals(Bd, nullptr, col, bias.index, q0, k0, Sq, Sk);
    }
    __syncthreads();

    float s[4][4];
    tile_dot<D>(s, Qs, Ks + st * TF, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float t = -INFINITY;
        if (visible(row, key, Sq, Sk, mg, causal, window)) {
          t = s[i][j] * scale;
          if constexpr (KIND != NO_BIAS) t += bias_at<KIND>(bg, Bd, row, key, q0, k0, bias.ld);
        }
        s[i][j] = t;
        mx = fmaxf(mx, t);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      const float mu = mn == -INFINITY ? 0.f : mn;   // no visible key yet
      const float alpha = expf(m[i] - mu);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mu);
        l[i] += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    tile_pm<D>(o, Ps, Vs + st * TF, ty, tx);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lr = row_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
    float* og = out + ((int64_t)bh * Sq + row) * D + tx;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) og[16 * c] = o[i][c] * inv;
    if (tx == 0) lse[(int64_t)bh * Sq + row] = lr == 0.f ? NEG_INF : m[i] + logf(lr);
  }
}

// -- the backward on the tensor cores: dq (and delta), dk, dv ---------------------

// Every product of dq_kernel and dkv_kernel is split-TF32: x = hi + lo with
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a . b = hi_a hi_b +
// hi_a lo_b + lo_a hi_b, each TF32 product exact in the float32 sums. x - hi
// is exact, and lo keeps 11 of its bits, so hi + lo is within 2^-22 |x|; the
// dropped lo_a lo_b is below 2^-22 |a b|. A term's error is then a few u =
// 2^-24 of it, as a float32 FMA chain's is, where one TF32 product keeps 2^-11.
//
// A block holds NC 64-row tiles resident, one per consumer warpgroup (dq:
// query rows with their Q and dO; dk/dv: keys with their K and V), and streams
// the other side in tiles of TN rows (dq: keys with K, V; dk/dv: queries with
// Q, dO) through a ring of two stages. Warpgroup 0 is the producer: its 128
// threads read a tile's float32 rows (16-byte loads, the next tile's issued
// before the wait for its stage), split them and store the hi and lo planes
// in the 128-byte swizzled K-major layout that wgmma reads (row r's 16-byte
// chunk j at chunk j ^ (r % 8), 32 floats a panel row), with the tile's dense
// bias, T5 diagonals, key flags or lse and delta beside them; fence.proxy.async
// and the stage's "full" mbarrier publish it. Each consumer then issues
//   dq:    S = Q K^T and dP = dO V^T    (wgmma m64nTNk8, both K-major),
//   dk/dv: S^T = K Q^T and dP^T = V dO^T,
// three products per k-step (lo hi, hi lo, hi hi), forms P and dS in
// registers, and adds dS K (dq), P^T dO (dv) and dS^T Q (dk) with
// mma.sync.m16n8k8.tf32: wgmma takes no transposed TF32 operand, and these
// products' B (K, dO, Q) would be N-major. Their A is the score accumulator
// itself, split in registers: an m16n8k8 A fragment wants columns t and t + 4
// where the accumulator holds 2t and 2t + 1, so the k-slots are permuted
// (slot t <-> key 2t, slot t + 4 <-> key 2t + 1) and B's rows read to match,
// by ld.shared from the same swizzled planes (conflict-free: the eight rows
// of a read fall on distinct chunks). The consumer frees the stage on its
// "empty" mbarrier once its products have read it.
//
// Shapes: NC = 2, TN = 32 at D = 64 (the resident tiles' planes take 128 KB,
// a stage 32 KB and, with a dense bias, 16 KB more); NC = 2, TN = 64 at D =
// 32; NC = 1, TN = 16 at D = 128. One block per SM. dq's grid runs the last
// (longest causal) query blocks first. dk/dv's spreads a K/V head's G query
// heads over a thread-block cluster of c blocks (c the largest divisor of G
// up to 8), the rank taking G / c heads in order, so that a key block's work
// under GQA and causality is c blocks' and the grid runs the first (longest
// causal) key blocks first; each block keeps its partial dk and dv, stores
// them over its resident tiles, and rank r sums rows [r R / c, (r + 1) R / c)
// of every rank's partials in rank order through distributed shared memory.
// No atomics anywhere: the same inputs give the same bits.
//
// What holds it back: shared memory. Both operands of a score wgmma come
// from it, so an m64n32k8 reads 3 KB for 32768 flops, about 190 bytes a
// cycle at the TF32 rate against the 128 shared memory gives, and every
// warp reads the whole B of its mma.sync products; a consumer also waits on
// its own score products before its exponentials (the two consumers overlap
// each other only). Tried and dropped (PERF.md §6): a third stage where
// it fits, and S and dP in two wgmma groups with P formed while dP runs.

// Registers a thread of the producer and of a consumer warpgroup keep once
// setmaxnreg has moved them (two consumers: 128 72 + 256 216 <= 65536).
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;

template <int KIND, int D, bool DKV>
struct Tc {
  static constexpr int NC = D == 128 ? 1 : 2;              // consumer warpgroups
  static constexpr int TN = D == 32 ? 64 : D == 64 ? 32 : 16;   // rows a stage
  static constexpr int R = 64 * NC;                        // resident rows
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int RES = 64 * D * 8;                   // a 64-row tile's hi, lo planes
  static constexpr int STREAM = TN * D * 8;                // a streamed tile's
  // the stage's dense bias: dq's (R queries x TN keys) rows of BIAS_LD floats,
  // dk/dv's (TN queries x R keys) rows of R
  static constexpr int BIAS_LD = DKV ? R : (TN == 16 ? 24 : TN);
  static constexpr int BIAS = KIND == DENSE_BIAS ? (DKV ? TN : R) * BIAS_LD * 4 : 0;
  static constexpr int STAGE = 2 * STREAM + BIAS;
  // per stage: T5's diagonals (R + TN - 1 floats); dq's key flags, dk/dv's
  // lse and delta of the tile's queries
  static constexpr int DIAG = KIND == T5_BIAS ? (R + TN) * 4 : 0;
  static constexpr int EXTRA = (DKV ? 2 * TN * 4 : 64) + DIAG;
  // two stages: a third, where it fits, was no faster (PERF.md §6)
  static constexpr int STAGES = 2;
  static constexpr int STAGES_AT = 2 * NC * RES;
  static constexpr int EXTRA_AT = STAGES_AT + STAGES * STAGE;
  static constexpr int BARS_AT = EXTRA_AT + STAGES * EXTRA;
  // the 1024 bytes align the tiles
  static constexpr size_t SMEM = 1024 + BARS_AT + 8 * 2 * STAGES;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Byte offset of float (r, c) in a plane of R rows: D / 32 panels of R rows x
// 128 bytes, 128-byte swizzled.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}
// The wgmma descriptor of k-step kk (8 floats) of a plane of R rows.
template <int R>
__device__ __forceinline__ uint64_t plane_desc(uint32_t plane, int kk) {
  return smem_desc(plane + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d (64 x N) += A (64 x 8) . B (N x 8)^T, TF32 operands read K-major from
// shared memory by their descriptors.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64, "m64nNk8, N 16, 32 or 64");
  if constexpr (N == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : WGMMA_D8(0)
        : "l"(da), "l"(db), "r"(1));
  else if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : WGMMA_D8(0), WGMMA_D8(8)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WGMMA_R32
        "}, %32, %33, p, 1, 1;\n}\n"
        : WGMMA_D32(0)
        : "l"(da), "l"(db), "r"(1));
}

// d += A B^T over D as the three split products (lo hi, hi lo, hi hi): the
// hi planes of A (64 rows) at a and of B (N rows) at b, each lo plane right
// after its hi plane.
template <int N, int D>
__device__ __forceinline__ void split_product(float (&d)[N / 2], uint32_t a, uint32_t b) {
  constexpr uint32_t A_LO = 64 * D * 4, B_LO = N * D * 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32<N>(d, plane_desc<64>(a + A_LO, kk), plane_desc<N>(b, kk));
    wgmma_tf32<N>(d, plane_desc<64>(a, kk), plane_desc<N>(b + B_LO, kk));
    wgmma_tf32<N>(d, plane_desc<64>(a, kk), plane_desc<N>(b, kk));
  }
}

// c (16 x 8) += A (16 x 8) . B (8 x 8), TF32 fragments of mma.sync.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (this warp's 16 rows x D) += X (16 x TN, the accumulator of an
// m64nTN score tile, split here) . M (TN x D, the split plane pair at m,
// rows matching X's columns). The tensor cores' sums may not round to
// nearest, so each output block sums the tile's products in fresh registers
// (3 TN / 8 steps) and adds them to acc with a float32 add: a sum over a
// long row (dq over 2048 keys) then takes one rounded add a tile.
template <int TN, int D>
__device__ __forceinline__ void split_mma(float (&acc)[D / 8][4], const float (&x)[TN / 2],
                                          const unsigned char* m, int lane) {
  constexpr int LO = TN * D * 4;
  const int g = lane / 4, t = lane % 4;
  uint32_t hi[TN / 8][4], lo[TN / 8][4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    // slot t <-> column 8 j + 2 t, slot t + 4 <-> 8 j + 2 t + 1
    split_tf32(x[4 * j], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int r = 8 * j + 2 * t;
      const int o0 = swz<TN>(r, 8 * nt + g), o1 = swz<TN>(r + 1, 8 * nt + g);
      const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(m + o0);
      const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(m + o1);
      const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(m + LO + o0);
      const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(m + LO + o1);
      mma_tf32(part, lo[j], bh0, bh1);
      mma_tf32(part, hi[j], bl0, bl1);
      mma_tf32(part, hi[j], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
  }
}

// Rows [r0, r0 + R) of a row-major (nrows, D) float32 matrix, zeros past
// nrows, read by 128 threads into registers (`load`), then split into the
// hi and lo planes at dst (`store`).
template <int R, int D>
struct SplitTile {
  static constexpr int CH = D / 4, N = R * CH / 128;
  float4 x[N];
  __device__ __forceinline__ void load(const float* __restrict__ src, int r0, int nrows, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + 128 * i, r = e / CH, c = (e % CH) * 4;
      x[i] = r0 + r < nrows ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * D + c))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(unsigned char* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + 128 * i, r = e / CH, c = (e % CH) * 4;
      uint4 hi, lo;
      split_tf32(x[i].x, hi.x, lo.x);
      split_tf32(x[i].y, hi.y, lo.y);
      split_tf32(x[i].z, hi.z, lo.z);
      split_tf32(x[i].w, hi.w, lo.w);
      const int o = swz<R>(r, c);
      *reinterpret_cast<uint4*>(dst + o) = hi;
      *reinterpret_cast<uint4*>(dst + R * D * 4 + o) = lo;
    }
  }
};

// A dense bias tile of ROWS x COLS from the head's rows `src` (ld floats
// apart; rows from r0 of nr, columns from c0 of nc, zeros outside) into
// shared memory at dst + off(r, c), by 128 threads: 16-byte loads, eight in
// flight a thread, where the rows allow (`vec`: ld a multiple of 4, the
// base 16-byte aligned; c0 is a multiple of 4), else 4-byte loads.
template <int ROWS, int COLS, class Off>
__device__ __forceinline__ void stage_bias(float* dst, const float* __restrict__ src, int r0,
                                           int c0, int nr, int nc, int ld, bool vec, int tid,
                                           Off off) {
  constexpr int N = ROWS * COLS / 4 / 128, CHUNK = N < 8 ? N : 8;
  static_assert(N * 128 * 4 == ROWS * COLS && N % CHUNK == 0, "whole float4s per thread");
  if (vec) {
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += CHUNK) {
      float4 x[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int e = tid + 128 * (i0 + i), r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
        x[i] = r0 + r < nr && c0 + c < nc
                   ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * ld + c0 + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int e = tid + 128 * (i0 + i), r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
        *reinterpret_cast<float4*>(dst + off(r, c)) = x[i];
      }
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += 128) {
      const int r = e / COLS, c = e % COLS;
      dst[off(r, c)] =
          r0 + r < nr && c0 + c < nc ? __ldg(src + (int64_t)(r0 + r) * ld + c0 + c) : 0.f;
    }
  }
}

// T5's bias by diagonal for a tile whose diagonal t holds distance `base` +
// t - (Sq - 1): the value of t5_diagonals, read by `load` ahead of the wait.
template <int NDIAG>
struct DiagTile {
  static constexpr int N = (NDIAG + 127) / 128;
  float x[N];
  __device__ __forceinline__ void load(const Bias& bias, int h, int H, int base, int Sq, int Sk,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int t = tid + 128 * i, g = base + t;
      const int n = t < NDIAG && g >= 0 && g < Sq + Sk - 1 ? __ldg(bias.index + g) : -1;
      x[i] = n >= 0 ? __ldg(bias.table + n * H + h) : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* bd, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (tid + 128 * i < NDIAG) bd[tid + 128 * i] = x[i];
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// dq: block (query block, b H + h), the last (longest causal) query blocks
// first; consumer g owns query rows q0 + 64 g .. + 63, computes their delta
// and lse, and writes dq.
template <int KIND, int D>
__global__ void __launch_bounds__(Tc<KIND, D, false>::THREADS, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
              const float* __restrict__ out, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
              int H, int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  using C = Tc<KIND, D, false>;
  constexpr int NC = C::NC, TN = C::TN, R = C::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  auto stage = [&](int s) { return sm + C::STAGES_AT + s * C::STAGE; };
  auto extra = [&](int s) { return sm + C::EXTRA_AT + s * C::EXTRA; };
  const uint32_t bars = smem_addr(sm + C::BARS_AT);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  // dq's bias tile: query row r, key c; the XOR spreads a warp's float2
  // reads of four rows over distinct banks (padding at TN = 16)
  auto boff = [](int r, int c) { return r * C::BIAS_LD + (TN == 16 ? c : c ^ ((r & 3) << 3)); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t q_off = (int64_t)bh * Sq * D;
  const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
  const uint8_t* mg = kv_mask + (int64_t)b * Sk;
  const float* bg = KIND == DENSE_BIAS ? bias_rows(bias, b, h, Sq) : nullptr;
  const bool vec = KIND == DENSE_BIAS && bias.ld % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bias.rows) & 15) == 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  int kt0, kt1;
  key_tiles(q0, R, TN, Sk, causal, window, kt0, kt1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    SplitTile<TN, D> kx, vx;
    DiagTile<R + TN - 1> dx;
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % C::STAGES, k0 = kt * TN;
      kx.load(k + kv_off, k0, Sk, tid);
      vx.load(v + kv_off, k0, Sk, tid);
      if constexpr (KIND == T5_BIAS) dx.load(bias, h, H, k0 - q0 - (R - 1) + Sq - 1, Sq, Sk, tid);
      const bool flag = tid < TN && k0 + tid < Sk && mg[k0 + tid];
      mbar_wait(empty(s), ((i / C::STAGES) & 1) ^ 1);
      kx.store(stage(s), tid);
      vx.store(stage(s) + C::STREAM, tid);
      if constexpr (KIND == DENSE_BIAS)
        stage_bias<R, TN>(reinterpret_cast<float*>(stage(s) + 2 * C::STREAM), bg, q0, k0, Sq, Sk,
                          bias.ld, vec, tid, boff);
      if constexpr (KIND == T5_BIAS) dx.store(reinterpret_cast<float*>(extra(s) + 64), tid);
      if (tid < TN) extra(s)[tid] = flag;
      fence_async_shared();
      mbar_arrive(full(s));
    }
    return;
  }

  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = wg - 1, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  unsigned char* qt = sm + g * 2 * C::RES;   // Q's planes, then dO's
  {
    SplitTile<64, D> x;
    x.load(q + q_off, q0 + 64 * g, Sq, tid);
    x.store(qt, tid);
    x.load(dout + q_off, q0 + 64 * g, Sq, tid);
    x.store(qt + C::RES, tid);
  }
  fence_async_shared();
  consumer_sync(g);

  const int rl = 64 * g + 16 * warp + lane / 4;   // local rows rl, rl + 8
  int row[2];
  float dl[2], ls[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + rl + 8 * hh;
    float acc = 0.f;
    if (row[hh] < Sq)
#pragma unroll
      for (int c = 4 * t4; c < D; c += 16) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(dout + q_off + (int64_t)row[hh] * D + c));
        const float4 o = __ldg(reinterpret_cast<const float4*>(out + q_off + (int64_t)row[hh] * D + c));
        acc = fmaf(a.x, o.x, acc);
        acc = fmaf(a.y, o.y, acc);
        acc = fmaf(a.z, o.z, acc);
        acc = fmaf(a.w, o.w, acc);
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    dl[hh] = acc + __shfl_xor_sync(0xffffffffu, acc, 2);
    ls[hh] = row[hh] < Sq ? lse[(int64_t)bh * Sq + row[hh]] : 0.f;
    if (t4 == 0 && row[hh] < Sq) delta[(int64_t)bh * Sq + row[hh]] = dl[hh];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int first = q0 + 64 * g, last = min(first + 63, Sq - 1);
  const uint32_t qa = smem_addr(qt), oa = qa + C::RES;

  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % C::STAGES, k0 = kt * TN;
    mbar_wait(full(s), (i / C::STAGES) & 1);
    const bool skip = first >= Sq || (causal && k0 > last) ||
                      (window > 0 && k0 + TN - 1 <= first - window);
    if (!skip) {
      float sc[TN / 2], dp[TN / 2];
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) sc[e] = dp[e] = 0.f;
      const uint32_t ka = smem_addr(stage(s)), va = ka + C::STREAM;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
      split_product<TN, D>(sc, qa, ka);
      split_product<TN, D>(dp, oa, va);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const uint8_t* flags = extra(s);
      const float* bt = reinterpret_cast<const float*>(stage(s) + 2 * C::STREAM);
      const float* bd = reinterpret_cast<const float*>(extra(s) + 64);
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) {
        const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1), key = k0 + c;
        const int r = row[hh];
        float p = 0.f;
        if (r < Sq && key < Sk && flags[c] && (!causal || key <= r) &&
            (window <= 0 || r - key < window)) {
          float x = sc[e] * scale;
          if constexpr (KIND == DENSE_BIAS) x += bt[boff(rl + 8 * hh, c)];
          if constexpr (KIND == T5_BIAS) x += bd[c - (rl + 8 * hh) + R - 1];
          p = expf(x - ls[hh]);
        }
        sc[e] = p * (dp[e] - dl[hh]);   // dS
      }
      split_mma<TN, D>(acc, sc, stage(s), lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= Sq) continue;
    float* o = dq + q_off + (int64_t)row[hh] * D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) =
          make_float2(acc[nt][2 * hh] * scale, acc[nt][2 * hh + 1] * scale);
  }
}

// dk, dv: block (cluster rank, b Hkv + hk, key block), the first (longest
// causal) key blocks first; consumer g owns keys j0 + 64 g .. + 63. Rank r of
// a cluster of gridDim.x blocks takes query heads hk G + r G / c .. + G / c -
// 1, each head's visible query tiles in order.
template <int KIND, int D>
__global__ void __launch_bounds__(Tc<KIND, D, true>::THREADS, 1)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               int H, int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  using C = Tc<KIND, D, true>;
  constexpr int NC = C::NC, TN = C::TN, R = C::R;
  constexpr int PLD = D + 8;   // floats of a partial sum's row (conflict-free float2 stores)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  auto stage = [&](int s) { return sm + C::STAGES_AT + s * C::STAGE; };
  auto extra = [&](int s) { return reinterpret_cast<float*>(sm + C::EXTRA_AT + s * C::EXTRA); };
  const uint32_t bars = smem_addr(sm + C::BARS_AT);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  // dk/dv's bias tile: query r, key c; the XOR spreads a warp's reads down
  // the keys of four query pairs over distinct banks
  auto boff = [](int r, int c) { return r * R + (c ^ (((r >> 1) & 3) << 3)); };

  const int rank = blockIdx.x, ranks = gridDim.x;
  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int j0 = blockIdx.z * R;
  const int group = H / Hkv, heads = group / ranks, hh0 = hk * group + rank * heads;
  const int nqt = (Sq + TN - 1) / TN;
  const int it0 = causal ? j0 / TN : 0;
  int it1 = nqt;
  if (window > 0) it1 = min(it1, (j0 + R - 1 + window - 1) / TN + 1);
  const int ntiles = max(0, it1 - it0), iters = heads * ntiles;
  const uint8_t* mg = kv_mask + (int64_t)b * Sk;
  const bool vec = KIND == DENSE_BIAS && bias.ld % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bias.rows) & 15) == 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    SplitTile<TN, D> qx, ox;
    DiagTile<R + TN - 1> dx;
    for (int n = 0; n < iters; ++n) {
      const int s = n % C::STAGES, hh = hh0 + n / ntiles, i0 = (it0 + n % ntiles) * TN;
      const int64_t bh = (int64_t)b * H + hh, off = bh * Sq * D;
      const float* bg = KIND == DENSE_BIAS ? bias_rows(bias, b, hh, Sq) : nullptr;
      qx.load(q + off, i0, Sq, tid);
      ox.load(dout + off, i0, Sq, tid);
      if constexpr (KIND == T5_BIAS) dx.load(bias, hh, H, j0 - i0 - (TN - 1) + Sq - 1, Sq, Sk, tid);
      const int row = i0 + tid % TN;
      const float rv = tid < 2 * TN && row < Sq ? __ldg((tid < TN ? lse : delta) + bh * Sq + row)
                                                : 0.f;
      mbar_wait(empty(s), ((n / C::STAGES) & 1) ^ 1);
      qx.store(stage(s), tid);
      ox.store(stage(s) + C::STREAM, tid);
      if constexpr (KIND == DENSE_BIAS)
        stage_bias<TN, R>(reinterpret_cast<float*>(stage(s) + 2 * C::STREAM), bg, i0, j0, Sq, Sk,
                          bias.ld, vec, tid, boff);
      if constexpr (KIND == T5_BIAS) dx.store(extra(s) + 2 * TN, tid);
      if (tid < 2 * TN) extra(s)[tid] = rv;
      fence_async_shared();
      mbar_arrive(full(s));
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int g = wg - 1, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
    unsigned char* kt = sm + g * 2 * C::RES;   // K's planes, then V's
    const int64_t kv_off = (int64_t)bk * Sk * D;
    {
      SplitTile<64, D> x;
      x.load(k + kv_off, j0 + 64 * g, Sk, tid);
      x.store(kt, tid);
      x.load(v + kv_off, j0 + 64 * g, Sk, tid);
      x.store(kt + C::RES, tid);
    }
    fence_async_shared();
    consumer_sync(g);

    const int kl = 64 * g + 16 * warp + lane / 4;   // local keys kl, kl + 8
    int key[2];
    bool seen[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      key[hh] = j0 + kl + 8 * hh;
      seen[hh] = key[hh] < Sk && mg[key[hh]];
    }
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
    const int first = j0 + 64 * g, last = min(first + 63, Sk - 1);
    const uint32_t ka = smem_addr(kt), va = ka + C::RES;

    for (int n = 0; n < iters; ++n) {
      const int s = n % C::STAGES, i0 = (it0 + n % ntiles) * TN;
      mbar_wait(full(s), (n / C::STAGES) & 1);
      const bool skip = first >= Sk || (causal && i0 + TN - 1 < first) ||
                        (window > 0 && i0 > last + window - 1);
      if (!skip) {
        float st[TN / 2], dpt[TN / 2];
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) st[e] = dpt[e] = 0.f;
        const uint32_t qa = smem_addr(stage(s)), oa = qa + C::STREAM;
        fence_acc(st);
        fence_acc(dpt);
        wgmma_fence();
        split_product<TN, D>(st, ka, qa);
        split_product<TN, D>(dpt, va, oa);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);
        const float* ls = extra(s);
        const float* dl = ls + TN;
        const float* bd = ls + 2 * TN;
        const float* bt = reinterpret_cast<const float*>(stage(s) + 2 * C::STREAM);
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) {
          const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1), query = i0 + c;
          const int kk = key[hh];
          float p = 0.f;
          if (query < Sq && seen[hh] && (!causal || kk <= query) &&
              (window <= 0 || query - kk < window)) {
            float x = st[e] * scale;
            if constexpr (KIND == DENSE_BIAS) x += bt[boff(c, kl + 8 * hh)];
            if constexpr (KIND == T5_BIAS) x += bd[(kl + 8 * hh) - c + TN - 1];
            p = expf(x - ls[c]);
          }
          st[e] = p;
          dpt[e] = p * (dpt[e] - dl[c]);
        }
        split_mma<TN, D>(dva, st, stage(s) + C::STREAM, lane);
        split_mma<TN, D>(dka, dpt, stage(s), lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    if (ranks == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (key[hh] >= Sk) continue;
        const int64_t o = ((int64_t)bk * Sk + key[hh]) * D + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          *reinterpret_cast<float2*>(dk + o + 8 * nt) =
              make_float2(dka[nt][2 * hh] * scale, dka[nt][2 * hh + 1] * scale);
          *reinterpret_cast<float2*>(dv + o + 8 * nt) =
              make_float2(dva[nt][2 * hh], dva[nt][2 * hh + 1]);
        }
      }
    } else {
      // this block's partial sums over its own resident tiles, which no
      // product of the warpgroup reads any more
      consumer_sync(g);
      float* pk = reinterpret_cast<float*>(kt);
      float* pv = pk + 64 * PLD;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + lane / 4 + 8 * hh;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          *reinterpret_cast<float2*>(pk + r * PLD + 8 * nt + 2 * t4) =
              make_float2(dka[nt][2 * hh], dka[nt][2 * hh + 1]);
          *reinterpret_cast<float2*>(pv + r * PLD + 8 * nt + 2 * t4) =
              make_float2(dva[nt][2 * hh], dva[nt][2 * hh + 1]);
        }
      }
    }
  }
  if (ranks == 1) return;

  // rank r sums rows [r R / c, (r + 1) R / c) of every rank's partials, in
  // rank order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r_lo = rank * R / ranks, r_hi = (rank + 1) * R / ranks;
  const int per = (r_hi - r_lo) * (D / 4);
  for (int e = threadIdx.x; e < 2 * per; e += C::THREADS) {
    const int m = e / per, kr = r_lo + (e % per) / (D / 4), c = (e % per) % (D / 4) * 4;
    if (j0 + kr >= Sk) continue;
    float* local = reinterpret_cast<float*>(sm + (kr / 64) * 2 * C::RES) + m * 64 * PLD +
                   (kr % 64) * PLD + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(local, r));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float f = m ? 1.f : scale;
    *reinterpret_cast<float4*>((m ? dv : dk) + ((int64_t)bk * Sk + j0 + kr) * D + c) =
        make_float4(sum.x * f, sum.y * f, sum.z * f, sum.w * f);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// -- dbias --------------------------------------------------------------------------

// dbias = dS, zero where a key is not visible, written at the (query tile x
// key tile) it was computed for. One block per (64-row query tile, output
// row): row (b, h) for a per-sample bias; row h with the batch summed inside
// the block when the bias is shared over the batch (batch_sum), the batches
// in order. Key tiles that causality or the window skip are written as zeros.
template <int D>
__global__ void __launch_bounds__(THREADS)
    dbias_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 const Bias bias, const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dbias, int B, int H,
                 int Hkv, int Sq, int Sk, float scale, int causal, int window, int batch_sum) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + TF;
  float* Ks = dOs + TF;      // [2][TF]
  float* Vs = Ks + 2 * TF;   // [2][TF]

  const int q0 = blockIdx.x * TILE;
  const int h = batch_sum ? blockIdx.y : blockIdx.y % H;
  const int b_begin = batch_sum ? 0 : blockIdx.y / H;
  const int b_end = batch_sum ? B : b_begin + 1;
  float* og = dbias + (int64_t)blockIdx.y * Sq * Sk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nkt = (Sk + TILE - 1) / TILE;
  int kt0, kt1;
  key_tiles(q0, TILE, TILE, Sk, causal, window, kt0, kt1);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt >= kt0 && kt < kt1) continue;
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
      const int row = q0 + i / TILE, key = kt * TILE + i % TILE;
      if (row < Sq && key < Sk) og[(int64_t)row * Sk + key] = 0.f;
    }
  }

  for (int b = b_begin; b < b_end; ++b) {
    const int bh = b * H + h;
    const int64_t q_off = (int64_t)bh * Sq * D;
    const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
    const float* kg = k + kv_off;
    const float* vg = v + kv_off;
    const uint8_t* mg = kv_mask + (int64_t)b * Sk;
    const float* bg = bias_rows(bias, b, h, Sq);
    load_rows<D>(Qs, q + q_off, q0, Sq);
    load_rows<D>(dOs, dout + q_off, q0, Sq);
    if (kt0 < kt1) {
      load_rows<D>(Ks, kg, kt0 * TILE, Sk);
      load_rows<D>(Vs, vg, kt0 * TILE, Sk);
    }
    cp_async_commit();
    float ls[4], dl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      ls[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
      dl[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
    }
    for (int kt = kt0; kt < kt1; ++kt) {
      const int st = (kt - kt0) & 1, k0 = kt * TILE;
      if (kt + 1 < kt1) {
        load_rows<D>(Ks + (st ^ 1) * TF, kg, k0 + TILE, Sk);
        load_rows<D>(Vs + (st ^ 1) * TF, vg, k0 + TILE, Sk);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(s, Qs, Ks + st * TF, ty, tx);
      tile_dot<D>(dp, dOs, Vs + st * TF, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (row >= Sq || key >= Sk) continue;
          float ds = 0.f;
          if (visible(row, key, Sq, Sk, mg, causal, window))
            ds = expf(s[i][j] * scale +
                      bias_at<DENSE_BIAS>(bg, nullptr, row, key, q0, k0, bias.ld) - ls[i]) *
                 (dp[i][j] - dl[i]);
          float* g = og + (int64_t)row * Sk + key;
          *g = b == b_begin ? ds : *g + ds;
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

// -- demb ---------------------------------------------------------------------------

// demb[n, h] = sum over b and the (i, j) of bucket n of dS, 0 where a key is
// not visible. One block per (64-row query tile, b H + h) loops over its key
// tiles: each tile's dS goes to shared memory, thread t sums diagonal t (rows
// in order), then thread n adds the diagonals of bucket n (in order) to its
// register; the block writes its nb sums to partial[((b H + h) tiles + query
// tile) nb + n], the layout of the bf16 T5 dq kernel's demb partial sums.
template <int D>
__global__ void __launch_bounds__(THREADS)
    demb_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                const Bias bias, const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ partial, int H, int Hkv,
                int Sq, int Sk, float scale, int causal, int window) {
  constexpr int TF = tile_floats<D>();
  constexpr int ND = 2 * TILE - 1;   // diagonals of a tile
  constexpr int LDS = TILE + 1;      // the dS tile's rows, 1 bank apart
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + TF;
  float* Ks = dOs + TF;       // [2][TF]
  float* Vs = Ks + 2 * TF;    // [2][TF]
  float* dS = Vs + 2 * TF;    // [TILE][LDS]
  float* Bd = dS + TILE * LDS;   // [ND + 1] the tile's bias by diagonal
  float* Dd = Bd + ND + 1;       // [ND + 1] the tile's dS summed by diagonal
  int* Bi = reinterpret_cast<int*>(Dd + ND + 1);   // [ND + 1] bucket by diagonal
  float* col = reinterpret_cast<float*>(Bi + ND + 1);   // [nb] the head's column

  const int q0 = blockIdx.x * TILE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t q_off = (int64_t)bh * Sq * D;
  const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
  const float* kg = k + kv_off;
  const float* vg = v + kv_off;
  const uint8_t* mg = kv_mask + (int64_t)b * Sk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int kt0, kt1;
  key_tiles(q0, TILE, TILE, Sk, causal, window, kt0, kt1);

  load_rows<D>(Qs, q + q_off, q0, Sq);
  load_rows<D>(dOs, dout + q_off, q0, Sq);
  if (kt0 < kt1) {
    load_rows<D>(Ks, kg, kt0 * TILE, Sk);
    load_rows<D>(Vs, vg, kt0 * TILE, Sk);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < bias.nb; c += THREADS) col[c] = bias.table[c * H + h];
  float ls[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    ls[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dl[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  float acc = 0.f;   // bucket threadIdx.x's sum (threads below nb)

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1, k0 = kt * TILE;
    if (kt + 1 < kt1) {
      load_rows<D>(Ks + (st ^ 1) * TF, kg, k0 + TILE, Sk);
      load_rows<D>(Vs + (st ^ 1) * TF, vg, k0 + TILE, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the table column, on the first tile
    t5_diagonals(Bd, Bi, col, bias.index, q0, k0, Sq, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks + st * TF, ty, tx);
    tile_dot<D>(dp, dOs, Vs + st * TF, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;
        if (visible(row, key, Sq, Sk, mg, causal, window))
          ds = expf(s[i][j] * scale + bias_at<T5_BIAS>(nullptr, Bd, row, key, q0, k0, 0) -
                    ls[i]) *
               (dp[i][j] - dl[i]);
        dS[(ty + 16 * i) * LDS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    // diagonal t holds the (row r, column r + t - 63) of the tile
    for (int t = threadIdx.x; t < ND; t += THREADS) {
      const int r_lo = max(0, TILE - 1 - t), r_hi = min(TILE, 2 * TILE - 1 - t);
      float sum = 0.f;
      for (int r = r_lo; r < r_hi; ++r) sum += dS[r * LDS + r + t - (TILE - 1)];
      Dd[t] = sum;
    }
    __syncthreads();
    if (threadIdx.x < bias.nb) {
      float sum = 0.f;
      for (int t = 0; t < ND; ++t)
        if (Bi[t] == (int)threadIdx.x) sum += Dd[t];
      acc += sum;
    }
  }
  cp_async_wait<0>();
  if (threadIdx.x < bias.nb)
    partial[((int64_t)bh * gridDim.x + blockIdx.x) * bias.nb + threadIdx.x] = acc;
}

// -- launchers ----------------------------------------------------------------------

// Above 48 KB a kernel opts in to dynamic shared memory, up to MAX_SMEM;
// done again only for a launch that needs more than the instance was allowed
// (a larger table), so later launches (and CUDA graph captures) make no
// attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

bool bad_args(int B, int H, int Hkv, int Sq, int Sk, int D, int window) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
         (D != 32 && D != 64 && D != 128) || window < 0 || (int64_t)B * H > 65535;
}

// A dense bias and a T5 table exclude each other; a table has 1 to
// MAX_BUCKETS buckets and comes with its index.
bool bad_bias(const float* rows, const float* table, const int* index, int nb) {
  if (table == nullptr) return false;
  return rows != nullptr || index == nullptr || nb <= 0 || nb > MAX_BUCKETS;
}

// Shared memory of a kernel with `tiles` operand tiles and `scores` score
// tiles, plus T5's diagonals and `columns` table columns.
template <int D>
size_t smem_bytes(int tiles, int scores, int kind, int columns, int nb) {
  return ((size_t)tiles * tile_floats<D>() + (size_t)scores * TILE * LDP +
          (kind == T5_BIAS ? 2 * TILE + (size_t)columns * nb : 0)) *
         sizeof(float);
}

template <int KIND, int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                       const Bias& bias, float* out, float* lse, int B, int H, int Hkv, int Sq,
                       int Sk, float scale, int causal, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(5, 1, KIND, 1, bias.nb);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(fwd_kernel<KIND, D>, bytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  fwd_kernel<KIND, D><<<grid, THREADS, bytes, stream>>>(q, k, v, mask, bias, out, lse, H, Hkv, Sq,
                                                        Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int KIND, int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const uint8_t* mask,
                      const Bias& bias, const float* out, const float* dout, const float* lse,
                      float* delta, float* dq, int B, int H, int Hkv, int Sq, int Sk, float scale,
                      int causal, int window, cudaStream_t stream) {
  using C = Tc<KIND, D, false>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dq_kernel<KIND, D>, C::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::R - 1) / C::R, B * H);
  dq_kernel<KIND, D><<<grid, C::THREADS, C::SMEM, stream>>>(
      q, k, v, mask, bias, out, dout, lse, delta, dq, H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

// dk/dv's grid (cluster rank, b Hkv + hk, key block): a K/V head's G query
// heads spread over a cluster of the largest divisor of G up to 8.
template <int KIND, int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const uint8_t* mask,
                       const Bias& bias, const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                       int causal, int window, cudaStream_t stream) {
  using C = Tc<KIND, D, true>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dkv_kernel<KIND, D>, C::SMEM, allowed);
  if (err != cudaSuccess) return err;
  int ranks = 1;
  for (int c = 2; c <= 8; ++c)
    if ((H / Hkv) % c == 0) ranks = c;
  if (ranks == 1) {
    const dim3 grid(1, B * Hkv, (Sk + C::R - 1) / C::R);
    dkv_kernel<KIND, D><<<grid, C::THREADS, C::SMEM, stream>>>(
        q, k, v, mask, bias, dout, lse, delta, dk, dv, H, Hkv, Sq, Sk, scale, causal, window);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, B * Hkv, (Sk + C::R - 1) / C::R);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dkv_kernel<KIND, D>, q, k, v, mask, bias, dout, lse, delta, dk,
                            dv, H, Hkv, Sq, Sk, scale, causal, window);
}

template <int D>
cudaError_t launch_dbias(const float* q, const float* k, const float* v, const uint8_t* mask,
                         const Bias& bias, const float* dout, const float* lse,
                         const float* delta, float* dbias, int B, int H, int Hkv, int Sq, int Sk,
                         float scale, int causal, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(6, 0, DENSE_BIAS, 0, 0);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dbias_kernel<D>, bytes, allowed);
  if (err != cudaSuccess) return err;
  // a bias shared over the batch (bs == 0) has one output row per head
  const int batch_sum = bias.bs == 0;
  const dim3 grid((Sq + TILE - 1) / TILE, batch_sum ? H : B * H);
  dbias_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, mask, bias, dout, lse, delta, dbias,
                                                    B, H, Hkv, Sq, Sk, scale, causal, window,
                                                    batch_sum);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_demb(const float* q, const float* k, const float* v, const uint8_t* mask,
                        const Bias& bias, const float* dout, const float* lse, const float* delta,
                        float* partial, int B, int H, int Hkv, int Sq, int Sk, float scale,
                        int causal, int window, cudaStream_t stream) {
  const size_t bytes = ((size_t)6 * tile_floats<D>() + (size_t)TILE * (TILE + 1) +
                        4 * 2 * TILE + bias.nb) *
                       sizeof(float);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(demb_kernel<D>, bytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  demb_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, mask, bias, dout, lse, delta, partial,
                                                   H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

// The call of LAUNCH's instance for the bias kind (T5_BIAS with a table,
// DENSE_BIAS with a bias, else NO_BIAS) and the head dim D.
#define F32_BY_DIM(LAUNCH, KIND, ...)                                   \
  (D == 32   ? LAUNCH<KIND, 32>(__VA_ARGS__)                            \
   : D == 64 ? LAUNCH<KIND, 64>(__VA_ARGS__)                            \
             : LAUNCH<KIND, 128>(__VA_ARGS__))
#define F32_DISPATCH(LAUNCH, ...)                                       \
  (t5_table ? F32_BY_DIM(LAUNCH, T5_BIAS, __VA_ARGS__)                  \
   : bias   ? F32_BY_DIM(LAUNCH, DENSE_BIAS, __VA_ARGS__)               \
            : F32_BY_DIM(LAUNCH, NO_BIAS, __VA_ARGS__))
#define F32_BY_DIM1(LAUNCH, ...)                                        \
  (D == 32 ? LAUNCH<32>(__VA_ARGS__) : D == 64 ? LAUNCH<64>(__VA_ARGS__) \
                                               : LAUNCH<128>(__VA_ARGS__))

}  // namespace flash_f32

using namespace flash_f32;

extern "C" {

// q, out, dout (B, H, Sq, D) and k, v (B, Hkv, Sk, D): float32, contiguous,
// 16-byte aligned; kv_mask (B, Sk) uint8 (1 = key present); lse, delta (B,
// H, Sq) f32. D is 32, 64 or 128; window 0 means none. Each entry point
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
//
// bias is nullptr or a float32 bias (b0 h0, Sq, Sk) whose rows lie ld >= Sk
// floats apart (ld = Sk when contiguous), with b0 in {1, B} and h0 in {1,
// H}, and the plane strides bs (0 when b0 = 1, else h0) and hs (0 when h0 =
// 1, else 1): the rows of (b, h) are plane b bs + h hs, Sq ld floats a plane.
// t5_table is nullptr or T5's float32 (nb, H) table, with t5_index the int32
// bucket of every distance (Sq + Sk - 1 entries, entry k - q + Sq - 1 for
// query slot q and key slot k) and 1 <= nb <= 128; never with a bias. With
// neither, the bias-free kernels.

// The forward: out (B, H, Sq, D) f32 and lse (B, H, Sq) f32 (natural log;
// -1e30 and out = 0 for a row that sees no key).
int fwd(const float* q, const float* k, const float* v, const uint8_t* kv_mask, const float* bias,
        int bs, int hs, int ld, const float* t5_table, const int* t5_index, int nb, float* out,
        float* lse, int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
        int window, void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      (bias && ld < Sk))
    return (int)cudaErrorInvalidValue;
  const Bias b{bias, bs, hs, ld, t5_table, t5_index, nb};
  return (int)F32_DISPATCH(launch_fwd, q, k, v, kv_mask, b, out, lse, B, H, Hkv, Sq, Sk, scale,
                           causal, window, static_cast<cudaStream_t>(stream));
}

// dq (B, H, Sq, D) f32 and delta (B, H, Sq) f32, from the forward's out and
// lse (of the same bias).
int bwd_dq(const float* q, const float* k, const float* v, const uint8_t* kv_mask,
           const float* bias, int bs, int hs, int ld, const float* t5_table, const int* t5_index,
           int nb, const float* out, const float* dout, const float* lse, float* delta, float* dq,
           int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
           void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      (bias && ld < Sk))
    return (int)cudaErrorInvalidValue;
  const Bias b{bias, bs, hs, ld, t5_table, t5_index, nb};
  return (int)F32_DISPATCH(launch_dq, q, k, v, kv_mask, b, out, dout, lse, delta, dq, B, H, Hkv,
                           Sq, Sk, scale, causal, window, static_cast<cudaStream_t>(stream));
}

// dk, dv (B, Hkv, Sk, D) f32, summed over each K/V head's query heads, from
// bwd_dq's delta.
int bwd_dkv(const float* q, const float* k, const float* v, const uint8_t* kv_mask,
            const float* bias, int bs, int hs, int ld, const float* t5_table, const int* t5_index,
            int nb, const float* dout, const float* lse, const float* delta, float* dk, float* dv,
            int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int window,
            void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      (bias && ld < Sk) || (int64_t)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const Bias b{bias, bs, hs, ld, t5_table, t5_index, nb};
  return (int)F32_DISPATCH(launch_dkv, q, k, v, kv_mask, b, dout, lse, delta, dk, dv, B, H, Hkv,
                           Sq, Sk, scale, causal, window, static_cast<cudaStream_t>(stream));
}

// dbias f32: (H, Sq, Sk) summed over the batch when bs == 0 (a bias shared
// over the batch), else (B, H, Sq, Sk); per query head either way (the
// caller sums over the heads for h0 = 1). bias must not be nullptr, and is
// contiguous (ld = Sk).
int bwd_dbias(const float* q, const float* k, const float* v, const uint8_t* kv_mask,
              const float* bias, int bs, int hs, const float* dout, const float* lse,
              const float* delta, float* dbias, int B, int H, int Hkv, int Sq, int Sk, int D,
              float scale, int causal, int window, void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const Bias b{bias, bs, hs, Sk, nullptr, nullptr, 0};
  return (int)F32_BY_DIM1(launch_dbias, q, k, v, kv_mask, b, dout, lse, delta, dbias, B, H, Hkv,
                          Sq, Sk, scale, causal, window, static_cast<cudaStream_t>(stream));
}

// partial (B, H, ceil(Sq / 64), nb) f32: the T5 table's gradient summed per
// (batch, head, 64-row query tile); the caller sums over the batch and the
// tiles. t5_table, t5_index and nb as for fwd, not nullptr.
int bwd_demb(const float* q, const float* k, const float* v, const uint8_t* kv_mask,
             const float* t5_table, const int* t5_index, int nb, const float* dout,
             const float* lse, const float* delta, float* partial, int B, int H, int Hkv, int Sq,
             int Sk, int D, float scale, int causal, int window, void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || t5_table == nullptr ||
      bad_bias(nullptr, t5_table, t5_index, nb))
    return (int)cudaErrorInvalidValue;
  const Bias b{nullptr, 0, 0, 0, t5_table, t5_index, nb};
  return (int)F32_BY_DIM1(launch_demb, q, k, v, kv_mask, b, dout, lse, delta, partial, B, H, Hkv,
                          Sq, Sk, scale, causal, window, static_cast<cudaStream_t>(stream));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
