// Flash attention in float32 for grouped K/V heads, without a bias, with an
// additive float32 bias or with T5's relative-position table: the forward
// (out and lse), the backward's dq (and delta, and with T5 the table's
// gradient demb), dk and dv, and the gradient of a dense bias (dbias):
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
// float32's accuracy: every kernel takes the tensor cores in split TF32
// (below), never a single TF32 product (which keeps about three decimal
// digits). The max and lse are kept in natural units for every bias kind,
// as the biased kernels keep them (the encoder ALiBi's -1e9 survives).
//
// Kernels, instanced by bias kind (KIND: NO_BIAS, DENSE_BIAS, T5_BIAS, as in
// flash_attention.cu and flash_bwd.cu) and head dim D (32, 64, 128; the
// wrapper pads other head dims), and the TPU kernels whose float32 mode they
// replace:
//   fwd_kernel   _fwd_packed_kernel (:261, through _fwd_packed, :342),
//                _fwd_kernel (:186, through _fwd, :381) and
//                _fwd_stream_kernel (:474, through _fwd_stream, :544);
//   dq_kernel    _bwd_dq_packed_kernel (:963), _bwd_dq_kernel (:866),
//                _bwd_dq_stream_kernel (:618); its T5 instance with DEMB
//                also _demb_kernel (:1255, through _compute_demb, :1318);
//   dkv_kernel   _bwd_dkv_packed_kernel (:1018), _bwd_dkv_kernel (:911),
//                _bwd_dkv_stream_kernel (:676);
//   dbias_kernel _dbias_kernel (:1160, through _compute_dbias, :1213); where
//                the TPU kernel keeps its output block resident across the
//                batch axis (:1160-1210), a shared bias's batch sum stays in
//                a consumer's registers.
//
// What bounds them: operations, but dbias. One causal product at (2, 8,
// 2048, 64) is 2 B H S^2 D / 2 = 4.3 GFLOP: 0.064 ms at the card's float32
// rate outside the tensor cores (67 TFLOP/s), 0.026 ms as split TF32 (three
// products at 495 TFLOP/s); the forward does two, dq three, dk/dv four.
// dbias does two, and writes its (Sq, Sk) planes whole: at that shape with
// a per-sample bias 0.13 ms of bytes against 0.052 of products.
//
// All four: see "the tensor-core kernels" below; dbias runs on dq's ring
// (see "dbias"). No atomics: dbias sums a bias shared over the batch in a
// consumer's registers, batch by batch, dq's demb writes a row of partial
// sums per (batch, head, query tile) for the wrapper to sum, and dk/dv sums
// a cluster's partials in rank order, so the same inputs give the same
// bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace flash_f32 {

using wgmma_gemm::mbar_arrive;
using wgmma_gemm::mbar_init;
using wgmma_gemm::mbar_wait;
using wgmma_gemm::smem_desc;
using wgmma_gemm::split_tf32;
using wgmma_gemm::wgmma_commit;
using wgmma_gemm::wgmma_fence;
using wgmma_gemm::wgmma_tf32_rs;
using wgmma_gemm::wgmma_wait;

constexpr int MAX_BUCKETS = 128;
constexpr size_t MAX_SMEM = 232448;   // shared memory a block can have
constexpr float NEG_INF = -1e30f;   // the lse of a row that sees no key

enum BiasKind : int { NO_BIAS = 0, DENSE_BIAS = 1, T5_BIAS = 2 };

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

// -- the tensor-core kernels: the forward, dq (and delta, demb), dk, dv, dbias ---

// Every product of fwd_kernel, dq_kernel, dkv_kernel and dbias_kernel is
// split-TF32: x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi), and a . b = hi_a hi_b + hi_a lo_b + lo_a hi_b, each TF32 product
// exact in the float32 sums. x - hi is exact, and lo keeps 11 of its bits,
// so hi + lo is within 2^-22 |x|; the dropped lo_a lo_b is below 2^-22
// |a b|. A term's error is then a few u = 2^-24 of it, as a float32 FMA
// chain's is, where one TF32 product keeps 2^-11.
//
// A block holds NC 64-row tiles resident, one per consumer warpgroup (the
// forward: query rows with their Q; dq: with their Q and dO; dk/dv: keys with
// their K and V), and streams the other side in tiles of TN rows (the forward
// and dq: keys with K, V; dk/dv: queries with Q, dO) through a ring of two
// stages. Warpgroup 0 is the producer: its 128 threads read a tile's float32
// rows (16-byte loads, the next tile's issued before the wait for its stage),
// split them and store the hi and lo planes in the 128-byte swizzled K-major
// layout that wgmma reads (row r's 16-byte chunk j at chunk j ^ (r % 8), 32
// floats a panel row), with the tile's dense bias, T5 diagonals, key flags or
// lse and delta beside them; fence.proxy.async and the stage's "full"
// mbarrier publish it. Each consumer then issues
//   forward: S = Q K^T                    (wgmma m64nTNk8, K-major),
//   dq:      S = Q K^T and dP = dO V^T,
//   dk/dv:   S^T = K Q^T and dP^T = V dO^T,
// three products per k-step (lo hi, hi lo, hi hi), forms P (the forward: by
// the online softmax, the row's running max and sum rescaling its output) and
// dS in registers, and adds dS K (dq), P^T dO (dv) and dS^T Q (dk) with
// mma.sync.m16n8k8.tf32: wgmma takes no transposed TF32 operand, and these
// products' B (K, dO, Q) would be N-major. Their A is the score accumulator
// itself, split in registers: an m16n8k8 A fragment wants columns t and t +
// 4 where the accumulator holds 2t and 2t + 1, so the k-slots are permuted
// (slot t <-> key 2t, slot t + 4 <-> key 2t + 1) and B's rows read to match,
// by ld.shared from the same swizzled planes (conflict-free: the eight rows
// of a read fall on distinct chunks). The consumer frees the stage on its
// "empty" mbarrier once its products have read it.
//
// The forward differs where only it can: its producer stores V's planes
// transposed (D rows of TN keys, the keys in the permuted slots; SplitTileT)
// so that P V is a register-A wgmma m64nDk8 with P's split accumulator as A,
// where the 128-byte swizzle allows it (TN >= 32; mma.sync at D = 128); its
// consumers hold Q's hi and lo parts in registers as the score product's A
// (QREG), where they fit and there is no dense bias, so S reads only K from
// shared memory; the producer copies a dense bias tile by cp.async while it
// splits K and V. A row's TN / 2 scores of a thread lie in the four lanes of
// a quad, so its row max and sum take two shuffles. Each tile's P V is
// summed in fresh registers and added to the output with a float32 add, as
// the mma.sync products are.
//
// Shapes: NC = 2, TN = 32 at D = 64 (dq's resident tiles' planes take 128
// KB, a stage 32 KB and, with a dense bias, 16 KB more); NC = 2, TN = 64 at
// D = 32; NC = 1, TN = 16 at D = 128. One block per SM. The forward's and
// dq's grids run the last (longest causal) query blocks first. dk/dv's
// spreads a K/V head's G query heads over a thread-block cluster of c blocks
// (c the largest divisor of G up to 8), the rank taking G / c heads in
// order, so that a key block's work under GQA and causality is c blocks' and
// the grid runs the first (longest causal) key blocks first; each block keeps
// its partial dk and dv, stores them over its resident tiles, and rank r sums
// rows [r R / c, (r + 1) R / c) of every rank's partials in rank order
// through distributed shared memory. No atomics anywhere: the same inputs
// give the same bits.
//
// T5's table gradient (demb) is the T5 dq kernel's DEMB instance: a
// consumer's 64 x TN tile of float32 dS is summed by bucket where it lies. A
// far tile, one whose every distance lies in the index's first or last
// bucket (by its 64-aligned offset against the host's plan of 64 x 64 tiles,
// models/positional.py t5_far_tiles: a 64 x TN tile inside a far 64 x 64 one
// is far), the thread adds into a running sum of that side. A near tile goes
// by diagonal through the consumer's skew buffer (DEMB_LD) and is summed by
// bucket by the consumer's own warps (the producer splits the tiles, so it
// has no idle warps): lane l of warp w takes diagonal 32 w + l, then a
// segmented scan by bucket across the lanes (a bucket is one run of
// diagonals) whose last lane of each run adds it into the warp's bucket sum.
// At the end the consumer sums its warps' sums and far sums into its row of
// partial sums, in a fixed order.
//
// What holds them back: shared memory. Both operands of a score wgmma come
// from it (but the forward's Q), so an m64n32k8 reads 3 KB for 32768 flops,
// about 190 bytes a cycle at the TF32 rate against the 128 shared memory
// gives, and every warp reads the whole B of its mma.sync products; a
// consumer also waits on its own score products before its exponentials
// (the two consumers overlap each other only). Tried and dropped (PERF.md
// §6): a third stage where it fits, and S and dP in two wgmma groups with P
// formed while dP runs; in the forward, P V by mma.sync, 64-key stages, a
// third stage, and the next tile's S issued behind the last tile's P V.

// Registers a thread of the producer and of a consumer warpgroup keep once
// setmaxnreg has moved them (two consumers: 128 72 + 256 216 <= 65536).
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;


// demb's skew buffer: a consumer thread adds its elements (r, c) and (r + 8,
// c + 8), which share a diagonal, down to 2 (TN / 8 + 1) partial sums,
// diagonals 8 m + e + 2 t - g - 16 w + 63 (m in -1 .. TN / 8 - 1, e in 0, 1;
// lane (g, t) of warp w), and stores them at row (diagonal), column 8 w + g:
// rows of DEMB_LD floats (the 32 columns, 16-byte aligned rows; a warp's 32
// stores fall on distinct banks). Each (diagonal, column) has at most one
// writer, and a column no element reaches stays 0 from the kernel's start.
constexpr int DEMB_LD = 36;

enum Pass : int { FWD = 0, DQ = 1, DKV = 2 };

template <int KIND, int D, int PASS, bool DEMB = false>
struct Tc {
  static_assert(!DEMB || (KIND == T5_BIAS && PASS == DQ), "demb: the T5 dq kernel's");
  static constexpr int NC = D == 128 ? 1 : 2;              // consumer warpgroups
  static constexpr int TN = D == 32 ? 64 : D == 64 ? 32 : 16;   // rows a stage
  // the forward stages V transposed, for P V as a register-A wgmma (its
  // 128-byte swizzle wants rows of 32 keys or more)
  static constexpr bool VT = PASS == FWD && TN >= 32;
  // the forward's consumers hold Q's hi and lo parts in registers as the
  // score product's register A (at D <= 64, where they fit, without a dense
  // bias, which then reads 7 % slower: PERF.md §6), else as resident planes
  static constexpr bool QREG = PASS == FWD && D <= 64 && KIND != DENSE_BIAS;
  static constexpr int R = 64 * NC;                        // resident rows
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int RES = 64 * D * 8;                   // a 64-row tile's hi, lo planes
  static constexpr int STREAM = TN * D * 8;                // a streamed tile's
  // the stage's dense bias: the forward's and dq's (R queries x TN keys) rows
  // of BIAS_LD floats, dk/dv's (TN queries x R keys) rows of R
  static constexpr int BIAS_LD = PASS == DKV ? R : (TN == 16 ? 24 : TN);
  static constexpr int BIAS = KIND == DENSE_BIAS ? (PASS == DKV ? TN : R) * BIAS_LD * 4 : 0;
  static constexpr int STAGE = 2 * STREAM + BIAS;
  // per stage: T5's diagonals (R + TN - 1 floats; with DEMB their buckets
  // after them); the forward's and dq's key flags, dk/dv's lse and delta of
  // the tile's queries
  static constexpr int DIAG = KIND == T5_BIAS ? (R + TN) * 4 * (DEMB ? 2 : 1) : 0;
  static constexpr int EXTRA = (PASS == DKV ? 2 * TN * 4 : 64) + DIAG;
  // two stages: a third, where it fits, was no faster (PERF.md §6)
  static constexpr int STAGES = 2;
  static constexpr int STAGES_AT = (PASS == FWD ? !QREG : 2) * NC * RES;
  static constexpr int EXTRA_AT = STAGES_AT + STAGES * STAGE;
  static constexpr int BARS_AT = EXTRA_AT + STAGES * EXTRA;
  // demb: each consumer's skew buffer (ND diagonals), its warps' bucket sums
  // and far sums (two sides)
  static constexpr int ND = TN + 63;
  static constexpr int SKEW_AT = BARS_AT + 8 * 2 * STAGES;
  static constexpr int WSUM_AT = SKEW_AT + (DEMB ? NC * ND * DEMB_LD * 4 : 0);
  static constexpr int WFAR_AT = WSUM_AT + (DEMB ? NC * 4 * MAX_BUCKETS * 4 : 0);
  // the 1024 bytes align the tiles
  static constexpr size_t SMEM = 1024 + WFAR_AT + (DEMB ? NC * 4 * 2 * 4 : 0);
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

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

// d += A B^T over D as split_product's three products, A's hi and lo parts
// in registers (wgmma's register A: a warp's 16 rows, slot s of k-step kk
// holding row g + 8 (s & 1), column 8 kk + t + 4 (s >> 1) for lane (g, t)),
// B's planes at b.
template <int N, int D>
__device__ __forceinline__ void split_product_rs(float (&d)[N / 2], const uint32_t (&ah)[D / 8][4],
                                                 const uint32_t (&al)[D / 8][4], uint32_t b) {
  constexpr uint32_t B_LO = N * D * 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32_rs<N>(d, al[kk], plane_desc<N>(b, kk));
    wgmma_tf32_rs<N>(d, ah[kk], plane_desc<N>(b + B_LO, kk));
    wgmma_tf32_rs<N>(d, ah[kk], plane_desc<N>(b, kk));
  }
}

// The forward's acc (this warp's 16 rows x D, split_mma's layout) += P (16
// x TN, the accumulator of an m64nTN score tile, split here as split_mma's
// A: the same permuted k-slots) . V (TN x D) from V's transposed hi and lo
// planes at vt (SplitTileT), as register-A wgmmas m64nDk8: the tile's
// three products per k-step summed in fresh registers, then added to acc
// with a float32 add, as split_mma does.
template <int TN, int D>
__device__ __forceinline__ void pv_wgmma(float (&acc)[D / 8][4], const float (&x)[TN / 2],
                                         uint32_t vt) {
  constexpr uint32_t LO = TN * D * 4;
  uint32_t hi[TN / 8][4], lo[TN / 8][4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    split_tf32(x[4 * j], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
  float part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
  fence_acc(part);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    wgmma_tf32_rs<D>(part, lo[j], plane_desc<D>(vt, j));
    wgmma_tf32_rs<D>(part, hi[j], plane_desc<D>(vt + LO, j));
    wgmma_tf32_rs<D>(part, hi[j], plane_desc<D>(vt, j));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += part[4 * nt + e];
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

// Rows [r0, r0 + TN) of a row-major (nrows, D) float32 matrix (a V tile),
// zeros past nrows, into the transposed hi and lo planes that wgmma reads as
// a K-major B of D rows: key r of the tile at k-slot (r & ~7) | (r & 1) << 2
// | (r >> 1 & 3), split_mma's permuted slots (slot t <-> key 2t, slot t + 4
// <-> key 2t + 1), so that P's accumulator serves as the register A. A
// warp's lanes take 32 consecutive keys of one column group, so each of its
// transposed stores falls on distinct banks.
template <int TN, int D>
struct SplitTileT {
  static constexpr int N = TN * D / 4 / 128;
  float4 x[N];
  __device__ __forceinline__ void load(const float* __restrict__ src, int r0, int nrows, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + 128 * i, r = e % TN, c = e / TN * 4;
      x[i] = r0 + r < nrows ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * D + c))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(unsigned char* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + 128 * i, r = e % TN, c = e / TN * 4;
      const int slot = (r & ~7) | (r & 1) << 2 | (r >> 1 & 3);
      const float v[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t hi, lo;
        split_tf32(v[j], hi, lo);
        const int o = swz<D>(c + j, slot);
        *reinterpret_cast<uint32_t*>(dst + o) = hi;
        *reinterpret_cast<uint32_t*>(dst + TN * D * 4 + o) = lo;
      }
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

// stage_bias's 16-byte path by cp.async (the caller commits and waits):
// the copies run while the thread does other work.
template <int ROWS, int COLS, class Off>
__device__ __forceinline__ void stage_bias_async(float* dst, const float* __restrict__ src, int r0,
                                                 int c0, int nr, int nc, int ld, int tid,
                                                 Off off) {
  constexpr int N = ROWS * COLS / 4 / 128;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = tid + 128 * i, r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
    const bool ok = r0 + r < nr && c0 + c < nc;
    cp_async16(dst + off(r, c), ok ? src + (int64_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// T5's bias by diagonal for a tile whose diagonal t holds distance `base` +
// t - (Sq - 1): table[index[distance], h] of each diagonal, 0 where the
// distance falls outside the index (a slot past Sq or Sk, masked anyway),
// read by `load` ahead of the wait. With BUCKETS also each diagonal's bucket,
// the index clamped to its ends (a slot outside is masked, its dS 0), for
// demb, stored after the NDIAG + 1 values.
template <int NDIAG, bool BUCKETS = false>
struct DiagTile {
  static constexpr int N = (NDIAG + 127) / 128;
  float x[N];
  int n[BUCKETS ? N : 1];
  __device__ __forceinline__ void load(const Bias& bias, int h, int H, int base, int Sq, int Sk,
                                       int tid) {
    const int length = Sq + Sk - 1;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int t = tid + 128 * i, g = base + t;
      const bool inside = g >= 0 && g < length;
      const int b = t < NDIAG && inside ? __ldg(bias.index + g) : -1;
      x[i] = b >= 0 ? __ldg(bias.table + b * H + h) : 0.f;
      if constexpr (BUCKETS)
        n[i] = t >= NDIAG ? -1 : inside ? b : __ldg(bias.index + (g < 0 ? 0 : length - 1));
    }
  }
  __device__ __forceinline__ void store(float* bd, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (tid + 128 * i < NDIAG) {
        bd[tid + 128 * i] = x[i];
        if constexpr (BUCKETS) reinterpret_cast<int*>(bd + NDIAG + 1)[tid + 128 * i] = n[i];
      }
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The ring's barriers at `bars`: stage s's "full" (the producer's 128
// threads arrive) at bars + 8 s, its "empty" (a consumer warp's lane 0
// each) at bars + 8 (STAGES + s).
template <class C>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8 * s, 128);
      mbar_init(bars + 8 * (C::STAGES + s), 4 * C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The forward's and dq's dense bias tile: query row r, key c; the XOR
// spreads a warp's float2 reads of four rows over distinct banks (padding at
// TN = 16).
template <class C>
__device__ __forceinline__ int qbias_off(int r, int c) {
  return r * C::BIAS_LD + (C::TN == 16 ? c : c ^ ((r & 3) << 3));
}

// The forward's producer warpgroup: key tiles kt0 .. kt1 - 1 of TN keys,
// each into stage i % STAGES once the consumers have freed it: K's hi and lo
// planes, V's (transposed where VT), the tile's dense bias (query rows q0
// .., R of them; by cp.async where the rows allow, in flight while K and V
// are split and stored) or T5 diagonals and its key flags, published on the
// stage's full barrier.
template <class C, int KIND, int D>
__device__ __forceinline__ void stream_keys(unsigned char* sm, const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const uint8_t* __restrict__ mg, const Bias& bias,
                                            const float* bg, int q0, int h, int H, int Sq, int Sk,
                                            int kt0, int kt1, int tid) {
  constexpr int TN = C::TN, R = C::R;
  const bool vec = KIND == DENSE_BIAS && bias.ld % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bias.rows) & 15) == 0;
  auto boff = [](int r, int c) { return qbias_off<C>(r, c); };
  const uint32_t bars = smem_addr(sm + C::BARS_AT);
  SplitTile<TN, D> kx;
  typename std::conditional<C::VT, SplitTileT<TN, D>, SplitTile<TN, D>>::type vx;
  DiagTile<R + TN - 1> dx;
  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % C::STAGES, k0 = kt * TN;
    unsigned char* st = sm + C::STAGES_AT + s * C::STAGE;
    unsigned char* ex = sm + C::EXTRA_AT + s * C::EXTRA;
    kx.load(k, k0, Sk, tid);
    vx.load(v, k0, Sk, tid);
    if constexpr (KIND == T5_BIAS) dx.load(bias, h, H, k0 - q0 - (R - 1) + Sq - 1, Sq, Sk, tid);
    const bool flag = tid < TN && k0 + tid < Sk && mg[k0 + tid];
    mbar_wait(bars + 8 * (C::STAGES + s), ((i / C::STAGES) & 1) ^ 1);
    float* bt = reinterpret_cast<float*>(st + 2 * C::STREAM);
    if constexpr (KIND == DENSE_BIAS) {
      if (vec)
        stage_bias_async<R, TN>(bt, bg, q0, k0, Sq, Sk, bias.ld, tid, boff);
      else
        stage_bias<R, TN>(bt, bg, q0, k0, Sq, Sk, bias.ld, false, tid, boff);
      cp_async_commit();
    }
    kx.store(st, tid);
    vx.store(st + C::STREAM, tid);
    if constexpr (KIND == T5_BIAS) dx.store(reinterpret_cast<float*>(ex + 64), tid);
    if (tid < TN) ex[tid] = flag;
    if constexpr (KIND == DENSE_BIAS) cp_async_wait<0>();
    fence_async_shared();
    mbar_arrive(bars + 8 * s);
  }
}

// Score element e of a consumer's 64 x TN accumulator tile at key k0 (rows
// row[0], row[1]; rl their first's row in the block): false where its key is
// not visible from its row, else true with x (the product) scaled and its
// bias added, from the stage's key flags, dense bias tile bt or T5
// diagonals bd.
template <class C, int KIND>
__device__ __forceinline__ bool tile_score(float& x, int e, int t4, int rl, const int (&row)[2],
                                           int k0, int Sq, int Sk, const uint8_t* flags,
                                           const float* bt, const float* bd, float scale,
                                           int causal, int window) {
  const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1), key = k0 + c;
  const int r = row[hh];
  if (!(r < Sq && key < Sk && flags[c] && (!causal || key <= r) &&
        (window <= 0 || r - key < window)))
    return false;
  x *= scale;
  if constexpr (KIND == DENSE_BIAS) x += bt[qbias_off<C>(rl + 8 * hh, c)];
  if constexpr (KIND == T5_BIAS) x += bd[c - (rl + 8 * hh) + C::R - 1];
  return true;
}

// The forward: block (query block, b H + h), the last (longest causal) query
// blocks first; consumer g owns query rows q0 + 64 g .. + 63 and writes their
// out and lse. Per key tile it takes S = Q K^T (Q as the register A where
// QREG), the row's new max m (natural units; from its four lanes), rescales
// its output and row sum by exp(m_old - m), adds P = exp(S - m) to the sum
// and P V to the output (pv_wgmma where VT, else split_mma: the tile's part
// in fresh registers, then one float32 add).
template <int KIND, int D>
__global__ void __launch_bounds__(Tc<KIND, D, FWD>::THREADS, 1)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
               float* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
               float scale, int causal, int window) {
  using C = Tc<KIND, D, FWD>;
  constexpr int NC = C::NC, TN = C::TN, R = C::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t bars = smem_addr(sm + C::BARS_AT);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t q_off = (int64_t)bh * Sq * D;
  const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  int kt0, kt1;
  key_tiles(q0, R, TN, Sk, causal, window, kt0, kt1);
  init_ring<C>(bars);

  if (wg == 0) {   // the producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    stream_keys<C, KIND, D>(sm, k + kv_off, v + kv_off, kv_mask + (int64_t)b * Sk, bias,
                            KIND == DENSE_BIAS ? bias_rows(bias, b, h, Sq) : nullptr, q0, h, H,
                            Sq, Sk, kt0, kt1, tid);
    return;
  }

  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = wg - 1, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  // Q's hi and lo parts as the register A (QREG), else its planes
  unsigned char* qt = sm + g * C::RES;
  uint32_t qh[C::QREG ? D / 8 : 1][4], ql[C::QREG ? D / 8 : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + 64 * g + 16 * warp + lane / 4 + 8 * (e & 1);
        const int c = 8 * kk + t4 + 4 * (e >> 1);
        split_tf32(r < Sq ? __ldg(q + q_off + (int64_t)r * D + c) : 0.f, qh[kk][e], ql[kk][e]);
      }
  } else {
    SplitTile<64, D> x;
    x.load(q + q_off, q0 + 64 * g, Sq, tid);
    x.store(qt, tid);
    fence_async_shared();
    consumer_sync(g);
  }

  const int rl = 64 * g + 16 * warp + lane / 4;   // local rows rl, rl + 8
  const int row[2] = {q0 + rl, q0 + rl + 8};
  // the output; per row the running max (natural units) and this thread's
  // part of the row sum
  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int first = q0 + 64 * g, last = min(first + 63, Sq - 1);
  const uint32_t qa = smem_addr(qt);

  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % C::STAGES, k0 = kt * TN;
    unsigned char* st = sm + C::STAGES_AT + s * C::STAGE;
    const unsigned char* ex = sm + C::EXTRA_AT + s * C::EXTRA;
    mbar_wait(bars + 8 * s, (i / C::STAGES) & 1);
    const bool skip = first >= Sq || (causal && k0 > last) ||
                      (window > 0 && k0 + TN - 1 <= first - window);
    if (!skip) {
      float sc[TN / 2];
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) sc[e] = 0.f;
      fence_acc(sc);
      wgmma_fence();
      if constexpr (C::QREG)
        split_product_rs<TN, D>(sc, qh, ql, smem_addr(st));
      else
        split_product<TN, D>(sc, qa, smem_addr(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      const float* bt = reinterpret_cast<const float*>(st + 2 * C::STREAM);
      const float* bd = reinterpret_cast<const float*>(ex + 64);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) {
        if (!tile_score<C, KIND>(sc[e], e, t4, rl, row, k0, Sq, Sk, ex, bt, bd, scale, causal,
                                 window))
          sc[e] = -INFINITY;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
      float mu[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float t = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
        const float mn = fmaxf(m[hh], t);
        mu[hh] = mn == -INFINITY ? 0.f : mn;   // no visible key yet
        const float alpha = expf(m[hh] - mu[hh]);
        m[hh] = mn;
        l[hh] *= alpha;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          acc[nt][2 * hh] *= alpha;
          acc[nt][2 * hh + 1] *= alpha;
        }
      }
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) {
        sc[e] = expf(sc[e] - mu[(e >> 1) & 1]);   // P
        l[(e >> 1) & 1] += sc[e];
      }
      if constexpr (C::VT)
        pv_wgmma<TN, D>(acc, sc, smem_addr(st + C::STREAM));
      else
        split_mma<TN, D>(acc, sc, st + C::STREAM, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (C::STAGES + s));
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (row[hh] >= Sq) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
    float* o = out + q_off + (int64_t)row[hh] * D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) =
          make_float2(acc[nt][2 * hh] * inv, acc[nt][2 * hh + 1] * inv);
    if (t4 == 0) lse[(int64_t)bh * Sq + row[hh]] = lr == 0.f ? NEG_INF : m[hh] + logf(lr);
  }
}

// demb of a near or far 64 x TN tile of consumer g's dS (sc, the
// accumulator's layout) at key k0, its query rows from `first`: a far tile
// (by the plan `far`, its offset rounded down to 64) into the thread's sum
// of its side; a near one by diagonal through the skew buffer (DEMB_LD),
// then lane l of warp w sums diagonal 32 w + l and a segmented scan by
// bucket (the stage's buckets by diagonal after its T5 values bd, consumer
// g's from 64 (NC - 1 - g) on) adds each run into the warp's bucket sums.
// Two barriers of the consumer's own: its last near tile's rows are read
// before they are written again.
template <int NC, int TN>
__device__ __forceinline__ void demb_tile(const float (&sc)[TN / 2], const float* bd, int k0,
                                          int first, const int4 far, float (&far_sum)[2],
                                          float* skew, float* wsum, int g, int warp, int lane) {
  constexpr int ND = TN + 63, R = 64 * NC;
  const int offset = (k0 & ~63) - first;
  const int side = offset >= far.y ? 1 : offset <= far.x ? 0 : -1;
  if (side >= 0) {
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int e = 0; e < TN / 2; e += 2) {
      v0 += sc[e];
      v1 += sc[e + 1];
    }
    far_sum[side] += v0 + v1;
    return;
  }
  consumer_sync(g);
  const int t4 = lane % 4;
  float* o = skew + DEMB_LD * (2 * t4 - lane / 4 - 16 * warp + 63) + 8 * warp + lane / 4;
#pragma unroll
  for (int m = -1; m < TN / 8; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = 0.f;
      if (m >= 0) x = sc[4 * m + e];
      if (m < TN / 8 - 1) x += sc[4 * m + 6 + e];
      o[DEMB_LD * (8 * m + e)] = x;
    }
  consumer_sync(g);
  const int r = 32 * warp + lane;
  float x = 0.f;
  int bk = -1;
  if (r < ND) {
    const float4* row = reinterpret_cast<const float4*>(skew + r * DEMB_LD);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 y = row[j];
      a0 += y.x;
      a1 += y.y;
      a2 += y.z;
      a3 += y.w;
    }
    x = (a0 + a1) + (a2 + a3);
    bk = reinterpret_cast<const int*>(bd + R + TN)[r + 64 * (NC - 1 - g)];
  }
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    const int by = __shfl_up_sync(0xffffffffu, bk, off);
    if (lane >= off && by == bk) x += y;
  }
  const int bn = __shfl_down_sync(0xffffffffu, bk, 1);
  if (bk >= 0 && (lane == 31 || bn != bk)) wsum[warp * MAX_BUCKETS + bk] += x;
}

// demb's row of the consumer (`row` of partial, written where `write`):
// each bucket's near sums by warp, then the far sums of its side.
__device__ __forceinline__ void demb_row(const float (&far_sum)[2], const float* wsum, float* wfar,
                                         float* __restrict__ partial, const int4 far, int nb,
                                         int64_t row, bool write, int g, int warp, int lane,
                                         int tid) {
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    float x = far_sum[side];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) wfar[2 * warp + side] = x;
  }
  consumer_sync(g);
  if (write && tid < nb) {
    float sum = 0.f, fz = 0.f, fw = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sum += wsum[w * MAX_BUCKETS + tid];
      fz += wfar[2 * w];
      fw += wfar[2 * w + 1];
    }
    if (tid == far.z) sum += fz;
    if (tid == far.w) sum += fw;
    partial[row * nb + tid] = sum;
  }
}

// dq's and dbias's producer warpgroup: key tiles kt0 .. kt1 - 1 of TN keys
// (keys k, values v, key flags mg of one batch and K/V head) from ring
// position i on, each into stage i % STAGES once the consumers have freed
// it: K's and V's hi and lo planes, the tile's dense bias (query rows q0 ..,
// R of them, from the head's rows bg; 16-byte loads where `vec`) or T5
// diagonals, and its key flags, published on the stage's full barrier.
// Returns the ring position after the last tile.
template <class C, int KIND, int D, bool DEMB>
__device__ __forceinline__ int stream_kv(unsigned char* sm, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const uint8_t* __restrict__ mg, const Bias& bias,
                                         const float* bg, bool vec, int q0, int h, int H, int Sq,
                                         int Sk, int kt0, int kt1, int i, int tid) {
  constexpr int TN = C::TN, R = C::R;
  auto boff = [](int r, int c) { return qbias_off<C>(r, c); };
  const uint32_t bars = smem_addr(sm + C::BARS_AT);
  SplitTile<TN, D> kx, vx;
  DiagTile<R + TN - 1, DEMB> dx;
  for (int kt = kt0; kt < kt1; ++kt, ++i) {
    const int s = i % C::STAGES, k0 = kt * TN;
    unsigned char* st = sm + C::STAGES_AT + s * C::STAGE;
    unsigned char* ex = sm + C::EXTRA_AT + s * C::EXTRA;
    kx.load(k, k0, Sk, tid);
    vx.load(v, k0, Sk, tid);
    if constexpr (KIND == T5_BIAS) dx.load(bias, h, H, k0 - q0 - (R - 1) + Sq - 1, Sq, Sk, tid);
    const bool flag = tid < TN && k0 + tid < Sk && mg[k0 + tid];
    mbar_wait(bars + 8 * (C::STAGES + s), ((i / C::STAGES) & 1) ^ 1);
    kx.store(st, tid);
    vx.store(st + C::STREAM, tid);
    if constexpr (KIND == DENSE_BIAS)
      stage_bias<R, TN>(reinterpret_cast<float*>(st + 2 * C::STREAM), bg, q0, k0, Sq, Sk, bias.ld,
                        vec, tid, boff);
    if constexpr (KIND == T5_BIAS) dx.store(reinterpret_cast<float*>(ex + 64), tid);
    if (tid < TN) ex[tid] = flag;
    fence_async_shared();
    mbar_arrive(bars + 8 * s);
  }
  return i;
}

// A consumer's resident Q and dO tiles (64 query rows from `first` of one
// (batch, head)): their hi and lo planes at qt, dO's RES bytes after Q's.
template <int D>
__device__ __forceinline__ void load_q_do(unsigned char* qt, const float* __restrict__ q,
                                          const float* __restrict__ dout, int first, int Sq,
                                          int tid) {
  SplitTile<64, D> x;
  x.load(q, first, Sq, tid);
  x.store(qt, tid);
  x.load(dout, first, Sq, tid);
  x.store(qt + 64 * D * 8, tid);
}

// dS of a consumer's 64 x TN tile at key k0 (the accumulator's layout; rows
// row[0], row[1], rl the first's row in the block) from the stage st / ex:
// S = Q K^T and dP = dO V^T from the resident planes at qa (Q) and oa (dO)
// against the stage's K and V planes, then P = exp(S scale + bias - lse)
// from its rows' lse ls (natural units) and dS = P (dP - delta) with their
// delta dl; 0 where a key is not visible.
template <class C, int KIND, int D>
__device__ __forceinline__ void tile_ds(float (&sc)[C::TN / 2], uint32_t qa, uint32_t oa,
                                        const unsigned char* st, const unsigned char* ex, int t4,
                                        int rl, const int (&row)[2], int k0, int Sq, int Sk,
                                        const float (&ls)[2], const float (&dl)[2], float scale,
                                        int causal, int window) {
  constexpr int TN = C::TN, R = C::R;
  float dp[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) sc[e] = dp[e] = 0.f;
  const uint32_t ka = smem_addr(st), va = ka + C::STREAM;
  fence_acc(sc);
  fence_acc(dp);
  wgmma_fence();
  split_product<TN, D>(sc, qa, ka);
  split_product<TN, D>(dp, oa, va);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  const uint8_t* flags = ex;
  const float* bt = reinterpret_cast<const float*>(st + 2 * C::STREAM);
  const float* bd = reinterpret_cast<const float*>(ex + 64);
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    const int hh = (e >> 1) & 1, c = 8 * (e >> 2) + 2 * t4 + (e & 1), key = k0 + c;
    const int r = row[hh];
    float p = 0.f;
    if (r < Sq && key < Sk && flags[c] && (!causal || key <= r) &&
        (window <= 0 || r - key < window)) {
      float x = sc[e] * scale;
      if constexpr (KIND == DENSE_BIAS) x += bt[qbias_off<C>(rl + 8 * hh, c)];
      if constexpr (KIND == T5_BIAS) x += bd[c - (rl + 8 * hh) + R - 1];
      p = expf(x - ls[hh]);
    }
    sc[e] = p * (dp[e] - dl[hh]);   // dS
  }
}

// dq: block (query block, b H + h), the last (longest causal) query blocks
// first; consumer g owns query rows q0 + 64 g .. + 63, computes their delta
// and lse, and writes dq. The DEMB instance (T5_BIAS) also sums the table's
// gradient (see "T5's table gradient" above) into row (b H + h) ceil(Sq /
// 64) + q0 / 64 + g of `partial`, (nb,) a row, given the host's plan of far
// tiles `far` (at most far.x: bucket far.z; at least far.y: far.w).
template <int KIND, int D, bool DEMB>
__global__ void __launch_bounds__(Tc<KIND, D, DQ, DEMB>::THREADS, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
              const float* __restrict__ out, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
              float* __restrict__ partial, const int4 far, int H, int Hkv, int Sq, int Sk,
              float scale, int causal, int window) {
  using C = Tc<KIND, D, DQ, DEMB>;
  constexpr int NC = C::NC, TN = C::TN, R = C::R, ND = C::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  auto stage = [&](int s) { return sm + C::STAGES_AT + s * C::STAGE; };
  auto extra = [&](int s) { return sm + C::EXTRA_AT + s * C::EXTRA; };
  const uint32_t bars = smem_addr(sm + C::BARS_AT);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };

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

  init_ring<C>(bars);

  if (wg == 0) {   // the producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    stream_kv<C, KIND, D, DEMB>(sm, k + kv_off, v + kv_off, mg, bias, bg, vec, q0, h, H, Sq, Sk,
                                kt0, kt1, 0, tid);
    return;
  }

  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = wg - 1, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  unsigned char* qt = sm + g * 2 * C::RES;   // Q's planes, then dO's
  // demb: the consumer's skew buffer, its warps' bucket sums, far sums
  float* skew = reinterpret_cast<float*>(sm + C::SKEW_AT) + g * ND * DEMB_LD;
  float* wsum = reinterpret_cast<float*>(sm + C::WSUM_AT) + g * 4 * MAX_BUCKETS;
  float* wfar = reinterpret_cast<float*>(sm + C::WFAR_AT) + g * 4 * 2;
  load_q_do<D>(qt, q + q_off, dout + q_off, q0 + 64 * g, Sq, tid);
  if constexpr (DEMB) {
    for (int i = tid; i < ND * DEMB_LD; i += 128) skew[i] = 0.f;
    for (int i = tid; i < 4 * MAX_BUCKETS; i += 128) wsum[i] = 0.f;
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
  float far_sum[2] = {0.f, 0.f};   // demb: the thread's sums of far tiles by side
  const int first = q0 + 64 * g, last = min(first + 63, Sq - 1);
  const uint32_t qa = smem_addr(qt), oa = qa + C::RES;

  for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
    const int s = i % C::STAGES, k0 = kt * TN;
    mbar_wait(full(s), (i / C::STAGES) & 1);
    const bool skip = first >= Sq || (causal && k0 > last) ||
                      (window > 0 && k0 + TN - 1 <= first - window);
    if (!skip) {
      float sc[TN / 2];
      tile_ds<C, KIND, D>(sc, qa, oa, stage(s), extra(s), t4, rl, row, k0, Sq, Sk, ls, dl, scale,
                          causal, window);
      split_mma<TN, D>(acc, sc, stage(s), lane);
      if constexpr (DEMB)
        demb_tile<NC, TN>(sc, reinterpret_cast<const float*>(extra(s) + 64), k0, first, far,
                          far_sum, skew, wsum, g, warp, lane);
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
  if constexpr (DEMB)
    demb_row(far_sum, wsum, wfar, partial, far, bias.nb,
             (int64_t)bh * ((Sq + 63) / 64) + first / 64, first < Sq, g, warp, lane, tid);
}

// dk, dv: block (cluster rank, b Hkv + hk, key block), the first (longest
// causal) key blocks first; consumer g owns keys j0 + 64 g .. + 63. Rank r of
// a cluster of gridDim.x blocks takes query heads hk G + r G / c .. + G / c -
// 1, each head's visible query tiles in order.
template <int KIND, int D>
__global__ void __launch_bounds__(Tc<KIND, D, DKV>::THREADS, 1)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               int H, int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  using C = Tc<KIND, D, DKV>;
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

  init_ring<C>(bars);

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

// The keys a block of a bias shared over the batch takes (DBIAS_KEYS / TN
// tiles): its dS sums stay in a consumer thread's registers across the
// batch, 64 floats at every head dim.
constexpr int DBIAS_KEYS = 128;

// Zeros into columns [c0, c1) of rows [r0, r1) of a dbias plane (rows Sk
// floats apart) by a warpgroup's 128 threads, a row at a time: 16-byte
// stores where the rows allow (Sk % 4 == 0; c0 and c1 are then multiples
// of 4).
__device__ __forceinline__ void zero_cols(float* __restrict__ og, int r0, int r1, int c0, int c1,
                                          int Sk, int tid) {
  const bool vec = Sk % 4 == 0;
  for (int r = r0; r < r1; ++r) {
    float* p = og + (int64_t)r * Sk;
    if (vec)
      for (int c = c0 + 4 * tid; c < c1; c += 4 * 128)
        *reinterpret_cast<float4*>(p + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      for (int c = c0 + tid; c < c1; c += 128) p[c] = 0.f;
  }
}

// A consumer's 64 x TN tile x (the accumulator's layout: rows row[0],
// row[1]) into a dbias plane at key k0, rows below Sq and keys below Sk:
// float2 stores where Sk is even.
template <int TN>
__device__ __forceinline__ void store_tile(float* __restrict__ og, const float (&x)[TN / 2],
                                           const int (&row)[2], int k0, int Sq, int Sk, int t4) {
#pragma unroll
  for (int e = 0; e < TN / 2; e += 2) {
    const int hh = (e >> 1) & 1, key = k0 + 8 * (e >> 2) + 2 * t4;
    if (row[hh] >= Sq || key >= Sk) continue;
    float* p = og + (int64_t)row[hh] * Sk + key;
    if (Sk % 2 == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(x[e], x[e + 1]);
    } else {
      p[0] = x[e];
      if (key + 1 < Sk) p[1] = x[e + 1];
    }
  }
}

// dbias = dS = P (dP - delta), zero where a key is not visible, written
// whole, on dq's ring (Tc<DENSE_BIAS, D, DQ>: the producer splits K, V and
// the bias tile into the stage; consumer g holds query rows q0 + 64 g .. +
// 63 of Q and dO as resident planes and forms the tile's dS by tile_ds, in
// split TF32). Block (output row o, query block, key range): the output
// rows vary fastest, so every row's last (longest causal) query block is
// dispatched before any row's next, and the blocks fill the card longest
// first.
//   A per-sample bias (SUM false): o = b H + h and every key; each tile's dS
// is stored as soon as it is formed (zeros for a tile the consumer's rows
// do not see), and the producer, once it has streamed the visible tiles,
// writes the zeros of the tiles no row of the block sees.
//   A bias shared over the batch (SUM true, B > 1): o = h and the KT tiles
// of keys [z DBIAS_KEYS, ...); for each batch in order the consumers split
// its Q and dO and the producer streams its K and V tiles, and each tile's
// dS is added to the thread's registers (acc[j], 0 + dS first), stored
// once after the last batch: the tile's bias and dbias cross device memory
// once, with no atomics and the batches summed in a fixed order.
template <int D, bool SUM>
__global__ void __launch_bounds__(Tc<DENSE_BIAS, D, DQ>::THREADS, 1)
    dbias_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 const Bias bias, const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dbias, int B, int H,
                 int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  using C = Tc<DENSE_BIAS, D, DQ>;
  constexpr int NC = C::NC, TN = C::TN, R = C::R;
  constexpr int KT = SUM ? DBIAS_KEYS / TN : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  auto stage = [&](int s) { return sm + C::STAGES_AT + s * C::STAGE; };
  auto extra = [&](int s) { return sm + C::EXTRA_AT + s * C::EXTRA; };
  const uint32_t bars = smem_addr(sm + C::BARS_AT);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int o = blockIdx.x, h = SUM ? o : o % H;
  const int b_begin = SUM ? 0 : o / H, b_end = SUM ? B : b_begin + 1;
  float* og = dbias + (int64_t)o * Sq * Sk;
  const int nkt = (Sk + TN - 1) / TN;
  int kt0, kt1;
  key_tiles(q0, R, TN, Sk, causal, window, kt0, kt1);
  const int ka = SUM ? blockIdx.z * KT : 0, kb = SUM ? min(ka + KT, nkt) : nkt;
  const int lo = max(kt0, ka), hi = min(kt1, kb);   // the tiles streamed, per batch
  const bool vec = bias.ld % 4 == 0 && (reinterpret_cast<uintptr_t>(bias.rows) & 15) == 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  init_ring<C>(bars);

  if (wg == 0) {   // the producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    int i = 0;
    if (lo < hi)
      for (int b = b_begin; b < b_end; ++b) {
        const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
        i = stream_kv<C, DENSE_BIAS, D, false>(sm, k + kv_off, v + kv_off,
                                               kv_mask + (int64_t)b * Sk, bias,
                                               bias_rows(bias, b, h, Sq), vec, q0, h, H, Sq, Sk,
                                               lo, hi, i, tid);
      }
    if constexpr (!SUM) {
      const int r1 = min(q0 + R, Sq);
      const int c0 = lo < hi ? min(lo * TN, Sk) : Sk, c1 = lo < hi ? min(hi * TN, Sk) : Sk;
      zero_cols(og, q0, r1, 0, c0, Sk, tid);
      zero_cols(og, q0, r1, c1, Sk, Sk, tid);
    }
    return;
  }

  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = wg - 1, warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  unsigned char* qt = sm + g * 2 * C::RES;   // Q's planes, then dO's
  const int rl = 64 * g + 16 * warp + lane / 4;   // local rows rl, rl + 8
  const int row[2] = {q0 + rl, q0 + rl + 8};
  const int first = q0 + 64 * g, last = min(first + 63, Sq - 1);
  const uint32_t qa = smem_addr(qt), oa = qa + C::RES;
  float acc[KT][TN / 2];   // SUM: the tiles' dS summed over the batch
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[j][e] = 0.f;

  int i = 0;
  for (int b = b_begin; b < b_end && lo < hi; ++b) {
    const int64_t bh = (int64_t)b * H + h;
    // every warp's products have read the last batch's planes
    if (b > b_begin) consumer_sync(g);
    load_q_do<D>(qt, q + bh * Sq * D, dout + bh * Sq * D, first, Sq, tid);
    fence_async_shared();
    consumer_sync(g);
    float ls[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ls[hh] = row[hh] < Sq ? lse[bh * Sq + row[hh]] : 0.f;
      dl[hh] = row[hh] < Sq ? delta[bh * Sq + row[hh]] : 0.f;
    }
    if constexpr (SUM) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int kt = ka + j, s = i % C::STAGES, k0 = kt * TN;
        if (kt < lo || kt >= hi) continue;
        mbar_wait(full(s), (i / C::STAGES) & 1);
        const bool skip = first >= Sq || (causal && k0 > last) ||
                          (window > 0 && k0 + TN - 1 <= first - window);
        if (!skip) {
          float sc[TN / 2];
          tile_ds<C, DENSE_BIAS, D>(sc, qa, oa, stage(s), extra(s), t4, rl, row, k0, Sq, Sk, ls,
                                    dl, scale, causal, window);
#pragma unroll
          for (int e = 0; e < TN / 2; ++e) acc[j][e] += sc[e];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        ++i;
      }
    } else {
      for (int kt = lo; kt < hi; ++kt, ++i) {
        const int s = i % C::STAGES, k0 = kt * TN;
        mbar_wait(full(s), (i / C::STAGES) & 1);
        const bool skip = first >= Sq || (causal && k0 > last) ||
                          (window > 0 && k0 + TN - 1 <= first - window);
        float sc[TN / 2];
        if (skip) {
#pragma unroll
          for (int e = 0; e < TN / 2; ++e) sc[e] = 0.f;
        } else {
          tile_ds<C, DENSE_BIAS, D>(sc, qa, oa, stage(s), extra(s), t4, rl, row, k0, Sq, Sk, ls,
                                    dl, scale, causal, window);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        store_tile<TN>(og, sc, row, k0, Sq, Sk, t4);
      }
    }
  }
  if constexpr (SUM) {
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (ka + j < nkt) store_tile<TN>(og, acc[j], row, (ka + j) * TN, Sq, Sk, t4);
  }
}

// -- launchers ----------------------------------------------------------------------

// Above 48 KB a kernel opts in to dynamic shared memory, up to MAX_SMEM;
// done once per instance, so later launches (and CUDA graph captures) make
// no attribute call.
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

template <int KIND, int D>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                       const Bias& bias, float* out, float* lse, int B, int H, int Hkv, int Sq,
                       int Sk, float scale, int causal, int window, cudaStream_t stream) {
  using C = Tc<KIND, D, FWD>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(fwd_kernel<KIND, D>, C::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::R - 1) / C::R, B * H);
  fwd_kernel<KIND, D><<<grid, C::THREADS, C::SMEM, stream>>>(q, k, v, mask, bias, out, lse, H, Hkv,
                                                             Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int KIND, int D, bool DEMB>
cudaError_t launch_dq_as(const float* q, const float* k, const float* v, const uint8_t* mask,
                         const Bias& bias, const float* out, const float* dout, const float* lse,
                         float* delta, float* dq, float* partial, int4 far, int B, int H, int Hkv,
                         int Sq, int Sk, float scale, int causal, int window,
                         cudaStream_t stream) {
  using C = Tc<KIND, D, DQ, DEMB>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dq_kernel<KIND, D, DEMB>, C::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::R - 1) / C::R, B * H);
  dq_kernel<KIND, D, DEMB><<<grid, C::THREADS, C::SMEM, stream>>>(
      q, k, v, mask, bias, out, dout, lse, delta, dq, partial, far, H, Hkv, Sq, Sk, scale, causal,
      window);
  return cudaGetLastError();
}

// dq, and with `partial` (T5_BIAS only) the table's gradient: the DEMB
// instance.
template <int KIND, int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const uint8_t* mask,
                      const Bias& bias, const float* out, const float* dout, const float* lse,
                      float* delta, float* dq, float* partial, int4 far, int B, int H, int Hkv,
                      int Sq, int Sk, float scale, int causal, int window, cudaStream_t stream) {
  if constexpr (KIND == T5_BIAS)
    if (partial)
      return launch_dq_as<KIND, D, true>(q, k, v, mask, bias, out, dout, lse, delta, dq, partial,
                                         far, B, H, Hkv, Sq, Sk, scale, causal, window, stream);
  return launch_dq_as<KIND, D, false>(q, k, v, mask, bias, out, dout, lse, delta, dq, nullptr, far,
                                      B, H, Hkv, Sq, Sk, scale, causal, window, stream);
}

// dk/dv's grid (cluster rank, b Hkv + hk, key block): a K/V head's G query
// heads spread over a cluster of the largest divisor of G up to 8.
template <int KIND, int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const uint8_t* mask,
                       const Bias& bias, const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                       int causal, int window, cudaStream_t stream) {
  using C = Tc<KIND, D, DKV>;
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

template <int D, bool SUM>
cudaError_t launch_dbias_as(const float* q, const float* k, const float* v, const uint8_t* mask,
                            const Bias& bias, const float* dout, const float* lse,
                            const float* delta, float* dbias, int B, int H, int Hkv, int Sq,
                            int Sk, float scale, int causal, int window, cudaStream_t stream) {
  using C = Tc<DENSE_BIAS, D, DQ>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dbias_kernel<D, SUM>, C::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const int keys = SUM ? DBIAS_KEYS : Sk;
  const dim3 grid(SUM ? H : B * H, (Sq + C::R - 1) / C::R, (Sk + keys - 1) / keys);
  dbias_kernel<D, SUM><<<grid, C::THREADS, C::SMEM, stream>>>(
      q, k, v, mask, bias, dout, lse, delta, dbias, B, H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

// A bias shared over a batch of more than one (bs == 0) sums it inside the
// kernel, one output row per head; otherwise one per (batch, head).
template <int D>
cudaError_t launch_dbias(const float* q, const float* k, const float* v, const uint8_t* mask,
                         const Bias& bias, const float* dout, const float* lse,
                         const float* delta, float* dbias, int B, int H, int Hkv, int Sq, int Sk,
                         float scale, int causal, int window, cudaStream_t stream) {
  if (bias.bs == 0 && B > 1)
    return launch_dbias_as<D, true>(q, k, v, mask, bias, dout, lse, delta, dbias, B, H, Hkv, Sq,
                                    Sk, scale, causal, window, stream);
  return launch_dbias_as<D, false>(q, k, v, mask, bias, dout, lse, delta, dbias, B, H, Hkv, Sq,
                                   Sk, scale, causal, window, stream);
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
// lse (of the same bias). With a T5 table, partial is nullptr or (B, H,
// ceil(Sq / 64), nb) f32: the table's gradient summed per (batch, head,
// 64-row query tile), for the caller to sum over the batch and the tiles,
// given the plan of far tiles of models/positional.py t5_far_tiles (far_neg,
// far_pos: the offsets k0 - q0 of 64 x 64 tiles at most and at least which
// every distance lies in bucket b_neg, b_pos).
int bwd_dq(const float* q, const float* k, const float* v, const uint8_t* kv_mask,
           const float* bias, int bs, int hs, int ld, const float* t5_table, const int* t5_index,
           int nb, const float* out, const float* dout, const float* lse, float* delta, float* dq,
           float* partial, int far_neg, int far_pos, int b_neg, int b_pos, int B, int H, int Hkv,
           int Sq, int Sk, int D, float scale, int causal, int window, void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bad_bias(bias, t5_table, t5_index, nb) ||
      (bias && ld < Sk))
    return (int)cudaErrorInvalidValue;
  if (partial && (t5_table == nullptr || b_neg < 0 || b_neg >= nb || b_pos < 0 || b_pos >= nb))
    return (int)cudaErrorInvalidValue;
  const Bias b{bias, bs, hs, ld, t5_table, t5_index, nb};
  return (int)F32_DISPATCH(launch_dq, q, k, v, kv_mask, b, out, dout, lse, delta, dq, partial,
                           make_int4(far_neg, far_pos, b_neg, b_pos), B, H, Hkv, Sq, Sk, scale,
                           causal, window, static_cast<cudaStream_t>(stream));
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

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
