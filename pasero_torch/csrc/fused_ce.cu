// Fused cross-entropy over a vocabulary head: the forward statistics and the
// two gradients of
//
//     logits[n, v] = sum_e x[n, e] * w[v, e]          (fp32 accumulation)
//
// without the (N, V) logits ever reaching device memory whole.
//
//   fused_ce_fwd  lse[n] = logsumexp_v logits[n, v], tgt[n] = logits[n, t[n]],
//                 suml[n] = sum_v logits[n, v]                       (f32 out)
//   fused_ce_bwd  dx[n, e] = sum_v dl[n, v] * w[v, e]           (x's type out)
//                 dw[v, e] = sum_n dl[n, v] * x[n, e]                 (f32 out)
//
// with dl = c1[n] * exp(logits - lse[n]) - c2[n] * [v == t[n]] - c3[n] on valid
// (n < N, v < V) entries, rounded to x's type before the products, as the JAX
// kernels do (pasero_tpu/ops/fused_ce.py:115-120, :155, :187).
//
// Replaces the TPU kernels of pasero_tpu/ops/fused_ce.py: _fwd_kernel (called
// through _fwd, :199), _bwd_kernel (_bwd_matmuls, :234) and _bwd_dx_kernel /
// _bwd_dw_kernel (_bwd_split, :281). x is (N, E) and w is the head weight in
// its stored (V, E) row-major layout (the tied embedding table or the output
// projection's weight), so no transposed copy is made.
//
// The bf16 forward. What bounds it: operations, one product of 2 N E V flops
// (1.086 ms at 989 TFLOP/s for llama_1b's head, 4.256 ms for bloom_560m's);
// its bytes (x and W read once, 3 floats a row written) take 0.05 and 0.16
// ms. The design: the logits tiles come from the backward's mainloop
// (wgmma_gemm.cuh, x and W both K-major as stored), and an epilogue
// (FwdEpilogue) reduces each row's 256 columns of a tile in registers (a
// thread's 64 columns, then across the four lanes of its quad by shuffles) to
// one partial: the max, the sum of exponentials relative to it, the target
// logit and the logits sum, written as 4 floats into a scratch of N x
// ceil(V / 256) partials (16 bytes each: 16 MB at llama_1b's head, 128 MB at
// bloom_560m's, an eighth of the library's bf16 logits or less). The grid
// spans (row tile, vocabulary tile), so a small N still fills the card
// (whisper_base's 2048 rows give 16 x 203 tiles), and walks the row tiles of
// one vocabulary column first, so each W tile comes from device memory once
// while x is re-read from L2. A second kernel, in the same C call, merges a
// row's partials in a fixed order (one warp a row: lane-strided, then a
// shuffle tree), so there are no atomics and two calls give the same bits.
// The exponentials are ex2.approx of log2(e)-scaled scores; lse leaves in
// natural units. Columns past V (zero-filled by the copy) enter no
// statistic. E must be a multiple of 8 (the wrapper pads x and w).
//
// The bf16 backward. What bounds it: operations. The function needs three
// products of 2 N E V flops each, one logits recompute whose dl feeds both
// gradients, as JAX's _bwd_kernel does: 3.26 ms at 989 TFLOP/s for llama_1b's
// head (8192 x 2048 x 32000), 12.8 ms for bloom_560m's (8192 x 1024 x 250880).
// The TPU kernels keep a dl tile in VMEM between the products; a Hopper block
// cannot hold an output block of dx and one of dW beside it, and blocks run
// in no order, so the design loops over the vocabulary in chunks of `chunk`
// rows (8192 by default) in the C entry point, three kernels a chunk:
//   (a) dl_c = f(x . W_c^T), written in bf16 into a scratch of N x chunk;
//   (b) dW[chunk rows] = dl_c^T . x, written once in f32;
//   (c) dx_acc (+)= dl_c . W_c in f32; the last chunk writes dx in x's type.
// That is the function's three products, and the logits are computed once per
// call whatever E is. The scratch is written once and read twice: 6 N V bytes
// in all, against which the products are compute-bound at every head of the
// main path (0.47 ms of bytes against 3.26 ms of operations at llama_1b's), and
// it never grows with V. Each product is one instance of the wgmma mainloop of
// wgmma_gemm.cuh (128 x 256 tiles, TMA copies through a 4-stage ring of
// mbarriers, m64n256k16 wgmma with fp32 sums in registers, a producer
// warpgroup and two consumers), its operands K-major or MN-major as each
// product needs: (a) x and W as stored; (b) the scratch and x transposed; (c)
// the scratch as stored and W transposed. No atomics and no split K: two calls
// give the same bits. E must be a multiple of 8 (16-byte rows for TMA; the
// wrapper pads x and w otherwise).
//
// The float32 forward and backward: every float32 model's loss takes them
// (`cli.train --dtype float32`, `bench_train --dtype float32`). What bounds
// them: operations, the bf16 design's products at float32's accuracy. They
// take the tensor cores in split TF32: each operand x as hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), each product a . b as hi_a
// hi_b + hi_a lo_b + lo_a hi_b with float32 sums (hi + lo is within 2^-22 |x|
// of x, the dropped lo_a lo_b below 2^-22 |a b|), never one TF32 product,
// which keeps about three decimal digits. Three TF32 products at 495 TFLOP/s
// take 1.225 ms a product at t5_base's head (4096 x 768 x 32128), against
// 3.017 ms on the CUDA cores' float32 FMAs.
//
// wgmma reads a TF32 operand only K-major. So B, the operand it reads from
// shared memory, lies in global memory as hi and lo planes in the
// orientation its product needs, written by a split pass (split_kernel: a
// vocabulary chunk of W as stored and transposed, x transposed); A, the
// operand it reads from registers, comes as a float32 tile that the
// consumers read from shared memory in either orientation and split
// themselves. The mainloop (tf32_gemm_kernel): 128 x 128 output tiles on a
// persistent grid; warp group 0 keeps TMA copies of A's float32 tile and B's
// hi and lo planes (32 deep, 128-byte swizzled) in flight through a ring of
// four 48 KB stages; warp groups 1 and 2 own 64 rows each and issue
// register-A wgmma m64n128k8, three per 8-deep step (lo hi, hi lo, hi hi;
// split_tf32 and wgmma_tf32_rs of wgmma_gemm.cuh, as flash_f32.cu's).
// Each 32-deep k-tile's part is summed in fresh registers and added to the
// tile's sums with a float32 add: summed over a whole row in the tensor
// cores' own accumulators, a float32 product loses float32's accuracy
// (PERF.md §6). Within a part the sums lose bits as they grow, toward
// zero, so a k-tile's small products (lo hi, hi lo) go first and its hi hi
// ones last.
//   forward:  per chunk of `chunk` vocabulary rows W_c's planes, then x .
//             W_c^T with FwdEpilogue's partials, one per row and 128-column
//             tile; fwd_combine_kernel merges them.
//   backward: x's transposed planes once; per chunk W_c's planes as stored
//             and transposed, then the bf16 design's three products: (a)
//             dl_c = f(x . W_c^T) in float32 into a scratch of N x chunk,
//             without the targets' -c2; (b) dW rows = dl_c^T . x, dl_c read
//             transposed from shared memory; (c) dx (+)= dl_c . W_c, in
//             float32 (the first chunk writes dx, later ones add to it); (b)
//             and (c) add the target terms in their epilogues (Targets).
// Scratch: the forward N x ceil(V / 128) partials and 2 chunk E floats; the
// backward N chunk + 4 chunk E + 2 E ceil4(N) floats. No atomics and no
// split K: two calls give the same bits. E must be a multiple of 4 (16-byte
// rows for TMA; the wrapper pads x and w otherwise). What holds them back
// (t5_base's head, PERF.md §6): the forward's product runs at 76 % of
// the split bound, the backward's at 53-68 %; (c) has 192 tiles for 132
// SMs, (b) reads its transposed A with two-way bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "wgmma_gemm.cuh"

namespace fused_ce {

constexpr float NEG_INF = -1e30f;

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// -- the epilogues of both mainloops ----------------------------------------------
//
// Each takes a consumer thread's NACC sums of its tile (wgmma's accumulator
// layout, NACC = 128 for bf16's 256-column tiles, 64 for float32's 128).

// 2^x on the special function unit (relative error about 2^-22, far below
// the bf16 rounding of dl that follows and the forward's limits; results
// below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr float LOG2E = 1.4426950408889634f;

// The forward's partial of one logits tile (2 NACC vocabulary columns from
// the tile's first, c0 - 2 (lane % 4)): for each row below N, over the
// tile's columns below V, the max, the sum of exp(logit - max), the target
// logit (0 where the target lies outside the tile) and the logits sum, one
// float4 at part[row * tiles_v + tile].
struct FwdEpilogue {
  const int32_t* targets;
  float4* part;
  int64_t N, V;
  int tiles_v;

  struct Rows {
    int t[2];   // the targets of the thread's two rows (-1 past N)
  };

  __device__ __forceinline__ Rows rows(int r0) const {
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      r.t[h] = n < N ? targets[n] : -1;
    }
    return r;
  }

  // row h's statistics of the thread's NACC / 2 columns, then of its quad's;
  // WHOLE: every column of the tile lies below V
  template <bool WHOLE, int NACC>
  __device__ __forceinline__ float4 row_stats(const float (&d)[NACC], int h, int c0,
                                              int t) const {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (WHOLE || c0 + 8 * j + e < V) mx = fmaxf(mx, d[4 * j + 2 * h + e]);
    mx = quad_max(mx);
    const float shift = mx * LOG2E;
    float l = 0.f, tg = 0.f, sum = 0.f;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = d[4 * j + 2 * h + e];
        if (WHOLE || c0 + 8 * j + e < V) {
          l += exp2_approx(fmaf(v, LOG2E, -shift));
          sum += v;
          if (8 * j + e == t) tg = v;
        }
      }
    return make_float4(mx, quad_sum(l), quad_sum(tg), quad_sum(sum));
  }

  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&d)[NACC], int r0, int c0,
                                             const Rows& r) const {
    constexpr int W = 2 * NACC;   // the tile's columns
    const int tile = c0 / W;
    const bool whole = (int64_t)(tile + 1) * W <= V;   // the same for the warp
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      // the target's offset from this thread's first column
      const int t = r.t[h] - c0;
      const float4 st = whole ? row_stats<true>(d, h, c0, t) : row_stats<false>(d, h, c0, t);
      if (threadIdx.x % 4 == 0 && n < N) part[n * tiles_v + tile] = st;
    }
  }
};

// FwdEpilogue for a float32 launch over the vocabulary chunk from row v0:
// the caller gives part from the chunk's first tile and V less v0, and the
// targets here are counted from v0.
struct FwdChunkEpilogue : FwdEpilogue {
  int v0;

  __device__ __forceinline__ Rows rows(int r0) const {
    Rows r = FwdEpilogue::rows(r0);
#pragma unroll
    for (int h = 0; h < 2; ++h) r.t[h] -= v0;
    return r;
  }
};

// The forward's merge of each row's tiles_v partials, one warp a row: lane i
// takes partials i, i + 32, ... in order, then the lanes' states meet in a
// shuffle tree (the same sums in the same order on every call); lane 0 writes
// lse in natural units, the target logit and the logits sum.
__global__ void __launch_bounds__(256)
    fwd_combine_kernel(const float4* __restrict__ part, int tiles_v, float* __restrict__ lse,
                       float* __restrict__ tgt, float* __restrict__ suml, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;   // the whole warp
  const float4* row = part + n * tiles_v;
  float m = NEG_INF, l = 0.f, tg = 0.f, sum = 0.f;
  auto merge = [&](float mo, float lo) {
    const float mn = fmaxf(m, mo);
    l = l * exp2f((m - mn) * LOG2E) + lo * exp2f((mo - mn) * LOG2E);
    m = mn;
  };
  for (int i = lane; i < tiles_v; i += 32) {
    const float4 p = row[i];
    merge(p.x, p.y);
    tg += p.z;
    sum += p.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    merge(mo, lo);
    tg += __shfl_xor_sync(0xffffffffu, tg, off);
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    lse[n] = m + logf(l);
    tgt[n] = tg;
    suml[n] = sum;
  }
}

// -- the backward's epilogues -------------------------------------------------------

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// (a) dl = f(x . W_c^T) in x's type T (bf16 rounded, float32 as it is) into
// the scratch (N, ld), columns of the chunk starting at vocabulary row v0;
// zero past V. Without TARGET, dl leaves out the target's -c2, which the
// float32 dW and dx epilogues add themselves.
template <class T, bool TARGET = true>
struct DlogitsEpilogue {
  const float* lse;
  const float* c1;
  const float* c2;
  const float* c3;
  const int32_t* targets;
  T* dl;
  int64_t ld, N, V, v0;

  static constexpr float LOG2E = 1.4426950408889634f;
  // the thread's two rows: lse in log2 units, c1, c2, c3 and the target's
  // column in the chunk
  struct Rows {
    float shift[2], a1[2], a2[2], a3[2];
    int64_t t[2];
  };

  __device__ __forceinline__ Rows rows(int r0) const {
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      const bool ok = n < N;
      r.shift[h] = ok ? lse[n] * LOG2E : 0.f;
      r.a1[h] = ok ? c1[n] : 0.f;
      r.a2[h] = ok ? c2[n] : 0.f;
      r.a3[h] = ok ? c3[n] : 0.f;
      r.t[h] = ok ? targets[n] - v0 : -1;
    }
    return r;
  }

  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&d)[NACC], int r0, int c0,
                                             const Rows& r) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      if (n >= N) continue;
      T* row = dl + n * ld;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = c0 + 8 * j;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = 0.f;
          if (v0 + col + e < V) {
            v[e] = r.a1[h] * exp2_approx(fmaf(d[4 * j + 2 * h + e], LOG2E, -r.shift[h]));
            if (TARGET && col + e == r.t[h]) v[e] -= r.a2[h];
            v[e] -= r.a3[h];
          }
        }
        store2(row + col, v[0], v[1]);
      }
    }
  }
};

// The float32 backward's target terms: dl[n, t[n]] holds -c2[n] besides
// c1 p - c3. They are dW's and dx's largest terms, and where they cancel (two
// rows with one target, or a large softmax term) the sum lies far below
// them. Split TF32 keeps 2^-22 of each operand, so the products leave these
// terms out (DlogitsEpilogue<float, false>) and the epilogues add them in
// float32: one fma each, rows in ascending order.
struct Targets {
  const int32_t* t;   // (N,)
  const float* c2;    // (N,)
  const float* src;   // x (N, E) for dW's rows, W (V, E) for dx's
  int64_t N;
};

// d[.., h, ..] -= c2[n] x[n, columns] for every row n (ascending) whose target
// is the thread's row v0 + r0 + 8 h, columns c0 + 8 j + e, j < NACC / 4. The
// warp's 16 rows [v0 + r0 - lane / 4, + 16) are matched against 32 targets a
// step by ballot; the whole warp calls it.
template <int NACC>
__device__ __forceinline__ void add_row_targets(float (&d)[NACC], const Targets& tg, int64_t v0,
                                                int r0, int c0, int64_t E) {
  const int lane = threadIdx.x % 32;
  const int64_t first = v0 + r0 - lane / 4, mine = v0 + r0;
  for (int64_t n0 = 0; n0 < tg.N; n0 += 32) {
    const int64_t n = n0 + lane;
    const int tn = n < tg.N ? tg.t[n] : -1;
    uint32_t hits = __ballot_sync(0xffffffffu, tn >= first && tn < first + 16);
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const int64_t v = __shfl_sync(0xffffffffu, tn, j);
      const float* row = tg.src + (n0 + j) * E;
      const float c = -tg.c2[n0 + j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (v != mine + 8 * h) continue;
#pragma unroll
        for (int q = 0; q < NACC / 4; ++q) {
          const int col = c0 + 8 * q;
          if (col < E) {
            d[4 * q + 2 * h] = fmaf(c, row[col], d[4 * q + 2 * h]);
            d[4 * q + 2 * h + 1] = fmaf(c, row[col + 1], d[4 * q + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// (b) dW rows [v0, v0 + chunk) = dl_c^T . x, float32, rows past V dropped;
// with TARGETS (float32) the rows' target terms added first.
template <bool TARGETS = false>
struct DwEpilogue {
  float* dw;
  int64_t E, V, v0;
  Targets tg;

  __device__ __forceinline__ wgmma_gemm::NoRows rows(int) const { return {}; }

  template <int NACC>
  __device__ __forceinline__ void operator()(float (&d)[NACC], int r0, int c0,
                                             wgmma_gemm::NoRows) const {
    if constexpr (TARGETS) add_row_targets(d, tg, v0, r0, c0, E);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t v = v0 + r0 + 8 * h;
      if (v >= V) continue;
      float* row = dw + v * E;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = c0 + 8 * j;
        if (col < E)
          *reinterpret_cast<float2*>(row + col) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
};

// (c) in bf16, dx (+)= dl_c . W_c: the first chunk writes the float32
// accumulator, later ones add to it, the last writes dx in bf16 (a single
// chunk writes dx at once).
struct DxEpilogue {
  float* acc;
  __nv_bfloat16* dx;
  int64_t N, E;
  bool first, last;

  __device__ __forceinline__ wgmma_gemm::NoRows rows(int) const { return {}; }

  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&d)[NACC], int r0, int c0,
                                             wgmma_gemm::NoRows) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = c0 + 8 * j;
        if (col >= E) continue;
        float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        float2* a = reinterpret_cast<float2*>(acc + n * E + col);
        if (!first) {
          const float2 p = *a;
          v.x += p.x;
          v.y += p.y;
        }
        if (last)
          *reinterpret_cast<__nv_bfloat162*>(dx + n * E + col) = __floats2bfloat162_rn(v.x, v.y);
        else
          *a = v;
      }
    }
  }
};

// (c) in float32, dx (+)= dl_c . W_c in dx itself: the first chunk writes
// it, later ones add to it. A row whose target lies in the chunk [v0, v0 +
// cols) adds its target term -c2[n] W[t[n]] first (tg.src is W).
struct DxAddEpilogue {
  float* dx;
  int64_t N, E;
  bool first;
  Targets tg;
  int64_t v0, cols;

  // the thread's two rows' target row of W in the chunk, or -1
  struct Rows {
    int64_t t[2];
    float c[2];
  };

  __device__ __forceinline__ Rows rows(int r0) const {
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      const int64_t t = n < N ? (int64_t)tg.t[n] : -1;
      const bool in = t >= v0 && t < v0 + cols;
      r.t[h] = in ? t : -1;
      r.c[h] = in ? -tg.c2[n] : 0.f;
    }
    return r;
  }

  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&d)[NACC], int r0, int c0,
                                             const Rows& r) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      if (n >= N) continue;
      const float* wt = r.t[h] >= 0 ? tg.src + r.t[h] * E : nullptr;
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int col = c0 + 8 * j;
        if (col >= E) continue;
        float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        if (wt) {
          v.x = fmaf(r.c[h], wt[col], v.x);
          v.y = fmaf(r.c[h], wt[col + 1], v.y);
        }
        float2* a = reinterpret_cast<float2*>(dx + n * E + col);
        if (!first) {
          const float2 p = *a;
          v.x += p.x;
          v.y += p.y;
        }
        *a = v;
      }
    }
  }
};

// -- float32: the split-TF32 mainloop ---------------------------------------------

namespace tf32 {

using wgmma_gemm::mbar_arrive;
using wgmma_gemm::mbar_expect_tx;
using wgmma_gemm::mbar_init;
using wgmma_gemm::mbar_wait;
using wgmma_gemm::smem_desc;
using wgmma_gemm::smem_u32;
using wgmma_gemm::split_tf32;
using wgmma_gemm::tma_load;
using wgmma_gemm::wgmma_commit;
using wgmma_gemm::wgmma_fence;
using wgmma_gemm::wgmma_tf32_rs;
using wgmma_gemm::wgmma_wait;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 384;
constexpr int ACC = BN / 2;                   // float32 sums per consumer thread
constexpr int A_BYTES = BM * BK * 4;          // A's float32 tile
constexpr int B_BYTES = BN * BK * 4;          // each of B's hi and lo planes
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
// the stages, 1024 bytes to align them (128-byte swizzle), 2 barriers each
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 1024 + 16 * STAGES;

// Byte offset of A's element (row m, depth k) in a stage's tile. K-major: a
// TMA box of 32 k x 128 rows, rows 128 bytes apart. MN-major (A^T as
// stored): four boxes of 32 m x 32 k-rows, 4 KB each. Both 128-byte
// swizzled: 16-byte chunk j of a 128-byte row r lies at chunk j ^ (r % 8).
template <bool MN>
__device__ __forceinline__ int a_offset(int m, int k) {
  return MN ? (m >> 5) * 4096 + k * 128 + ((((m >> 2) & 7) ^ (k & 7)) << 4) + (m & 3) * 4
            : m * 128 + (((k >> 2) ^ (m & 7)) << 4) + (k & 3) * 4;
}

template <bool M_FAST>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  m0 = (M_FAST ? tile % tiles_m : tile / tiles_n) * BM;
  n0 = (M_FAST ? tile / tiles_m : tile % tiles_n) * BN;
}

template <int N>
__device__ __forceinline__ void fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The (tiles_m x tiles_n) 128 x 128 tiles of C = A . B^T over k_tiles
// k-tiles of 32, walked as wgmma_gemm's gemm_kernel walks its tiles (block b
// takes tiles b, b + gridDim.x, ...; n fastest, or m fastest with M_FAST).
// A is float32 (map_a: K-major, or MN-major with A_MN), B its hi and lo
// planes (map_hi, map_lo, K-major). A consumer reads its 64 rows' A
// fragments of a k-tile from shared memory, splits them, issues the
// k-tile's twelve wgmmas into fresh sums, waits for them, frees the stage
// and adds the sums into the tile's with float32 adds. The tensor cores'
// sums lose bits as they grow (PERF.md §6), so a k-tile's small
// products (lo hi, hi lo) go first, its hi hi products last.
template <class Epilogue, bool A_MN, bool M_FAST>
__global__ void __launch_bounds__(THREADS, 1)
    tf32_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_hi,
                     const __grid_constant__ CUtensorMap map_lo, int tiles_m, int tiles_n,
                     int k_tiles, Epilogue epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* tiles_ptr = smem_raw + (base - raw);
  const uint32_t full = base + STAGES * STAGE_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;
  const int tiles = tiles_m * tiles_n;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `it` counts the k-tiles this block has passed through the ring: stage
  // it % STAGES, phase (it / STAGES) & 1
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin<M_FAST>(tile, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          const uint32_t st = base + s * STAGE_BYTES;
          if (A_MN) {
#pragma unroll
            for (int j = 0; j < BM / 32; ++j)
              tma_load(st + j * 4096, &map_a, full + 8 * s, m0 + 32 * j, kt * BK);
          } else {
            tma_load(st, &map_a, full + 8 * s, kt * BK, m0);
          }
          tma_load(st + A_BYTES, &map_hi, full + 8 * s, kt * BK, n0);
          tma_load(st + A_BYTES + B_BYTES, &map_lo, full + 8 * s, kt * BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int ml = 64 * g + 16 * warp + lane / 4, t = lane % 4;   // A's rows ml, ml + 8
    int it = 0;
    float part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) part[i] = 0.f;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin<M_FAST>(tile, tiles_m, tiles_n, m0, n0);
      const int r0 = m0 + ml;
      const int c0 = n0 + 2 * t;
      const auto rows = epi.rows(r0);
      float d[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const unsigned char* a = tiles_ptr + s * STAGE_BYTES;
        uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(*reinterpret_cast<const float*>(
                      a + a_offset<A_MN>(ml + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1))),
                  ah[kk][e], al[kk][e]);
        const uint32_t bh = base + s * STAGE_BYTES + A_BYTES, bl = bh + B_BYTES;
        fence_sums(part);
        wgmma_fence();
        // an 8-deep step is 32 bytes into the planes' 128-byte rows
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          wgmma_tf32_rs<BN>(part, al[kk], smem_desc(bh + 32 * kk, 16, 1024), kk > 0);
          wgmma_tf32_rs<BN>(part, ah[kk], smem_desc(bl + 32 * kk, 16, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          wgmma_tf32_rs<BN>(part, ah[kk], smem_desc(bh + 32 * kk, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_sums(part);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
        for (int i = 0; i < ACC; ++i) d[i] += part[i];
      }
      epi(d, r0, c0, rows);
    }
  }
}

// hi and lo of rows [0, rows_out) x columns [0, cols) of a row-major float32
// matrix (cols a row) whose rows past `rows` read as zeros: into (hi, lo) in
// the same layout and, where hi_t is given, transposed into (hi_t, lo_t),
// cols rows of ld_t floats (columns [0, rows_out) written). A 32 x 32 tile a
// block of 256 threads; the transposed stores go through shared memory.
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ src, int64_t rows, int64_t rows_out, int64_t cols,
                 float* __restrict__ hi, float* __restrict__ lo, float* __restrict__ hi_t,
                 float* __restrict__ lo_t, int64_t ld_t) {
  __shared__ float th[32][33], tl[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t c0 = (int64_t)blockIdx.x * 32, r0 = (int64_t)blockIdx.y * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + ty + 8 * i, c = c0 + tx;
    const float x = r < rows && c < cols ? src[r * cols + c] : 0.f;
    uint32_t h, l;
    split_tf32(x, h, l);
    if (hi && r < rows_out && c < cols) {
      hi[r * cols + c] = __uint_as_float(h);
      lo[r * cols + c] = __uint_as_float(l);
    }
    th[ty + 8 * i][tx] = __uint_as_float(h);
    tl[ty + 8 * i][tx] = __uint_as_float(l);
  }
  if (!hi_t) return;   // the same for the whole block
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t e = c0 + ty + 8 * i, j = r0 + tx;
    if (e < cols && j < rows_out) {
      hi_t[e * ld_t + j] = th[tx][ty + 8 * i];
      lo_t[e * ld_t + j] = tl[tx][ty + 8 * i];
    }
  }
}

cudaError_t split_planes(const float* src, int64_t rows, int64_t rows_out, int64_t cols,
                         float* hi, float* lo, float* hi_t, float* lo_t, int64_t ld_t,
                         cudaStream_t stream) {
  const dim3 grid((unsigned)((cols + 31) / 32), (unsigned)((rows_out + 31) / 32));
  split_kernel<<<grid, 256, 0, stream>>>(src, rows, rows_out, cols, hi, lo, hi_t, lo_t, ld_t);
  return cudaGetLastError();
}

// The tensor map of a row-major float32 (rows, cols) matrix with leading
// dimension ld (floats), read in boxes of 32 columns x box_rows rows,
// 128-byte swizzled; TMA fills what lies outside the matrix with zeros.
// Returns false where cuTensorMapEncodeTiled refuses it (ld a multiple of
// 4, the base 16-byte aligned).
inline bool f32_map(CUtensorMap* m, const float* ptr, int64_t rows, int64_t cols, int64_t ld,
                int box_rows) {
  wgmma_gemm::EncodeTiled fn = wgmma_gemm::encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the (ceil(m / BM) x ceil(n / BN)) tiles of an m x n output, k
// deep, on at most one block per SM.
template <bool A_MN, bool M_FAST, class Epilogue>
cudaError_t gemm(const CUtensorMap& a, const CUtensorMap& hi, const CUtensorMap& lo, int64_t m,
                 int64_t n, int64_t k, const Epilogue& epi, cudaStream_t stream) {
  auto kernel = tf32_gemm_kernel<Epilogue, A_MN, M_FAST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = tiles_m * tiles_n;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(tiles < sms ? tiles : sms), THREADS, SMEM_BYTES, stream>>>(
      a, hi, lo, (int)tiles_m, (int)tiles_n, (int)((k + BK - 1) / BK), epi);
  return cudaGetLastError();
}

}  // namespace tf32

// -- launchers -------------------------------------------------------------------

// Is any of the pointers not 16-byte aligned (as TMA wants its bases)?
bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16;
}

// The bf16 forward: the partials of every logits tile into `part` (N x
// ceil(V / 256) float4), then their merge, both on `stream`.
cudaError_t launch_fwd_wgmma(const void* x, const void* w, const int32_t* targets, float* lse,
                             float* tgt, float* suml, void* part, int64_t N, int64_t E,
                             int64_t V, cudaStream_t stream) {
  using namespace wgmma_gemm;
  if (E % 8 || !part || misaligned({x, w, part})) return cudaErrorInvalidValue;
  CUtensorMap x_k, w_k;
  if (!operand_map(&x_k, x, N, E, E, false, BM) || !operand_map(&w_k, w, V, E, E, false, BN))
    return cudaErrorInvalidValue;
  const int tiles_v = (int)((V + BN - 1) / BN);
  auto* p = static_cast<float4*>(part);
  // the row tiles of one vocabulary column first (M_FAST): W from device
  // memory once, x from L2
  cudaError_t err = gemm<false, false, true>(x_k, w_k, Coords{0, 0}, N, V, E,
                                             FwdEpilogue{targets, p, N, V, tiles_v}, stream);
  if (err != cudaSuccess) return err;
  fwd_combine_kernel<<<(unsigned)((N + 7) / 8), 256, 0, stream>>>(p, tiles_v, lse, tgt, suml, N);
  return cudaGetLastError();
}

// The float32 forward: per chunk of `chunk` vocabulary rows, W_c's hi and lo
// planes into `scratch` (2 chunk E floats), then the split-TF32 product with
// the partials of its 128-column tiles into `part` (N x ceil(V / 128)
// float4); then their merge; all on `stream`.
cudaError_t launch_fwd_tf32(const float* x, const float* w, const int32_t* targets, float* lse,
                            float* tgt, float* suml, void* part, float* scratch, int64_t N,
                            int64_t E, int64_t V, int64_t chunk, cudaStream_t stream) {
  using namespace tf32;
  if (E % 4 || !part || !scratch || chunk <= 0 || chunk % BN ||
      misaligned({x, w, part, scratch}))
    return cudaErrorInvalidValue;
  float* w_hi = scratch;
  float* w_lo = scratch + chunk * E;
  CUtensorMap x_k, hi, lo;
  if (!f32_map(&x_k, x, N, E, E, BM) || !f32_map(&hi, w_hi, chunk, E, E, BN) ||
      !f32_map(&lo, w_lo, chunk, E, E, BN))
    return cudaErrorInvalidValue;
  const int tiles_v = (int)((V + BN - 1) / BN);
  auto* p = static_cast<float4*>(part);
  for (int64_t v0 = 0; v0 < V; v0 += chunk) {
    const int64_t cols = min64(chunk, V - v0);
    cudaError_t err =
        split_planes(w + v0 * E, cols, chunk, E, w_hi, w_lo, nullptr, nullptr, 0, stream);
    // the row tiles of one vocabulary column first: W_c's planes from device
    // memory once, x from L2
    if (err == cudaSuccess)
      err = gemm<false, true>(
          x_k, hi, lo, N, cols, E,
          FwdChunkEpilogue{{targets, p + v0 / BN, N, V - v0, tiles_v}, (int)v0}, stream);
    if (err != cudaSuccess) return err;
  }
  fwd_combine_kernel<<<(unsigned)((N + 7) / 8), 256, 0, stream>>>(p, tiles_v, lse, tgt, suml, N);
  return cudaGetLastError();
}

// The bf16 backward: for each chunk of `chunk` vocabulary rows, (a) the
// logits of the chunk and their dl into the scratch (N, chunk) in bf16, (b)
// the chunk's rows of dW from it, (c) its share of dx, all on `stream`.
cudaError_t launch_bwd_wgmma(const void* x, const void* w, const int32_t* targets,
                             const float* lse, const float* c1, const float* c2,
                             const float* c3, void* dx, float* dw, void* scratch,
                             float* dx_acc, int64_t N, int64_t E, int64_t V,
                             int64_t chunk, cudaStream_t stream) {
  using namespace wgmma_gemm;
  const int64_t nchunks = (V + chunk - 1) / chunk;
  if (E % 8 || chunk % BN || (nchunks > 1 && !dx_acc) || misaligned({x, w, scratch}))
    return cudaErrorInvalidValue;
  // x and w K-major for (a); x, w and the scratch MN-major for (b) and (c);
  // the scratch K-major for (c)
  CUtensorMap x_k, w_k, x_mn, w_mn, dl_mn, dl_k;
  if (!operand_map(&x_k, x, N, E, E, false, BM) || !operand_map(&w_k, w, V, E, E, false, BN) ||
      !operand_map(&x_mn, x, N, E, E, true, 0) || !operand_map(&w_mn, w, V, E, E, true, 0) ||
      !operand_map(&dl_mn, scratch, N, chunk, chunk, true, 0) ||
      !operand_map(&dl_k, scratch, N, chunk, chunk, false, BM))
    return cudaErrorInvalidValue;
  auto* dl = static_cast<__nv_bfloat16*>(scratch);
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t v0 = c * chunk, cols = min64(chunk, V - v0);
    cudaError_t err = gemm<false, false>(
        x_k, w_k, Coords{(int)v0, 0}, N, cols, E,
        DlogitsEpilogue<__nv_bfloat16>{lse, c1, c2, c3, targets, dl, chunk, N, V, v0}, stream);
    if (err == cudaSuccess)
      err = gemm<true, true>(dl_mn, x_mn, Coords{0, 0}, cols, E, N,
                             DwEpilogue<>{dw, E, V, v0, {}}, stream);
    if (err == cudaSuccess)
      err = gemm<false, true>(dl_k, w_mn, Coords{0, (int)v0}, N, E, cols,
                              DxEpilogue{dx_acc, static_cast<__nv_bfloat16*>(dx), N, E,
                                         c == 0, c == nchunks - 1},
                              stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The float32 backward: x's transposed planes once, then for each chunk of
// `chunk` vocabulary rows W_c's planes as stored and transposed, (a) the
// chunk's dl in float32, (b) its rows of dW, (c) its share of dx, added in
// dx itself; all on `stream`. The scratch, in floats: dl (N x chunk), W_c's
// hi and lo (chunk x E each), W_c^T's (E x chunk each), x^T's (E x ld_x
// each, ld_x = N rounded up to 4).
cudaError_t launch_bwd_tf32(const float* x, const float* w, const int32_t* targets,
                            const float* lse, const float* c1, const float* c2, const float* c3,
                            float* dx, float* dw, float* scratch, int64_t N, int64_t E, int64_t V,
                            int64_t chunk, cudaStream_t stream) {
  using namespace tf32;
  if (E % 4 || chunk <= 0 || chunk % BN || !scratch || misaligned({x, w, scratch}))
    return cudaErrorInvalidValue;
  const int64_t ld_x = (N + 3) / 4 * 4;
  float* dl = scratch;
  float* wc_hi = dl + N * chunk;
  float* wc_lo = wc_hi + chunk * E;
  float* wt_hi = wc_lo + chunk * E;
  float* wt_lo = wt_hi + E * chunk;
  float* xt_hi = wt_lo + E * chunk;
  float* xt_lo = xt_hi + E * ld_x;
  // (a): x and W_c's planes K-major; (b): dl read MN-major, x^T's planes;
  // (c): dl K-major, W_c^T's planes
  CUtensorMap x_k, wc_h, wc_l, dl_mn, xt_h, xt_l, dl_k, wt_h, wt_l;
  if (!f32_map(&x_k, x, N, E, E, BM) || !f32_map(&wc_h, wc_hi, chunk, E, E, BN) ||
      !f32_map(&wc_l, wc_lo, chunk, E, E, BN) || !f32_map(&dl_mn, dl, N, chunk, chunk, 32) ||
      !f32_map(&xt_h, xt_hi, E, N, ld_x, BN) || !f32_map(&xt_l, xt_lo, E, N, ld_x, BN) ||
      !f32_map(&dl_k, dl, N, chunk, chunk, BM) || !f32_map(&wt_h, wt_hi, E, chunk, chunk, BN) ||
      !f32_map(&wt_l, wt_lo, E, chunk, chunk, BN))
    return cudaErrorInvalidValue;
  cudaError_t err = split_planes(x, N, ld_x, E, nullptr, nullptr, xt_hi, xt_lo, ld_x, stream);
  for (int64_t v0 = 0; v0 < V && err == cudaSuccess; v0 += chunk) {
    const int64_t cols = min64(chunk, V - v0);
    err = split_planes(w + v0 * E, cols, chunk, E, wc_hi, wc_lo, wt_hi, wt_lo, chunk, stream);
    // (a) the row tiles of one vocabulary column first, as the forward
    if (err == cudaSuccess)
      err = gemm<false, true>(
          x_k, wc_h, wc_l, N, cols, E,
          DlogitsEpilogue<float, false>{lse, c1, c2, c3, targets, dl, chunk, N, V, v0}, stream);
    // (b) and (c) the E tiles of one row block in turn: dl from device
    // memory once; each adds the target terms that dl leaves out
    if (err == cudaSuccess)
      err = gemm<true, false>(dl_mn, xt_h, xt_l, cols, E, N,
                              DwEpilogue<true>{dw, E, V, v0, {targets, c2, x, N}}, stream);
    if (err == cudaSuccess)
      err = gemm<false, false>(dl_k, wt_h, wt_l, N, E, cols,
                               DxAddEpilogue{dx, N, E, v0 == 0, {targets, c2, w, N}, v0, cols},
                               stream);
  }
  return err;
}

// Rows and vocabulary columns are ints in the kernels (a tile's columns up
// to V + 255 among them).
bool bad_sizes(int64_t N, int64_t E, int64_t V) {
  return N < 0 || E <= 0 || V <= 0 || N > 0x7fffffff || V > 0x7fffff00;
}

}  // namespace fused_ce

using namespace fused_ce;

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (x and w). targets int32 (N,); lse, tgt,
// suml f32 (N,); x, w and part 16-byte aligned. bfloat16 takes the wgmma
// kernel and its merge: E a multiple of 8, part a scratch of N x ceil(V /
// 256) float4 partials (scratch and chunk unused). float32 takes the
// split-TF32 kernels and the merge: E a multiple of 4, part N x ceil(V /
// 128) float4 partials, scratch 2 chunk E floats, chunk a multiple of 128.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
int fused_ce_fwd(const void* x, const void* w, const int32_t* targets, float* lse, float* tgt,
                 float* suml, void* part, void* scratch, int64_t N, int64_t E, int64_t V,
                 int64_t chunk, int dtype, void* stream) {
  if (bad_sizes(N, E, V) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_wgmma(x, w, targets, lse, tgt, suml, part, N, E, V, s);
  return (int)launch_fwd_tf32(static_cast<const float*>(x), static_cast<const float*>(w), targets,
                              lse, tgt, suml, part, static_cast<float*>(scratch), N, E, V, chunk,
                              s);
}

// The backward of one call: dx (N, E) in x's type and dw (V, E) in f32, every
// element written (the caller zeroes dw where N == 0: nothing is launched).
// bfloat16 takes the wgmma kernels: E a multiple of 8, chunk a multiple of
// 256, x, w and scratch 16-byte aligned; scratch holds (N, chunk) bf16 and,
// where V > chunk, dx_acc (N, E) f32. float32 takes the split-TF32 kernels:
// E a multiple of 4, chunk a multiple of 128, scratch of N chunk + 4 chunk E
// + 2 E ceil4(N) floats, laid out as launch_bwd_tf32 says (dx_acc unused).
int fused_ce_bwd(const void* x, const void* w, const int32_t* targets,
                 const float* lse, const float* c1, const float* c2,
                 const float* c3, void* dx, float* dw, void* scratch,
                 float* dx_acc, int64_t N, int64_t E, int64_t V, int64_t chunk,
                 int dtype, void* stream) {
  if (bad_sizes(N, E, V) || (dtype != 0 && dtype != 1) || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_wgmma(x, w, targets, lse, c1, c2, c3, dx, dw, scratch,
                                 dx_acc, N, E, V, chunk, s);
  return (int)launch_bwd_tf32(static_cast<const float*>(x), static_cast<const float*>(w), targets,
                              lse, c1, c2, c3, static_cast<float*>(dx), dw,
                              static_cast<float*>(scratch), N, E, V, chunk, s);
}

const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
