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
// The float32 forward (not on any main path) keeps an FMA kernel: 256
// threads tile 64 rows x 128 vocabulary columns staged by cp.async, with each
// thread's online max / sum-exp / target logit / logit sum in registers
// across the vocabulary loop.
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
// The float32 backward (not on any main path) keeps FMA kernels: a dx and a dW
// kernel, each recomputing its logits, 32 x 512 output blocks in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace fused_ce {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

// float32 forward tile: 64 rows x 128 vocabulary columns, width chunks of KC
constexpr int F_ROWS = 64;
constexpr int F_COLS = 128;
// backward tile: 32 own rows x 64 loop rows; the output block is 32 x B_WIDTH
constexpr int B_OWN = 32;
constexpr int B_LOOP = 64;
constexpr int B_WIDTH = 512;

// float32 operands in shared memory
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int PAD = 4;     // 16 bytes of row padding
  static constexpr int VEC = 4;     // elements per 16-byte load
  static constexpr int F_KC = 128;  // forward width chunk
};

__host__ __device__ inline int round16(int64_t x) {
  return (int)((x + 15) / 16 * 16);
}

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}


// 16 bytes from global to shared memory without a register round trip;
// src_bytes = 0 writes zeros (the source is then not read).
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Wait for this thread's cp.async copies; a __syncthreads() after it makes
// every thread's copies visible to the block.
__device__ inline void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [r0, r0 + R) x columns [c0, c0 + C) of a (nrows, width) row-major
// matrix into shared memory (leading dimension ld), zero outside the matrix.
// C is a multiple of 16. The 16-byte path issues all of a thread's copies
// before any completes (cp.async); the caller runs stage_wait() and
// __syncthreads() before reading the tile.
template <typename T>
__device__ void stage(T* dst, int ld, const T* __restrict__ src, int64_t nrows,
                      int64_t width, int64_t r0, int R, int64_t c0, int C,
                      bool vec) {
  constexpr int VEC = Cfg<T>::VEC;
  if (vec) {
    const int per_row = C / VEC;
    for (int i = threadIdx.x; i < R * per_row; i += THREADS) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * VEC;
      const int64_t gr = r0 + r, gc = c0 + c;
      const bool valid = gr < nrows && gc < width;
      cp_async16(dst + r * ld + c, valid ? src + gr * width + gc : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += THREADS) {
      const int r = i / C;
      const int c = i - r * C;
      const int64_t gr = r0 + r, gc = c0 + c;
      dst[r * ld + c] = (gr < nrows && gc < width) ? src[gr * width + gc] : T(0);
    }
  }
}

// S[OWN x LOOP] (+)= A[OWN x kdim] . B[LOOP x kdim]^T from shared memory on
// the FMA units: thread t owns the elements t, t + 256, ... of the row-major
// OWN x LOOP tile.
template <int OWN, int LOOP>
struct TileFma {
  static constexpr int PER = OWN * LOOP / THREADS;
  float acc[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  }

  __device__ void run(const float* A, int lda, const float* B, int ldb,
                      int kdim) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const float* a = A + (e / LOOP) * lda;
      const float* b = B + (e % LOOP) * ldb;
      float s = acc[i];
      for (int k = 0; k < kdim; ++k) s = fmaf(a[k], b[k], s);
      acc[i] = s;
    }
  }

  __device__ void store(float* S, int lds) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * THREADS;
      S[(e / LOOP) * lds + e % LOOP] = acc[i];
    }
  }
};

// -- forward, float32: an FMA kernel ----------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int32_t* __restrict__ targets, float* __restrict__ lse_out,
               float* __restrict__ tgt_out, float* __restrict__ sum_out,
               int64_t N, int64_t E, int64_t V, bool vec) {
  constexpr int PAD = Cfg<T>::PAD;
  const int kc = (int)min64(Cfg<T>::F_KC, round16(E));  // width chunk
  const int ld = kc + PAD;
  const int lds = F_COLS + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  T* Ws = Xs + F_ROWS * ld;
  // the logits tile reuses the weight tile's memory once the product is done
  float* Ss = reinterpret_cast<float*>(Ws);

  const int64_t n0 = (int64_t)blockIdx.x * F_ROWS;
  const int nchunks = (int)((E + kc - 1) / kc);
  // thread t reduces row t / 4, columns (t % 4) + 4j of each tile
  const int row = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int64_t n = n0 + row;
  const int target = n < N ? targets[n] : -1;
  float m = NEG_INF, l = 0.f, tgt = 0.f, suml = 0.f;

  if (nchunks == 1)
    stage<T>(Xs, ld, x, N, E, n0, F_ROWS, 0, round16(E), vec);
  TileFma<F_ROWS, F_COLS> tile;
  for (int64_t v0 = 0; v0 < V; v0 += F_COLS) {
    tile.zero();
    for (int c = 0; c < nchunks; ++c) {
      const int64_t e0 = (int64_t)c * kc;
      const int width = round16(min64(kc, E - e0));
      if (nchunks > 1) stage<T>(Xs, ld, x, N, E, n0, F_ROWS, e0, width, vec);
      stage<T>(Ws, ld, w, V, E, v0, F_COLS, e0, width, vec);
      stage_wait();
      __syncthreads();
      tile.run(Xs, ld, Ws, ld, width);
      __syncthreads();
    }
    tile.store(Ss, lds);
    __syncthreads();
    const float* srow = Ss + row * lds;
    float tile_max = NEG_INF;
#pragma unroll 8
    for (int j = quarter; j < F_COLS; j += 4)
      if (v0 + j < V) tile_max = fmaxf(tile_max, srow[j]);
    const float m_new = fmaxf(m, tile_max);
    float acc = l * expf(m - m_new);
#pragma unroll 8
    for (int j = quarter; j < F_COLS; j += 4) {
      const int64_t col = v0 + j;
      if (col < V) {
        const float s = srow[j];
        acc += expf(s - m_new);
        suml += s;
        if (col == target) tgt += s;
      }
    }
    m = m_new;
    l = acc;
    __syncthreads();
  }
  // merge the four partial states of a row (lanes 4k .. 4k+3 of one warp)
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
    m = m_new;
    tgt += __shfl_xor_sync(0xffffffffu, tgt, off);
    suml += __shfl_xor_sync(0xffffffffu, suml, off);
  }
  if (quarter == 0 && n < N) {
    lse_out[n] = m + logf(l);
    tgt_out[n] = tgt;
    sum_out[n] = suml;
  }
}

// -- backward, float32: FMA kernels ---------------------------------------------

// ROWS_OWN: dx (own rows are rows of x, loop over the vocabulary);
// otherwise dW (own rows are rows of w, loop over the rows of x). Each
// block keeps a 32 x 512 output block in registers and recomputes the
// logits of its rows; E > 512 takes several blocks along the width.
template <bool ROWS_OWN>
__global__ void __launch_bounds__(THREADS)
    bwd_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int32_t* __restrict__ targets,
                   const float* __restrict__ lse, const float* __restrict__ c1,
                   const float* __restrict__ c2, const float* __restrict__ c3,
                   float* __restrict__ out, int64_t N, int64_t E, int64_t V,
                   bool vec) {
  constexpr int PAD = Cfg<float>::PAD;
  const float* own_src = ROWS_OWN ? x : w;
  const float* loop_src = ROWS_OWN ? w : x;
  const int64_t n_own = ROWS_OWN ? N : V;
  const int64_t n_loop = ROWS_OWN ? V : N;

  const int ld = B_WIDTH + PAD;
  const int lds = B_LOOP + 4;
  const int ldd = B_LOOP + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Os = reinterpret_cast<float*>(smem);        // own rows x width chunk
  float* Ls = Os + B_OWN * ld;                        // loop rows x width chunk
  float* Ss = Ls + B_LOOP * ld;                       // logits tile
  float* Ds = Ss + B_OWN * lds;                       // dl tile
  // per-row vectors of x's rows in this tile (own rows for dx, loop rows
  // for dW)
  constexpr int VR = ROWS_OWN ? B_OWN : B_LOOP;
  float* v_lse = Ds + B_OWN * ldd;
  float* v_c1 = v_lse + VR;
  float* v_c2 = v_c1 + VR;
  float* v_c3 = v_c2 + VR;
  int32_t* v_t = reinterpret_cast<int32_t*>(v_c3 + VR);

  const int64_t own0 = (int64_t)blockIdx.x * B_OWN;
  const int nchunks = (int)((E + B_WIDTH - 1) / B_WIDTH);
  const int mine = blockIdx.y;                       // this block's width chunk
  const int64_t e_mine = (int64_t)mine * B_WIDTH;
  const int w_mine = round16(min64(B_WIDTH, E - e_mine));

  auto load_vectors = [&](int64_t r0) {
    for (int i = threadIdx.x; i < VR; i += THREADS) {
      const int64_t n = r0 + i;
      const bool ok = n < N;
      v_lse[i] = ok ? lse[n] : 0.f;
      v_c1[i] = ok ? c1[n] : 0.f;
      v_c2[i] = ok ? c2[n] : 0.f;
      v_c3[i] = ok ? c3[n] : 0.f;
      v_t[i] = ok ? targets[n] : -1;
    }
  };
  if (ROWS_OWN) load_vectors(own0);
  if (nchunks == 1)
    stage<float>(Os, ld, own_src, n_own, E, own0, B_OWN, 0, w_mine, vec);

  // thread t owns columns t and t + 256 of the (32 x 512) output block
  float acc[2 * B_OWN];
#pragma unroll
  for (int i = 0; i < 2 * B_OWN; ++i) acc[i] = 0.f;

  TileFma<B_OWN, B_LOOP> tile;
  for (int64_t l0 = 0; l0 < n_loop; l0 += B_LOOP) {
    if (!ROWS_OWN) load_vectors(l0);
    tile.zero();
    // the block's own width chunk goes last, so Ls holds it afterwards
    for (int i = 1; i <= nchunks; ++i) {
      const int c = (mine + i) % nchunks;
      const int64_t e0 = (int64_t)c * B_WIDTH;
      const int width = round16(min64(B_WIDTH, E - e0));
      if (nchunks > 1) stage<float>(Os, ld, own_src, n_own, E, own0, B_OWN, e0, width, vec);
      stage<float>(Ls, ld, loop_src, n_loop, E, l0, B_LOOP, e0, width, vec);
      stage_wait();
      __syncthreads();
      tile.run(Os, ld, Ls, ld, width);
      if (i < nchunks) __syncthreads();
    }
    tile.store(Ss, lds);
    __syncthreads();
    for (int i = threadIdx.x; i < B_OWN * B_LOOP; i += THREADS) {
      const int r = i / B_LOOP, c = i % B_LOOP;
      const int64_t own = own0 + r, lp = l0 + c;
      const int64_t n = ROWS_OWN ? own : lp;
      const int64_t v = ROWS_OWN ? lp : own;
      const int vi = ROWS_OWN ? r : c;
      float d = 0.f;
      if (n < N && v < V) {
        d = v_c1[vi] * expf(Ss[r * lds + c] - v_lse[vi]);
        if (v == v_t[vi]) d -= v_c2[vi];
        d -= v_c3[vi];
      }
      Ds[r * ldd + c] = d;
    }
    __syncthreads();
    // out[own, e] += dl[own, loop] . loop_src[loop, e] over this width chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = threadIdx.x + h * THREADS;
      if (col < w_mine) {
        for (int k = 0; k < B_LOOP; ++k) {
          const float b = Ls[k * ld + col];
#pragma unroll
          for (int r = 0; r < B_OWN; ++r)
            acc[h * B_OWN + r] = fmaf(Ds[r * ldd + k], b, acc[h * B_OWN + r]);
        }
      }
    }
    __syncthreads();
  }

  // rows past n_own and columns past E are dropped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = threadIdx.x + h * THREADS;
    const int64_t e = e_mine + c;
    if (c >= w_mine || e >= E) continue;
#pragma unroll
    for (int r = 0; r < B_OWN; ++r) {
      const int64_t own = own0 + r;
      if (own < n_own) out[own * E + e] = acc[h * B_OWN + r];
    }
  }
}

// -- bfloat16: epilogues of the wgmma mainloop ----------------------------------------

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

// The forward's partial of one 128 x 256 logits tile (vocabulary columns from
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

  // row h's statistics of the thread's 64 columns, then of its quad's 256;
  // WHOLE: every column of the tile lies below V
  template <bool WHOLE>
  __device__ __forceinline__ float4 row_stats(const float (&d)[wgmma_gemm::ACC], int h, int c0,
                                              int t) const {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < wgmma_gemm::ACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (WHOLE || c0 + 8 * j + e < V) mx = fmaxf(mx, d[4 * j + 2 * h + e]);
    mx = quad_max(mx);
    const float shift = mx * LOG2E;
    float l = 0.f, tg = 0.f, sum = 0.f;
#pragma unroll
    for (int j = 0; j < wgmma_gemm::ACC / 4; ++j)
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

  __device__ __forceinline__ void operator()(const float (&d)[wgmma_gemm::ACC], int r0, int c0,
                                             const Rows& r) const {
    const int tile = c0 / wgmma_gemm::BN;
    const bool whole = (int64_t)(tile + 1) * wgmma_gemm::BN <= V;   // the same for the warp
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

// -- the bf16 backward's three epilogues --------------------------------------------

// (a) dl = f(x . W_c^T) in bf16 into the scratch (N, ld), columns of the chunk
// starting at vocabulary row v0; zero past V.
struct DlogitsEpilogue {
  const float* lse;
  const float* c1;
  const float* c2;
  const float* c3;
  const int32_t* targets;
  __nv_bfloat16* dl;
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

  __device__ __forceinline__ void operator()(const float (&d)[wgmma_gemm::ACC], int r0,
                                             int c0, const Rows& r) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      if (n >= N) continue;
      __nv_bfloat16* row = dl + n * ld;
#pragma unroll
      for (int j = 0; j < wgmma_gemm::ACC / 4; ++j) {
        const int col = c0 + 8 * j;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = 0.f;
          if (v0 + col + e < V) {
            v[e] = r.a1[h] * exp2_approx(fmaf(d[4 * j + 2 * h + e], LOG2E, -r.shift[h]));
            if (col + e == r.t[h]) v[e] -= r.a2[h];
            v[e] -= r.a3[h];
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
};

// (b) dW rows [v0, v0 + chunk) = dl_c^T . x, float32, rows past V dropped.
struct DwEpilogue {
  float* dw;
  int64_t E, V, v0;

  __device__ __forceinline__ wgmma_gemm::NoRows rows(int) const { return {}; }

  __device__ __forceinline__ void operator()(const float (&d)[wgmma_gemm::ACC], int r0,
                                             int c0, wgmma_gemm::NoRows) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t v = v0 + r0 + 8 * h;
      if (v >= V) continue;
      float* row = dw + v * E;
#pragma unroll
      for (int j = 0; j < wgmma_gemm::ACC / 4; ++j) {
        const int col = c0 + 8 * j;
        if (col < E)
          *reinterpret_cast<float2*>(row + col) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
};

// (c) dx (+)= dl_c . W_c: the first chunk writes the float32 accumulator,
// later ones add to it, the last writes dx in bf16 (a single chunk writes
// dx at once).
struct DxEpilogue {
  float* acc;
  __nv_bfloat16* dx;
  int64_t N, E;
  bool first, last;

  __device__ __forceinline__ wgmma_gemm::NoRows rows(int) const { return {}; }

  __device__ __forceinline__ void operator()(const float (&d)[wgmma_gemm::ACC], int r0,
                                             int c0, wgmma_gemm::NoRows) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = r0 + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < wgmma_gemm::ACC / 4; ++j) {
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

// -- launchers -------------------------------------------------------------------

template <typename T>
bool vectorizable(const void* a, const void* b, int64_t E) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b);
  return E % Cfg<T>::VEC == 0 && align % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // above 48 KB a kernel must opt in to dynamic shared memory
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_fwd_fma(const float* x, const float* w, const int32_t* targets, float* lse,
                           float* tgt, float* suml, int64_t N, int64_t E, int64_t V,
                           cudaStream_t stream) {
  const int kc = (int)min64(Cfg<float>::F_KC, round16(E));
  const int ld = kc + Cfg<float>::PAD;
  const size_t w_bytes = (size_t)F_COLS * ld * sizeof(float);
  const size_t s_bytes = (size_t)F_ROWS * (F_COLS + 4) * sizeof(float);
  const size_t bytes = (size_t)F_ROWS * ld * sizeof(float) +
                       (w_bytes > s_bytes ? w_bytes : s_bytes);
  cudaError_t err = allow_smem(fwd_fma_kernel<float>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + F_ROWS - 1) / F_ROWS));
  fwd_fma_kernel<float><<<grid, THREADS, bytes, stream>>>(x, w, targets, lse, tgt, suml, N, E, V,
                                                          vectorizable<float>(x, w, E));
  return cudaGetLastError();
}

// The bf16 forward: the partials of every logits tile into `part` (N x
// ceil(V / 256) float4), then their merge, both on `stream`.
cudaError_t launch_fwd_wgmma(const void* x, const void* w, const int32_t* targets, float* lse,
                             float* tgt, float* suml, void* part, int64_t N, int64_t E,
                             int64_t V, cudaStream_t stream) {
  using namespace wgmma_gemm;
  if (E % 8 || !part ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(part)) % 16))
    return cudaErrorInvalidValue;
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

template <bool ROWS_OWN>
cudaError_t launch_bwd_fma(const float* x, const float* w, const int32_t* targets,
                           const float* lse, const float* c1, const float* c2,
                           const float* c3, float* out, int64_t N, int64_t E,
                           int64_t V, cudaStream_t stream) {
  const int ld = B_WIDTH + Cfg<float>::PAD;
  constexpr int VR = ROWS_OWN ? B_OWN : B_LOOP;
  const size_t bytes = ((size_t)(B_OWN + B_LOOP) * ld + (size_t)B_OWN * (B_LOOP + 4) +
                        (size_t)B_OWN * (B_LOOP + Cfg<float>::PAD) + (size_t)VR * 4) *
                           sizeof(float) +
                       (size_t)VR * sizeof(int32_t);
  auto kernel = bwd_fma_kernel<ROWS_OWN>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_own = ROWS_OWN ? N : V;
  const dim3 grid((unsigned)((n_own + B_OWN - 1) / B_OWN),
                  (unsigned)((E + B_WIDTH - 1) / B_WIDTH));
  kernel<<<grid, THREADS, bytes, stream>>>(x, w, targets, lse, c1, c2, c3, out, N, E, V,
                                           vectorizable<float>(x, w, E));
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
  if (E % 8 || chunk % BN || (nchunks > 1 && !dx_acc) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(scratch)) % 16))
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
        DlogitsEpilogue{lse, c1, c2, c3, targets, dl, chunk, N, V, v0}, stream);
    if (err == cudaSuccess)
      err = gemm<true, true>(dl_mn, x_mn, Coords{0, 0}, cols, E, N,
                             DwEpilogue{dw, E, V, v0}, stream);
    if (err == cudaSuccess)
      err = gemm<false, true>(dl_k, w_mn, Coords{0, (int)v0}, N, E, cols,
                              DxEpilogue{dx_acc, static_cast<__nv_bfloat16*>(dx), N, E,
                                         c == 0, c == nchunks - 1},
                              stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool bad_sizes(int64_t N, int64_t E, int64_t V) {
  return N < 0 || E <= 0 || V <= 0 || (N + F_ROWS) / F_ROWS > 0x7fffffff ||
         (V + B_OWN) / B_OWN > 0x7fffffff;
}

}  // namespace fused_ce

using namespace fused_ce;

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (x and w). targets int32 (N,); lse, tgt,
// suml f32 (N,). bfloat16 takes the wgmma kernel and its merge: E a multiple
// of 8, x, w and part 16-byte aligned, part a scratch of N x ceil(V / 256)
// float4 partials. float32 takes the FMA kernel (no scratch). Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
int fused_ce_fwd(const void* x, const void* w, const int32_t* targets,
                 float* lse, float* tgt, float* suml, void* part, int64_t N,
                 int64_t E, int64_t V, int dtype, void* stream) {
  if (bad_sizes(N, E, V) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_wgmma(x, w, targets, lse, tgt, suml, part, N, E, V, s);
  return (int)launch_fwd_fma(static_cast<const float*>(x), static_cast<const float*>(w), targets,
                             lse, tgt, suml, N, E, V, s);
}

// The backward of one call: dx (N, E) in x's type and dw (V, E) in f32, every
// element written (the caller zeroes dw where N == 0: nothing is launched).
// bfloat16 takes the wgmma kernels: E a multiple of 8, chunk a multiple of
// 256, x, w and scratch 16-byte aligned; scratch holds (N, chunk) bf16 and,
// where V > chunk, dx_acc (N, E) f32. float32 takes the FMA kernels (no
// scratch).
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
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  cudaError_t err = launch_bwd_fma<true>(xf, wf, targets, lse, c1, c2, c3,
                                         static_cast<float*>(dx), N, E, V, s);
  if (err == cudaSuccess)
    err = launch_bwd_fma<false>(xf, wf, targets, lse, c1, c2, c3, dw, N, E, V, s);
  return (int)err;
}

const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
