// Fused cross-entropy over a vocabulary head: the forward statistics and the
// two gradients of
//
//     logits[n, v] = sum_e x[n, e] * w[v, e]          (fp32 accumulation)
//
// without the (N, V) logits ever reaching device memory.
//
//   fused_ce_fwd     lse[n] = logsumexp_v logits[n, v], tgt[n] = logits[n, t[n]],
//                    suml[n] = sum_v logits[n, v]                    (f32 out)
//   fused_ce_bwd_dx  dx[n, e] = sum_v dl[n, v] * w[v, e]         (x's type out)
//   fused_ce_bwd_dw  dw[v, e] = sum_n dl[n, v] * x[n, e]              (f32 out)
//
// with dl = c1[n] * exp(logits - lse[n]) - c2[n] * [v == t[n]] - c3[n] on valid
// (n < N, v < V) entries, rounded to x's type before the product, as the JAX
// kernels do (pasero_tpu/ops/fused_ce.py:115-120, :155, :187).
//
// Replaces the TPU kernels of pasero_tpu/ops/fused_ce.py: _fwd_kernel (called
// through _fwd, :199), _bwd_kernel (_bwd_matmuls, :234) and _bwd_dx_kernel /
// _bwd_dw_kernel (_bwd_split, :281). x is (N, E) and w is the head weight in
// its stored (V, E) row-major layout (the tied embedding table or the output
// projection's weight), so no transposed copy is made. The TPU's fused
// backward wrote per-row-block dW partials to save one logits recompute; here
// they would cost N/32 * E * V bytes (gigabytes at the full-width shape), so
// both TPU backwards become one design: a dx kernel and a dW kernel, each
// recomputing its logits tile, dW written once in f32 with no partials and no
// atomics (the same result on every run).
//
// What bounds it: operations. One logits product is 2*N*E*V flops: at
// N = 16384, E = 512, V = 32000 that is 536.9 GFLOP, 0.543 ms at 989 TFLOP/s
// (bf16 dense). The backward's function needs three (one recompute whose dl
// tile feeds both dx and dW, as the TPU's _bwd_kernel does), 1.63 ms; this
// design does four (a recompute in each kernel), the price of writing dW
// with no partials and no atomics. The bf16 weight (32.8 MB) and x (16.8 MB) are read from L2
// once per row (resp. vocabulary) tile.
//
// Design, kept simple and right first: 256 threads (8 warps in a 2 x 4 grid),
// bf16 operands staged in shared memory with 16-byte cp.async copies, all of
// a tile's in flight at once (zero-filled past the ragged row, vocabulary and
// width edges, so no padding copy is made), and multiplied on the tensor
// cores with WMMA (mma.sync, fp32 accumulation); fp32 x takes an FMA path of
// the same kernels. The forward tiles 64 rows x 128 vocabulary columns, keeps
// its x tile resident when E <= 512, writes each logits tile over the weight
// tile it came from, and keeps each thread's online max / sum-exp / target
// logit / logit sum in registers across the vocabulary loop, merging the
// four threads of a row by warp shuffles at the end. The backward tiles 32
// "own" rows (rows of x for dx, rows of w for dW) x 64 "loop" rows and keeps
// the (32 x 512) output block in registers, so E > 512 takes several blocks
// along the width, each recomputing the logits. What holds it back: no
// double-buffered pipeline (a tile's copies and its tensor-core work do not
// overlap), small WMMA tiles instead of wgmma, the backward's 32-row tiles
// (w, or x, is read from L2 once per 32 rows), and one forward block per SM
// (195 KB of shared memory). Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace fused_ce {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

// forward tile: 64 rows x 128 vocabulary columns, width chunks of KC
constexpr int F_ROWS = 64;
constexpr int F_COLS = 128;
// backward tile: 32 own rows x 64 loop rows; the output block is 32 x B_WIDTH
constexpr int B_OWN = 32;
constexpr int B_LOOP = 64;
constexpr int B_WIDTH = 512;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int PAD = 8;     // 16 bytes of row padding in shared memory
  static constexpr int VEC = 8;     // elements per 16-byte load
  static constexpr int F_KC = 512;  // forward width chunk
};
template <>
struct Cfg<float> {
  static constexpr int PAD = 4;
  static constexpr int VEC = 4;
  static constexpr int F_KC = 128;
};

__host__ __device__ inline int round16(int64_t x) {
  return (int)((x + 15) / 16 * 16);
}

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}


template <typename T>
__device__ inline T from_float(float v);
template <>
__device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ inline float from_float<float>(float v) { return v; }

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
      dst[r * ld + c] = (gr < nrows && gc < width) ? src[gr * width + gc]
                                                   : from_float<T>(0.f);
    }
  }
}

// S[OWN x LOOP] (+)= A[OWN x kdim] . B[LOOP x kdim]^T from shared memory,
// OWN = 32 * FM, LOOP = 64 * FN: warp (wr, wc) of the 2 x 4 grid holds the
// FM x FN 16 x 16 fragments at rows wr*16*FM, columns wc*16*FN.
template <int FM, int FN>
struct TileMma {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void run(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                      int ldb, int kdim) {
    const int warp = threadIdx.x / 32;
    const int wr = warp / 4, wc = warp % 4;
    for (int k = 0; k < kdim; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>
          b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], A + (wr * FM + i) * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], B + (wc * FN + j) * 16 * ldb + k, ldb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* S, int lds) {
    const int warp = threadIdx.x / 32;
    const int wr = warp / 4, wc = warp % 4;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(S + (wr * FM + i) * 16 * lds + (wc * FN + j) * 16,
                                acc[i][j], lds, wmma::mem_row_major);
  }
};

// The same product on the FMA units for fp32 operands: thread t owns the
// elements t, t + 256, ... of the row-major OWN x LOOP tile.
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

template <typename T, int OWN, int LOOP>
using Tile = typename std::conditional<std::is_same<T, float>::value,
                                       TileFma<OWN, LOOP>,
                                       TileMma<OWN / 32, LOOP / 64>>::type;

// -- forward -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
  Tile<T, F_ROWS, F_COLS> tile;
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

// -- backward ------------------------------------------------------------------

// ROWS_OWN: dx (own rows are rows of x, loop over the vocabulary);
// otherwise dW (own rows are rows of w, loop over the rows of x).
template <typename T, bool ROWS_OWN, typename OutT>
__global__ void __launch_bounds__(THREADS)
    bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int32_t* __restrict__ targets,
               const float* __restrict__ lse, const float* __restrict__ c1,
               const float* __restrict__ c2, const float* __restrict__ c3,
               OutT* __restrict__ out, int64_t N, int64_t E, int64_t V,
               bool vec) {
  constexpr int PAD = Cfg<T>::PAD;
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  const T* own_src = ROWS_OWN ? x : w;
  const T* loop_src = ROWS_OWN ? w : x;
  const int64_t n_own = ROWS_OWN ? N : V;
  const int64_t n_loop = ROWS_OWN ? V : N;

  const int ld = B_WIDTH + PAD;
  const int lds = B_LOOP + 4;
  const int ldd = B_LOOP + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Os = reinterpret_cast<T*>(smem);                 // own rows x width chunk
  T* Ls = Os + B_OWN * ld;                            // loop rows x width chunk
  float* Ss = reinterpret_cast<float*>(Ls + B_LOOP * ld);  // logits tile
  T* Ds = reinterpret_cast<T*>(Ss + B_OWN * lds);     // dl tile, x's type
  // per-row vectors of x's rows in this tile (own rows for dx, loop rows
  // for dW)
  constexpr int VR = ROWS_OWN ? B_OWN : B_LOOP;
  float* v_lse = reinterpret_cast<float*>(Ds + B_OWN * ldd);
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
    stage<T>(Os, ld, own_src, n_own, E, own0, B_OWN, 0, w_mine, vec);

  // the (32 x 512) output block: warp wp holds columns [64 wp, 64 wp + 64)
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  float facc[MMA ? 1 : 2 * B_OWN];
  if constexpr (MMA) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 2 * B_OWN; ++i) facc[i] = 0.f;
  }

  Tile<T, B_OWN, B_LOOP> tile;
  for (int64_t l0 = 0; l0 < n_loop; l0 += B_LOOP) {
    if (!ROWS_OWN) load_vectors(l0);
    tile.zero();
    // the block's own width chunk goes last, so Ls holds it afterwards
    for (int i = 1; i <= nchunks; ++i) {
      const int c = (mine + i) % nchunks;
      const int64_t e0 = (int64_t)c * B_WIDTH;
      const int width = round16(min64(B_WIDTH, E - e0));
      if (nchunks > 1) stage<T>(Os, ld, own_src, n_own, E, own0, B_OWN, e0, width, vec);
      stage<T>(Ls, ld, loop_src, n_loop, E, l0, B_LOOP, e0, width, vec);
      stage_wait();
      __syncthreads();
      tile.run(Os, ld, Ls, ld, width);
      if (i < nchunks) __syncthreads();
    }
    tile.store(Ss, lds);
    __syncthreads();
    // dl, rounded to x's type
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
      Ds[r * ldd + c] = from_float<T>(d);
    }
    __syncthreads();
    // out[own, e] += dl[own, loop] . loop_src[loop, e] over this width chunk
    if constexpr (MMA) {
      for (int k = 0; k < B_LOOP; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
            a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Ds + i * 16 * ldd + k, ldd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = warp * 64 + j * 16;
          if (col < w_mine) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                b;
            wmma::load_matrix_sync(b, Ls + k * ld + col, ld);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
          }
        }
      }
    } else {
      // thread t owns columns t and t + 256 of the output block
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = threadIdx.x + h * THREADS;
        if (col < w_mine) {
          for (int k = 0; k < B_LOOP; ++k) {
            const float b = Ls[k * ld + col];
#pragma unroll
            for (int r = 0; r < B_OWN; ++r)
              facc[h * B_OWN + r] = fmaf(Ds[r * ldd + k], b,
                                         facc[h * B_OWN + r]);
          }
        }
      }
    }
    __syncthreads();
  }

  // write the output block in out's type; rows past n_own and columns past
  // E are dropped
  if constexpr (MMA) {
    float* Cs = reinterpret_cast<float*>(Ls);   // 32 x (512 + 4) f32 fits in Ls
    const int ldc = B_WIDTH + 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + i * 16 * ldc + warp * 64 + j * 16,
                                acc[i][j], ldc, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < B_OWN * B_WIDTH; i += THREADS) {
      const int r = i / B_WIDTH, c = i % B_WIDTH;
      const int64_t own = own0 + r, e = e_mine + c;
      if (own < n_own && c < w_mine && e < E)
        out[own * E + e] = from_float<OutT>(Cs[r * ldc + c]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = threadIdx.x + h * THREADS;
      const int64_t e = e_mine + c;
      if (c >= w_mine || e >= E) continue;
#pragma unroll
      for (int r = 0; r < B_OWN; ++r) {
        const int64_t own = own0 + r;
        if (own < n_own) out[own * E + e] = from_float<OutT>(facc[h * B_OWN + r]);
      }
    }
  }
}

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

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int32_t* targets,
                       float* lse, float* tgt, float* suml, int64_t N,
                       int64_t E, int64_t V, cudaStream_t stream) {
  const int kc = (int)min64(Cfg<T>::F_KC, round16(E));
  const int ld = kc + Cfg<T>::PAD;
  const size_t w_bytes = (size_t)F_COLS * ld * sizeof(T);
  const size_t s_bytes = (size_t)F_ROWS * (F_COLS + 4) * sizeof(float);
  const size_t bytes = (size_t)F_ROWS * ld * sizeof(T) +
                       (w_bytes > s_bytes ? w_bytes : s_bytes);
  cudaError_t err = allow_smem(fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + F_ROWS - 1) / F_ROWS));
  fwd_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, lse, tgt,
      suml, N, E, V, vectorizable<T>(x, w, E));
  return cudaGetLastError();
}

template <typename T, bool ROWS_OWN, typename OutT>
cudaError_t launch_bwd(const void* x, const void* w, const int32_t* targets,
                       const float* lse, const float* c1, const float* c2,
                       const float* c3, void* out, int64_t N, int64_t E,
                       int64_t V, cudaStream_t stream) {
  const int ld = B_WIDTH + Cfg<T>::PAD;
  constexpr int VR = ROWS_OWN ? B_OWN : B_LOOP;
  const size_t bytes = (size_t)(B_OWN + B_LOOP) * ld * sizeof(T) +
                       (size_t)B_OWN * (B_LOOP + 4) * sizeof(float) +
                       (size_t)B_OWN * (B_LOOP + Cfg<T>::PAD) * sizeof(T) +
                       (size_t)VR * (4 * sizeof(float) + sizeof(int32_t));
  auto kernel = bwd_kernel<T, ROWS_OWN, OutT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int64_t n_own = ROWS_OWN ? N : V;
  const dim3 grid((unsigned)((n_own + B_OWN - 1) / B_OWN),
                  (unsigned)((E + B_WIDTH - 1) / B_WIDTH));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, lse, c1, c2,
      c3, static_cast<OutT*>(out), N, E, V, vectorizable<T>(x, w, E));
  return cudaGetLastError();
}

bool bad_sizes(int64_t N, int64_t E, int64_t V) {
  return N < 0 || E <= 0 || V <= 0 || (N + F_ROWS) / F_ROWS > 0x7fffffff ||
         (V + B_OWN) / B_OWN > 0x7fffffff;
}

}  // namespace fused_ce

using namespace fused_ce;

extern "C" {

// dtype: 0 = bfloat16, 1 = float32 (x and w). targets int32 (N,); lse, tgt,
// suml f32 (N,). Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for arguments the kernels do not take.
int fused_ce_fwd(const void* x, const void* w, const int32_t* targets,
                 float* lse, float* tgt, float* suml, int64_t N, int64_t E,
                 int64_t V, int dtype, void* stream) {
  if (bad_sizes(N, E, V) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<__nv_bfloat16>(x, w, targets, lse, tgt, suml, N, E, V, s);
  return (int)launch_fwd<float>(x, w, targets, lse, tgt, suml, N, E, V, s);
}

// dx (N, E) in x's type.
int fused_ce_bwd_dx(const void* x, const void* w, const int32_t* targets,
                    const float* lse, const float* c1, const float* c2,
                    const float* c3, void* dx, int64_t N, int64_t E, int64_t V,
                    int dtype, void* stream) {
  if (bad_sizes(N, E, V) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<__nv_bfloat16, true, __nv_bfloat16>(
        x, w, targets, lse, c1, c2, c3, dx, N, E, V, s);
  return (int)launch_bwd<float, true, float>(x, w, targets, lse, c1, c2, c3,
                                             dx, N, E, V, s);
}

// dw (V, E) in f32, every element written (zero where N == 0 is left to the
// caller: with no rows the kernel is not launched).
int fused_ce_bwd_dw(const void* x, const void* w, const int32_t* targets,
                    const float* lse, const float* c1, const float* c2,
                    const float* c3, float* dw, int64_t N, int64_t E, int64_t V,
                    int dtype, void* stream) {
  if (bad_sizes(N, E, V) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<__nv_bfloat16, false, float>(
        x, w, targets, lse, c1, c2, c3, dw, N, E, V, s);
  return (int)launch_bwd<float, false, float>(x, w, targets, lse, c1, c2, c3,
                                              dw, N, E, V, s);
}

const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
