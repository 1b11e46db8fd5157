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
// ds.astype(k.dtype) (:899, :998) change nothing. The products are float32
// FMAs on the CUDA cores, not TF32 (which keeps about three decimal digits),
// and the max and lse are kept in natural units for every bias kind, as the
// biased kernels keep them (the encoder ALiBi's -1e9 survives).
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
// What bounds them: operations at the card's float32 rate outside the tensor
// cores (67 TFLOP/s). One causal product at (2, 8, 2048, 64) is 2 B H S^2 D /
// 2 = 4.3 GFLOP, 0.064 ms; the forward does two, dq three, dk/dv four.
//
// Design, simple and right first: 256 threads (a 16 x 16 grid) per block,
// one block per 64-row tile (query rows for the forward, dq, dbias and demb;
// keys for dk/dv, which loop over the group's query heads and their query
// tiles). The block's own rows stay in shared memory; the streamed tiles (K
// and V, or Q and dO) are staged by 16-byte cp.async, double-buffered, the
// next tile's copies in flight while this one is used; rows are padded by 16
// bytes, so a warp's float4 reads down the rows are free of bank conflicts.
// Thread (ty, tx) holds the scores of rows ty + 16 i and columns tx + 16 j
// (i, j < 4) in registers, each a float32 FMA chain over d in order; the
// online softmax runs there (a row's 64 scores lie in 16 neighbouring lanes).
// P or dS goes through shared memory once per tile for the next product. A
// dense bias is read straight from device memory, a row's keys by
// neighbouring lanes; T5's table column is staged once per block and the
// tile's bias written by diagonal (64 + 64 - 1 values). No atomics: dbias
// sums a bias shared over the batch inside the block, batch by batch, and
// demb writes a row of partial sums per (batch, head, query tile) for the
// wrapper to sum, so the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace flash_f32 {

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

// The transposed product: o[i][c] += sum_k P[k][ty + 16 i] M[k][tx + 16 c]
// (dk, dv: the tile's columns are the block's keys, its rows the queries).
template <int D>
__device__ __forceinline__ void tile_ptm(float (&o)[4][D / 16], const float* P, const float* M,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[k * LDP + ty + 16 * i];
    const float* m = M + k * LD + tx;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float mv = m[16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], mv, o[i][c]);
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

// The key tiles [kt0, kt1) that the 64 queries from q0 can see.
__device__ __forceinline__ void key_tiles(int q0, int Sk, int causal, int window, int& kt0,
                                          int& kt1) {
  kt0 = 0;
  kt1 = (Sk + TILE - 1) / TILE;
  if (causal) kt1 = min(kt1, (q0 + TILE - 1) / TILE + 1);
  if (window > 0) kt0 = max(0, (q0 - window + 1) / TILE);
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
  key_tiles(q0, Sk, causal, window, kt0, kt1);

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

// -- dq (and delta) ------------------------------------------------------------------

// Block (query tile, b H + h): Q and dO resident, K and V streamed; delta of
// its rows written for dk/dv, dbias and demb.
template <int KIND, int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
              const float* __restrict__ out, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
              int H, int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + TF;
  float* Ks = dOs + TF;        // [2][TF]
  float* Vs = Ks + 2 * TF;     // [2][TF]
  float* Ss = Vs + 2 * TF;     // [TILE][LDP] dS
  float* Bd = Ss + TILE * LDP; // [2 TILE] T5
  float* col = Bd + 2 * TILE;  // [nb] T5

  const int q0 = blockIdx.x * TILE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int64_t q_off = (int64_t)bh * Sq * D;
  const int64_t kv_off = ((int64_t)b * Hkv + h / (H / Hkv)) * Sk * D;
  const float* kg = k + kv_off;
  const float* vg = v + kv_off;
  const uint8_t* mg = kv_mask + (int64_t)b * Sk;
  const float* bg = KIND == DENSE_BIAS ? bias_rows(bias, b, h, Sq) : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int kt0, kt1;
  key_tiles(q0, Sk, causal, window, kt0, kt1);

  load_rows<D>(Qs, q + q_off, q0, Sq);
  load_rows<D>(dOs, dout + q_off, q0, Sq);
  if (kt0 < kt1) {
    load_rows<D>(Ks, kg, kt0 * TILE, Sk);
    load_rows<D>(Vs, vg, kt0 * TILE, Sk);
  }
  cp_async_commit();
  if constexpr (KIND == T5_BIAS)
    for (int c = threadIdx.x; c < bias.nb; c += THREADS) col[c] = bias.table[c * H + h];

  // delta and lse of the thread's rows
  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < Sq)
      for (int d = tx; d < D; d += 16)
        acc = fmaf(dout[q_off + (int64_t)row * D + d], out[q_off + (int64_t)row * D + d], acc);
    dl[i] = row_sum(acc);
    ls[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    if (tx == 0 && row < Sq) delta[(int64_t)bh * Sq + row] = dl[i];
  }

  float dqa[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[i][c] = 0.f;

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
      __syncthreads();
      t5_diagonals(Bd, nullptr, col, bias.index, q0, k0, Sq, Sk);
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
        float ds = 0.f;
        if (visible(row, key, Sq, Sk, mg, causal, window)) {
          float t = s[i][j] * scale;
          if constexpr (KIND != NO_BIAS) t += bias_at<KIND>(bg, Bd, row, key, q0, k0, bias.ld);
          ds = expf(t - ls[i]) * (dp[i][j] - dl[i]);
        }
        Ss[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_pm<D>(dqa, Ss, Ks + st * TF, ty, tx);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    float* g = dq + q_off + (int64_t)row * D + tx;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) g[16 * c] = dqa[i][c] * scale;
  }
}

// -- dk, dv ---------------------------------------------------------------------

// Block (key tile, b Hkv + hk): K and V resident; the Q and dO tiles of the
// group's query heads streamed, head by head, the query tiles the keys are
// visible from in order. The scores keep queries as rows and the block's
// keys as columns (a dense bias is read along its rows); P and then dS go
// through one shared tile to the transposed products.
template <int KIND, int D>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask, const Bias bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               int H, int Hkv, int Sq, int Sk, float scale, int causal, int window) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TF;
  float* Qs = Vs + TF;         // [2][TF]
  float* dOs = Qs + 2 * TF;    // [2][TF]
  float* Ts = dOs + 2 * TF;    // [TILE][LDP] P, then dS
  float* Bd = Ts + TILE * LDP; // [2 TILE] T5
  float* cols = Bd + 2 * TILE; // [G nb] T5: the group's table columns

  const int j0 = blockIdx.x * TILE;
  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int group = H / Hkv;
  const uint8_t* mg = kv_mask + (int64_t)b * Sk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int it0 = causal ? j0 / TILE : 0;
  int it1 = (Sq + TILE - 1) / TILE;
  if (window > 0) it1 = min(it1, (j0 + TILE + window - 2) / TILE + 1);
  const int ntiles = max(0, it1 - it0), iters = group * ntiles;

  load_rows<D>(Ks, k + (int64_t)bk * Sk * D, j0, Sk);
  load_rows<D>(Vs, v + (int64_t)bk * Sk * D, j0, Sk);
  // inner tile n: query head hk G + n / ntiles, query tile it0 + n % ntiles
  auto load_q = [&](int n, int st) {
    const int64_t off = ((int64_t)b * H + hk * group + n / ntiles) * Sq * D;
    const int i0 = (it0 + n % ntiles) * TILE;
    load_rows<D>(Qs + st * TF, q + off, i0, Sq);
    load_rows<D>(dOs + st * TF, dout + off, i0, Sq);
  };
  if (iters > 0) load_q(0, 0);
  cp_async_commit();
  if constexpr (KIND == T5_BIAS)
    for (int c = threadIdx.x; c < group * bias.nb; c += THREADS)
      cols[c] = bias.table[(c % bias.nb) * H + hk * group + c / bias.nb];

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int n = 0; n < iters; ++n) {
    const int st = n & 1, hh = hk * group + n / ntiles, i0 = (it0 + n % ntiles) * TILE;
    const int bh = b * H + hh;
    if (n + 1 < iters) {
      load_q(n + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (KIND == T5_BIAS) {
      __syncthreads();
      t5_diagonals(Bd, nullptr, cols + (n / ntiles) * bias.nb, bias.index, i0, j0, Sq, Sk);
    }
    __syncthreads();

    const float* bg = KIND == DENSE_BIAS ? bias_rows(bias, b, hh, Sq) : nullptr;
    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs + st * TF, Ks, ty, tx);
    tile_dot<D>(dp, dOs + st * TF, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * i;
      const float ls = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
      const float dl = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + tx + 16 * j;
        float p = 0.f;
        if (visible(row, key, Sq, Sk, mg, causal, window)) {
          float t = s[i][j] * scale;
          if constexpr (KIND != NO_BIAS) t += bias_at<KIND>(bg, Bd, row, key, i0, j0, bias.ld);
          p = expf(t - ls);
        }
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl);
        Ts[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    tile_ptm<D>(dva, Ts, dOs + st * TF, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ts[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    tile_ptm<D>(dka, Ts, Qs + st * TF, ty, tx);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = j0 + ty + 16 * i;
    if (key >= Sk) continue;
    float* gk = dk + ((int64_t)bk * Sk + key) * D + tx;
    float* gv = dv + ((int64_t)bk * Sk + key) * D + tx;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      gk[16 * c] = dka[i][c] * scale;
      gv[16 * c] = dva[i][c];
    }
  }
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
  key_tiles(q0, Sk, causal, window, kt0, kt1);
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
// tile) nb + n], as flash_attention.cu's demb_kernel does.
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
  key_tiles(q0, Sk, causal, window, kt0, kt1);

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
  const size_t bytes = smem_bytes<D>(6, 1, KIND, 1, bias.nb);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dq_kernel<KIND, D>, bytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  dq_kernel<KIND, D><<<grid, THREADS, bytes, stream>>>(q, k, v, mask, bias, out, dout, lse, delta,
                                                       dq, H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int KIND, int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const uint8_t* mask,
                       const Bias& bias, const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int B, int H, int Hkv, int Sq, int Sk, float scale,
                       int causal, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(6, 1, KIND, H / Hkv, bias.nb);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(dkv_kernel<KIND, D>, bytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + TILE - 1) / TILE, B * Hkv);
  dkv_kernel<KIND, D><<<grid, THREADS, bytes, stream>>>(q, k, v, mask, bias, dout, lse, delta, dk,
                                                        dv, H, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
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
