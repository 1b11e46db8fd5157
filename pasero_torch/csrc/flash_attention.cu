// The backward's gradient of flash attention's dense additive bias (dbias),
// for grouped K/V heads, from the scores
//
//   s[i, j]  = scale * sum_d q[b, h, i, d] * k[b, h / G, j, d]     (fp32)
//              + bias[b, h, i, j]                               (float32)
//   p[i, j]  = exp(s[i, j] - lse[i]) where key j is visible from row i, else 0
//
// with G = H / Hkv query heads per K/V head. Key j is visible from row i when
// kv_mask[b, j] is set, j <= i (causal, slot indices) and i - j < window (a
// sliding window), as pasero_tpu/ops/flash_attention.py applies them. It
// takes dO, the forward's lse and delta = sum_d dO[i, d] * out[i, d] (both
// written by flash_bwd.cu's forward and dq kernels of the same bias):
//
//   dS[i, j] = p[i, j] * (dO[i] . v[j] - delta[i])
//   dbias[i, j] = dS[i, j], unrounded fp32, 0 where key j is not visible
//
// The forward and dq and dk/dv of every bias kind are flash_bwd.cu's wgmma
// kernels, and so is the T5 table's gradient (demb), which the T5 dq kernel
// sums from its own dS; the float32 kernels of every kind are flash_f32.cu's.
//
// The bias is (b0 h0, Sq, Sk) rows with b0 in {1, B} and h0 in {1, H}; the
// row of (b, h) is b bs + h hs (bias_row), so a shared bias is never
// broadcast in memory. It is added to the scaled score in fp32, and p is
// taken in natural units against the forward's natural-unit lse: a score
// near the encoder ALiBi's -1e9 has an ulp of 64 there, so a change of base
// before the subtraction would lose it.
//
// The kernel and the TPU kernel it replaces:
//   dbias_kernel   _dbias_kernel (:1160, through _compute_dbias, :1213): one
//                  block per (64-row query tile, output row); a bias shared
//                  over the batch is summed over it inside the block, batch
//                  by batch, so the sum is deterministic without atomics.
//
// What bounds it: operations, and with a per-sample bias bytes. It
// recomputes two products (QK^T, dO V^T): at B = 4, H = 16, S = 2048, D = 64
// causal 34.4 GFLOP, 0.0348 ms at 989 TFLOP/s (bf16 dense); with a
// per-sample bias its visible causal half is 537 MB (0.160 ms at 3.35 TB/s)
// and dbias writes 1.07 GB; the bias tiles ride the K/V tiles' cp.async
// stages, so their reads overlap the products.
//
// Design, kept simple and right first: 128 threads (4 warps) per block, each
// warp owning 16 rows of a 64-row tile; bf16 operands staged in shared
// memory with 16-byte cp.async copies (rows padded by 16 bytes, so ldmatrix
// reads are free of bank conflicts), the next K/V tile's copies in flight
// while the tensor cores work on this one (two stages); products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulation). The
// score tiles of a warp stay in registers. Causal key tiles past the
// diagonal, and tiles below a sliding window, are skipped (written as zeros
// once); ragged edges are zero-filled by the copies and masked. What holds
// it back: mma.sync instead of wgmma, 64-row tiles whose K/V are read from
// L2 once per query tile and head, two pipeline stages; flash_bwd.cu's
// kernels show the wgmma design it would take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;  // 4 warps
constexpr int BM = 64;        // rows of a block's own tile, 16 per warp
constexpr int BN = 64;        // columns of the tile it loops over
constexpr float LOG2E = 1.4426950408889634f;
// leading dimension of the float32 bias tiles in shared memory, a (query,
// key) tile read as float2 pairs along a score row (rows 8 banks apart),
// 16-byte rows
constexpr int LDB = BN + 8;

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; valid = false
// writes zeros and reads nothing.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, for float32 rows that are not 16-byte aligned.
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + R) of a row-major (nrows, D) matrix into shared memory with
// leading dimension D + 8, zeros past nrows. Issues cp.async copies only; the
// caller commits and waits.
template <int D, int R>
__device__ inline void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                 int nrows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * (D + 8) + c, ok ? src + (int64_t)(r0 + r) * D + c : src, ok);
  }
}

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a row-major (nrows, ncols)
// float32 bias into shared memory with leading dimension LDS, zeros outside.
// vec (ncols % 4 == 0): 16-byte copies, each chunk whole and aligned; else
// 4-byte copies. Issues cp.async copies only; the caller commits and waits.
template <int R, int C, int LDS>
__device__ inline void load_bias_tile(float* dst, const float* __restrict__ src, int r0,
                                      int c0, int nrows, int ncols, bool vec) {
  if (vec) {
    constexpr int CH = C / 4;
    for (int i = threadIdx.x; i < R * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async16(dst + r * LDS + c, ok ? src + (int64_t)(r0 + r) * ncols + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async4(dst + r * LDS + c, ok ? src + (int64_t)(r0 + r) * ncols + c0 + c : src, ok);
    }
  }
}

// The bias row of (batch b, query head h): the bias is (b0 h0, Sq, Sk) with
// row strides bs (0 when b0 = 1, else h0) and hs (0 when h0 = 1, else 1).
__device__ inline const float* bias_row(const float* bias, int b, int h, int bs, int hs,
                                        int Sq, int Sk) {
  return bias + ((int64_t)b * bs + (int64_t)h * hs) * Sq * Sk;
}

// s[16 x 8 NT] = A[16 x D] . B[8 NT x D]^T for one warp: A's 16 rows and B's
// rows in shared memory (leading dimension D + 8). s is in the mma
// accumulator layout: s[j][0..1] at row lane / 4, columns 8 j + 2 (lane % 4)
// + {0, 1}; s[j][2..3] the same columns at row lane / 4 + 8.
template <int D, int NT>
__device__ inline void warp_abt(float (&s)[NT][4], const bf16* A, const bf16* B,
                                int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Is key `col` visible from query row `row`?
__device__ inline bool visible(int row, int col, int Sk, const uint8_t* __restrict__ mask,
                               int causal, int window) {
  bool ok = col < Sk && mask[col];
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

// -- backward: dbias -------------------------------------------------------------

// dbias = dS = P (dP - delta) in float32, unrounded, zero where a key is not
// visible, written at the (query tile x key tile) it was computed for. One
// block per (64-row query tile, output row): output row (b, h) for a
// per-sample bias; row h with the batch summed inside the block when the
// bias is shared over the batch (batch_sum), the batches in order, so the
// sum is deterministic without atomics. Key tiles that causality or the
// window skip are written as zeros once.
template <int D>
__global__ void __launch_bounds__(THREADS)
    dbias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 const float* __restrict__ bias, int bias_bs, int bias_hs,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dbias, int B, int H,
                 int Hkv, int Sq, int Sk, float scale, int causal, int window,
                 int batch_sum) {
  constexpr int LD = D + 8;
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;      // [2][BN][LD]
  bf16* Vs = Ks + 2 * BN * LD;   // [2][BN][LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BN * LD);   // [2][BM][LDB]

  const int q0 = blockIdx.x * BM;
  const int h = batch_sum ? blockIdx.y : blockIdx.y % H;
  const int b_begin = batch_sum ? 0 : blockIdx.y / H;
  const int b_end = batch_sum ? B : b_begin + 1;
  const int hk = h / (H / Hkv);
  float* og = dbias + (int64_t)blockIdx.y * Sq * Sk;
  const bool bvec = Sk % 4 == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int tcol = 2 * (lane % 4);

  const int nkt = (Sk + BN - 1) / BN;
  int kt0 = 0, kt1 = nkt;
  if (causal) kt1 = min(kt1, (q0 + BM - 1) / BN + 1);
  if (window > 0) kt0 = max(0, (q0 - window + 1) / BN);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt >= kt0 && kt < kt1) continue;
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int row = q0 + i / BN, col = kt * BN + i % BN;
      if (row < Sq && col < Sk) og[(int64_t)row * Sk + col] = 0.f;
    }
  }

  for (int b = b_begin; b < b_end; ++b) {
    const int bh = b * H + h;
    const int64_t q_off = (int64_t)bh * Sq * D;
    const int64_t kv_off = ((int64_t)b * Hkv + hk) * Sk * D;
    const bf16* kg = k + kv_off;
    const bf16* vg = v + kv_off;
    const uint8_t* mg = kv_mask + (int64_t)b * Sk;
    const float* bg = bias_row(bias, b, h, bias_bs, bias_hs, Sq, Sk);
    auto load_kv = [&](int kt, int stage) {
      load_tile<D, BN>(Ks + stage * BN * LD, kg, kt * BN, Sk);
      load_tile<D, BN>(Vs + stage * BN * LD, vg, kt * BN, Sk);
      load_bias_tile<BM, BN, LDB>(Bs + stage * BM * LDB, bg, q0, kt * BN, Sq, Sk, bvec);
    };
    load_tile<D, BM>(Qs, q + q_off, q0, Sq);
    load_tile<D, BM>(dOs, dout + q_off, q0, Sq);
    if (kt0 < kt1) load_kv(kt0, 0);
    cp_async_commit();

    float lse_r[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      lse_r[r] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
      dl[r] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
    }

    for (int kt = kt0; kt < kt1; ++kt) {
      const int st = (kt - kt0) & 1;
      if (kt + 1 < kt1) {
        load_kv(kt + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      const float* Bt = Bs + st * BM * LDB + (warp * 16 + lane / 4) * LDB + tcol;
      float s[NT][4], dp[NT][4];
      warp_abt<D, NT>(s, Qs + warp * 16 * LD, Ks + st * BN * LD, lane);
      warp_abt<D, NT>(dp, dOs + warp * 16 * LD, Vs + st * BN * LD, lane);
      const int k0 = kt * BN;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = row0 + r * 8, col = k0 + j * 8 + tcol + (e & 1);
          if (row >= Sq || col >= Sk) continue;
          float ds = 0.f;
          if (visible(row, col, Sk, mg, causal, window))
            ds = exp2f((s[j][e] * scale + Bt[r * 8 * LDB + j * 8 + (e & 1)] - lse_r[r]) *
                       LOG2E) *
                 (dp[j][e] - dl[r]);
          float* g = og + (int64_t)row * Sk + col;
          *g = b == b_begin ? ds : *g + ds;
        }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

// -- launchers -----------------------------------------------------------------

// Above 48 KB a kernel must opt in to dynamic shared memory; done on the
// first launch of each kernel only, so later launches (and CUDA graph
// captures) make no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

bool bad_args(int B, int H, int Hkv, int Sq, int Sk, int D, int window) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
         (D != 32 && D != 64 && D != 128) || window < 0 || (int64_t)B * H > 65535;
}

// Shared memory of a dense bias: two stages of float32 bias tiles (BM rows
// of LDB).
constexpr size_t BIAS_SMEM = (size_t)2 * BM * LDB * sizeof(float);

template <int D>
cudaError_t launch_dbias(const void* q, const void* k, const void* v, const uint8_t* mask,
                         const float* bias, int bs, int hs, const void* dout,
                         const float* lse, const float* delta, float* dbias, int B, int H,
                         int Hkv, int Sq, int Sk, float scale, int causal, int window,
                         cudaStream_t stream) {
  const size_t bytes = (size_t)(2 * BM + 4 * BN) * (D + 8) * sizeof(bf16) + BIAS_SMEM;
  static bool done = false;
  cudaError_t err = allow_smem(dbias_kernel<D>, bytes, done);
  if (err != cudaSuccess) return err;
  // a bias shared over the batch (bs == 0) has one output row per head
  const int batch_sum = bs == 0;
  const dim3 grid((Sq + BM - 1) / BM, batch_sum ? H : B * H);
  dbias_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, bias, bs, hs, static_cast<const bf16*>(dout),
      lse, delta, dbias, B, H, Hkv, Sq, Sk, scale, causal, window, batch_sum);
  return cudaGetLastError();
}

}  // namespace flash

using namespace flash;

extern "C" {

// q, dout (B, H, Sq, D), k/v (B, Hkv, Sk, D): bfloat16, contiguous,
// 16-byte aligned; kv_mask (B, Sk) uint8 (1 = key present); lse and delta
// (B, H, Sq) f32 from the forward and the dq kernel of the same bias
// (flash_bwd.cu). D is 32, 64 or 128; window 0 means none. Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernels do not take.
//
// bias is a float32 bias (b0 h0, Sq, Sk), contiguous and 16-byte aligned,
// with b0 in {1, B} and h0 in {1, H}, and the row strides bs (0 when b0 = 1,
// else h0) and hs (0 when h0 = 1, else 1): the row of (b, h) is b bs + h hs.
//
// dbias f32: (H, Sq, Sk) summed over the batch when bs == 0 (a bias shared
// over the batch), else (B, H, Sq, Sk); per query head either way (the
// caller sums over the heads for h0 = 1). bias must not be nullptr.
int flash_bwd_dbias(const void* q, const void* k, const void* v, const uint8_t* kv_mask,
                    const float* bias, int bs, int hs, const void* dout, const float* lse,
                    const float* delta, float* dbias, int B, int H, int Hkv, int Sq,
                    int Sk, int D, float scale, int causal, int window, void* stream) {
  if (bad_args(B, H, Hkv, Sq, Sk, D, window) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                      \
  q, k, v, kv_mask, bias, bs, hs, dout, lse, delta, dbias, B, H, Hkv, Sq, Sk, scale, \
      causal, window, s
  return (int)(D == 32   ? launch_dbias<32>(ARGS)
               : D == 64 ? launch_dbias<64>(ARGS)
                         : launch_dbias<128>(ARGS));
#undef ARGS
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
