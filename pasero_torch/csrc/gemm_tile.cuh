// One tile of x . W^T on the tensor cores, shared by int8_matmul.cu and
// fused_head.cu: x (M, K) bfloat16 and a weight W (N, K) stored either as
// int8 (converted to bfloat16 on the chip, exactly) or as bfloat16, both
// row-major, so W's rows are the output columns. A block of 128 threads
// computes the (BM, BN) tile of float32 sums at rows m0.. and columns n0..
// and leaves it in shared memory; the caller's epilogue reads it from there.
//
// Mainloop: tiles of BK columns of x and W staged in shared memory by
// 16-byte cp.async copies, STAGES deep, so the next tiles' copies are in
// flight while the tensor cores work on this one; mma.sync m16n8k16 (bf16 in,
// fp32 accumulation). Rows past M or N and columns past K are zero-filled by
// the copies (no memory traffic), so a ragged edge needs no padded copy in
// device memory; K must be a multiple of 16. The warps split the tile WM x WN
// and the BK columns of a stage WK ways; with WK > 1 (small M: a 16-row tile
// and four warps that each sum a quarter of K) the epilogue adds the WK
// partial sums.
//
// Within each 16-wide k step the k index is permuted, the same way for x and
// W (a product's sum does not depend on the order of its terms): lane t of a
// quad holds the four consecutive columns 4t..4t+3 in the operand slots that
// mma assigns to k = 2t, 2t+1, 2t+8, 2t+9. So a lane reads 4 int8 weights as
// one 32-bit word (4 bf16 as one 64-bit word), and x as one 64-bit word.
// Shared-memory rows are padded (16 elements) so these reads are free of
// bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_tile {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int STAGES = 3;
constexpr int PAD = 16;   // elements of padding per shared-memory row

template <int BM_, int BN_, int BK_, int WM_, int WN_, int WK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_, WK = WK_;
  static constexpr int MT = BM / WM / 16;   // m16 tiles per warp
  static constexpr int NT = BN / WN / 8;    // n8 tiles per warp
  static constexpr int KS = BK / WK / 16;   // k16 steps per warp and stage
  static constexpr int RED_LD = BN + 4;     // row length of the sums in smem
  static_assert(WM * WN * WK * 32 == THREADS, "four warps");
  static_assert(MT >= 1 && NT >= 1 && KS >= 1, "tile too small");
};

// M up to 80 rows (decode, speculative chunks): 16-row tiles, 32 columns,
// the warps splitting K. Larger M (prompts): 64 x 128 tiles, 2 x 2 warps.
typedef Tile<16, 32, 256, 1, 1, 4> Small;
typedef Tile<64, 128, 64, 2, 2, 1> Large;
constexpr int SMALL_MAX_M = 80;

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid = false writes zeros and reads nothing.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The weight's element type: how many per 16-byte copy, and the operand
// fragment of one lane (4 consecutive k at `p`).
struct Int8W {
  typedef int8_t T;
  static constexpr int PER_COPY = 16;
  __device__ static inline void frag(const T* p, uint32_t& b0, uint32_t& b1) {
    int8x4_to_bf16x4(*reinterpret_cast<const uint32_t*>(p), b0, b1);
  }
};
struct Bf16W {
  typedef bf16 T;
  static constexpr int PER_COPY = 8;
  __device__ static inline void frag(const T* p, uint32_t& b0, uint32_t& b1) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    b0 = u.x;
    b1 = u.y;
  }
};

template <class C, class W>
struct Smem {
  static constexpr int X_STAGE = C::BM * (C::BK + PAD) * (int)sizeof(bf16);
  static constexpr int W_STAGE = C::BN * (C::BK + PAD) * (int)sizeof(typename W::T);
  static constexpr int PIPE = STAGES * (X_STAGE + W_STAGE);
  static constexpr int RED = C::WK * C::BM * C::RED_LD * (int)sizeof(float);
  static constexpr int BYTES = PIPE > RED ? PIPE : RED;
};

// Copies of the k-th BK-column tile of x and W into one stage.
template <class C, class W>
__device__ inline void load_stage(bf16* xs, typename W::T* ws, const bf16* __restrict__ x,
                                  const typename W::T* __restrict__ w, int M, int N, int K,
                                  int m0, int n0, int k0) {
  constexpr int XC = C::BK / 8;   // 16-byte copies per x row
  for (int i = threadIdx.x; i < C::BM * XC; i += THREADS) {
    const int r = i / XC, c = (i % XC) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async16(xs + r * (C::BK + PAD) + c, ok ? x + (int64_t)(m0 + r) * K + k0 + c : x,
               ok);
  }
  constexpr int WC = C::BK / W::PER_COPY;
  for (int i = threadIdx.x; i < C::BN * WC; i += THREADS) {
    const int r = i / WC, c = (i % WC) * W::PER_COPY;
    const bool ok = n0 + r < N && k0 + c < K;
    cp_async16(ws + r * (C::BK + PAD) + c, ok ? w + (int64_t)(n0 + r) * K + k0 + c : w,
               ok);
  }
}

// The (BM, BN) tile of x . W^T at (m0, n0) in float32: on return, red[(wk *
// BM + r) * RED_LD + c] holds warp group wk's partial sum of row r, column c
// (the caller adds the WK of them). `smem` holds Smem<C, W>::BYTES.
template <class C, class W>
__device__ inline void tile_product(const bf16* __restrict__ x,
                                    const typename W::T* __restrict__ w, int M, int N,
                                    int K, int m0, int n0, char* smem, float*& red) {
  typedef typename W::T WT;
  constexpr int LD = C::BK + PAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  WT* ws = reinterpret_cast<WT*>(smem + STAGES * Smem<C, W>::X_STAGE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk = warp % C::WK;
  const int wn = (warp / C::WK) % C::WN;
  const int wm = warp / (C::WK * C::WN);
  const int row0 = wm * (C::BM / C::WM), col0 = wn * (C::BN / C::WN);

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<C, W>(xs + s * C::BM * LD, ws + s * C::BN * LD, x, w, M, N, K, m0, n0,
                       s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) {
      const int s = next % STAGES;
      load_stage<C, W>(xs + s * C::BM * LD, ws + s * C::BN * LD, x, w, M, N, K, m0, n0,
                       next * C::BK);
    }
    cp_async_commit();
    const bf16* xt = xs + (kt % STAGES) * C::BM * LD;
    const WT* wt = ws + (kt % STAGES) * C::BN * LD;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      const int kk = (wk * C::KS + ks) * 16 + 4 * t;
      uint32_t a[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const int r = row0 + i * 16 + g;
        const uint2 lo = *reinterpret_cast<const uint2*>(xt + r * LD + kk);
        const uint2 hi = *reinterpret_cast<const uint2*>(xt + (r + 8) * LD + kk);
        a[i][0] = lo.x;
        a[i][1] = hi.x;
        a[i][2] = lo.y;
        a[i][3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        uint32_t b0, b1;
        W::frag(wt + (col0 + j * 8 + g) * LD + kk, b0, b1);
#pragma unroll
        for (int i = 0; i < C::MT; ++i) mma(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages: reuse them for sums

  red = reinterpret_cast<float*>(smem);
  float* mine = red + wk * C::BM * C::RED_LD;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int r = row0 + i * 16 + g, c = col0 + j * 8 + 2 * t;
      mine[r * C::RED_LD + c] = acc[i][j][0];
      mine[r * C::RED_LD + c + 1] = acc[i][j][1];
      mine[(r + 8) * C::RED_LD + c] = acc[i][j][2];
      mine[(r + 8) * C::RED_LD + c + 1] = acc[i][j][3];
    }
  __syncthreads();
}

// The tile's sum at row r, column c, over the WK partial sums.
template <class C>
__device__ inline float tile_sum(const float* red, int r, int c) {
  float s = red[r * C::RED_LD + c];
#pragma unroll
  for (int wk = 1; wk < C::WK; ++wk) s += red[(wk * C::BM + r) * C::RED_LD + c];
  return s;
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

}  // namespace gemm_tile
