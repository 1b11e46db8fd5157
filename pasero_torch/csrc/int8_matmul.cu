// Weight-only int8 matrix product:
//
//   y[m, n] = (sum_k x[m, k] * q[n, k]) * scale[n]
//
// x (M, K) bfloat16, q (N, K) int8 with one float32 scale per row n (the
// port's (out, in) layout: a Linear weight, or the tied (vocab, embed) table);
// float32 sums of exact products, rounded once to y's type (bfloat16 for a
// Linear, float32 for the tied head). It replaces the Pallas kernel
// _int8_matmul_2d (pasero_tpu/ops/quantize.py:245, body _kernel :227), which
// serves both int8_matmul and int8_matmul_t there.
//
// What bounds it: bytes at decode, operations at a prompt. At llama_1b's
// decode (M = 8 rows) each call must read its int8 weight once: fc1's 2048 x
// 5632 is 11.5 MB, 3.4 us at 3.35 TB/s, and the 154 products of one decoder
// call 1.03 GB, 0.31 ms. At the 8 x 128-token prompt (M = 1024), fc1 is 23.6
// GFLOP, 24 us at 989 TFLOP/s (bf16 dense).
//
// Design (gemm_tile.cuh): the weight is read from device memory as int8 only
// and converted to bfloat16 on the chip, tile by tile, as the Pallas kernel
// converts it in VMEM: no bfloat16 copy of a weight exists in device memory.
// Tiles of x and q are staged in shared memory by cp.async, three deep, and
// multiplied with mma.sync m16n8k16; the scale multiplies the float32 sums in
// the epilogue. Decode rows (M <= 80) take 16 x 32 tiles with the four warps
// splitting K, so a 2048-wide layer spreads over 64 blocks; rows past M are
// zero-filled in shared memory, never in device memory. Prompts take 64 x
// 128 tiles. The ragged edges of M and N are masked (the TPU kernel pads to
// 128); K must be a multiple of 16. What holds it back: mma.sync instead of
// wgmma, no split of K across blocks (a 2048 x 256 K/V projection runs on 8
// blocks at decode), and x re-read from L2 by every column block.

#include "gemm_tile.cuh"

namespace int8mm {

using namespace gemm_tile;

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
      (int64_t)(N + Small::BN - 1) / Small::BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= SMALL_MAX_M)
    return (int)(out_f32 ? launch<Small, float>(x, q, scale, y, M, N, K, s)
                         : launch<Small, bf16>(x, q, scale, y, M, N, K, s));
  return (int)(out_f32 ? launch<Large, float>(x, q, scale, y, M, N, K, s)
                       : launch<Large, bf16>(x, q, scale, y, M, N, K, s));
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
