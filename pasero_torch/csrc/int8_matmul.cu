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
// The mainloops are weight_gemm.cuh's (its comment gives their design):
// decode_kernel at M <= SMALL_MAX_M (operands swapped, K split over a
// cluster, the weight streamed by TMA) and prompt_kernel above (persistent
// wgmma, the int8 weight as register A). This file holds their epilogues:
// - decode rows: each output the sum of its partial sums in a fixed order
//   (rank, then warp), times its row's scale, rounded to y's type;
// - prompt rows: each accumulator row scaled by its scale and rounded, the
//   transposed tile written into the consumer's staging and stored by TMA
//   (rows of y that are not 16-byte aligned take plain stores).
// The scale multiplies the float32 sums once.

#include "weight_gemm.cuh"

namespace int8mm {

using namespace weight_gemm;

// -- decode rows -------------------------------------------------------------------

// y[m, n] for the rank's nr rows from n: the sum over the parts in order,
// times the row's scale.
template <typename OutT>
struct StoreDecode {
  OutT* y;

  __device__ __forceinline__ void operator()(const float* recv, const float* row_scale, int parts,
                                             int MP, int R, int nr, int n_first, int M,
                                             int N, int) const {
    for (int e = threadIdx.x; e < nr * M; e += DEC_THREADS) {
      const int m = e / nr, r = e % nr, n = n_first + r;
      if (n >= N) continue;
      float sum = 0.f;
      for (int c = 0; c < parts; ++c) sum += recv[(c * MP + m) * R + r];
      const float v = sum * row_scale[r];
      if constexpr (sizeof(OutT) == 4)
        y[(int64_t)m * N + n] = v;
      else
        y[(int64_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
};

template <typename OutT>
cudaError_t decode(const void* x, const int8_t* q, const float* scale, void* y, int M, int N,
                   int K, cudaStream_t s) {
  const StoreDecode<OutT> epi{static_cast<OutT*>(y)};
  return with_nt(M, [&](auto nt) {
    return launch_decode<decltype(nt)::value, Int8Weight>(x, q, scale, M, N, K, epi, s);
  });
}

// -- prompt rows -------------------------------------------------------------------

// The x rows of an epilogue pass: a consumer's staging holds 64 n by
// PR_OUT / (64 sizeof(OutT)) rows; a tile that holds more goes in equal
// passes (the output map's box is one pass, so none reaches past its tile).
template <int BX, typename OutT>
__host__ __device__ constexpr int pass_rows() {
  return BX <= PR_OUT / (64 * (int)sizeof(OutT))          ? BX
         : BX % (PR_OUT / (64 * (int)sizeof(OutT))) == 0 ? PR_OUT / (64 * (int)sizeof(OutT))
                                                          : BX / 2;
}

// A box of a 2-D tensor map from shared memory into device memory, as one
// bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The epilogue of a prompt tile: it scales each accumulator row n by
// scale[n], rounds to OutT and writes the transposed tile y[m0 .., n0 + 64 g
// ..] into the consumer's staging, laid out as the output map's boxes (64 n
// of bf16 or 32 n of float32 a 128-byte row, 128-byte swizzled), then one
// thread stores it by TMA, which writes only what lies inside y. A float32
// tile of more than 128 x rows goes in two passes (pass_rows). Rows of y
// that are not 16-byte aligned (direct) take plain stores.
template <typename OutT>
struct StorePrompt {
  CUtensorMap map_y;
  OutT* y;
  int direct;

  template <int ACC>
  __device__ __forceinline__ void operator()(const float (&d)[ACC], const PromptTile& at, int M,
                                             int N) const {
    constexpr int BX = 2 * ACC;
    constexpr bool F32 = sizeof(OutT) == 4;
    constexpr int PASS_ROWS = pass_rows<BX, OutT>();   // x rows a pass stages
    constexpr int PASSES = BX / PASS_ROWS;
    static_assert(PASSES * PASS_ROWS == BX && PASS_ROWS % 8 == 0, "equal passes");
    const int t = at.t, gl = at.gl;
    if (direct) {   // rows of y not 16-byte aligned: no tensor map, plain stores
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int m = at.m0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int n = at.n0 + at.wrow + gl + 8 * ((i >> 1) & 1);
        if (m < M && n < N) {
          const float v = d[i] * at.sc[(i >> 1) & 1];
          if constexpr (F32)
            y[(int64_t)m * N + n] = v;
          else
            y[(int64_t)m * N + n] = __float2bfloat16_rn(v);
        }
      }
      return;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (threadIdx.x % 128 == 0) store_wait_read();   // the last store read the staging
      consumer_sync(at.g);
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int j8 = 8 * (i >> 2) - p * PASS_ROWS;   // the pass's rows, known at compile time
        if (j8 < 0 || j8 >= PASS_ROWS) continue;
        const int m = j8 + 2 * t + (i & 1);
        const int n = 16 * at.warp + gl + 8 * ((i >> 1) & 1);   // of the consumer's 64
        const float v = d[i] * at.sc[(i >> 1) & 1];
        if constexpr (F32) {
          float* box = reinterpret_cast<float*>(at.staging + (n >> 5) * (PR_OUT / 2));
          box[m * 32 + ((((n & 31) >> 2) ^ (m & 7)) << 2) + (n & 3)] = v;
        } else {
          bf16* box = reinterpret_cast<bf16*>(at.staging);
          box[m * 64 + (((n >> 3) ^ (m & 7)) << 3) + (n & 7)] = __float2bfloat16_rn(v);
        }
      }
      fence_async_shared();
      consumer_sync(at.g);
      if (threadIdx.x % 128 == 0) {
        const uint32_t src = at.staging_s;
        const int row = at.m0 + p * PASS_ROWS, col = at.n0 + 64 * at.g;
        if constexpr (F32) {
          tma_store_2d(&map_y, src, col, row);
          tma_store_2d(&map_y, src + PR_OUT / 2, col + 32, row);
        } else {
          tma_store_2d(&map_y, src, col, row);
        }
      }
    }
  }
};

// The tensor map of y (M, N) as the epilogue stores it: boxes of 64 n
// (bf16) or 32 n (float32) x the rows of a pass, 128-byte swizzled.
template <typename OutT>
bool output_map(CUtensorMap* map, void* y, int M, int N, int rows) {
  wgmma_gemm::EncodeTiled fn = wgmma_gemm::encode_tiled();
  if (!fn) return false;
  constexpr bool F32 = sizeof(OutT) == 4;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(OutT)};
  const cuuint32_t box[2] = {F32 ? 32u : 64u, (cuuint32_t)rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y,
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
cudaError_t prompt(const void* x, const int8_t* q, const float* scale, void* y, int M, int N,
                   int K, cudaStream_t s) {
  return with_bx(M, N, [&](auto bx) {
    constexpr int BX = decltype(bx)::value;
    StorePrompt<OutT> epi = {};
    epi.y = static_cast<OutT*>(y);
    // y's rows must be 16-byte aligned for a tensor map; else plain stores
    epi.direct = N % (16 / (int)sizeof(OutT)) != 0;
    if (!epi.direct && !output_map<OutT>(&epi.map_y, y, M, N, pass_rows<BX, OutT>()))
      return cudaErrorInvalidValue;
    return launch_prompt<BX>(x, q, scale, M, N, K, epi, s);
  });
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
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || (int64_t)(N + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= SMALL_MAX_M)
    return (int)(out_f32 ? decode<float>(x, q, scale, y, M, N, K, s)
                         : decode<bf16>(x, q, scale, y, M, N, K, s));
  return (int)(out_f32 ? prompt<float>(x, q, scale, y, M, N, K, s)
                       : prompt<bf16>(x, q, scale, y, M, N, K, s));
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
