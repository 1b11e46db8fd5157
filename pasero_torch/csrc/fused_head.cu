// Greedy vocabulary head: for each row n of x (N, E) bfloat16 and a head
// W (V, E), the argmax token and its log-probability,
//
//   s[n, v]  = sum_e x[n, e] * W[v, e]                     (fp32 sums)
//              times scale[v] when W is int8 with a per-row scale
//   tok[n]   = the lowest v with s[n, v] = max_v s[n, v]
//   lp[n]    = -log sum_v exp(s[n, v] - max_v s[n, v])
//
// without the (N, V) logits in device memory. It replaces the Pallas kernels
// of pasero_tpu/ops/fused_ce.py: fused_head_argmax (:431, bodies
// _argmax_kernel :319 and _online_argmax :344) with a bfloat16 W, and
// _fused_head_argmax_q8 (:387, body _argmax_kernel_q8 :359) with an int8 W.
// W is the port's (V, E) layout: a Linear head's (out, in) weight or the tied
// table, both read row by row.
//
// What bounds it: bytes at decode, operations at a prompt. At llama_1b's
// decode (N = 8, E = 2048, V = 32000) it must read the head once: 131 MB in
// bfloat16, 39 us at 3.35 TB/s, or 65.5 MB in int8, 20 us. At the 8 x 128
// prompt (N = 1024) the bfloat16 head is 134 GFLOP, 0.136 ms at 989 TFLOP/s.
//
// Design. The TPU kernel sweeps V in order in one program per row block,
// carrying (max, sum, index) in scratch from one vocabulary block to the
// next. Blocks of a CUDA grid run in no order, so V is split across blocks
// instead: each block computes one (BM, BN) tile of logits with the tensor
// cores (gemm_tile.cuh: int8 converted to bfloat16 on the chip, as the Pallas
// kernel converts it in VMEM), and reduces each of its rows to a partial
// (max, sum of exp, first index of the max) over its BN columns, written to a
// small (N, V / BN) buffer: 12 bytes per row and block instead of 4 BN. A
// second kernel combines a row's partials with the tie rule of the sweep (a
// later block replaces the index only with a strictly larger maximum, so the
// lowest index among equal maxima wins) and rescales the sums to the common
// maximum. Columns past V are never read. Decode rows (N <= 80) take 16 x 32
// tiles, so the head spreads over 1000 blocks; prompts take 64 x 128 tiles,
// with the row blocks of one vocabulary tile next to each other in the grid
// so they share its weights in L2.

#include <math.h>

#include "gemm_tile.cuh"

namespace fused_head {

using namespace gemm_tile;

// Row n's partial over its tile's columns [n0, n0 + BN) of V: one warp per
// row, lanes over columns.
template <class C, class W, bool Q8>
__global__ void __launch_bounds__(THREADS)
    partials_kernel(const bf16* __restrict__ x, const typename W::T* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ part_m,
                    float* __restrict__ part_l, int* __restrict__ part_i, int N, int V,
                    int E, int nvb) {
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.x * C::BM, v0 = blockIdx.y * C::BN;
  float* red;
  tile_product<C, W>(x, w, N, V, E, m0, v0, smem, red);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < C::BM; r += THREADS / 32) {
    if (m0 + r >= N) break;
    float s[C::BN / 32];
    float bm = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < C::BN / 32; ++j) {
      const int c = lane + 32 * j;
      s[j] = -INFINITY;
      if (v0 + c < V) {
        s[j] = tile_sum<C>(red, r, c);
        if (Q8) s[j] *= scale[v0 + c];
        if (s[j] > bm) {   // columns in increasing order: the first max wins
          bm = s[j];
          bi = v0 + c;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float om = __shfl_xor_sync(0xffffffffu, bm, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (om > bm || (om == bm && oi < bi)) {
        bm = om;
        bi = oi;
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < C::BN / 32; ++j)
      if (v0 + lane + 32 * j < V) l += expf(s[j] - bm);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      const int64_t at = (int64_t)(m0 + r) * nvb + blockIdx.y;
      part_m[at] = bm;
      part_l[at] = l;
      part_i[at] = bi;
    }
  }
}

// One warp per row: merge its nvb partials (max, sum, index).
__global__ void combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const int* __restrict__ part_i, int64_t* __restrict__ tok,
                               float* __restrict__ lp, int N, int nvb) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  float m = -INFINITY, l = 0.f;
  int i = 0x7fffffff;
  for (int b = lane; b < nvb; b += 32) {   // blocks in increasing order
    const int64_t at = (int64_t)row * nvb + b;
    const float bm = part_m[at], bl = part_l[at];
    const int bi = part_i[at];
    if (bm > m) {
      l = l * expf(m - bm) + bl;
      m = bm;
      i = bi;
    } else {
      l += bl * expf(bm - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float ol = __shfl_xor_sync(0xffffffffu, l, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    const float nm = fmaxf(m, om);
    // a lane that saw no block holds m = -inf and l = 0: it adds nothing
    l = (m == -INFINITY ? 0.f : l * expf(m - nm)) +
        (om == -INFINITY ? 0.f : ol * expf(om - nm));
    if (om > m || (om == m && oi < i)) i = oi;
    m = nm;
  }
  if (lane == 0) {
    tok[row] = i;
    lp[row] = -logf(l);
  }
}

template <class C, class W, bool Q8>
cudaError_t launch(const void* x, const void* w, const float* scale, float* part_m,
                   float* part_l, int* part_i, int64_t* tok, float* lp, int N, int V,
                   int E, cudaStream_t stream) {
  constexpr int bytes = Smem<C, W>::BYTES;
  auto kernel = partials_kernel<C, W, Q8>;
  static bool done = false;
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  const int nvb = (V + C::BN - 1) / C::BN;
  const dim3 grid((N + C::BM - 1) / C::BM, nvb);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const typename W::T*>(w), scale, part_m,
      part_l, part_i, N, V, E, nvb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<(N + 3) / 4, 128, 0, stream>>>(part_m, part_l, part_i, tok, lp, N, nvb);
  return cudaGetLastError();
}

}  // namespace fused_head

extern "C" {

// The number of vocabulary blocks, the second dimension of the partial
// buffers, for N rows and a vocabulary of V.
int fused_head_blocks(int N, int V) {
  using namespace gemm_tile;
  const int bn = N <= SMALL_MAX_M ? Small::BN : Large::BN;
  return (V + bn - 1) / bn;
}

// x (N, E) bfloat16; w (V, E) bfloat16 (int8 = 0) or int8 with scale (V,)
// float32 (int8 = 1); part_m, part_l (N, fused_head_blocks(N, V)) float32 and
// part_i int32 scratch; tok (N,) int64 and lp (N,) float32 out. All
// contiguous and 16-byte aligned. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for arguments the
// kernels do not take.
int fused_head_argmax(const void* x, const void* w, const float* scale, int int8,
                      float* part_m, float* part_l, int* part_i, int64_t* tok, float* lp,
                      int N, int V, int E, void* stream) {
  using namespace fused_head;
  if (N <= 0 || V <= 0 || E <= 0 || E % 16 != 0 || fused_head_blocks(N, V) > 65535 ||
      (int8 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = N <= SMALL_MAX_M;
  if (int8)
    return (int)(small ? launch<Small, Int8W, true>(x, w, scale, part_m, part_l, part_i,
                                                     tok, lp, N, V, E, s)
                       : launch<Large, Int8W, true>(x, w, scale, part_m, part_l, part_i,
                                                     tok, lp, N, V, E, s));
  return (int)(small ? launch<Small, Bf16W, false>(x, w, scale, part_m, part_l, part_i,
                                                    tok, lp, N, V, E, s)
                     : launch<Large, Bf16W, false>(x, w, scale, part_m, part_l, part_i,
                                                    tok, lp, N, V, E, s));
}

const char* fused_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
