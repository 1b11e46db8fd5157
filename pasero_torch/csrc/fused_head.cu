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
// bfloat16, 39 us at 3.35 TB/s, or 65.5 MB in int8, 20 us; a speculative
// chunk (N = 72) reads it once too. At the 8 x 128 prompt (N = 1024) either
// head is 134 GFLOP, 0.136 ms at 989 TFLOP/s.
//
// Design. The TPU kernel sweeps V in order in one program per row block,
// carrying (max, sum, index) in scratch from one vocabulary block to the
// next. Blocks of a CUDA grid run in no order, so V is split into tiles
// instead: the logits of a tile come from the port's matrix-product
// mainloops, and an epilogue reduces each x row's logits of the tile to a
// partial (max, sum of exp relative to it, first index of the max), written
// to a (parts, N) buffer: 12 bytes per row and tile instead of 4 per logit.
// - Decode rows (N <= 8 for a bfloat16 head, 16 for an int8 one:
//   takes_decode): weight_gemm.cuh's decode_kernel (the head's rows as the m
//   side of mma.sync, x's rows the n side, the head streamed by TMA with an
//   L2 evict-first hint, as int8 or bfloat16 boxes), DecodePartials over
//   each block's 64 head rows.
// - More rows, int8 head: weight_gemm.cuh's prompt_kernel (persistent
//   wgmma, the int8 head as register A, x as B), PromptPartials over each
//   consumer's 64 head rows: the logits transposed through shared memory and
//   each x row scanned in order.
// - More rows, bfloat16 head: wgmma_gemm.cuh's gemm_kernel (x and W as
//   stored, 128 x 256 logits tiles, the row tiles of one vocabulary tile
//   first), TilePartials over each row's 256 columns, in registers and a
//   quad's shuffles, as the fused CE forward's FwdEpilogue.
// combine_kernel then merges each row's partials with the sweep's tie rule
// (a partial replaces the index only with a strictly larger maximum, so the
// lowest index among equal maxima wins) and rescales the sums to the common
// maximum, in a fixed order; it is launched as a programmatic dependent of
// the partials kernel, so its launch overlaps that kernel's tail. No
// atomics: two calls give the same bits.
// Head rows past V are never counted.

#include <math.h>

#include "weight_gemm.cuh"

namespace fused_head {

using namespace weight_gemm;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NO_INDEX = 0x7fffffff;

// exp(x) for x <= 0 by the SFU's 2^x (relative error about 2^-22).
__device__ __forceinline__ float exp_le0(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

// (m, i) takes (om, oi) where that is the larger value or, equal, the lower
// index: the first index of the max.
__device__ __forceinline__ void take_max(float& m, int& i, float om, int oi) {
  if (om > m || (om == m && oi < i)) {
    m = om;
    i = oi;
  }
}

// (m, l, i) merged with another partial (om, ol, oi): the larger max (the
// lower index on a tie) and both sums rescaled to it. The same bits whichever
// side a partial is on; a partial of no row (max -inf, sum 0) adds nothing.
__device__ __forceinline__ void merge(float& m, float& l, int& i, float om, float ol, int oi) {
  const float hi = fmaxf(m, om), lo = fminf(m, om);
  const float e = lo == -INFINITY ? 0.f : exp_le0(lo - hi);
  l = m >= om ? l + ol * e : l * e + ol;
  take_max(m, i, om, oi);
}
__device__ __forceinline__ void merge_xor(float& m, float& l, int& i, int off) {
  merge(m, l, i, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off),
        __shfl_xor_sync(0xffffffffu, i, off));
}

struct Parts {
  float* m;
  float* l;
  int* i;
  __device__ __forceinline__ void put(int64_t at, float pm, float pl, int pi) const {
    m[at] = pm;
    l[at] = pl;
    i[at] = pi;
  }
};

// decode_kernel's epilogue: for each x row m < M (one warp a row), the
// partial over the rank's nr head rows from n_first (lanes over rows, two a
// lane in increasing order, then a shuffle tree), each logit the sum of its
// parts in order times its row's scale; at parts.m[part * M + m].
struct DecodePartials {
  Parts out;

  __device__ __forceinline__ void operator()(const float* recv, const float* row_scale, int parts,
                                             int MP, int R, int nr, int n_first, int M, int N,
                                             int part) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int m = warp; m < M; m += DEC_THREADS / 32) {
      float pm = -INFINITY, pl = 0.f;
      int pi = NO_INDEX;
#pragma unroll
      for (int r = lane; r < 64; r += 32) {
        if (r >= nr || n_first + r >= N) break;
        float sum = 0.f;
        for (int c = 0; c < parts; ++c) sum += recv[(c * MP + m) * R + r];
        merge(pm, pl, pi, sum * row_scale[r], 1.f, n_first + r);
      }
#pragma unroll
      for (int off = 1; off < 32; off *= 2) merge_xor(pm, pl, pi, off);
      if (lane == 0) out.put((int64_t)part * M + m, pm, pl, pi);
    }
  }
};

// prompt_kernel's epilogue: for each x row of the tile, the partial over the
// consumer's 64 head rows n0 + 64 g ... A thread holds its accumulators
// across x rows and two head rows, so the reduction along head rows would
// run across lanes and warps; instead the consumer transposes its logits
// through the staging, PX x rows a pass (rows LD floats apart, so that
// neither side's accesses collide on a bank beyond two ways), and two
// threads scan each x row's 64 values in order, one the even head rows and
// one the odd, and merge; at parts.m[(n0 / 64 + g) * M + m]. Rows past V
// are staged as -inf: a consumer whose rows all lie past V writes a partial
// of none.
struct PromptPartials {
  Parts out;
  static constexpr int PX = 64, LD = 66;

  template <int ACC>
  __device__ __forceinline__ void operator()(const float (&d)[ACC], const PromptTile& at, int M,
                                             int N) const {
    constexpr int BX = 2 * ACC;
    static_assert(BX % PX == 0 && PX * LD * 4 <= PR_OUT, "passes of PX x rows fit the staging");
    float* tile = reinterpret_cast<float*>(at.staging);   // [x row][head row]
    const int first = at.n0 + 64 * at.g;                  // the consumer's first head row
    const int lo = 16 * at.warp + at.gl;                  // this thread's rows lo, lo + 8
    const bool ok[2] = {first + lo < N, first + lo + 8 < N};
    const int tid = threadIdx.x % 128, xr = tid / 2, hf = tid % 2;   // the scan's row, half
    const int part = at.n0 / 64 + at.g;
#pragma unroll
    for (int p = 0; p < BX / PX; ++p) {
      consumer_sync(at.g);   // the last pass's scans are done with the staging
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        const int j8 = 8 * (e >> 2) - p * PX;   // the pass's rows, known at compile time
        if (j8 < 0 || j8 >= PX) continue;
        const int h = (e >> 1) & 1;
        tile[(j8 + 2 * at.t + (e & 1)) * LD + lo + 8 * h] = ok[h] ? d[e] * at.sc[h] : -INFINITY;
      }
      consumer_sync(at.g);
      const float* row = tile + xr * LD + hf;
      float m = -INFINITY, l = 0.f;
      int i = NO_INDEX;
#pragma unroll 8
      for (int k = 0; k < 32; ++k)
        if (row[2 * k] > m) m = row[2 * k], i = first + 2 * k + hf;
      if (m != -INFINITY)
#pragma unroll 8
        for (int k = 0; k < 32; ++k) l += exp_le0(row[2 * k] - m);
      merge_xor(m, l, i, 1);
      const int x = at.m0 + p * PX + xr;
      if (hf == 0 && x < M) out.put((int64_t)part * M + x, m, l, i);
    }
  }
};

// gemm_kernel's epilogue for the bfloat16 head (A = x, B = W): the partial
// of rows r0 and r0 + 8 over the tile's 256 columns, a thread's 64 in
// increasing order, then its quad's; at parts.m[tile * N + row].
struct TilePartials {
  Parts out;
  int N, V;

  __device__ __forceinline__ wgmma_gemm::NoRows rows(int) const { return {}; }

  template <bool WHOLE, int NACC>
  __device__ __forceinline__ void row_partial(const float (&d)[NACC], int h, int c0, float& m,
                                              float& l, int& i) const {
    m = -INFINITY;
    i = NO_INDEX;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((WHOLE || c0 + 8 * j + e < V) && d[4 * j + 2 * h + e] > m)
          m = d[4 * j + 2 * h + e], i = c0 + 8 * j + e;
#pragma unroll
    for (int off = 1; off < 4; off *= 2)
      take_max(m, i, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, i, off));
    l = 0.f;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (WHOLE || c0 + 8 * j + e < V) l += exp_le0(d[4 * j + 2 * h + e] - m);
#pragma unroll
    for (int off = 1; off < 4; off *= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
  }

  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&d)[NACC], int r0, int c0,
                                             const wgmma_gemm::NoRows&) const {
    constexpr int W = 2 * NACC;   // the tile's columns
    const int tile = c0 / W;
    const bool whole = (tile + 1) * W <= V;   // the same for the warp
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      float m, l;
      int i;
      if (whole)
        row_partial<true>(d, h, c0, m, l, i);
      else
        row_partial<false>(d, h, c0, m, l, i);
      if (threadIdx.x % 4 == 0 && row < N) out.put((int64_t)tile * N + row, m, l, i);
    }
  }
};

// The merge of each row's `parts` partials ((parts, N) buffers): a block
// of 32 warps takes rb rows (a power of two up to 32, at least N where N <
// 32), lane r of each warp row r % rb and stream (warp, r / rb) of the row's
// 32 (32 / rb); a stream merges partials stream, stream + streams, ... in
// increasing order, the lanes of a row meet in a shuffle tree and warp 0
// merges the 32 warps' states in warp order. Fixed order, the lower index
// on a tie, and at small N more loads in flight than one warp a row.
constexpr int MERGE_WARPS = 32;

__global__ void __launch_bounds__(32 * MERGE_WARPS)
    combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const int* __restrict__ part_i, int64_t* __restrict__ tok,
                   float* __restrict__ lp, int N, int parts, int rb) {
  __shared__ float sm[MERGE_WARPS][32], sl[MERGE_WARPS][32];
  __shared__ int si[MERGE_WARPS][32];
  // launched before the partials kernel ends (programmatic dependent
  // launch): wait until it has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * rb + lane % rb;
  const int streams = MERGE_WARPS * (32 / rb), stream = warp * (32 / rb) + lane / rb;
  float m = -INFINITY, l = 0.f;
  int i = NO_INDEX;
  if (row < N) {
#pragma unroll 4
    for (int b = stream; b < parts; b += streams) {
      const int64_t at = (int64_t)b * N + row;
      merge(m, l, i, part_m[at], part_l[at], part_i[at]);
    }
  }
  for (int off = rb; off < 32; off *= 2) merge_xor(m, l, i, off);
  if (lane < rb) {
    sm[warp][lane] = m;
    sl[warp][lane] = l;
    si[warp][lane] = i;
  }
  __syncthreads();
  if (warp != 0 || lane >= rb || row >= N) return;
  for (int w = 1; w < MERGE_WARPS; ++w) merge(m, l, i, sm[w][lane], sl[w][lane], si[w][lane]);
  tok[row] = i;
  lp[row] = -logf(l);
}

// The partials of each x row: the decode plan's tiles x ranks; the int8
// prompt's two 64-row consumer halves of each 128-row tile; the bf16
// prompt's 256-column tiles.
int parts(int N, int V, int E, bool int8, bool decode) {
  if (decode)
    return with_nt(N, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      const DecodePlan p = int8 ? decode_plan<NT, Int8Weight>(N, V, E)
                                : decode_plan<NT, Bf16Weight>(N, V, E);
      return p.tiles * p.cs;
    });
  return int8 ? 2 * ((V + PR_ROWS - 1) / PR_ROWS) : (V + wgmma_gemm::BN - 1) / wgmma_gemm::BN;
}

cudaError_t partials(const void* x, const void* w, const float* scale, bool int8, bool decode,
                     const Parts& out, int N, int V, int E, cudaStream_t s) {
  if (decode) {
    const DecodePartials epi{out};
    return with_nt(N, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      return int8 ? launch_decode<NT, Int8Weight>(x, w, scale, N, V, E, epi, s)
                  : launch_decode<NT, Bf16Weight>(x, w, nullptr, N, V, E, epi, s);
    });
  }
  if (int8) {
    const PromptPartials epi{out};
    return with_bx(N, V, [&](auto bx) {
      return launch_prompt<decltype(bx)::value>(x, static_cast<const int8_t*>(w), scale, N, V, E,
                                                epi, s);
    });
  }
  using namespace wgmma_gemm;
  CUtensorMap x_k, w_k;
  if (!operand_map(&x_k, x, N, E, E, false, BM) || !operand_map(&w_k, w, V, E, E, false, BN))
    return cudaErrorInvalidValue;
  // the row tiles of one vocabulary tile first (M_FAST): W from device
  // memory once, x from L2
  return gemm<false, false, true>(x_k, w_k, Coords{0, 0}, N, V, E, TilePartials{out, N, V}, s);
}

// The rows up to which a head takes the decode kernel: one n8 tile of a
// bfloat16 head, two of an int8 one. Above them the wgmma kernels read the
// head as fast or faster (timed on an H100: PERF.md).
constexpr int DECODE_ROWS_BF16 = 8, DECODE_ROWS_INT8 = 16;
static_assert(DECODE_ROWS_BF16 <= SMALL_MAX_M && DECODE_ROWS_INT8 <= SMALL_MAX_M,
              "the decode kernel's rows");

inline bool takes_decode(int N, bool int8) {
  return N <= (int8 ? DECODE_ROWS_INT8 : DECODE_ROWS_BF16);
}

}  // namespace fused_head

extern "C" {

// The partials per x row, the first dimension of the partial buffers, for N
// rows, a vocabulary of V, width E and an int8 (1) or bfloat16 (0) head.
int fused_head_blocks(int N, int V, int E, int int8) {
  if (N <= 0 || V <= 0 || E <= 0) return 0;
  return fused_head::parts(N, V, E, int8 != 0, fused_head::takes_decode(N, int8 != 0));
}

// x (N, E) bfloat16; w (V, E) bfloat16 (int8 = 0) or int8 with scale (V,)
// float32 (int8 = 1); part_m, part_l (fused_head_blocks(N, V, E, int8), N)
// float32 and part_i int32 scratch; tok (N,) int64 and lp (N,) float32 out.
// All contiguous and 16-byte aligned. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for arguments the
// kernels do not take.
int fused_head_argmax(const void* x, const void* w, const float* scale, int int8,
                      float* part_m, float* part_l, int* part_i, int64_t* tok, float* lp,
                      int N, int V, int E, void* stream) {
  using namespace fused_head;
  if (N <= 0 || V <= 0 || E <= 0 || E % 16 != 0 || (V + 15) / 16 > 65535 ||
      (int8 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool decode = fused_head::takes_decode(N, int8 != 0);
  cudaError_t err =
      partials(x, w, scale, int8 != 0, decode, Parts{part_m, part_l, part_i}, N, V, E, s);
  if (err != cudaSuccess) return (int)err;
  int rb = 1;
  while (rb < 32 && rb < N) rb *= 2;
  // the merge may launch while the partials kernel drains; it waits for it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + rb - 1) / rb);
  cfg.blockDim = dim3(32 * MERGE_WARPS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel, (const float*)part_m, (const float*)part_l,
                           (const int*)part_i, tok, lp, N, parts(N, V, E, int8 != 0, decode),
                           rb);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

const char* fused_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
