// A bf16 GEMM mainloop for Hopper (sm_90a): C (BM x BN, fp32, registers) =
// A (M x K) . B (N x K)^T over K, with TMA copies into a ring of shared-memory
// stages and wgmma products, for a caller's epilogue to consume. Used by
// fused_ce.cu: its forward is one epilogue of it (the logsumexp partials of
// each 128 x 256 logits tile), its three backward products three others; and
// by fused_head.cu, whose bfloat16 head at prompt rows is another (the argmax
// partials of each tile). Its PTX wrappers serve the other wgmma kernels too:
// the mbarriers, TMA, descriptors, and wgmma_rs (A from registers, m64 x n
// 64-256), which weight_gemm.cuh's int8 prompt kernel and flash_bwd.cu's
// P.V, dS.K and dS^T.Q products issue; split_tf32 and wgmma_tf32_rs (TF32 A
// from registers, m64 x n 32-128), the split-TF32 products of flash_f32.cu
// and fused_ce.cu.
//
// Shape: a persistent grid of at most one block per SM, each block of 384
// threads walking 128 x 256 output tiles. Warpgroup 0 is the producer: one
// of its threads keeps the TMA copies of the next k-tiles (64 deep) in
// flight, STAGES ahead and across tiles, each stage's completion counted in
// bytes on its "full" mbarrier. Warpgroups 1 and 2 are the consumers: each
// owns 64 rows of the tile and issues four m64n256k16 wgmmas per k-tile
// (bf16 operands read from shared memory, fp32 sums in 128 registers a
// thread), keeps one k-tile's group in flight, and frees a stage on its
// "empty" mbarrier once the products that read it have retired. setmaxnreg
// moves registers from the producer (40) to the consumers (232).
//
// Operands in either major order. wgmma reads bf16 operands transposed or
// not, so each of A and B is K-major (K contiguous in device memory: a
// row-major (M, K) matrix) or MN-major (M contiguous: a row-major (K, M)
// matrix, read as its transpose), a template flag each:
// - K-major: one TMA box of 64 K-elements (128 bytes) x R rows per stage,
//   128-byte swizzled, so rows are 128 bytes apart and 8-row groups 1024
//   (the descriptor's stride offset); a 16-deep k-slice starts 32 bytes on.
// - MN-major: R / 64 boxes of 64 MN-elements x 64 K-rows, each 8 KB, 128-byte
//   swizzled; the descriptor's leading offset steps from one 64-wide MN block
//   to the next (8192 bytes), its stride offset over 8 K-rows (1024); a
//   16-deep k-slice starts 2048 bytes on.
// Ragged edges need nothing: TMA fills with zeros what lies outside the
// tensor map (rows past M or N, columns past K), and the epilogue drops
// what lies outside the output.
//
// The epilogue is called by every consumer thread with its 128 sums: element
// i lies at row r0 + 8 * ((i >> 1) & 1) and column c0 + 8 * (i >> 2) + (i & 1)
// of the output, r0 = m0 + 64 * (consumer) + 16 * (warp in it) + lane / 4 and
// c0 = n0 + 2 * (lane % 4), and with what its rows(r0) returned before the
// tile's products (values of the thread's two rows, read early so that their
// latency hides behind the products).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_gemm {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the stages, 1024 bytes to align them (128-byte swizzle), 2 barriers each
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
constexpr int ACC = BN / 2;   // fp32 sums per consumer thread

// -- PTX wrappers ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed. A wait
// of more than about ten seconds traps (a launch error) rather than hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (!start)
      start = clock64();
    else if (clock64() - start > 20000000000ll)
      __trap();
  }
}

// A 2-D box of a tensor map into shared memory, counted on `bar`; c0 is the
// coordinate along the contiguous dimension.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the sums across an asynchronous
// wgmma that reads or writes them.
__device__ __forceinline__ void fence_sums(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

// The accumulator operands of a wgmma, d[o] .. d[o + 31], and their places
// in its text: WGMMA_Rn names the first n (%0 .. %n-1).
#define WGMMA_D8(o)                                                              \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WGMMA_D32(o) WGMMA_D8(o), WGMMA_D8(o + 8), WGMMA_D8(o + 16), WGMMA_D8(o + 24)
#define WGMMA_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7" \
  ", %8, %9, %10, %11, %12, %13, %14, %15" \
  ", %16, %17, %18, %19, %20, %21, %22, %23" \
  ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R64 WGMMA_R32 \
  ", %32, %33, %34, %35, %36, %37, %38, %39" \
  ", %40, %41, %42, %43, %44, %45, %46, %47" \
  ", %48, %49, %50, %51, %52, %53, %54, %55" \
  ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_R96 WGMMA_R64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71" \
  ", %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87" \
  ", %88, %89, %90, %91, %92, %93, %94, %95"
#define WGMMA_R128 WGMMA_R96 \
  ", %96, %97, %98, %99, %100, %101, %102, %103" \
  ", %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119" \
  ", %120, %121, %122, %123, %124, %125, %126, %127"

// d (64 x 256, fp32) += A (64 x 16) . B (256 x 16)^T; TRANS_x = 1 for an
// MN-major operand.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint64_t desc_a,
                                                 uint64_t desc_b) {
  const uint32_t scale_d = 1;   // the predicate operand: d += A . B, not d = A . B
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WGMMA_R128
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : WGMMA_D32(0), WGMMA_D32(32), WGMMA_D32(64), WGMMA_D32(96)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x N, fp32) += A (64 x 16, bf16 in registers in mma.sync's m16k16
// A-fragment layout, one m16 slice a warp) . B (N x 16)^T, B read from
// shared memory by its descriptor: K-major (TRANS_B = 0) or MN-major (1).
// N is 64, 128, 192 or 256; d holds N / 2 sums a thread.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "m64nNk16, N a multiple of 64");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WGMMA_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WGMMA_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
  else if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WGMMA_D32(0), WGMMA_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
  else if constexpr (N == 192)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WGMMA_R96
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : WGMMA_D32(0), WGMMA_D32(32), WGMMA_D32(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WGMMA_R128
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : WGMMA_D32(0), WGMMA_D32(32), WGMMA_D32(64), WGMMA_D32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// float32 on the tensor cores in split TF32 (flash_f32.cu, fused_ce.cu): x
// as hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), x = hi + lo within
// 2^-22 |x|; a product a . b as hi_a lo_b + lo_a hi_b + hi_a hi_b.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (64 x N) = A (64 x 8, TF32 in registers: a warp's 16 rows in mma.sync's
// m16n8k8 A-fragment layout, slot s holding row g + 8 (s & 1), column t + 4
// (s >> 1) for lane (g, t)) . B (N x 8)^T + (accumulate ? d : 0), B read
// K-major from shared memory by its descriptor (wgmma reads TF32 K-major
// only). N is 32, 64 or 128; d holds N / 2 sums a thread.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, uint32_t accumulate = 1) {
  static_assert(N == 32 || N == 64 || N == 128, "m64nNk8, N 32, 64 or 128");
  if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WGMMA_D8(0), WGMMA_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  else if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WGMMA_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WGMMA_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WGMMA_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WGMMA_D32(0), WGMMA_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// -- the kernel ------------------------------------------------------------------

// The stage's tile of one operand: R rows (M or N) x BK k-columns.
template <bool MN, int R>
__device__ __forceinline__ void load_operand(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                    int r0, int k0) {
  if (MN) {
#pragma unroll
    for (int j = 0; j < R / 64; ++j) tma_load(dst + j * 8192, map, bar, r0 + 64 * j, k0);
  } else {
    tma_load(dst, map, bar, k0, r0);
  }
}

// The descriptor of the k-th 16-deep slice of an operand's stage tile.
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int k) {
  return MN ? smem_desc(tile + k * 2048, 8192, 1024) : smem_desc(tile + k * 32, 16, 1024);
}

// Offsets of B's tiles in its tensor map (a vocabulary chunk's first row of
// the whole weight, along N or along K); A's tiles start at (m0, k0).
struct Coords {
  int b_mn_off;   // added to B's N coordinate
  int b_k_off;    // added to B's K coordinate
};

// Empty per-row values, for an epilogue that reads none before its tile.
struct NoRows {};

// The (tiles_m x tiles_n) output tiles of A . B^T, k_tiles k-tiles of BK
// each, walked by a persistent grid: block b takes tiles b, b + gridDim.x, ...
// (n fastest, or m fastest with M_FAST), so the producer copies the next
// tile's first k-tiles while the consumers run the epilogue of this one. Each
// consumer thread reads its rows' values for the epilogue (epi.rows) before
// the tile's products.
template <bool M_FAST>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  m0 = (M_FAST ? tile % tiles_m : tile / tiles_n) * BM;
  n0 = (M_FAST ? tile / tiles_m : tile % tiles_n) * BN;
}

template <bool A_MN, bool B_MN, class Epilogue, bool M_FAST = false>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, Coords at, int tiles_m,
                int tiles_n, int k_tiles, Epilogue epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
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
          const uint32_t tile_smem = base + s * STAGE_BYTES;
          load_operand<A_MN, BM>(tile_smem, &map_a, full + 8 * s, m0, kt * BK);
          load_operand<B_MN, BN>(tile_smem + A_BYTES, &map_b, full + 8 * s,
                                 n0 + at.b_mn_off, kt * BK + at.b_k_off);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin<M_FAST>(tile, tiles_m, tiles_n, m0, n0);
      const int r0 = m0 + 64 * g + 16 * warp + lane / 4;
      const int c0 = n0 + 2 * (lane % 4);
      const auto rows = epi.rows(r0);
      float d[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        // this consumer's 64 rows of A: the next 8 KB in either order
        const uint32_t a = base + s * STAGE_BYTES + g * 8192;
        const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
        fence_sums(d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_m64n256k16<A_MN, B_MN>(d, operand_desc<A_MN>(a, k), operand_desc<B_MN>(b, k));
        wgmma_commit();
        fence_sums(d);
        // the previous k-tile's products have retired: free its stage
        wgmma_wait<1>();
        fence_sums(d);
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_sums(d);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      epi(d, r0, c0, rows);
    }
  }
}

// -- host side -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library needs no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major bf16 (rows, cols) matrix with leading
// dimension ld (elements) read as the operand of a gemm_kernel: for a K-major
// operand of R rows a box of 64 columns x R rows, for an MN-major one a box of
// 64 columns x 64 rows. Returns false where the driver refuses it (cols and
// ld must be multiples of 8, the base 16-byte aligned).
inline bool operand_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
                        int64_t ld, bool mn, int R) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)(mn ? 64 : R)};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the (ceil(m / BM) x ceil(n / BN)) tiles of an m x n output on at
// most one block per SM; M_FAST walks the m tiles of one n column first.
template <bool A_MN, bool B_MN, bool M_FAST = false, class Epilogue>
cudaError_t gemm(const CUtensorMap& map_a, const CUtensorMap& map_b, Coords at,
                 int64_t m, int64_t n, int64_t k, const Epilogue& epi, cudaStream_t stream) {
  auto kernel = gemm_kernel<A_MN, B_MN, Epilogue, M_FAST>;
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
      map_a, map_b, at, (int)tiles_m, (int)tiles_n, (int)((k + BK - 1) / BK), epi);
  return cudaGetLastError();
}

}  // namespace wgmma_gemm
