// KV-cache slot write for beam/greedy decoding: one launch writes one layer's
// new K and V into slot `index` of its fixed-size caches,
//
//     k_cache[:, :, index, :] = k_new[:, :, 0, :]
//     v_cache[:, :, index, :] = v_new[:, :, 0, :]
//
// for contiguous (R, H, L, D) caches and contiguous (R, H, 1, D) new blocks
// of the cache's type (bf16 or fp32; the wrapper casts `new`).
//
// Replaces the TPU kernel pasero_tpu/ops/cache_update.py:_write_kernel
// (called through cache_slot_write). That kernel read-modify-wrote an 8-slot
// window because TPU sublane tiling cannot express a 1-slot block, and existed
// to let XLA alias the while-loop carry. Neither applies here: PyTorch updates
// the cache in place, and a thread can store exactly one 16-byte vector.
//
// What bounds it: the launch, not the bytes. Each launch reads the two new
// blocks and writes the two slot rows, 4 R H D itemsize bytes in all: at the
// full-width decode shape (R = B K = 320, H = 8, D = 64, bf16) 1.31 MB, about
// 0.39 us at 3.35 TB/s, and at llama_1b's decode (R = 8, H = 4) 16 KB. Both
// lie below what one kernel node of a CUDA graph costs, so the time is the
// launch's and one round trip to memory. The design aims at those:
//
// - One wave sized to the card: a block of bx x by threads, bx a row's
//   vectors (up to 256), by rows of R H; by from the SM count, so that the
//   rows spread over every SM (at least a warp a block); a grid-stride loop
//   over rows covers what one wave of resident threads does not. 32-bit
//   index math, no division: the row from the block and threadIdx.y, the
//   vector from threadIdx.x. A thread issues its K and V loads before its
//   stores, so all of its traffic is in flight at once.
// - L2 policy: the default for both sides. An evict-first, no-L1 read of
//   the new blocks (read once) and an evict-last store of the cache rows
//   (read by the attention right after) each read within 0.5 % of plain
//   accesses on the card (PERF.md), so neither is taken.
// - Programmatic dependent launch: the kernel is launched with
//   cudaLaunchAttributeProgrammaticStreamSerialization and runs
//   griddepcontrol.wait before its first read, so its launch and setup
//   overlap the drain of the kernel before it (eagerly and in a CUDA graph,
//   where the launch becomes a programmatic edge). The wait returns once
//   that kernel has finished and its writes are visible, so the result is
//   ordered behind its producer whatever it is. What it buys depends on
//   that kernel: the K/V projection and RoPE come from cuBLAS and PyTorch's
//   elementwise kernels, which never trigger early, so the overlap is the
//   launch latency behind their last blocks' exit, not their work.
//
// 16-byte vectors where D itemsize is a multiple of 16 (and both caches and
// new blocks are 16-byte aligned), one element per thread otherwise. K and V
// share the thread: one launch per layer and step. The slot index is passed
// by value and checked by the wrapper (0 <= index < L).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BX = 256;        // a row's vectors a block row takes at most
constexpr int MIN_THREADS = 32;    // a block fills at least one warp
constexpr int MAX_THREADS = 1024;
constexpr int THREADS_PER_SM = 2048;

// Rows of row_vecs vectors T: row r of the new blocks (r row_vecs on) into
// slot `index` of cache row r ((r slots + index) row_vecs on).
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    slot_write_kernel(T* __restrict__ k_cache, T* __restrict__ v_cache,
                      const T* __restrict__ k_new, const T* __restrict__ v_new, int rows,
                      int row_vecs, int slots, int index) {
  // launched before the kernel ahead of it has drained (programmatic
  // dependent launch): wait until it has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int step = gridDim.x * blockDim.y;
  for (int row = blockIdx.x * blockDim.y + threadIdx.y; row < rows; row += step) {
    const T* kn = k_new + (int64_t)row * row_vecs;
    const T* vn = v_new + (int64_t)row * row_vecs;
    const int64_t dst = ((int64_t)row * slots + index) * row_vecs;
    for (int col = threadIdx.x; col < row_vecs; col += blockDim.x) {
      const T k = kn[col], v = vn[col];
      k_cache[dst + col] = k;
      v_cache[dst + col] = v;
    }
  }
}

// The launch's floor: the same configuration and attributes, no work but
// the wait that orders the kernel behind the one before it.
__global__ void __launch_bounds__(MAX_THREADS) floor_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The card's SM count, read once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      return 132;
    counts[dev] = n;
  }
  return counts[dev];
}

// The launch of `rows` rows of `row_vecs` vectors: block (bx, by), grid.
struct Plan {
  dim3 grid, block;
};

Plan plan(int rows, int row_vecs) {
  const int sms = sm_count();
  const int bx = row_vecs < MAX_BX ? row_vecs : MAX_BX;
  int by = (rows + sms - 1) / sms;                     // rows an SM takes
  const int least = (MIN_THREADS + bx - 1) / bx;
  if (by < least) by = least;
  if (by > MAX_THREADS / bx) by = MAX_THREADS / bx;
  int blocks = (rows + by - 1) / by;
  const int wave = sms * (THREADS_PER_SM / (bx * by));   // resident at once
  if (blocks > wave) blocks = wave;                     // the loop covers the rest
  if (blocks < 1) blocks = 1;
  return {dim3((unsigned)blocks), dim3((unsigned)bx, (unsigned)by)};
}

// A launch of `kernel` by plan p as a programmatic dependent of the kernel
// before it on the stream.
template <typename K, typename... Args>
cudaError_t launch_pdl(K kernel, const Plan& p, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = p.block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* k_cache, void* v_cache, const void* k_new, const void* v_new, int rows,
                   int row_vecs, int slots, int index, cudaStream_t stream) {
  return launch_pdl(slot_write_kernel<T>, plan(rows, row_vecs), stream, static_cast<T*>(k_cache),
                    static_cast<T*>(v_cache), static_cast<const T*>(k_new),
                    static_cast<const T*>(v_new), rows, row_vecs, slots, index);
}

// The vector type and row length of a write: 16-byte vectors where the rows
// and every pointer allow them, else elements; 0 for arguments the kernel
// does not take.
int vector_bytes(void* k_cache, void* v_cache, const void* k_new, const void* v_new,
                 int64_t rows, int64_t slots, int64_t head_dim, int64_t itemsize, int64_t index) {
  constexpr int64_t INT_LIMIT = 0x7fffffff;   // the kernel's int operands
  if (rows < 0 || slots <= 0 || head_dim <= 0 || index < 0 || index >= slots ||
      (itemsize != 2 && itemsize != 4) || rows > INT_LIMIT || slots > INT_LIMIT ||
      head_dim > INT_LIMIT / 4)
    return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k_cache) |
                          reinterpret_cast<uintptr_t>(v_cache) |
                          reinterpret_cast<uintptr_t>(k_new) | reinterpret_cast<uintptr_t>(v_new);
  return (head_dim * itemsize) % 16 == 0 && align % 16 == 0 ? 16 : (int)itemsize;
}

}  // namespace

extern "C" {

// rows = R*H, slots = L, head_dim = D, itemsize in bytes (2 or 4).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int cache_slot_write(void* k_cache, void* v_cache, const void* k_new, const void* v_new,
                     int64_t rows, int64_t slots, int64_t head_dim, int64_t itemsize,
                     int64_t index, void* stream) {
  const int vec =
      vector_bytes(k_cache, v_cache, k_new, v_new, rows, slots, head_dim, itemsize, index);
  if (vec == 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_vecs = (int)(head_dim * itemsize / vec);
  if (vec == 16)
    return (int)launch<int4>(k_cache, v_cache, k_new, v_new, (int)rows, row_vecs, (int)slots,
                             (int)index, s);
  if (vec == 2)
    return (int)launch<uint16_t>(k_cache, v_cache, k_new, v_new, (int)rows, row_vecs,
                                 (int)slots, (int)index, s);
  return (int)launch<uint32_t>(k_cache, v_cache, k_new, v_new, (int)rows, row_vecs, (int)slots,
                               (int)index, s);
}

// The empty kernel of cache_slot_write's launch (the same grid, block and
// attribute) for the same arguments: what a launch costs with no work.
int cache_slot_write_floor(void* k_cache, void* v_cache, const void* k_new, const void* v_new,
                           int64_t rows, int64_t slots, int64_t head_dim, int64_t itemsize,
                           int64_t index, void* stream) {
  const int vec =
      vector_bytes(k_cache, v_cache, k_new, v_new, rows, slots, head_dim, itemsize, index);
  if (vec == 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  return (int)launch_pdl(floor_kernel, plan((int)rows, (int)(head_dim * itemsize / vec)),
                         static_cast<cudaStream_t>(stream));
}

const char* cache_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
