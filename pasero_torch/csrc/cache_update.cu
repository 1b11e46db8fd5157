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
// What bounds it: bytes. Each launch reads the two new blocks and writes the
// two slot rows, 4 * R*H*D*itemsize bytes in all. At the full-width decode
// shape (R = B*K = 320, H = 8, D = 64, bf16) that is 2 x 327,680 B read and
// 2 x 327,680 B written, 1.31 MB, about 0.39 us at 3.35 TB/s: far below the
// few microseconds a launch costs, so the kernel is launch-bound. The remedy
// is to remove launches, not bytes: capture the decode step in a CUDA graph
// (the slot index then becomes a device scalar), or fuse the write into the
// epilogue of the K/V projection.
//
// Design: threads cover R*H*D in 16-byte vectors where D*itemsize is a
// multiple of 16 (and both caches and new blocks are 16-byte aligned), one
// element per thread otherwise. K and V share the thread: one launch per
// layer and step. The slot index is passed by value and checked by the
// wrapper (0 <= index < L).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void slot_write_kernel(T* __restrict__ k_cache,
                                  T* __restrict__ v_cache,
                                  const T* __restrict__ k_new,
                                  const T* __restrict__ v_new,
                                  int64_t rows, int64_t row_vecs,
                                  int64_t slots, int64_t index) {
  const int64_t total = rows * row_vecs;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / row_vecs;
    const int64_t col = i - row * row_vecs;
    const int64_t dst = (row * slots + index) * row_vecs + col;
    k_cache[dst] = k_new[i];
    v_cache[dst] = v_new[i];
  }
}

template <typename T>
cudaError_t launch(void* k_cache, void* v_cache, const void* k_new,
                   const void* v_new, int64_t rows, int64_t row_vecs,
                   int64_t slots, int64_t index, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = rows * row_vecs;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  slot_write_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(k_cache), static_cast<T*>(v_cache),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), rows,
      row_vecs, slots, index);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows = R*H, slots = L, head_dim = D, itemsize in bytes (2 or 4).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int cache_slot_write(void* k_cache, void* v_cache, const void* k_new,
                     const void* v_new, int64_t rows, int64_t slots,
                     int64_t head_dim, int64_t itemsize, int64_t index,
                     void* stream) {
  if (rows < 0 || slots <= 0 || head_dim <= 0 || index < 0 || index >= slots ||
      (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = head_dim * itemsize;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k_cache) |
                          reinterpret_cast<uintptr_t>(v_cache) |
                          reinterpret_cast<uintptr_t>(k_new) |
                          reinterpret_cast<uintptr_t>(v_new);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return (int)launch<int4>(k_cache, v_cache, k_new, v_new, rows,
                             row_bytes / 16, slots, index, s);
  if (itemsize == 2)
    return (int)launch<uint16_t>(k_cache, v_cache, k_new, v_new, rows,
                                 head_dim, slots, index, s);
  return (int)launch<uint32_t>(k_cache, v_cache, k_new, v_new, rows, head_dim,
                               slots, index, s);
}

const char* cache_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
