// Fused STFT power and mel filterbank: for every frame x (n_fft samples of
// the reflect-padded waveform, hop apart, the last frame dropped)
//
//     mel[b, t, :] = ((x @ cos_b)^2 + (x @ sin_b)^2) @ mel_w
//
// with the windowed DFT bases cos_b, sin_b (n_fft, n_freq) and the Slaney
// filterbank mel_w (n_freq, n_mels), all float32. Frame t of utterance b
// starts at padded sample t * hop; padded sample p is waveform sample
// reflect(p - n_fft / 2), so the caller passes the raw (B, N) waveform.
//
// Replaces the TPU kernel pasero_tpu/ops/mel.py:_mel_kernel (called through
// _fused_power_mel), which takes materialized (B, T, n_fft) frames, 2.5x the
// audio, and keeps the (256, n_freq) power block in VMEM. Here a block reads
// the waveform strip its frames cover and the power tile never leaves shared
// memory: device memory sees the waveform, the bases, the filterbank and the
// mel output only.
//
// What bounds it: operations. Per frame 2 * n_fft * 2 * n_freq flops for the
// two DFT products and 2 * n_freq * n_mels for the mel product, 353,760 at
// Whisper's shape (400, 201, 80), against 0.97 kB of bytes moved (160 new
// samples in, 80 mels out): 365 flops per byte, above the float32 ridge of
// the CUDA cores (67 TFLOP/s / 3.35 TB/s = 20). The products run as float32
// FMAs on the CUDA cores: TF32 keeps about three decimal digits, and bins
// near the clamp floor (8 decades under an utterance's peak) come out of
// large cancelling sums.
//
// Design, for one block of 64 frames of one utterance, 256 threads:
// 1. the strip of 63 * hop + n_fft samples (42 KB at hop 160) is read once
//    into shared memory, reflect-padded by index;
// 2. the DFT products stream the bases through shared memory 16 rows at a
//    time (2 x 400 x 201 x 4 B = 643 KB do not fit); the frequency axis is
//    padded to 224 columns inside the kernel (zero basis columns), so each
//    of the 8 warps owns 8 frames and each lane 7 columns, and keeps their
//    real and imaginary sums (112 registers); a lane's sample is the same
//    for the whole warp (a broadcast), its basis values are consecutive;
// 3. the power tile (64 x 224, row stride 225 against bank conflicts) goes
//    to shared memory;
// 4. the mel product streams the filterbank through the freed strip and
//    basis space; each thread owns 4 frames x up to 8 mel columns.
// Sums run over n and k in order, one FMA each. log10, the per-utterance
// clamp and the scale stay with the caller, as JAX keeps them outside its
// kernel: the clamp's maximum spans the whole utterance, so no tile may
// take it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 64;                 // frames per block
constexpr int kThreads = 256;
constexpr int kCols = 7;                    // frequency columns per lane
constexpr int kFreqPad = 32 * kCols;        // 224 >= n_freq
constexpr int kPowStride = kFreqPad + 1;
constexpr int kChunk = 16;                  // basis rows per shared chunk
constexpr int kRows = kFrames / (kThreads / 32);   // 8 frames per warp
constexpr int kMelRows = kFrames / 16;      // 4 frames per thread
constexpr int kMelCols = 8;                 // n_mels <= 128

__device__ __forceinline__ int64_t reflect(int64_t s, int64_t n) {
  if (s < 0) s = -s;
  if (s >= n) s = 2 * (n - 1) - s;
  return s;
}

__global__ void __launch_bounds__(kThreads, 1)
power_mel_kernel(const float* __restrict__ audio,
                 const float* __restrict__ cos_b,
                 const float* __restrict__ sin_b,
                 const float* __restrict__ mel_w, float* __restrict__ out,
                 int64_t n_samples, int n_fft, int hop, int n_freq,
                 int n_mels, int n_frames, int strip_len) {
  extern __shared__ float smem[];
  float* strip = smem;                              // strip_len
  float* sc = smem + strip_len;                     // kChunk x kFreqPad
  float* ss = sc + kChunk * kFreqPad;               // kChunk x kFreqPad
  float* pw = ss + kChunk * kFreqPad;               // kFrames x kPowStride
  float* melbuf = smem;                             // reuses strip, sc, ss
  const int region = strip_len + 2 * kChunk * kFreqPad;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int pad = n_fft / 2;
  const float* x = audio + (int64_t)b * n_samples;

  // 1. the waveform strip, reflect-padded by index; samples no frame of the
  // utterance reaches (past the last frame, or the chunk's tail) are zero
  const int64_t s0 = (int64_t)f0 * hop - pad;
  for (int i = tid; i < strip_len; i += kThreads) {
    const int64_t s = s0 + i;
    strip[i] = s < n_samples + pad ? __ldg(x + reflect(s, n_samples)) : 0.f;
  }

  // 2. real and imaginary parts of 64 frames x 224 bins
  const int lane = tid & 31, warp = tid >> 5;
  float re[kRows][kCols], im[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) re[i][j] = im[i][j] = 0.f;

  for (int n0 = 0; n0 < n_fft; n0 += kChunk) {
    __syncthreads();   // the strip is written, the last chunk consumed
    for (int i = tid; i < kChunk * kFreqPad; i += kThreads) {
      const int r = i / kFreqPad, k = i - r * kFreqPad;
      const int n = n0 + r;
      const bool ok = n < n_fft && k < n_freq;
      const int64_t at = (int64_t)n * n_freq + k;
      sc[i] = ok ? __ldg(cos_b + at) : 0.f;
      ss[i] = ok ? __ldg(sin_b + at) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      float xv[kRows], cv[kCols], sv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        xv[i] = strip[(warp + 8 * i) * hop + n0 + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        cv[j] = sc[r * kFreqPad + lane + 32 * j];
        sv[j] = ss[r * kFreqPad + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          re[i][j] = fmaf(xv[i], cv[j], re[i][j]);
          im[i][j] = fmaf(xv[i], sv[j], im[i][j]);
        }
    }
  }

  // 3. the power tile, on the chip only
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      pw[(warp + 8 * i) * kPowStride + lane + 32 * j] =
          re[i][j] * re[i][j] + im[i][j] * im[i][j];

  // 4. the mel product, the filterbank streamed through the freed space
  const int mc = tid & 15, mr = tid >> 4;
  const int mel_chunk = region / n_mels;
  float acc[kMelRows][kMelCols];
#pragma unroll
  for (int i = 0; i < kMelRows; ++i)
#pragma unroll
    for (int j = 0; j < kMelCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n_freq; k0 += mel_chunk) {
    const int rows = min(mel_chunk, n_freq - k0);
    __syncthreads();   // the power tile is written, the last chunk consumed
    for (int i = tid; i < rows * n_mels; i += kThreads)
      melbuf[i] = __ldg(mel_w + (int64_t)k0 * n_mels + i);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      float pv[kMelRows], mv[kMelCols];
#pragma unroll
      for (int i = 0; i < kMelRows; ++i)
        pv[i] = pw[(mr + 16 * i) * kPowStride + k0 + r];
#pragma unroll
      for (int j = 0; j < kMelCols; ++j) {
        const int m = mc + 16 * j;
        mv[j] = m < n_mels ? melbuf[r * n_mels + m] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMelRows; ++i)
#pragma unroll
        for (int j = 0; j < kMelCols; ++j)
          acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
    }
  }

  // 5. store the frames of the utterance
#pragma unroll
  for (int i = 0; i < kMelRows; ++i) {
    const int f = f0 + mr + 16 * i;
    if (f >= n_frames) continue;
    float* row = out + ((int64_t)b * n_frames + f) * n_mels;
#pragma unroll
    for (int j = 0; j < kMelCols; ++j) {
      const int m = mc + 16 * j;
      if (m < n_mels) row[m] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// audio (B, N), cos_b/sin_b (n_fft, n_freq), mel_w (n_freq, n_mels) and
// out (B, n_frames, n_mels): contiguous float32 on the current device.
// n_freq <= 224, n_mels <= 128, N > n_fft / 2; strip_len and smem_bytes
// come from the wrapper (pasero_torch/ops/mel.py:_smem_layout).
int power_mel(const void* audio, const void* cos_b, const void* sin_b,
              const void* mel_w, void* out, int batch, int64_t n_samples,
              int n_fft, int hop, int n_freq, int n_mels, int n_frames,
              int strip_len, int smem_bytes, void* stream) {
  if (n_freq > kFreqPad || n_mels > 16 * kMelCols || n_frames <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      power_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  power_mel_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)cos_b, (const float*)sin_b,
      (const float*)mel_w, (float*)out, n_samples, n_fft, hop, n_freq,
      n_mels, n_frames, strip_len);
  return (int)cudaGetLastError();
}

const char* mel_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
