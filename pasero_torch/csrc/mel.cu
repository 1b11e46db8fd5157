// Fused STFT power and mel filterbank: for every frame (n_fft samples of the
// reflect-padded waveform, hop apart, the last frame dropped) y = frame *
// window, and
//
//     mel[b, t, :] = |DFT(y)[0 .. n_freq)|^2 @ mel_w
//
// with n_freq = n_fft / 2 + 1 and the Slaney filterbank mel_w (n_freq,
// n_mels), all float32. Frame t of utterance b starts at padded sample
// t * hop; padded sample p is waveform sample reflect(p - n_fft / 2), so the
// caller passes the raw (B, N) waveform and the window.
//
// Replaces the TPU kernel pasero_tpu/ops/mel.py:_mel_kernel (called through
// _fused_power_mel), which multiplies materialized (B, T, n_fft) frames by
// the windowed DFT bases and keeps the (256, n_freq) power block in VMEM.
// Here a block reads the waveform its frames cover and the power tile never
// leaves shared memory: device memory sees the waveform, the window, one
// twiddle table and the filterbank, and the mel output.
//
// The DFT is factored, n_fft = P * Q (400 = 20 x 20), in float32 on the CUDA
// cores: with n = Q n1 + n2 and k1 = k mod P,
//
//     A[n2][k1] = sum_n1 y[Q n1 + n2] e^(-2 pi i n1 k1 / P)     (P-point DFTs)
//     X[k]      = sum_n2 A[n2][k mod P] e^(-2 pi i n2 k / n_fft)
//
// since n k = Q n1 k1 + n2 k (mod n_fft). y is real, so A[n2][P - k1] is the
// conjugate of A[n2][k1] and only k1 <= P / 2 is computed. Every factor is
// an entry of one table, e^(-2 pi i j / n_fft) for j < n_fft, computed on
// the host in float64 and rounded once to float32 (ops/mel.py:_twiddles),
// with the quarter turns exact: j = 0 is (1, 0), so the imaginary parts of
// bin 0 and of the Nyquist bin are exact zeros, as the dense product's are.
//
// What bounds it: operations. Per frame 4 Q (P / 2 + 1) P flops for the
// P-point DFTs, 8 Q n_freq for the second stage, 3 n_freq for the power and
// 2 per nonzero span bin of the filterbank for the mel product (391 bins of
// 16,080 for Whisper's 80 filters): 51,145 at Whisper's (400, 201, 80),
// against 353,760 for the dense DFT and mel products it replaces, and
// 0.97 kB moved per frame (160 new samples in, 80 mels out), 53 flops per
// byte: above the float32 ridge of the CUDA cores (67 TFLOP/s / 3.35 TB/s =
// 20). An FFT of 400 points needs 2.5 n_fft log2 n_fft = 8,644 flops in
// place of the first two stages (49,760). Float32 FMAs, not TF32 tensor
// cores: bins near the clamp floor (8 decades under an utterance's peak)
// come out of cancelling sums, and TF32 keeps three decimal digits. At one
// wav the card is not filled with work for long: the time is the latency of
// a block's phases more than its operations.
//
// Design: one block of 256 threads per 12 frames of one utterance, so one
// 30 s wav (3000 frames) is 250 blocks, about two on each of the 132 SMs;
// a block takes about 100 KB of shared memory at Whisper's shape, so two
// fit on an SM.
// 0. every input a block reads goes to shared memory by cp.async copies
//    issued at its start, so their latencies overlap: the waveform strip its
//    frames cover (11 hop + n_fft samples, reflect padding by index, zeros
//    past the utterance's last frame), the window, the twiddle table and,
//    in a second group that lands during steps 1-3, the filterbank;
// 1. the P x (P / 2 + 1) small DFT matrix, taken from the twiddle table;
// 2. one thread per (frame, n2) computes the P-point DFT of its windowed
//    column (P samples in registers, the matrix read as a broadcast) into A;
// 3. one thread per bin k keeps its Q twiddles e^(-2 pi i n2 k / n_fft) in
//    registers and sums Q complex products per frame, then writes the power
//    re^2 + im^2 over the dead strip;
// 4. the mel product: thread (m, g) finds the first and last nonzero
//    weight of filterbank column m (a Slaney filter spans a few bins) and
//    sums frames g, g + G, ... of column m over that span only, which gives
//    the bits of the dense sum (the terms it skips add exact zeros).
// Sums run over n1, n2 and k in order, one FMA each. log10, the
// per-utterance clamp and the scale stay with the caller, as JAX keeps them
// outside its kernel: the clamp's maximum spans the whole utterance, so no
// tile may take it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 12;                 // frames per block
constexpr int kThreads = 256;
constexpr int kMaxMels = 128;               // at least two frame groups
constexpr int kMelRows = (kFrames + 1) / 2; // frames per thread in step 4

__device__ __forceinline__ int64_t reflect(int64_t s, int64_t n) {
  if (s < 0) s = -s;
  if (s >= n) s = 2 * (n - 1) - s;
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 or 16 bytes global -> shared; valid = false writes zeros, reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's shared memory, in floats: the twiddle table (2 N), the small
// DFT matrix (2 P KH), A (2 kFrames Q KH), the filterbank (n_freq n_mels,
// 16-byte aligned), then the strip and the window, whose space the power
// tile (kFrames n_freq) takes after step 2.
struct Layout {
  int tw, dft, a, melw, strip, window, total;
};

template <int P, int Q>
__host__ __device__ inline Layout layout(int hop, int n_mels) {
  constexpr int N = P * Q, KH = P / 2 + 1, NFREQ = N / 2 + 1;
  Layout l;
  l.tw = 0;
  l.dft = 2 * N;
  l.a = l.dft + 2 * P * KH;
  l.melw = (l.a + 2 * kFrames * Q * KH + 3) & ~3;
  l.strip = l.melw + ((NFREQ * n_mels + 3) & ~3);
  const int strip_len = (kFrames - 1) * hop + N;
  l.window = l.strip + strip_len;
  const int end = l.window + N, pw_end = l.strip + kFrames * NFREQ;
  l.total = end > pw_end ? end : pw_end;
  return l;
}

template <int P, int Q>
__global__ void __launch_bounds__(kThreads, 2)
power_mel_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                 const float2* __restrict__ twiddle, const float* __restrict__ mel_w,
                 float* __restrict__ out, int64_t n_samples, int hop, int n_mels,
                 int n_frames) {
  constexpr int N = P * Q;
  constexpr int KH = P / 2 + 1;            // k1 = 0 .. P / 2; the rest conjugates
  constexpr int NFREQ = N / 2 + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout l = layout<P, Q>(hop, n_mels);
  float2* tw = reinterpret_cast<float2*>(smem + l.tw);     // N
  float2* dft = reinterpret_cast<float2*>(smem + l.dft);   // P x KH
  float2* A = reinterpret_cast<float2*>(smem + l.a);       // kFrames x Q x KH
  float* melw = smem + l.melw;                             // NFREQ x n_mels
  float* strip = smem + l.strip;
  float* win = smem + l.window;
  float* pw = strip;                                       // kFrames x NFREQ, after step 2

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const float* x = audio + (int64_t)b * n_samples;

  // 0. the strip, the window and the twiddles; then the filterbank
  const int strip_len = (kFrames - 1) * hop + N;
  const int64_t s0 = (int64_t)f0 * hop - N / 2;
#pragma unroll 4
  for (int i = tid; i < strip_len; i += kThreads) {
    const int64_t s = s0 + i;
    const bool ok = s < n_samples + N / 2;   // else past the last frame's reach
    cp_async4(strip + i, ok ? x + reflect(s, n_samples) : x, ok);
  }
  for (int i = tid; i < N; i += kThreads) cp_async4(win + i, window + i, true);
  for (int i = tid; i < N / 2; i += kThreads) cp_async16(tw + 2 * i, twiddle + 2 * i);
  cp_async_commit();
  const int wn = NFREQ * n_mels;
  const bool vec = (reinterpret_cast<uintptr_t>(mel_w) & 15) == 0;
  const int w4 = vec ? wn / 4 : 0;
#pragma unroll 4
  for (int i = tid; i < w4; i += kThreads) cp_async16(melw + 4 * i, mel_w + 4 * i);
  for (int i = 4 * w4 + tid; i < wn; i += kThreads) cp_async4(melw + i, mel_w + i, true);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 1. the small DFT matrix
  for (int i = tid; i < P * KH; i += kThreads) {
    const int n1 = i / KH, kk = i - n1 * KH;
    dft[i] = tw[(Q * n1 * kk) % N];   // e^(-2 pi i n1 kk / P)
  }
  __syncthreads();

  // 2. the P-point DFTs of the windowed columns, k1 <= P / 2
  for (int item = tid; item < kFrames * Q; item += kThreads) {
    const int f = item / Q, n2 = item - f * Q;
    float y[P];
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) y[n1] = strip[f * hop + Q * n1 + n2] * win[Q * n1 + n2];
    float2* a = A + item * KH;
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int n1 = 0; n1 < P; ++n1) {
        const float2 t = dft[n1 * KH + kk];
        re = fmaf(y[n1], t.x, re);
        im = fmaf(y[n1], t.y, im);
      }
      a[kk] = make_float2(re, im);
    }
  }
  __syncthreads();   // the strip is dead: the power tile takes its place

  // 3. the bins: X[k] = sum_n2 A[n2][k mod P] e^(-2 pi i n2 k / N), then power
  for (int k = tid; k < NFREQ; k += kThreads) {
    const int k1 = k % P;
    const bool conj = k1 > P / 2;
    const int kk = conj ? P - k1 : k1;
    const float sgn = conj ? -1.f : 1.f;
    float2 w[Q];
    int j = 0;
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) {
      w[n2] = tw[j];
      j += k;
      if (j >= N) j -= N;
    }
    for (int f = 0; f < kFrames; ++f) {
      const float2* a = A + f * Q * KH + kk;
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < Q; ++n2) {
        const float2 v = a[n2 * KH];
        const float vi = sgn * v.y;
        re = fmaf(v.x, w[n2].x, re);
        re = fmaf(-vi, w[n2].y, re);
        im = fmaf(v.x, w[n2].y, im);
        im = fmaf(vi, w[n2].x, im);
      }
      pw[f * NFREQ + k] = re * re + im * im;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. the mel product over each column's nonzero span: thread (m, g) owns
  // frames g, g + groups, ...
  const int groups = kThreads / n_mels;   // >= 2
  const int m = tid % n_mels, g = tid / n_mels;
  if (g >= groups) return;
  int lo = NFREQ, hi = 0;
#pragma unroll 8
  for (int k = 0; k < NFREQ; ++k)
    if (melw[k * n_mels + m] != 0.f) {
      lo = min(lo, k);
      hi = k + 1;
    }
  float acc[kMelRows];
#pragma unroll
  for (int i = 0; i < kMelRows; ++i) acc[i] = 0.f;
  for (int k = lo; k < hi; ++k) {
    const float wv = melw[k * n_mels + m];
#pragma unroll
    for (int i = 0; i < kMelRows; ++i) {
      const int f = g + groups * i;
      if (f < kFrames) acc[i] = fmaf(pw[f * NFREQ + k], wv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMelRows; ++i) {
    const int f = g + groups * i;
    if (f < kFrames && f0 + f < n_frames)
      out[((int64_t)b * n_frames + f0 + f) * n_mels + m] = acc[i];
  }
}

template <int P, int Q>
cudaError_t launch(const float* audio, const float* window, const float2* twiddle,
                   const float* mel_w, float* out, int batch, int64_t n_samples, int hop,
                   int n_mels, int n_frames, cudaStream_t stream) {
  const size_t bytes = 4 * (size_t)layout<P, Q>(hop, n_mels).total;
  if (bytes > 232448) return cudaErrorInvalidValue;
  // opt in to the largest size launched so far, so graph captures of the
  // same shapes make no attribute call
  static size_t allowed = 0;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        power_mel_kernel<P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  power_mel_kernel<P, Q><<<grid, kThreads, bytes, stream>>>(
      audio, window, twiddle, mel_w, out, n_samples, hop, n_mels, n_frames);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// audio (B, N), window (n_fft), twiddle (n_fft, 2) = e^(-2 pi i j / n_fft),
// mel_w (n_fft / 2 + 1, n_mels) and out (B, n_frames, n_mels): contiguous
// float32 on the current device. n_fft is 256, 400 or 512 (the factorings
// compiled here), n_mels <= 128, N > n_fft / 2.
int power_mel(const void* audio, const void* window, const void* twiddle,
              const void* mel_w, void* out, int batch, int64_t n_samples, int n_fft,
              int hop, int n_mels, int n_frames, void* stream) {
  if (n_mels <= 0 || n_mels > kMaxMels || n_frames <= 0 || batch <= 0 || hop <= 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                           \
  (const float*)audio, (const float*)window, (const float2*)twiddle, (const float*)mel_w, \
      (float*)out, batch, n_samples, hop, n_mels, n_frames, (cudaStream_t)stream
  switch (n_fft) {
    case 256: return (int)launch<16, 16>(ARGS);
    case 400: return (int)launch<20, 20>(ARGS);
    case 512: return (int)launch<16, 32>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

const char* mel_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
