// Log-mel spectrogram blocks, kernel K7 of whisper_tpu_torch.
//
// Replaces whisper_tpu/ops/mel_pallas.py `_mel_blocks` / `_mel_kernel`
// (Pallas, TPU): per frame, the 400 samples of three row slices (rows0 and
// rows1 give 160 each, rows2 the first 80), times the periodic Hann
// window, the real DFT as products with the (400 x 201) cos and sin bases,
// the power re^2 + im^2, the (201 x n_mel) filterbank product and
// log10(max(., 1e-10)).  All in full float32 on CUDA cores: no TF32, no
// tensor cores, as the TPU kernel computes at HIGHEST precision (the
// result feeds log10 and a global-max clamp).
//
// Bound on the H100: operations.  Per frame 2 x 400 x 201 multiply-adds
// for the DFT and 201 x n_mel for the filterbank, ~41 FLOP per byte of
// input at n_mel = 128, above the f32 ridge (~20 FLOP/byte at 67 TFLOP/s
// and 3.35 TB/s).  Design: one block of 256 threads per 64 frames.  The
// block's frames are built in shared memory, windowed as they are loaded
// (64 x 400 f32, 100 KB: a sample belongs to 2-3 frames at different
// window positions, so the frames are stored, not the shared samples).
// The bases (643 KB in all) stream from L2 in (80 x 32) tiles of cos and
// sin; a thread accumulates 8 frames x 1 bin of re and im in registers,
// reading 4 consecutive samples of a frame as one float4.  The power goes
// to shared memory (64 x 201 f32, 50 KB), then the filterbank, loaded into
// the frame buffer in chunks of bins, gives each thread n_mel / 4 outputs.
// No frame matrix, spectrum or power ever reaches device memory.
//
// Plain C entry point for ctypes; launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHop = 160;
constexpr int kFft = 400;
constexpr int kBins = kFft / 2 + 1;          // 201
constexpr int kFrames = 64;                  // frames per block
constexpr int kThreads = 256;
constexpr int kBinTile = 32;                 // DFT bins per pass
constexpr int kRows = 80;                    // basis rows per tile
constexpr int kFramesPerThread = kFrames * kBinTile / kThreads;   // 8

constexpr int kFrameFloats = kFrames * kFft;        // 25,600
constexpr int kBasisFloats = kRows * kBinTile;      // 2,560 each
constexpr size_t kSmemBytes =
    (kFrameFloats + 2 * kBasisFloats + kFrames * kBins) * sizeof(float);

template <int kMel>
__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ rows0, int ld0,
               const float* __restrict__ rows1, int ld1,
               const float* __restrict__ rows2, int ld2,
               const float* __restrict__ hann, const float* __restrict__ cos_b,
               const float* __restrict__ sin_b,
               const float* __restrict__ filters_t, float* __restrict__ out) {
  static_assert(kFrames * kMel % kThreads == 0, "outputs per thread");
  constexpr int kOut = kFrames * kMel / kThreads;
  constexpr int kChunkBins = kFrameFloats / kMel;   // filterbank bins per load

  extern __shared__ __align__(16) float smem[];
  float* frames = smem;                       // [f][n], windowed
  float* cos_s = frames + kFrameFloats;       // [row][bin]
  float* sin_s = cos_s + kBasisFloats;
  float* power = sin_s + kBasisFloats;        // [f][bin]

  const int tid = threadIdx.x;
  const size_t f0 = (size_t)blockIdx.x * kFrames;

  for (int i = tid; i < kFrameFloats; i += kThreads) {
    const int f = i / kFft;
    const int n = i % kFft;
    const size_t r = f0 + f;
    const float x = n < kHop       ? rows0[r * ld0 + n]
                    : n < 2 * kHop ? rows1[r * ld1 + n - kHop]
                                   : rows2[r * ld2 + n - 2 * kHop];
    frames[i] = x * hann[n];
  }

  const int bin_lane = tid % kBinTile;
  const int fbase = (tid / kBinTile) * kFramesPerThread;
  for (int b0 = 0; b0 < kBins; b0 += kBinTile) {
    float re[kFramesPerThread] = {};
    float im[kFramesPerThread] = {};
    for (int n0 = 0; n0 < kFft; n0 += kRows) {
      __syncthreads();   // frames built / the previous basis tile consumed
      for (int i = tid; i < kBasisFloats; i += kThreads) {
        const int bin = b0 + i % kBinTile;
        const size_t src = (size_t)(n0 + i / kBinTile) * kBins + bin;
        cos_s[i] = bin < kBins ? cos_b[src] : 0.f;
        sin_s[i] = bin < kBins ? sin_b[src] : 0.f;
      }
      __syncthreads();
      for (int n = 0; n < kRows; n += 4) {
        float c[4], s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          c[u] = cos_s[(n + u) * kBinTile + bin_lane];
          s[u] = sin_s[(n + u) * kBinTile + bin_lane];
        }
#pragma unroll
        for (int f = 0; f < kFramesPerThread; ++f) {
          const float4 x = *reinterpret_cast<const float4*>(
              frames + (fbase + f) * kFft + n0 + n);
          re[f] = fmaf(x.x, c[0], re[f]);
          im[f] = fmaf(x.x, s[0], im[f]);
          re[f] = fmaf(x.y, c[1], re[f]);
          im[f] = fmaf(x.y, s[1], im[f]);
          re[f] = fmaf(x.z, c[2], re[f]);
          im[f] = fmaf(x.z, s[2], im[f]);
          re[f] = fmaf(x.w, c[3], re[f]);
          im[f] = fmaf(x.w, s[3], im[f]);
        }
      }
    }
    const int bin = b0 + bin_lane;
    if (bin < kBins) {
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f)
        power[(fbase + f) * kBins + bin] = re[f] * re[f] + im[f] * im[f];
    }
  }

  // mel = power . filters_t, the filterbank read in chunks of bins into the
  // frame buffer (free from here on)
  float* filt = frames;
  float acc[kOut] = {};
  for (int c0 = 0; c0 < kBins; c0 += kChunkBins) {
    const int nb = min(kChunkBins, kBins - c0);
    __syncthreads();   // power complete / the previous chunk consumed
    for (int i = tid; i < nb * kMel; i += kThreads)
      filt[i] = filters_t[(size_t)c0 * kMel + i];
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int idx = tid + j * kThreads;
        acc[j] = fmaf(power[(idx / kMel) * kBins + c0 + b],
                      filt[b * kMel + idx % kMel], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int idx = tid + j * kThreads;
    out[(f0 + idx / kMel) * kMel + idx % kMel] = log10f(fmaxf(acc[j], 1e-10f));
  }
}

template <int kMel>
int launch(const float* rows0, int ld0, const float* rows1, int ld1,
           const float* rows2, int ld2, const float* hann, const float* cos_b,
           const float* sin_b, const float* filters_t, float* out,
           int n_frames, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel<kMel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  log_mel_kernel<kMel><<<n_frames / kFrames, kThreads, kSmemBytes, stream>>>(
      rows0, ld0, rows1, ld1, rows2, ld2, hann, cos_b, sin_b, filters_t, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rows0/rows1 (n_frames, 160) and rows2 (n_frames, 80) f32 with row
// strides ld0/ld1/ld2 (elements); hann (400,); cos_b/sin_b (400, 201);
// filters_t (201, n_mel); out (n_frames, n_mel), all f32 and contiguous
// but the rows.  n_frames a multiple of 64; n_mel 80 or 128.
extern "C" int wtt_log_mel(const void* rows0, int ld0, const void* rows1,
                           int ld1, const void* rows2, int ld2,
                           const void* hann, const void* cos_b,
                           const void* sin_b, const void* filters_t, void* out,
                           int n_frames, int n_mel, void* stream) {
  if (n_frames < kFrames || n_frames % kFrames != 0)
    return (int)cudaErrorInvalidValue;
  const float* r0 = static_cast<const float*>(rows0);
  const float* r1 = static_cast<const float*>(rows1);
  const float* r2 = static_cast<const float*>(rows2);
  const float* h = static_cast<const float*>(hann);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  const float* ft = static_cast<const float*>(filters_t);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_mel == 80)
    return launch<80>(r0, ld0, r1, ld1, r2, ld2, h, cb, sb, ft, o, n_frames, s);
  if (n_mel == 128)
    return launch<128>(r0, ld0, r1, ld1, r2, ld2, h, cb, sb, ft, o, n_frames, s);
  return (int)cudaErrorInvalidValue;
}
