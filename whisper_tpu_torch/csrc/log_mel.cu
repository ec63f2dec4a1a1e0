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
// and 3.35 TB/s).  So the design keeps the FMA units fed:
//   * the card filled: 36 frames a CTA of 9 warps and 90 KB of shared
//     memory, two CTAs an SM; 60 s (8,960 frames) is 249 CTAs, one wave on
//     the 264 slots of 132 SMs (32 frames gave 280: a second wave of 16
//     CTAs doubled the time).  The frame count needs no multiple: frames
//     past it read as zero and are not stored;
//   * the frames built once in shared memory, windowed as they are loaded
//     (36 x 400 f32: a sample belongs to 2-3 frames at different window
//     positions, so the frames are stored, not the shared samples);
//   * the bases (643 KB, the same for every CTA, so they sit in L2) stream
//     through a double buffer of 8-row tiles, cos and sin of a bin side by
//     side (201 bins padded with zeros to 224), by 4-byte `cp.async` (the
//     rows are 804 bytes apart, too ragged for wider copies or TMA): tile
//     t + 1 is in flight while tile t is used, one barrier a tile;
//   * an outer-product tile in registers: a warp owns 4 frames, a lane 7
//     bins (lane + 32 j), so a thread keeps 4 x 7 re and im sums, and every
//     4 samples it reads 4 float4 of frames (a broadcast to the warp) and
//     28 (cos, sin) pairs (one conflict-free row piece a warp) for 224
//     FMAs;
//   * the power (36 x 228 f32, rows padded so 4 frames' rows fall in other
//     banks) overwrites the bases' buffers; the filterbank comes in chunks
//     of bins into the frames' buffer, and a thread sums 4 frames x 4 mels
//     (128 mels) or 2 x 5 (80).
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
constexpr int kFramesPerWarp = 4;
constexpr int kWarps = 9;
constexpr int kFrames = kWarps * kFramesPerWarp;   // 36 frames per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kPadBins = 224;                // 7 bins a lane, 32 lanes
constexpr int kBinsPerLane = kPadBins / 32;  // 7
constexpr int kTileRows = 8;                 // basis rows per tile
constexpr int kTiles = kFft / kTileRows;     // 50
constexpr int kPowerLd = 228;                // power row stride (floats)
constexpr int kFbBins = 204;                 // 201 bins rounded up to 4

constexpr int kFrameFloats = kFrames * kFft;            // 14,400
constexpr int kTileFloats = kTileRows * kPadBins * 2;   // [row][bin][cos, sin]
constexpr int kPowerFloats = kFrames * kPowerLd;        // 8,208
// two stages of the bases, or the power over them
constexpr int kBasisFloats =
    2 * kTileFloats > kPowerFloats ? 2 * kTileFloats : kPowerFloats;
constexpr size_t kSmemBytes = (kFrameFloats + kBasisFloats) * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One f32 from global `src` to shared `dst`, asynchronous; cp.async.wait_all
// makes this thread's copies visible to it
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Grid ceil(n_frames / 36): frames [36 b, 36 b + 36) of CTA b.
template <int kMel>
__global__ void __launch_bounds__(kThreads, 2)
log_mel_kernel(const float* __restrict__ rows0, int ld0,
               const float* __restrict__ rows1, int ld1,
               const float* __restrict__ rows2, int ld2,
               const float* __restrict__ hann, const float* __restrict__ cos_b,
               const float* __restrict__ sin_b,
               const float* __restrict__ filters_t, float* __restrict__ out,
               int n_frames) {
  // the filterbank's thread tile: kMelLanes lanes of mels, each kMelPer
  // mels (m = lane + kMelLanes j), times kFbFrames frames
  constexpr int kMelLanes = kMel % 32 == 0 ? 32 : 16;
  constexpr int kMelPer = kMel / kMelLanes;
  constexpr int kFbFrames = kFrames * kMelLanes / kThreads;
  static_assert(kMel % kMelLanes == 0 && kFrames * kMelLanes % kThreads == 0,
                "filterbank tile");
  constexpr int kChunkBins = kFrameFloats / kMel / 4 * 4;   // a chunk of rows

  extern __shared__ __align__(16) float smem[];
  float* frames = smem;                        // [f][n], windowed
  float* basis = frames + kFrameFloats;        // [stage][row][bin][cos, sin]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int f0 = blockIdx.x * kFrames;

  // tile t of cos and sin into stage t % 2, a bin a thread (bins past 201
  // stay the zeros written below)
  auto request = [&](int t) {
    if (tid >= kBins) return;
    float* dst = basis + (t % 2) * kTileFloats + 2 * tid;
    const size_t src = (size_t)t * kTileRows * kBins + tid;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      cp_async4(dst + r * 2 * kPadBins, cos_b + src + r * kBins);
      cp_async4(dst + r * 2 * kPadBins + 1, sin_b + src + r * kBins);
    }
  };
  request(0);
  constexpr int kPad = 2 * (kPadBins - kBins);   // floats past 201 bins a row
  for (int i = tid; i < 2 * kTileRows * kPad; i += kThreads)
    basis[(i / kPad) * 2 * kPadBins + 2 * kBins + i % kPad] = 0.f;
  for (int i = tid; i < kFrameFloats; i += kThreads) {
    const int f = i / kFft;
    const int n = i % kFft;
    const int r = f0 + f;
    float x = 0.f;
    if (r < n_frames)
      x = n < kHop       ? rows0[(size_t)r * ld0 + n]
          : n < 2 * kHop ? rows1[(size_t)r * ld1 + n - kHop]
                         : rows2[(size_t)r * ld2 + n - 2 * kHop];
    frames[i] = x * hann[n];
  }

  // the DFT: warp w's frames 4 w .. + 3, lane's bins lane + 32 j
  float re[kFramesPerWarp][kBinsPerLane] = {};
  float im[kFramesPerWarp][kBinsPerLane] = {};
  const float* fr = frames + warp * kFramesPerWarp * kFft;
  for (int t = 0; t < kTiles; ++t) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();   // tile t is in; every thread is done with tile t - 1
    if (t + 1 < kTiles) request(t + 1);
    const float* cs = basis + (t % 2) * kTileFloats + 2 * lane;
    const int n0 = t * kTileRows;
#pragma unroll
    for (int nn = 0; nn < kTileRows; nn += 4) {
      float4 x[kFramesPerWarp];
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f)
        x[f] = *reinterpret_cast<const float4*>(fr + f * kFft + n0 + nn);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float c[kBinsPerLane], s[kBinsPerLane];
#pragma unroll
        for (int j = 0; j < kBinsPerLane; ++j) {
          const float2 cs2 = *reinterpret_cast<const float2*>(
              cs + ((nn + u) * kPadBins + 32 * j) * 2);
          c[j] = cs2.x;
          s[j] = cs2.y;
        }
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f) {
          const float xv = u == 0 ? x[f].x : u == 1 ? x[f].y : u == 2 ? x[f].z : x[f].w;
#pragma unroll
          for (int j = 0; j < kBinsPerLane; ++j) {
            re[f][j] = fmaf(xv, c[j], re[f][j]);
            im[f][j] = fmaf(xv, s[j], im[f][j]);
          }
        }
      }
    }
  }

  // the power over the bases' buffers, once every thread is done with them
  __syncthreads();
  float* power = basis;                        // [f][kPowerLd]
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f)
#pragma unroll
    for (int j = 0; j < kBinsPerLane; ++j)
      power[(warp * kFramesPerWarp + f) * kPowerLd + lane + 32 * j] =
          re[f][j] * re[f][j] + im[f][j] * im[f][j];

  // mel = power . filters_t, the filterbank read in chunks of bins into the
  // frames' buffer (free from here on); rows past 201 are zeros, as are
  // the power's bins past 201
  float* filt = frames;
  const int ml = tid % kMelLanes;
  const int fb0 = (tid / kMelLanes) * kFbFrames;
  float acc[kFbFrames][kMelPer] = {};
  for (int c0 = 0; c0 < kFbBins; c0 += kChunkBins) {
    const int nb = min(kChunkBins, kFbBins - c0);
    __syncthreads();   // power complete / the previous chunk consumed
    for (int i = tid; i < nb * kMel; i += kThreads)
      filt[i] = c0 + i / kMel < kBins ? filters_t[(size_t)c0 * kMel + i] : 0.f;
    __syncthreads();
    for (int b = 0; b < nb; b += 4) {
      float4 p[kFbFrames];
#pragma unroll
      for (int f = 0; f < kFbFrames; ++f)
        p[f] = *reinterpret_cast<const float4*>(power + (fb0 + f) * kPowerLd + c0 + b);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < kMelPer; ++j) {
          const float w = filt[(b + u) * kMel + ml + kMelLanes * j];
#pragma unroll
          for (int f = 0; f < kFbFrames; ++f) {
            const float pv = u == 0 ? p[f].x : u == 1 ? p[f].y : u == 2 ? p[f].z : p[f].w;
            acc[f][j] = fmaf(pv, w, acc[f][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kFbFrames; ++f) {
    const int r = f0 + fb0 + f;
    if (r >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < kMelPer; ++j)
      out[(size_t)r * kMel + ml + kMelLanes * j] = log10f(fmaxf(acc[f][j], 1e-10f));
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
  // all of the SM's 228 KB as shared memory, so two CTAs fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(log_mel_kernel<kMel>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  log_mel_kernel<kMel><<<(n_frames + kFrames - 1) / kFrames, kThreads, kSmemBytes,
                         stream>>>(rows0, ld0, rows1, ld1, rows2, ld2, hann, cos_b,
                                   sin_b, filters_t, out, n_frames);
  return (int)cudaGetLastError();
}

}  // namespace

// rows0/rows1 (n_frames, 160) and rows2 (n_frames, 80) f32 with row
// strides ld0/ld1/ld2 (elements); hann (400,); cos_b/sin_b (400, 201);
// filters_t (201, n_mel); out (n_frames, n_mel), all f32 and contiguous
// but the rows.  n_frames >= 1; n_mel 80 or 128.
extern "C" int wtt_log_mel(const void* rows0, int ld0, const void* rows1,
                           int ld1, const void* rows2, int ld2,
                           const void* hann, const void* cos_b,
                           const void* sin_b, const void* filters_t, void* out,
                           int n_frames, int n_mel, void* stream) {
  if (n_frames < 1) return (int)cudaErrorInvalidValue;
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
