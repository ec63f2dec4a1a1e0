// Block-quantized weight matmul, kernel K3 of whisper_tpu_torch.
//
// Replaces whisper_tpu/ops/quantized.py `quantized_matmul` / `_qmm_kernel`
// and `_qmm_kernel_mins` (Pallas, TPU):
//   y[m, n] = sum_k bf16(x[m, k]) * w[k, n]
//   w[k, n] = bf16(code[k, n] * bf16(scale[k/32, n]))
//             (+ bf16(min[k/32, n]), rounded to bf16 again, with mins)
// x (M, K) bf16; codes (K, N) int8 K-major; scales/mins (K/32, N) f32;
// y (M, N) f32.  The roundings are the TPU kernel's, so only the order of
// the f32 sums differs.
//
// Bound on the H100: device-memory bandwidth.  In the token loop M is the
// batch (1 in whisper_full), so every call streams K*N code bytes for
// 2*M FLOP each.  Design: a block takes 128 output columns and up to 8 rows
// of x; each of its 8 warps takes whole 32-row quantization blocks of K.
// A lane owns 4 adjacent columns and reads them as one char4, so a warp
// reads 128 contiguous bytes of a code row (coalesced), loads the block's
// 4 scales once per 32 rows, dequantizes in registers and keeps 8 x 4 f32
// sums.  The warps' sums meet in shared memory.  When the column tiles
// alone cannot fill the card, K is split over `splits` blocks that write
// partial sums to a workspace, and a second kernel adds them in a fixed
// order (no atomics: the result does not depend on scheduling).  No
// dequantized copy of W is ever written to device memory.
//
// Plain C entry point for ctypes; launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kQK = 32;        // quantization block
constexpr int kTileN = 128;    // output columns per block: 32 lanes x 4
constexpr int kTileM = 8;      // rows of x per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool kMins>
__global__ void __launch_bounds__(kThreads)
quantized_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ scales,
                        const float* __restrict__ mins,
                        float* __restrict__ dst, int M, int N, int K,
                        int kb_per_split) {
  __shared__ float xs[kWarps][kTileM][kQK];        // each warp's x slice
  __shared__ float red[kWarps][kTileM][kTileN];    // per-warp partial sums

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kTileN + lane * 4;
  const int m0 = blockIdx.z * kTileM;
  const int rows = min(kTileM, M - m0);
  const int kb_begin = blockIdx.y * kb_per_split;
  const int kb_end = min(kb_begin + kb_per_split, K / kQK);

  float acc[kTileM][4];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kb = kb_begin + warp; kb < kb_end; kb += kWarps) {
    const int k0 = kb * kQK;
    for (int i = lane; i < kTileM * kQK; i += 32) {
      const int m = i / kQK, kk = i % kQK;
      xs[warp][m][kk] =
          m < rows ? __bfloat162float(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncwarp();

    const float4 s4 = *reinterpret_cast<const float4*>(scales + (size_t)kb * N + n);
    const float s[4] = {round_bf16(s4.x), round_bf16(s4.y), round_bf16(s4.z),
                        round_bf16(s4.w)};
    float mn[4] = {0.f, 0.f, 0.f, 0.f};
    if (kMins) {
      const float4 m4 = *reinterpret_cast<const float4*>(mins + (size_t)kb * N + n);
      mn[0] = round_bf16(m4.x);
      mn[1] = round_bf16(m4.y);
      mn[2] = round_bf16(m4.z);
      mn[3] = round_bf16(m4.w);
    }

#pragma unroll 8
    for (int r = 0; r < kQK; ++r) {
      const char4 c = *reinterpret_cast<const char4*>(codes + (size_t)(k0 + r) * N + n);
      float w[4] = {round_bf16((float)c.x * s[0]), round_bf16((float)c.y * s[1]),
                    round_bf16((float)c.z * s[2]), round_bf16((float)c.w * s[3])};
      if (kMins) {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = round_bf16(w[j] + mn[j]);
      }
#pragma unroll
      for (int m = 0; m < kTileM; ++m) {
        const float xv = xs[warp][m][r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();

  for (int i = threadIdx.x; i < kTileM * kTileN; i += kThreads) {
    const int m = i / kTileN, col = i % kTileN;
    if (m >= rows) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][m][col];
    dst[(size_t)blockIdx.y * M * N + (size_t)(m0 + m) * N + blockIdx.x * kTileN + col] = sum;
  }
}

// out[i] = sum over s of work[s][i], in order of s
__global__ void sum_splits_kernel(const float* __restrict__ work,
                                  float* __restrict__ out, size_t count,
                                  int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += work[(size_t)s * count + i];
    out[i] = sum;
  }
}

}  // namespace

// work: (splits, M, N) f32 scratch when splits > 1 (may alias out when
// splits == 1).  mins may be null.
extern "C" int wtt_quantized_matmul(const void* x, const void* codes,
                                    const void* scales, const void* mins,
                                    void* work, void* out, int M, int N, int K,
                                    int splits, int kb_per_split, void* stream) {
  if (M < 1 || N < kTileN || N % kTileN || K < kQK || K % kQK || splits < 1 ||
      kb_per_split < 1 || (long long)splits * kb_per_split < K / kQK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(N / kTileN, splits, (M + kTileM - 1) / kTileM);
  float* dst = static_cast<float*>(splits > 1 ? work : out);
  if (mins != nullptr)
    quantized_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
        static_cast<const float*>(scales), static_cast<const float*>(mins), dst,
        M, N, K, kb_per_split);
  else
    quantized_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
        static_cast<const float*>(scales), nullptr, dst, M, N, K, kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)M * N;
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(work),
                                             static_cast<float*>(out), count, splits);
  return (int)cudaGetLastError();
}
