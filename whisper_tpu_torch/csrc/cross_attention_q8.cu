// Single-query cross-attention over int8 K/V, kernel K2 of whisper_tpu_torch.
//
// Replaces whisper_tpu/ops/cross_attention.py `cross_attention_decode_q8dt` /
// `_xattn_kernel_q8dt` (Pallas, TPU), the same function as the serving
// path's "q8e" einsum.  Per (b, h):
//   s[t]  = (q . k_q[:, t]) * k_s[t] * Dh^-1/2
//   w     = softmax(s)                      (f32)
//   wv[t] = bf16(w[t] * v_s[t])             (rounded like the reference)
//   o[d]  = sum_t wv[t] * v_q[d, t]         (f32)
// q (B, H, 1, Dh) bf16; k_q/v_q (B, H, Dh, Ta) int8; k_s/v_s (B, H, Ta) f32;
// out (B, H, 1, Dh) f32.
//
// Bound on the H100: device-memory bandwidth.  Every decode step reads the
// whole int8 cross-KV, 2*Dh*Ta bytes per (b, h) per layer, for ~2 FLOP a
// byte.  Design: one block per (b, h).  Pass 1 gives each thread whole key
// positions: consecutive threads read consecutive bytes of each contiguous
// Ta row of k_q (coalesced), dequantize in registers and leave only the
// f32 logit in shared memory.  Block-wide max and sum make the softmax.
// Pass 2 gives each warp whole rows d of v_q, lanes striding along Ta
// (coalesced again), and reduces with shuffles.  No bf16 copy of K/V and
// no (Ta,) score vector is ever written to device memory.
//
// Plain C entry point for ctypes; launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kMaxTa = 16384;   // 4 * Ta bytes of dynamic shared memory

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Reduce one value per thread across the block; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();   // scratch free from any previous reduction
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < kWarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(x) : warp_sum(x);
}

__global__ void __launch_bounds__(kThreads)
cross_attention_q8_kernel(const __nv_bfloat16* __restrict__ q,
                          const int8_t* __restrict__ k_q,
                          const float* __restrict__ k_s,
                          const int8_t* __restrict__ v_q,
                          const float* __restrict__ v_s,
                          float* __restrict__ out, int Dh, int Ta, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w = reinterpret_cast<float*>(smem);   // (Ta,) logits, then weights
  __shared__ float qf[kMaxDh];
  __shared__ float scratch[kWarps];

  const size_t bh = blockIdx.x;                // b * H + h
  const int8_t* kq = k_q + bh * Dh * Ta;
  const int8_t* vq = v_q + bh * Dh * Ta;
  const float* ks = k_s + bh * Ta;
  const float* vs = v_s + bh * Ta;

  for (int d = threadIdx.x; d < Dh; d += kThreads)
    qf[d] = __bfloat162float(q[bh * Dh + d]);
  __syncthreads();

  // pass 1: logits, one key position per thread per step
  float local_max = -INFINITY;
  for (int t = threadIdx.x; t < Ta; t += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < Dh; ++d) acc += qf[d] * (float)kq[(size_t)d * Ta + t];
    const float s = acc * ks[t] * scale;
    w[t] = s;
    local_max = fmaxf(local_max, s);
  }
  const float m = block_reduce<true>(local_max, scratch);

  float local_sum = 0.f;
  for (int t = threadIdx.x; t < Ta; t += kThreads) {
    const float e = expf(w[t] - m);
    w[t] = e;
    local_sum += e;
  }
  const float inv_sum = 1.f / block_reduce<false>(local_sum, scratch);

  // softmax weight times the V scale, rounded to bf16 as the reference does
  for (int t = threadIdx.x; t < Ta; t += kThreads)
    w[t] = __bfloat162float(__float2bfloat16(w[t] * inv_sum * vs[t]));
  __syncthreads();

  // pass 2: one output channel per warp per step, lanes along Ta
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int d = warp; d < Dh; d += kWarps) {
    const int8_t* row = vq + (size_t)d * Ta;
    float acc = 0.f;
    for (int t = lane; t < Ta; t += 32) acc += w[t] * (float)row[t];
    acc = warp_sum(acc);
    if (lane == 0) out[bh * Dh + d] = acc;
  }
}

}  // namespace

extern "C" int wtt_cross_attention_q8(const void* q, const void* k_q, const void* k_s,
                                      const void* v_q, const void* v_s, void* out,
                                      int B, int H, int Dh, int Ta, void* stream) {
  if (B < 1 || H < 1 || Dh < 1 || Dh > kMaxDh || Ta < 1 || Ta > kMaxTa)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Ta * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cross_attention_q8_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_q),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v_q),
      static_cast<const float*>(v_s), static_cast<float*>(out), Dh, Ta,
      1.0f / sqrtf((float)Dh));
  return (int)cudaGetLastError();
}
