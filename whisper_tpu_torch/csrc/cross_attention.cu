// Single-query cross-attention over K/V in (B, H, Ta, Dh) layout: kernels
// K4 (bf16 K/V) and K5 (int8 K/V with per-position scales) of
// whisper_tpu_torch.
//
// K4 replaces whisper_tpu/ops/cross_attention.py `cross_attention_decode` /
// `_xattn_kernel`, K5 `cross_attention_decode_q8` / `_xattn_kernel_q8`
// (Pallas, TPU).  Per (b, h), with q rounded to bf16:
//   K4: s[t] = (q . k[t]) * Dh^-1/2;            w = softmax(s)
//       o    = sum_t bf16(w[t]) * v[t]
//   K5: s[t] = (q . k_q[t]) * k_s[t] * Dh^-1/2; w = softmax(s)
//       o    = sum_t bf16(w[t] * v_s[t]) * v_q[t]
// q (B, H, 1, Dh) bf16; k/v (B, H, Ta, Dh) bf16 (K4) or int8 (K5);
// k_s/v_s (B, H, Ta, 1) f32 (K5); out (B, H, 1, Dh) f32.  Dh = 64.
//
// Bound on the H100: device-memory bandwidth.  Each decode step reads the
// whole cross-KV of every layer, 2*Dh*Ta elements per (b, h), for ~2 FLOP
// an element.  Design (K2's, on the other layout): one block per (b, h).
// Here Dh is the contiguous axis, so a group of 8 lanes takes one key
// position, each lane 8 adjacent channels as one 16-byte (bf16) or 8-byte
// (int8) load: a warp reads 4 whole rows, 512 or 256 contiguous bytes.
// Pass 1 dots each row with q in registers, reduces in the 8-lane group by
// shuffles and leaves the f32 logit in shared memory; block-wide max and
// sum make the softmax.  Pass 2 has each lane accumulate its 8 channels over
// the rows its group visits, then sums the 32 row slots by shuffles and
// shared memory.  K/V are dequantized in registers; neither a bf16 copy nor
// the (Ta,) scores reach device memory.  Splitting Ta over blocks (B*H is
// only 20 at batch 1) is later work.
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = kDh / 8;            // 8 channels a lane
constexpr int kRowsPerWarp = 32 / kLanesPerRow;  // 4
constexpr int kRowsPerStep = kWarps * kRowsPerWarp;
constexpr int kMaxTa = 16384;                    // 4 * Ta bytes of shared memory

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// 8 adjacent channels of one row, as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (float)c[i];
}

template <typename KV, bool kScaled>
__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ k, const float* __restrict__ k_s,
                       const KV* __restrict__ v, const float* __restrict__ v_s,
                       float* __restrict__ out, int Ta, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w = reinterpret_cast<float*>(smem);   // (Ta,) logits, then weights
  __shared__ float scratch[kWarps];
  __shared__ float red[kWarps][kDh];

  const size_t bh = blockIdx.x;                // b * H + h
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane % kLanesPerRow;         // which 8 channels
  const int slot = lane / kLanesPerRow;        // which row of the warp's 4
  const KV* kb = k + bh * Ta * kDh + sub * 8;
  const KV* vb = v + bh * Ta * kDh + sub * 8;

  float qf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qf[j] = __bfloat162float(q[bh * kDh + sub * 8 + j]);

  // pass 1: logits; the loop bound is uniform over the warp (shuffles)
  float local_max = -INFINITY;
  for (int t0 = warp * kRowsPerWarp; t0 < Ta; t0 += kRowsPerStep) {
    const int t = t0 + slot;
    const bool valid = t < Ta;
    float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) load8(kb + (size_t)t * kDh, kf);
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) d = fmaf(qf[j], kf[j], d);
#pragma unroll
    for (int o = 1; o < kLanesPerRow; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (valid) {
      const float s = kScaled ? d * k_s[bh * Ta + t] * scale : d * scale;
      if (sub == 0) w[t] = s;
      local_max = fmaxf(local_max, s);
    }
  }
  const float m = block_reduce<true>(local_max, scratch);   // syncs w too

  float local_sum = 0.f;
  for (int t = threadIdx.x; t < Ta; t += kThreads) {
    const float e = expf(w[t] - m);
    w[t] = e;
    local_sum += e;
  }
  const float inv_sum = 1.f / block_reduce<false>(local_sum, scratch);

  // softmax weight (times the V scale), rounded to bf16 as the reference does
  for (int t = threadIdx.x; t < Ta; t += kThreads) {
    const float p = w[t] * inv_sum;
    w[t] = __bfloat162float(__float2bfloat16(kScaled ? p * v_s[bh * Ta + t] : p));
  }
  __syncthreads();

  // pass 2: each lane sums its 8 channels over the rows its group visits
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = warp * kRowsPerWarp + slot; t < Ta; t += kRowsPerStep) {
    float vf[8];
    load8(vb + (size_t)t * kDh, vf);
    const float wt = w[t];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(wt, vf[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int o = kLanesPerRow; o < 32; o <<= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (slot == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp][sub * 8 + j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < kDh) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += red[i][threadIdx.x];
    out[bh * kDh + threadIdx.x] = sum;
  }
}

template <typename KV, bool kScaled>
int launch(const void* q, const void* k, const void* k_s, const void* v,
           const void* v_s, void* out, int B, int H, int Dh, int Ta,
           void* stream) {
  if (B < 1 || H < 1 || Dh != kDh || Ta < 1 || Ta > kMaxTa)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Ta * sizeof(float);
  auto kernel = cross_attention_kernel<KV, kScaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const float*>(k_s), static_cast<const KV*>(v),
      static_cast<const float*>(v_s), static_cast<float*>(out), Ta,
      1.0f / sqrtf((float)Dh));
  return (int)cudaGetLastError();
}

}  // namespace

// K4: bf16 K/V
extern "C" int wtt_cross_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Dh, int Ta,
                                   void* stream) {
  return launch<__nv_bfloat16, false>(q, k, nullptr, v, nullptr, out, B, H, Dh,
                                      Ta, stream);
}

// K5: int8 K/V, per-position f32 scales
extern "C" int wtt_cross_attention_bhtd_q8(const void* q, const void* k_q,
                                           const void* k_s, const void* v_q,
                                           const void* v_s, void* out, int B,
                                           int H, int Dh, int Ta, void* stream) {
  return launch<int8_t, true>(q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, stream);
}
