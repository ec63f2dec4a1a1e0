// The decoder step's self-attention over its KV cache, one kernel of
// whisper_tpu_torch (ops/decoder_attention.py):
//   q, v = bf16(f32(q|v) + b)        in place in the step's q/k/v row
//   cache[:, :, :, cache_index] = k, v
//   out = bf16(softmax(bf16(q . K) * Dh^-1/2) over keys [pad_len, kv_len)
//             rounded to bf16, . V)
//
// It replaces no TPU kernel: on the TPU the decode step is one XLA program.
// Under PyTorch the plain step makes ~17 launches a layer for this: the two
// bias adds, a cast and a copy for each cache column, then the attention
// over all C cache columns with an additive mask rebuilt every step (the
// scores' matmul, a cast, the scale, the mask add, the softmax, the
// weights' cast, the second matmul, a cast).  Here one CTA per (b, h)
// does all of it and reads only the valid keys.
//
// The roundings are the plain step's: q and v rounded to bf16 after an f32
// bias add (k has no bias); each score is an f32 dot product rounded to
// bf16 (the bf16 matmul's output) and then scaled in f32; the softmax runs
// in f32 over the valid keys, exp(s - max) / sum; its weights are rounded
// to bf16; their products with V are summed in f32 and rounded to bf16.
// Only the order of the f32 sums differs (cuBLAS's against four warps'
// parts of a score, a lane's keys then a warp's shuffles for an output),
// and masked keys, which weigh exactly 0 in the plain step, are never
// read.
//
// Bound on the H100: bytes.  Per (b, h) it reads 2 x Dh x n valid keys of
// bf16 (n = kv_len - pad_len) for 4 x Dh x n operations.  The cache is
// (B, H, Dh, C): a key's channels lie C apart, and for one channel the
// keys are contiguous, so a warp reads 32 neighbouring keys of a channel
// at once (64 bytes).  Each warp takes 16 of the head's (up to 64)
// channels.  A CTA's time is a chain of latencies, so the chain is cut
// short: a 128-key tile's loads all go up before any is used (4 keys x 16
// channels = 64 loads a lane in flight), the first K tile before the new
// column is even written (its one stale key takes k from shared memory),
// and the first V tile before the softmax's barriers.  The scores' four
// warp parts meet in shared memory; the weighted sum is a lane's keys,
// then each channel across the warp's lanes.  Longer ranges go tile by
// tile.  Tried and slower on an H100 at B 256: a key a thread with 16
// channels in flight, the new column selected from shared memory for V
// (the select split each warp's loads), and staging K and V tiles
// through shared memory as aligned 32-bit words.  What is left is mostly
// fixed: at one key the kernel still takes ~70 us at B 256, the 64
// scattered 2-byte column writes a (b, h) and the chain of each CTA, so
// it reads ~0.3 of its byte bound at the decode loop's key counts.
//
// The new key and value are written to the cache before a barrier and
// read back from it after, like every other key: the barrier orders a
// CTA's global writes before its threads' later reads (the cache pointers
// are not read-only, so no non-coherent load path is taken).
//
// Plain C entry point for ctypes; it launches on the given stream and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                  // channels a warp takes
constexpr int kMaxDh = kGroup * kWarps;     // 64
constexpr int kMaxKeys = 8192;              // the (n,) weights in smem
constexpr int kChunks = kWarps;             // keys a lane takes a tile
constexpr int kTile = 32 * kChunks;         // keys a tile: a thread a key

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// every thread gets the block's max (kMax) or sum; red holds kWarps floats
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();   // red is reused by the next reduction
  return r;
}

// A warp's share of a tile: kChunks keys a lane (32 apart) for its
// kGroup channels, rows C apart from `rows`, 0 past the n keys or Dh
template <int kDh>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* rows, int C,
                                          int Dh, int d0, int j0, int n,
                                          int lane,
                                          float (&r)[kChunks][kGroup]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = j0 + 32 * c + lane;
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      r[c][i] = j < n && (kDh || d0 + i < Dh)
                    ? __bfloat162float(rows[(long long)i * C + j])
                    : 0.f;
  }
}

// kDh: the head width, or 0 for a width given at run time (Dh <= kMaxDh);
// at most 128 registers, four CTAs an SM
template <int kDh>
__global__ void __launch_bounds__(kThreads, 4)
self_attn_step_kernel(__nv_bfloat16* qkv, const float* __restrict__ q_b,
                      const float* __restrict__ v_b, __nv_bfloat16* k_cache,
                      __nv_bfloat16* v_cache,
                      const long long* __restrict__ pad_len,
                      __nv_bfloat16* __restrict__ out, int H, int dh, int C,
                      int cache_index, int kv_len, float scale) {
  extern __shared__ float w[];                  // a score, then a weight, a key
  __shared__ float q[kMaxDh], k_new[kMaxDh];
  __shared__ float part[kWarps][kTile];         // a warp's part of a score
  __shared__ float red[kWarps];
  const int Dh = kDh ? kDh : dh;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int D = H * Dh;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int d0 = warp * kGroup;                 // this warp's channels
  __nv_bfloat16* row = qkv + (long long)b * 3 * D + h * Dh;
  const long long head = (long long)blockIdx.x * Dh * C;
  const __nv_bfloat16* k_rows = k_cache + head + (long long)d0 * C;
  const __nv_bfloat16* v_rows = v_cache + head + (long long)d0 * C;

  long long first = pad_len ? pad_len[b] : 0;
  first = first < 0 ? 0 : (first > kv_len ? kv_len : first);
  const int lo = (int)first;
  const int n = kv_len - lo;

  // the first K tile goes up before anything waits: the new column is
  // the one key it may read stale, and its score takes k from shared
  // memory below
  float kv[kChunks][kGroup];
  load_tile<kDh>(k_rows + lo, C, Dh, d0, 0, n, lane, kv);

  // the new column: q and v biased and rounded (back into the row), k and
  // v into the cache
  for (int d = t; d < Dh; d += kThreads) {
    const __nv_bfloat16 qd =
        __float2bfloat16_rn(__bfloat162float(row[d]) + q_b[h * Dh + d]);
    const __nv_bfloat16 kd = row[D + d];
    const __nv_bfloat16 vd =
        __float2bfloat16_rn(__bfloat162float(row[2 * D + d]) + v_b[h * Dh + d]);
    row[d] = qd;
    row[2 * D + d] = vd;
    k_cache[head + (long long)d * C + cache_index] = kd;
    v_cache[head + (long long)d * C + cache_index] = vd;
    q[d] = __bfloat162float(qd);
    k_new[d] = __bfloat162float(kd);
  }
  __syncthreads();

  // scores, a tile of kTile keys at a time: each warp sums its kGroup
  // channels for kChunks keys a lane, the warps' parts meet in shared
  // memory, and a thread a key adds them
  float m = -INFINITY;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    if (j0 > 0) load_tile<kDh>(k_rows + lo, C, Dh, d0, j0, n, lane, kv);
    float p[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const bool fresh = lo + j0 + 32 * c + lane == cache_index;
      p[c] = 0.f;
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (kDh || d0 + i < Dh)
          p[c] = fmaf(q[d0 + i], fresh ? k_new[d0 + i] : kv[c][i], p[c]);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) part[warp][32 * c + lane] = p[c];
    __syncthreads();
    const int j = j0 + t;
    if (j < n) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += part[i][t];
      s = bf16_round(s) * scale;
      w[j] = s;
      m = fmaxf(m, s);
    }
    __syncthreads();                            // part is the next tile's
  }

  // the first V tile goes up before the softmax's barriers (the barrier
  // above put the new column in the cache)
  float v[kChunks][kGroup];
  load_tile<kDh>(v_rows + lo, C, Dh, d0, 0, n, lane, v);
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int j = t; j < n; j += kThreads) {
    const float e = expf(w[j] - m);
    w[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = t; j < n; j += kThreads) w[j] = bf16_round(w[j] / sum);
  __syncthreads();

  // the weighted sum: the warp's channels, kChunks keys a lane a tile,
  // then each channel's sum across the lanes
  float acc[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    if (j0 > 0) load_tile<kDh>(v_rows + lo, C, Dh, d0, j0, n, lane, v);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = j0 + 32 * c + lane;
      const float wj = j < n ? w[j] : 0.f;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = fmaf(wj, v[c][i], acc[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    if (i == lane) mine = acc[i];
  if (lane < kGroup && d0 + lane < Dh)
    out[(long long)b * D + h * Dh + d0 + lane] = __float2bfloat16_rn(mine);
}

}  // namespace

extern "C" int wtt_self_attn_step(void* qkv, const void* q_b, const void* v_b,
                                  void* k_cache, void* v_cache,
                                  const void* pad_len, void* out, int B,
                                  int H, int Dh, int C, int cache_index,
                                  int kv_len, float scale, void* stream) {
  if (B < 1 || H < 1 || Dh < 1 || Dh > kMaxDh || C < 1 || cache_index < 0
      || cache_index >= C || kv_len < 1 || kv_len > C || kv_len > kMaxKeys
      || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // Whisper's heads are 64 wide: that width unrolls fully
  auto kernel =
      Dh == 64 ? self_attn_step_kernel<64> : self_attn_step_kernel<0>;
  kernel<<<B * H, kThreads, kv_len * sizeof(float), (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(qkv), static_cast<const float*>(q_b),
      static_cast<const float*>(v_b), static_cast<__nv_bfloat16*>(k_cache),
      static_cast<__nv_bfloat16*>(v_cache),
      static_cast<const long long*>(pad_len),
      static_cast<__nv_bfloat16*>(out), H, Dh, C, cache_index, kv_len, scale);
  return (int)cudaGetLastError();
}
