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
// The weights are rounded to bf16 after the softmax's global
// normalisation, so a split over Ta must agree on the global max and sum
// before any weight is formed: flash-decoding's rescaled merge of partial
// outputs would round unnormalised weights, another function.
//
// Bound on the H100: device-memory bandwidth.  Each decode step reads the
// whole cross-KV of every layer, 2*Dh*Ta elements per (b, h), for ~2 FLOP
// an element: 384 KB per (b, h) at Ta = 1500 in bf16, so at batch 1 (B*H
// = 12 or 20) one block per (b, h) leaves most of the card idle.
//
// K4 (`xattn_cluster_kernel`, templated on the K/V type): one thread-block
// cluster per (b, h), of C CTAs (C <= 16, chosen by the wrapper so the
// grid fills the card: 16 at B*H = 12 or 20 and Ta = 1500), each owning a
// contiguous range of whole 16-key chunks (at least 64 keys a CTA).  The range's K rows and its V
// rows are each one contiguous run of bytes; thread 0 starts both with
// `cp.async.bulk` (1-D TMA) into shared memory at the top, each on its own
// mbarrier, so V lands while the CTA computes its logits.  A longer range
// (the wrapper's tile size: past 128 keys) streams through a ring of
// 128-key copies (K tiles, then V tiles; the wrapper picks the depth),
// which keeps a CTA's shared memory small enough for every CTA of the grid
// to be resident at once.  A group of 8 lanes dots one key row with q (8 channels a lane),
// the logits stay in shared memory.  The CTAs then agree on the softmax
// in one exchange through distributed shared memory: each stores its (max
// m_r, sum s_r of exp(s - m_r)) into a slot of every CTA's shared memory
// with `st.async`, whose bytes complete a transaction count on an mbarrier
// there (a push: no CTA waits on a remote load, and none on a
// cluster-wide barrier), and every CTA merges the slots in rank order: m =
// max m_r, sum = sum over r of s_r exp(m_r - m), the same bits in every
// CTA.  Only then does a CTA sum its V rows, each weighted by bf16(exp(s -
// m) / sum) formed from the row's logit.  The C partial (64,) outputs are
// stored the same way into slots of rank 0, which adds them in rank order:
// two launches give the same bits, with no atomics, workspace or second
// kernel.
//
// K5 (`cross_attention_kernel`) is the earlier design, one block per
// (b, h) reading K/V from device memory in 16-byte (8-byte for int8) loads
// in two passes; it becomes an instance of K4's template later.
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---- K4: one (b, h) per cluster, Ta split over its CTAs -----------------

constexpr int kKeyChunk = 16;       // a CTA's key range is whole chunks
constexpr int kMinKeys = 64;        // at least this many keys a CTA
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 8;
constexpr int kMaxStageBytes = 96 * 1024;   // all stages together
constexpr int kBarBytes = 8 * kMaxStages;   // the stages' mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The cluster barrier, split: a relaxed arrive at the top, the wait just
// before the first store into another CTA, so it costs nothing by then
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of shared address `addr` in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Store into another CTA's shared memory (cluster addresses from map_rank);
// the bytes count against the transaction count of the mbarrier `bar`
// there, so its owner learns of them by waiting on it
__device__ __forceinline__ void st_async(uint32_t addr, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
      ::"r"(addr), "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}


// `bytes` (a multiple of 16) from global `src` to shared `dst` by 1-D TMA,
// completing on the mbarrier at `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Grid (C, B * H), cluster (C, 1, 1).  CTA rank r takes key chunks
// [r * n / C, (r + 1) * n / C) of the n = ceil(Ta / 16), clipped at Ta.
// Its range arrives in tiles of `tile_keys` rows (the whole range when it
// fits): load i of 2 * n_tiles is K tile i, then V tile i - n_tiles, into
// stage i % n_stages.  Shared memory: xattn_smem.
template <typename KV>
__global__ void __launch_bounds__(kThreads)
xattn_cluster_kernel(const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ k, const KV* __restrict__ v,
                     float* __restrict__ out, int Ta, int tile_keys,
                     int n_stages, float scale) {
  constexpr int kRowBytes = kDh * sizeof(KV);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const size_t bh = blockIdx.y;                 // b * H + h
  const int n_chunks = (Ta + kKeyChunk - 1) / kKeyChunk;
  const int t0 = rank * n_chunks / n_ranks * kKeyChunk;
  const int n_keys = min((rank + 1) * n_chunks / n_ranks * kKeyChunk, Ta) - t0;
  const int n_tiles = (n_keys + tile_keys - 1) / tile_keys;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane % kLanesPerRow;          // which 8 channels
  const int slot = lane / kLanesPerRow;         // which row of the warp's 4

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem);         // stage s's at bar0 + 8 s
  KV* stages = reinterpret_cast<KV*>(smem + kBarBytes);
  const size_t stage_elems = (size_t)tile_keys * kDh;
  float* w = reinterpret_cast<float*>(smem + kBarBytes +
                                      n_stages * stage_elems * sizeof(KV));
  __shared__ float scratch[kWarps];
  __shared__ float red[kWarps][kDh];
  // each CTA's (max, sum) and (in rank 0) partial output, by rank, and the
  // mbarriers that count their bytes in
  __shared__ __align__(16) float2 stats[kMaxCluster];
  __shared__ __align__(16) float parts[kMaxCluster][kDh];
  __shared__ __align__(8) uint64_t stats_bar, parts_bar;

  auto rows_of = [&](int tile) { return min(tile_keys, n_keys - tile * tile_keys); };
  auto load = [&](int i) {
    const int tile = i < n_tiles ? i : i - n_tiles;
    const KV* src = (i < n_tiles ? k : v) +
                    (bh * Ta + t0 + (size_t)tile * tile_keys) * kDh;
    const uint32_t bytes = rows_of(tile) * kRowBytes;
    const int s = i % n_stages;
    mbar_expect_tx(bar0 + 8 * s, bytes);
    bulk_load(smem_u32(stages + s * stage_elems), src, bytes, bar0 + 8 * s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_init(smem_u32(&stats_bar), 1);
    mbar_init(smem_u32(&parts_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int i = 0; i < n_stages && i < 2 * n_tiles; ++i) load(i);
    // what the other CTAs will store here
    mbar_expect_tx(smem_u32(&stats_bar), n_ranks * sizeof(float2));
    if (rank == 0) mbar_expect_tx(smem_u32(&parts_bar), n_ranks * kDh * sizeof(float));
  }
  __syncthreads();
  // the wait that matches this arrive, before the first remote store,
  // makes sure every CTA of the cluster is running, its mbarriers set up
  cluster_arrive_relaxed();

  float qf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qf[j] = __bfloat162float(q[bh * kDh + sub * 8 + j]);

  // pass 1: logits into shared memory; the loop bound is uniform over the
  // warp (shuffles)
  float local_max = -INFINITY;
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(bar0 + 8 * (i % n_stages), (i / n_stages) & 1);
    const KV* kt = stages + (i % n_stages) * stage_elems + sub * 8;
    const int rows = rows_of(i);
    for (int r0 = warp * kRowsPerWarp; r0 < rows; r0 += kRowsPerStep) {
      const int r = r0 + slot;
      const bool valid = r < rows;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (valid) load8(kt + r * kDh, kf);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(qf[j], kf[j], d);
#pragma unroll
      for (int o = 1; o < kLanesPerRow; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (valid) {
        const float s = d * scale;
        if (sub == 0) w[i * tile_keys + r] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    if (i + n_stages < 2 * n_tiles) {   // a refill: stage i % n_stages is free
      __syncthreads();
      if (threadIdx.x == 0) load(i + n_stages);
    }
  }

  // the softmax over the whole of Ta: this CTA's max and sum, then the
  // cluster's, each CTA storing its pair into slot `rank` of every CTA
  // (thread r takes CTA r) and merging the slots in rank order
  const float m_cta = block_reduce<true>(local_max, scratch);
  float local_sum = 0.f;
  for (int t = threadIdx.x; t < n_keys; t += kThreads) local_sum += expf(w[t] - m_cta);
  const float s_cta = block_reduce<false>(local_sum, scratch);
  cluster_wait();
  if (threadIdx.x < n_ranks)
    st_async(map_rank(smem_u32(&stats[rank]), threadIdx.x), make_float2(m_cta, s_cta),
             map_rank(smem_u32(&stats_bar), threadIdx.x));
  mbar_wait(smem_u32(&stats_bar), 0);
  float m = stats[0].x;
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r)
    if (r < n_ranks) m = fmaxf(m, stats[r].x);
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < n_ranks) sum += stats[r].y * expf(stats[r].x - m);
  const float inv_sum = 1.f / sum;

  // pass 2: each lane sums its 8 channels over the rows its group visits
  // (the rows whose logits it wrote), each row's softmax weight formed from
  // its logit and the global max and rounded to bf16 as the reference does
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int i = n_tiles + tile;
    mbar_wait(bar0 + 8 * (i % n_stages), (i / n_stages) & 1);
    const KV* vt = stages + (i % n_stages) * stage_elems + sub * 8;
    const float* wt = w + tile * tile_keys;
    const int rows = rows_of(tile);
    for (int r = warp * kRowsPerWarp + slot; r < rows; r += kRowsPerStep) {
      float vf[8];
      load8(vt + r * kDh, vf);
      const float p = __bfloat162float(__float2bfloat16(expf(wt[r] - m) * inv_sum));
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, vf[j], acc[j]);
    }
    if (i + n_stages < 2 * n_tiles) {   // a refill: stage i % n_stages is free
      __syncthreads();
      if (threadIdx.x == 0) load(i + n_stages);
    }
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
  // the partial outputs meet in rank 0 (16 threads store 4 channels each
  // into its slot `rank`), added in rank order
  if (threadIdx.x < kDh / 4) {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s[c] += red[i][4 * threadIdx.x + c];
    }
    st_async(map_rank(smem_u32(&parts[rank][4 * threadIdx.x]), 0),
             make_float4(s[0], s[1], s[2], s[3]), map_rank(smem_u32(&parts_bar), 0));
  }
  if (rank != 0) return;
  mbar_wait(smem_u32(&parts_bar), 0);
  if (threadIdx.x < kDh) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_ranks) o += parts[r][threadIdx.x];
    out[bh * kDh + threadIdx.x] = o;
  }
}

// Shared memory of xattn_cluster_kernel: the mbarriers, n_stages stages of
// tile_keys rows, range_cap f32 logits.
template <typename KV>
size_t xattn_smem(int tile_keys, int n_stages, int range_cap) {
  return kBarBytes + (size_t)n_stages * tile_keys * kDh * sizeof(KV) +
         (size_t)range_cap * sizeof(float);
}

template <typename KV>
int launch_cluster(const void* q, const void* k, const void* v, void* out, int B,
                   int H, int Dh, int Ta, int cluster, int tile_keys,
                   int n_stages, void* stream) {
  const int n_chunks = (Ta + kKeyChunk - 1) / kKeyChunk;
  if (B < 1 || H < 1 || Dh != kDh || Ta < 1 || Ta > kMaxTa || cluster < 1 ||
      cluster > kMaxCluster || cluster > (Ta + kMinKeys - 1) / kMinKeys ||
      (long long)B * H > 65535 || tile_keys < 1 || n_stages < 2 ||
      n_stages > kMaxStages ||
      (long long)n_stages * tile_keys * kDh * sizeof(KV) > kMaxStageBytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = xattn_cluster_kernel<KV>;
  // attributes once per device: the largest shared memory any shape asks,
  // clusters above the portable 8
  static int ready_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (ready_on != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kBarBytes + kMaxStageBytes + kMaxTa * sizeof(float)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return (int)err;
    ready_on = dev;
  }
  const int longest = (n_chunks + cluster - 1) / cluster * kKeyChunk;
  const int range_cap = longest < Ta ? longest : Ta;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B * H, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = xattn_smem<KV>(tile_keys, n_stages, range_cap);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const KV*>(k), static_cast<const KV*>(v),
                           static_cast<float*>(out), Ta, tile_keys, n_stages,
                           1.0f / sqrtf((float)Dh));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K4: bf16 K/V, each (b, h) on a cluster of `cluster` CTAs (1-16, at most
// ceil(Ta / 64)), its K and V arriving in tiles of `tile_keys` rows through
// `n_stages` stages (2-8, 96 KB in all; a range that fits in one tile
// lands in one copy each)
extern "C" int wtt_cross_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Dh, int Ta,
                                   int cluster, int tile_keys, int n_stages,
                                   void* stream) {
  return launch_cluster<__nv_bfloat16>(q, k, v, out, B, H, Dh, Ta, cluster,
                                       tile_keys, n_stages, stream);
}

// K5: int8 K/V, per-position f32 scales
extern "C" int wtt_cross_attention_bhtd_q8(const void* q, const void* k_q,
                                           const void* k_s, const void* v_q,
                                           const void* v_s, void* out, int B,
                                           int H, int Dh, int Ta, void* stream) {
  return launch<int8_t, true>(q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, stream);
}
