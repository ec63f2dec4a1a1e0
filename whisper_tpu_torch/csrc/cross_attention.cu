// Single-query cross-attention over the decode step's cross-KV: kernels K2
// (int8 K/V in (B, H, Dh, Ta) layout), K4 (bf16 K/V in (B, H, Ta, Dh)) and
// K5 (int8 K/V in (B, H, Ta, Dh)) of whisper_tpu_torch.
//
// K2 replaces whisper_tpu/ops/cross_attention.py `cross_attention_decode_q8dt`
// / `_xattn_kernel_q8dt`, K4 `cross_attention_decode` / `_xattn_kernel`, K5
// `cross_attention_decode_q8` / `_xattn_kernel_q8` (Pallas, TPU).  Per
// (b, h), with q rounded to bf16:
//   K4:     s[t] = (q . k[t]) * Dh^-1/2;            w = softmax(s)
//           o    = sum_t bf16(w[t]) * v[t]
//   K2, K5: s[t] = (q . k_q[t]) * k_s[t] * Dh^-1/2; w = softmax(s)
//           o    = sum_t bf16(w[t] * v_s[t]) * v_q[t]
// K4/K5: q (B, H, 1, Dh) bf16, out (B, H, 1, Dh) f32, k/v (B, H, Ta, Dh)
// bf16 or int8, k_s/v_s (B, H, Ta, 1) f32, Dh = 64.  K2 takes G queries a
// (b, h), 1 <= G <= 8, each with the function above: q (B, H, G, Dh) bf16,
// out (B, H, G, Dh) f32, k_q/v_q (B, H, Dh, Ta) int8, k_s/v_s (B, H, Ta)
// f32, Dh <= 128.  Batched beam search puts a stream's K beams on its one
// cross-KV row as K queries (G = K); the serving step has G = 1.  The softmax is f32 and
// every sum f32.  The weights are rounded to bf16 after the softmax's
// global normalisation, so a split over Ta must agree on the global max
// and sum before any weight is formed: flash-decoding's rescaled merge of
// partial outputs would round unnormalised weights, another function.
//
// Bound on the H100: device-memory bandwidth.  Each decode step reads the
// whole cross-KV of every layer, 2*Dh*Ta elements per (b, h), for ~2 FLOP
// an element: 384 KB per (b, h) at Ta = 1500 in bf16, 192 KB in int8, so
// at batch 1 (B*H = 12 or 20) one block per (b, h) leaves most of the
// card idle, and a block that reads a byte a thread keeps few bytes in
// flight.
//
// All three put one (b, h) on a thread-block cluster of C CTAs (C <= 16,
// chosen by the wrapper so the grid fills the card: 16 at B*H = 12 or 20
// and Ta = 1500; for K2 at G > 1, which holds two CTAs an SM, so that the
// grid stays in one wave), each owning a contiguous range of whole 16-key chunks (at
// least 64 keys a CTA), and keep the range's logits in shared memory.  The
// CTAs then agree on the softmax in one exchange through distributed shared
// memory (`cluster_softmax`): each stores its (max m_r, sum s_r of exp(s -
// m_r)) into a slot of every CTA's shared memory with `st.async`, whose
// bytes complete a transaction count on an mbarrier there (a push: no CTA
// waits on a remote load, and none on a cluster-wide barrier), and every
// CTA merges the slots in rank order: m = max m_r, sum = sum over r of s_r
// exp(m_r - m), the same bits in every CTA.  Only then does a CTA weight
// its V, each key's weight formed from its logit and rounded to bf16.  The
// C partial outputs are stored the same way into slots of rank 0, which
// adds them in rank order: two launches give the same bits, with no
// atomics, workspace or second kernel.  The per-position scales (K2, K5)
// come into shared memory by 4-byte `cp.async`: a layer's slice of the
// stacked scales starts only 4-byte aligned at odd Ta.
//
// K4/K5 (`xattn_cluster_kernel<KV, kScaled>`): a range's K rows and its V
// rows are each one contiguous run of bytes; thread 0 starts both with
// `cp.async.bulk` (1-D TMA) into shared memory at the top, each on its own
// mbarrier, so V lands while the CTA computes its logits.  A longer range
// (past the wrapper's tile: 128 keys in bf16, 256 in int8, 16 KB either
// way) streams through a ring of such tiles (K tiles, then V tiles; the
// wrapper picks the depth), which keeps a CTA's shared memory small enough
// for every CTA of the grid to be resident at once.  A group of 8 lanes
// dots one key row with q (8 channels a lane).
//
// K2 (`xattn_q8dt_kernel<kWords, kG>`) reads the Dh-major layout as it lies:
// its d-rows are Ta bytes apart, only 4-byte aligned at Ta = 1500 and
// 1-byte aligned at odd Ta, so neither a 2-D tensor map (16-byte strides)
// nor a 1-D bulk copy (16-byte source and size) can take them.  A thread
// owns 4 consecutive keys, one 32-bit word of each d-row (kWords; byte by
// byte where Ta % 4 != 0 or a pointer is not 4-byte aligned), so a warp
// instruction reads 128 contiguous bytes; when the range has few words the
// d-rows are split over up to 8 groups of threads whose partial dots meet
// in shared memory, and each thread loads 8 rows at once, so the whole
// range is in flight at batch 1.  For V a warp takes whole d-rows (d =
// warp + 8 r), its lanes a word of keys at a time against their 4 weights,
// then a shuffle sum; each lane's first word of 8 V rows is loaded before
// pass 1, so at batch 1 all of V lands while the logits are formed.  Every
// code it reads serves all kG queries (a thread keeps kG x 4 dots in pass
// 1 and kG x 8 sums in pass 2), so K and V are read once for the group;
// the exchange carries kG (max, sum) pairs and rank 0 adds kG x Dh partial
// outputs in rank order.  kG = 1 is the single-query kernel.
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError() (or the error that kept it from launching).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDh = 64;                          // K4/K5
constexpr int kMaxDh = 128;                      // K2
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = kDh / 8;            // 8 channels a lane
constexpr int kRowsPerWarp = 32 / kLanesPerRow;  // 4
constexpr int kRowsPerStep = kWarps * kRowsPerWarp;
constexpr int kMaxTa = 16384;                    // the logits stay in shared memory
constexpr int kMaxQueries = 8;                   // K2's G: WHISPER_MAX_DECODERS
constexpr size_t kQ8dtMaxSmem = 200 * 1024;      // K2's dynamic shared memory

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kG max- or sum-reductions over the block at once, each in the same
// order; every thread gets the results.  scratch: kWarps x kG floats.
template <bool kMax, int kG>
__device__ __forceinline__ void block_reduce(float* x, float* scratch) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < kG; ++g) x[g] = kMax ? warp_max(x[g]) : warp_sum(x[g]);
  __syncthreads();   // scratch free from any previous reduction
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) scratch[warp * kG + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float y = lane < kWarps ? scratch[lane * kG + g] : (kMax ? -INFINITY : 0.f);
    x[g] = kMax ? warp_max(y) : warp_sum(y);
  }
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
  block_reduce<kMax, 1>(&x, scratch);
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

constexpr int kKeyChunk = 16;       // a CTA's key range is whole chunks
constexpr int kMinKeys = 64;        // at least this many keys a CTA
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 8 * kMaxStages;   // the stages' mbarriers

// all stages of K4/K5 together
template <typename KV>
constexpr int max_stage_bytes() { return sizeof(KV) == 2 ? 96 * 1024 : 64 * 1024; }

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
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
      ::"r"(addr), "f"(v), "r"(bar)
      : "memory");
}
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

// One f32 from global `src` (4-byte aligned) to shared `dst`, asynchronous;
// cp_async_wait_all() makes this thread's copies visible to it
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The CTA's keys [t0, t0 + n_keys): chunks [r * n / C, (r + 1) * n / C) of
// the n = ceil(Ta / 16), clipped at Ta; `cap` is the longest range of the
// cluster, what shared memory holds
struct KeyRange {
  int t0, n_keys, cap;
};
__device__ __forceinline__ KeyRange key_range(int Ta, int rank, int n_ranks) {
  const int n_chunks = (Ta + kKeyChunk - 1) / kKeyChunk;
  const int t0 = rank * n_chunks / n_ranks * kKeyChunk;
  return {t0, min((rank + 1) * n_chunks / n_ranks * kKeyChunk, Ta) - t0,
          min((n_chunks + n_ranks - 1) / n_ranks * kKeyChunk, Ta)};
}

// kG softmaxes over the whole of Ta from each CTA's maxes and sums: each
// CTA stores its kG pairs into slot `rank` of every CTA (thread r takes
// CTA r; stats: kMaxCluster x kG pairs) and merges the slots in rank order
// -> m (max) and inv (1 / sum), the same bits in every CTA.  Its
// cluster_wait matches the caller's cluster_arrive_relaxed.
template <int kG>
__device__ __forceinline__ void cluster_softmax(const float* m_cta, const float* s_cta,
                                                int rank, int n_ranks, float2* stats,
                                                uint32_t stats_bar, float* m, float* inv) {
  cluster_wait();
  if (threadIdx.x < n_ranks) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      st_async(map_rank(smem_u32(&stats[rank * kG + g]), threadIdx.x),
               make_float2(m_cta[g], s_cta[g]), map_rank(stats_bar, threadIdx.x));
  }
  mbar_wait(stats_bar, 0);
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float mg = stats[g].x;
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < n_ranks) mg = fmaxf(mg, stats[r * kG + g].x);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_ranks) sum += stats[r * kG + g].y * expf(stats[r * kG + g].x - mg);
    m[g] = mg;
    inv[g] = 1.f / sum;
  }
}

// ---- K4/K5: (B, H, Ta, Dh) K/V --------------------------------------------

// Grid (C * B * H), cluster (C, 1, 1): cluster i is (b, h) = i.  CTA rank
// r takes its key_range.  Its range arrives in tiles of `tile_keys` rows
// (the whole range when it fits): load i of 2 * n_tiles is K tile i, then
// V tile i - n_tiles, into stage i % n_stages.  kScaled (K5): k_s/v_s
// scale each key's logit and weight.  Shared memory: xattn_smem.
template <typename KV, bool kScaled>
__global__ void __launch_bounds__(kThreads)
xattn_cluster_kernel(const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ k, const float* __restrict__ k_s,
                     const KV* __restrict__ v, const float* __restrict__ v_s,
                     float* __restrict__ out, int Ta, int tile_keys,
                     int n_stages, float scale) {
  constexpr int kRowBytes = kDh * sizeof(KV);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const size_t bh = blockIdx.x / n_ranks;       // b * H + h
  const KeyRange range = key_range(Ta, rank, n_ranks);
  const int t0 = range.t0, n_keys = range.n_keys;
  const int n_tiles = (n_keys + tile_keys - 1) / tile_keys;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int sub = lane % kLanesPerRow;          // which 8 channels
  const int slot = lane / kLanesPerRow;         // which row of the warp's 4

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem);         // stage s's at bar0 + 8 s
  KV* stages = reinterpret_cast<KV*>(smem + kBarBytes);
  const size_t stage_elems = (size_t)tile_keys * kDh;
  // the range's logits (K5: first its K scales), and K5's V scales
  float* w = reinterpret_cast<float*>(smem + kBarBytes +
                                      n_stages * stage_elems * sizeof(KV));
  float* vs = w + range.cap;
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
  if constexpr (kScaled) {
    // the range's scales while K and V land
    const size_t base = bh * Ta + t0;
    for (int t = threadIdx.x; t < n_keys; t += kThreads) {
      cp_async4(w + t, k_s + base + t);
      cp_async4(vs + t, v_s + base + t);
    }
    cp_async_wait_all();
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
      // K5: the key's scale, read before the shuffles below (its slot then
      // takes the logit)
      const float ks = kScaled && valid ? w[i * tile_keys + r] : 1.f;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (valid) load8(kt + r * kDh, kf);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d = fmaf(qf[j], kf[j], d);
#pragma unroll
      for (int o = 1; o < kLanesPerRow; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (valid) {
        const float s = kScaled ? d * ks * scale : d * scale;
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
  // cluster's
  const float m_cta = block_reduce<true>(local_max, scratch);
  float local_sum = 0.f;
  for (int t = threadIdx.x; t < n_keys; t += kThreads) local_sum += expf(w[t] - m_cta);
  const float s_cta = block_reduce<false>(local_sum, scratch);
  float m, inv_sum;
  cluster_softmax<1>(&m_cta, &s_cta, rank, n_ranks, stats, smem_u32(&stats_bar), &m,
                     &inv_sum);

  // pass 2: each lane sums its 8 channels over the rows its group visits
  // (the rows whose logits it wrote), each row's softmax weight (times its
  // V scale, K5) formed from its logit and the global max and sum and
  // rounded to bf16 as the reference does
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int i = n_tiles + tile;
    mbar_wait(bar0 + 8 * (i % n_stages), (i / n_stages) & 1);
    const KV* vt = stages + (i % n_stages) * stage_elems + sub * 8;
    const float* wt = w + tile * tile_keys;
    const float* vst = vs + tile * tile_keys;
    const int rows = rows_of(tile);
    for (int r = warp * kRowsPerWarp + slot; r < rows; r += kRowsPerStep) {
      float vf[8];
      load8(vt + r * kDh, vf);
      const float e = expf(wt[r] - m) * inv_sum;
      const float p = round_bf16(kScaled ? e * vst[r] : e);
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
// tile_keys rows, range_cap f32 logits (and as many V scales, K5).
template <typename KV, bool kScaled>
size_t xattn_smem(int tile_keys, int n_stages, int range_cap) {
  return kBarBytes + (size_t)n_stages * tile_keys * kDh * sizeof(KV) +
         (kScaled ? 2 : 1) * (size_t)range_cap * sizeof(float);
}

// A cluster size the kernels take: 1-16, at most one CTA per kMinKeys keys,
// and C * B * H blocks in one grid dimension
bool bad_cluster(int B, int H, int Ta, int cluster) {
  return B < 1 || H < 1 || Ta < 1 || Ta > kMaxTa || cluster < 1 ||
         cluster > kMaxCluster || cluster > (Ta + kMinKeys - 1) / kMinKeys ||
         (long long)cluster * B * H > INT_MAX;
}

// Launch `kernel` on a grid of cluster * B * H CTAs in clusters of
// `cluster`, after setting its attributes once per device (`ready_on`, the
// caller's for this kernel): `max_smem` bytes of dynamic shared memory,
// clusters above the portable 8
template <typename Kernel, typename... Args>
int launch_on_clusters(Kernel kernel, int& ready_on, size_t max_smem, int cluster,
                       int B, int H, size_t smem, void* stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (ready_on != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return (int)err;
    ready_on = dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * B * H, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int longest_range(int Ta, int cluster) {
  const int n_chunks = (Ta + kKeyChunk - 1) / kKeyChunk;
  const int longest = (n_chunks + cluster - 1) / cluster * kKeyChunk;
  return longest < Ta ? longest : Ta;
}

template <typename KV, bool kScaled>
int launch_cluster(const void* q, const void* k, const void* k_s, const void* v,
                   const void* v_s, void* out, int B, int H, int Dh, int Ta,
                   int cluster, int tile_keys, int n_stages, void* stream) {
  if (Dh != kDh || bad_cluster(B, H, Ta, cluster) || tile_keys < 1 || n_stages < 2 ||
      n_stages > kMaxStages ||
      (long long)n_stages * tile_keys * kDh * sizeof(KV) > max_stage_bytes<KV>())
    return (int)cudaErrorInvalidValue;
  static int ready_on = -1;
  return launch_on_clusters(
      xattn_cluster_kernel<KV, kScaled>, ready_on,
      xattn_smem<KV, kScaled>(max_stage_bytes<KV>() / (kDh * sizeof(KV)), 1, kMaxTa),
      cluster, B, H, xattn_smem<KV, kScaled>(tile_keys, n_stages, longest_range(Ta, cluster)),
      stream, static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const float*>(k_s), static_cast<const KV*>(v),
      static_cast<const float*>(v_s), static_cast<float*>(out), Ta, tile_keys, n_stages,
      1.0f / sqrtf((float)Dh));
}

// ---- K2: (B, H, Dh, Ta) int8 K/V ------------------------------------------

// 4 consecutive codes of one d-row from `p` as the bytes of a word: one
// 32-bit load (kWords: p 4-byte aligned, all 4 keys in the range), else
// byte by byte, the `valid` keys in the range and zeros past them
template <bool kWords>
__device__ __forceinline__ int load_codes4(const int8_t* p, int valid) {
  if constexpr (kWords) {
    return *reinterpret_cast<const int*>(p);
  } else {
    unsigned int word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < valid) word |= (unsigned int)(uint8_t)p[i] << (8 * i);
    return (int)word;
  }
}

// code i (byte i) of a word, as f32
__device__ __forceinline__ float code_of(int word, int i) {
  return (float)(int8_t)(word >> (8 * i));
}

constexpr int kMaxRowsPerWarp = kMaxDh / kWarps;   // V rows d = warp + 8 r
constexpr int kLoadRows = 8;                       // rows a thread loads at once

// 4 codes (`valid` of them in the range) of kLoadRows d-rows `stride` bytes
// apart from `p`, the first `rows` of them (zeros past), a word each
template <bool kWords>
__device__ __forceinline__ void load_rows(int (&c)[kLoadRows], const int8_t* p,
                                          size_t stride, int rows, int valid) {
#pragma unroll
  for (int r = 0; r < kLoadRows; ++r)
    c[r] = r < rows ? load_codes4<kWords>(p + r * stride, valid) : 0;
}

// The dynamic shared memory of K2 for a cluster of `cluster` CTAs and kG
// queries, in floats: the longest range's K scales, V scales and kG rows of
// logits (its keys rounded up to whole words), then a region that holds
// the d-groups' partial dots in pass 1 (kG x 1024) and, in rank 0, the
// cluster's partial outputs (cluster x kG x Dh) after it.  The wrapper
// (ops/cross_attention.py `_q8dt_smem`) computes the same.
size_t q8dt_smem_floats(int Ta, int cluster, int kG, int Dh) {
  const size_t cap4 = (longest_range(Ta, cluster) + 3) / 4 * 4;
  const size_t dots = (size_t)kG * kThreads * 4;
  const size_t parts = (size_t)cluster * kG * Dh;
  return (kG + 2) * cap4 + (dots > parts ? dots : parts);
}

// Grid (C * B * H), cluster (C, 1, 1): cluster i is (b, h) = i.  CTA rank
// r takes its key_range; word j of the range (keys 4j..4j+3) belongs to
// thread j % 256, which loads its scales and forms its kG logits and
// weights.  Shared memory: q8dt_smem_floats.
template <bool kWords, int kG>
__global__ void __launch_bounds__(kThreads)
xattn_q8dt_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_q,
                  const float* __restrict__ k_s, const int8_t* __restrict__ v_q,
                  const float* __restrict__ v_s, float* __restrict__ out, int Dh,
                  int Ta, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();
  const size_t bh = blockIdx.x / n_ranks;       // b * H + h
  const KeyRange range = key_range(Ta, rank, n_ranks);
  const int n_keys = range.n_keys;
  const int n_words = (n_keys + 3) / 4;
  const int cap4 = (range.cap + 3) / 4 * 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);   // K scales
  float* vs = ks + cap4;                        // V scales
  float* w = vs + cap4;                         // query g's logits at w + g * cap4
  float* part = w + kG * cap4;                  // pass 1's partial dots, then
  float* parts = part;                          // rank 0's (rank, g, d) slots
  __shared__ float qf[kG][kMaxDh];
  __shared__ float scratch[kWarps * kG];
  __shared__ __align__(16) float2 stats[kMaxCluster * kG];
  __shared__ __align__(8) uint64_t stats_bar, parts_bar;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&stats_bar), 1);
    mbar_init(smem_u32(&parts_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(smem_u32(&stats_bar), n_ranks * kG * sizeof(float2));
    if (rank == 0) mbar_expect_tx(smem_u32(&parts_bar), n_ranks * kG * Dh * sizeof(float));
  }
  const size_t base = bh * Ta + range.t0;
  for (int j = threadIdx.x; j < n_words; j += kThreads) {
    for (int t = 4 * j; t < 4 * j + 4 && t < n_keys; ++t) {
      cp_async4(ks + t, k_s + base + t);
      cp_async4(vs + t, v_s + base + t);
    }
  }
  for (int i = threadIdx.x; i < kG * Dh; i += kThreads)
    qf[i / Dh][i % Dh] = __bfloat162float(q[bh * kG * Dh + i]);

  // pass 1: groups of 256 / n_groups threads, each group d-rows [d0, d1),
  // a thread one word of keys at a time (words j0, j0 + 256 / n_groups,
  // ...); n_groups = 1 when the words fill the block.  Pass 2's first
  // loads (V rows d = warp + 8 r, r < 8, at word `lane`) are made here, in
  // flight during pass 1 and the softmax.
  int n_groups = 1;
  while (n_groups < 8 && 2 * n_groups * n_words <= kThreads) n_groups *= 2;
  const int tpg = kThreads / n_groups;
  const int grp = threadIdx.x / tpg, j0 = threadIdx.x % tpg;
  const int rpg = (Dh + n_groups - 1) / n_groups;
  const int d0 = min(Dh, grp * rpg), d1 = min(Dh, d0 + rpg);
  const int8_t* kb = k_q + (bh * Dh + d0) * Ta + range.t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = (Dh - warp + kWarps - 1) / kWarps;
  const int8_t* vb = v_q + (bh * Dh + warp) * Ta + range.t0;
  int vc[kLoadRows];
  if (lane < n_words)
    load_rows<kWords>(vc, vb + 4 * lane, (size_t)kWarps * Ta, rows, min(4, n_keys - 4 * lane));
  __syncthreads();
  cluster_arrive_relaxed();  // cluster_softmax waits on it

  float local_max[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) local_max[g] = -INFINITY;
  for (int j = j0; j < n_words; j += tpg) {
    const int valid = min(4, n_keys - 4 * j);
    float a[kG][4];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[g][i] = 0.f;
    }
    const int8_t* p = kb + 4 * j;
    int d = d0;
#pragma unroll 2
    for (; d + kLoadRows <= d1; d += kLoadRows, p += (size_t)kLoadRows * Ta) {
      int kc[kLoadRows];
      load_rows<kWords>(kc, p, Ta, kLoadRows, valid);
#pragma unroll
      for (int u = 0; u < kLoadRows; ++u) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[g][i] = fmaf(qf[g][d + u], code_of(kc[u], i), a[g][i]);
        }
      }
    }
    for (; d < d1; ++d, p += Ta) {
      const int c = load_codes4<kWords>(p, valid);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[g][i] = fmaf(qf[g][d], code_of(c, i), a[g][i]);
      }
    }
    if (n_groups == 1) {   // this thread's own word: its K scales are in
      cp_async_wait_all();
      for (int i = 0; i < valid; ++i) {
        const float kscale = ks[4 * j + i];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float s = a[g][i] * kscale * scale;
          w[g * cap4 + 4 * j + i] = s;
          local_max[g] = fmaxf(local_max[g], s);
        }
      }
    } else {               // j < tpg: one word a thread
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[((g * n_groups + grp) * tpg + j) * 4 + i] = a[g][i];
      }
    }
  }
  if (n_groups > 1) {      // thread j adds word j's partial dots in group order
    cp_async_wait_all();
    __syncthreads();
    const int j = threadIdx.x;
    for (int i = 0; j < n_words && i < min(4, n_keys - 4 * j); ++i) {
      const float kscale = ks[4 * j + i];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = part[(g * n_groups * tpg + j) * 4 + i];
        for (int gg = 1; gg < n_groups; ++gg) dot += part[((g * n_groups + gg) * tpg + j) * 4 + i];
        const float s = dot * kscale * scale;
        w[g * cap4 + 4 * j + i] = s;
        local_max[g] = fmaxf(local_max[g], s);
      }
    }
  }

  // the kG softmaxes over the whole of Ta
  float m_cta[kG], s_cta[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) m_cta[g] = local_max[g];
  block_reduce<true, kG>(m_cta, scratch);
#pragma unroll
  for (int g = 0; g < kG; ++g) s_cta[g] = 0.f;
  for (int j = threadIdx.x; j < n_words; j += kThreads)
    for (int t = 4 * j; t < 4 * j + 4 && t < n_keys; ++t) {
#pragma unroll
      for (int g = 0; g < kG; ++g) s_cta[g] += expf(w[g * cap4 + t] - m_cta[g]);
    }
  block_reduce<false, kG>(s_cta, scratch);
  float m[kG], inv[kG];
  cluster_softmax<kG>(m_cta, s_cta, rank, n_ranks, stats, smem_u32(&stats_bar), m, inv);
  // the weights times the V scales, rounded to bf16 as the reference does;
  // zeros past the range in its last word
  for (int j = threadIdx.x; j < n_words; j += kThreads)
    for (int t = 4 * j; t < 4 * j + 4; ++t) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float* wt = w + g * cap4 + t;
        *wt = t < n_keys ? round_bf16(expf(*wt - m[g]) * inv[g] * vs[t]) : 0.f;
      }
    }
  __syncthreads();

  // pass 2: warp `warp` takes V rows d = warp + 8 r, 8 rows at a time (h),
  // its lanes a word of keys at a time (the first one already loaded) for
  // all kG weight rows; each row's sum into rank 0's slot (rank, g, d),
  // where they are added in rank order
#pragma unroll
  for (int h = 0; h < kMaxRowsPerWarp / kLoadRows; ++h) {
    if (h * kLoadRows >= rows) break;
    float acc[kG][kLoadRows];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r) acc[g][r] = 0.f;
    }
    for (int j = lane; j < n_words; j += 32) {
      if (h > 0 || j > lane)
        load_rows<kWords>(vc, vb + (size_t)h * kLoadRows * kWarps * Ta + 4 * j,
                          (size_t)kWarps * Ta, rows - h * kLoadRows, min(4, n_keys - 4 * j));
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 wt = *reinterpret_cast<const float4*>(w + g * cap4 + 4 * j);
#pragma unroll
        for (int r = 0; r < kLoadRows; ++r) {
          float& a = acc[g][r];
          a = fmaf(wt.x, code_of(vc[r], 0), a);
          a = fmaf(wt.y, code_of(vc[r], 1), a);
          a = fmaf(wt.z, code_of(vc[r], 2), a);
          a = fmaf(wt.w, code_of(vc[r], 3), a);
        }
      }
    }
    // every lane gets every (g, r) sum; lane l then stores sum l (32 at a
    // time), so a warp's kG x 8 stores leave in ceil(kG / 4) instructions
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r) acc[g][r] = warp_sum(acc[g][r]);
    }
#pragma unroll
    for (int base = 0; base < kG * kLoadRows; base += 32) {
      const int idx = base + lane, g = idx / kLoadRows, r = idx % kLoadRows;
      float mine = 0.f;
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) {
#pragma unroll
        for (int rr = 0; rr < kLoadRows; ++rr)
          if (gg * kLoadRows + rr == idx) mine = acc[gg][rr];
      }
      if (idx < kG * kLoadRows && h * kLoadRows + r < rows)
        st_async(map_rank(smem_u32(&parts[(rank * kG + g) * Dh + warp +
                                          kWarps * (h * kLoadRows + r)]), 0),
                 mine, map_rank(smem_u32(&parts_bar), 0));
    }
  }
  if (rank == 0) {
    mbar_wait(smem_u32(&parts_bar), 0);
    for (int i = threadIdx.x; i < kG * Dh; i += kThreads) {
      float o = 0.f;
      for (int r = 0; r < n_ranks; ++r) o += parts[r * kG * Dh + i];
      out[bh * kG * Dh + i] = o;
    }
  }
}

template <bool kWords, int kG>
int launch_q8dt(const void* q, const void* k_q, const void* k_s, const void* v_q,
                const void* v_s, void* out, int B, int H, int Dh, int Ta, int cluster,
                void* stream) {
  const size_t smem = 4 * q8dt_smem_floats(Ta, cluster, kG, Dh);
  if (smem > kQ8dtMaxSmem) return (int)cudaErrorInvalidValue;
  static int ready_on = -1;
  return launch_on_clusters(
      xattn_q8dt_kernel<kWords, kG>, ready_on, kQ8dtMaxSmem, cluster, B, H, smem, stream,
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_q),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v_q),
      static_cast<const float*>(v_s), static_cast<float*>(out), Dh, Ta,
      1.0f / sqrtf((float)Dh));
}

template <bool kWords>
int launch_q8dt_g(int G, const void* q, const void* k_q, const void* k_s, const void* v_q,
                  const void* v_s, void* out, int B, int H, int Dh, int Ta, int cluster,
                  void* stream) {
#define WTT_Q8DT_CASE(g) \
  case g:                \
    return launch_q8dt<kWords, g>(q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, cluster, stream);
  switch (G) {
    WTT_Q8DT_CASE(1)
    WTT_Q8DT_CASE(2)
    WTT_Q8DT_CASE(3)
    WTT_Q8DT_CASE(4)
    WTT_Q8DT_CASE(5)
    WTT_Q8DT_CASE(6)
    WTT_Q8DT_CASE(7)
    WTT_Q8DT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WTT_Q8DT_CASE
}

}  // namespace

// K2: int8 (B, H, Dh, Ta) K/V with (B, H, Ta) scales, Dh 1-128, G queries
// a (b, h) (1-8: q and out (B, H, G, Dh)), each (b, h) on a cluster of
// `cluster` CTAs (1-16, at most ceil(Ta / 64), within K2's shared memory:
// q8dt_smem_floats); `words` reads the codes a 32-bit word at a time, which
// needs Ta % 4 == 0 and 4-byte aligned k_q and v_q (else byte by byte)
extern "C" int wtt_cross_attention_q8(const void* q, const void* k_q, const void* k_s,
                                      const void* v_q, const void* v_s, void* out,
                                      int B, int H, int G, int Dh, int Ta, int cluster,
                                      int words, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || G < 1 || G > kMaxQueries || bad_cluster(B, H, Ta, cluster))
    return (int)cudaErrorInvalidValue;
  if (!words)
    return launch_q8dt_g<false>(G, q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, cluster, stream);
  if (Ta % 4 || ((uintptr_t)k_q | (uintptr_t)v_q) % 4) return (int)cudaErrorInvalidValue;
  return launch_q8dt_g<true>(G, q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, cluster, stream);
}

// K4: bf16 K/V, each (b, h) on a cluster of `cluster` CTAs (1-16, at most
// ceil(Ta / 64)), its K and V arriving in tiles of `tile_keys` rows through
// `n_stages` stages (2-8, 96 KB in all; a range that fits in one tile
// lands in one copy each)
extern "C" int wtt_cross_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Dh, int Ta,
                                   int cluster, int tile_keys, int n_stages,
                                   void* stream) {
  return launch_cluster<__nv_bfloat16, false>(q, k, nullptr, v, nullptr, out, B, H, Dh,
                                              Ta, cluster, tile_keys, n_stages, stream);
}

// K5: int8 K/V with (B, H, Ta, 1) f32 scales, the same plan arguments as
// K4 (stages 64 KB in all)
extern "C" int wtt_cross_attention_bhtd_q8(const void* q, const void* k_q,
                                           const void* k_s, const void* v_q,
                                           const void* v_s, void* out, int B,
                                           int H, int Dh, int Ta, int cluster,
                                           int tile_keys, int n_stages, void* stream) {
  return launch_cluster<int8_t, true>(q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, cluster,
                                      tile_keys, n_stages, stream);
}
