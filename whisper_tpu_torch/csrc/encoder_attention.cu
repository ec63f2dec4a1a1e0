// Encoder self-attention: kernel K1 of whisper_tpu_torch, and K6 on the
// same device code.
//
// K1 replaces whisper_tpu/ops/encoder_attention.py `encoder_attention` /
// `_attn_kernel` (Pallas, TPU); K6 replaces `encoder_attention_btd` /
// `_attn_btd_kernel`.  Both compute out = softmax(Q K^T * 64^-1/2) V per
// (batch, head), keys at or beyond t_valid masked, no causal mask, bf16 in
// and f32 out; rows past t_valid (the padding of encode's padded variants)
// are computed like any other row and sliced off by the caller.
//
// What bounds it on the H100.  At T = 1500, Dh = 64 one (b, h) is two
// T x T x 64 products (0.58 GFLOP) against 0.6 MB of bf16 q/k/v: 950
// operations a byte, far above the card's ~295 bf16 ridge, so the tensor
// cores bound it, and only `wgmma` reaches their full rate.  At Dh = 64
// the softmax is nearly as costly: each score takes 256 tensor-core
// operations and one exp2, and the SM issues 16 exp2 a clock, so the
// exponentials take as long as the products unless the two overlap.
//
// Design.  The TPU kernel holds one head's whole K/V in VMEM (~384 KB), more
// than a block's 227 KB, so here K/V stream through shared memory with an
// online softmax:
//   * one CTA per (b, h, 128 queries): two warpgroups of 64 query rows;
//   * Q once and 128-key K/V tiles arrive by TMA (`cp.async.bulk.tensor`,
//     128-byte swizzle) in a ring of two stages, each stage completing on
//     an mbarrier; thread 0 fills both stages at the start, and the last of
//     the 8 warps to release a stage (a shared counter) refills it, so no
//     warp waits for a free stage; tiles wholly past t_valid are never
//     loaded.  No producer warp: a ninth warp puts five warps of the two
//     CTAs on one of the SM's four register-file quarters, which held
//     every thread to 96 registers (ptxas: 488 bytes of spills, wgmma
//     serialized) and left `setmaxnreg` nothing to hand the consumers;
//   * S = Q K^T runs on `wgmma` m64n128k16 from shared memory into f32
//     registers; the online softmax works on those fragments (each thread
//     owns two rows, a row's max reduces over the 4 lanes of a quad, exp2
//     with scale * log2(e) folded in); P is converted to bf16 in place and
//     O += P V runs on `wgmma` m64n64k16 with P as the A operand from
//     registers.  Scores and O never touch shared memory;
//   * masking by index: only a tile that straddles t_valid masks, so the
//     padded keys of K6 and of the Dh-major entry may hold anything finite;
//   * shared memory is Q 16 KB + 2 x (K 16 + V 16) KB = 80 KB and each
//     thread is held to 128 registers, so two CTAs share an SM:
//     (1, 1500, 20) is 240 CTAs, one wave on 132 SMs.  Inside a
//     warpgroup the products and the softmax take turns; only the SM's
//     four warpgroups overlap them (cutting the softmax out saves 30%,
//     cutting the exp2 alone or the K/V loads nothing: the instructions
//     between the products bound it, not the exp unit or the memory);
//   * epilogue: each thread divides its two rows by their sums and stores
//     them from registers; every store instruction of a warp fills whole
//     32-byte sectors in both layouts.
//
// Two layouts, one template:
//   * rows (kDhMajor = false): (B, T, H, Dh), i.e. (B, T, D) with head h
//     the Dh-wide column slice h of each row: a 4-D tensor map (64, H, T, B)
//     with box (64, 1, 128, 1) lands a tile as [t][d], 128 bytes a row.
//     K1's `self_attention` entry (T = t_valid; TMA zero-fills rows >= T)
//     and K6 (T = Tp).  Q and K are K-major operands, V is MN-major (the
//     B operand's transpose bit).  Output (B, T, H*Dh) f32.
//   * Dh-major (kDhMajor = true): (B, H, Dh, Tp), the TPU kernel's own
//     layout (encode's pallas_dt / pallas_pf), as a 2-D map (Tp, B*H*Dh)
//     with box (64, 64): a tile lands as two [d][t] halves of 64 keys.  Q
//     and K are MN-major, V K-major, by the `wgmma` transpose bits; no copy
//     transposes anything.  Output (B, H, Dh, Tp) f32, written [d][t].
//
// The tensor maps are built by the C entry points with the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no libcuda at link time; they reach the kernel as
// __grid_constant__ parameters (by value, also inside a CUDA graph).
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError() (or the error that kept it from launching).

#include <cuda.h>   // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;                 // head dim (every Whisper model)
constexpr int kBlockQ = 128;            // queries per CTA
constexpr int kBlockK = 128;            // keys per K/V tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kWarps = 8;               // two warpgroups of 64 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = kBlockK * kDh * 2;     // a Q, K or V tile, bf16
constexpr int kHalfBytes = kTileBytes / 2;        // 64 rows of 128 bytes
// tiles, then the mbarriers (Q, full[kStages]) and the stages' release
// counters; 1 KB of slack to align the tiles to the 1024 bytes of the
// swizzle pattern
constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + kStages) + 4 * kStages;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

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

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Rows [r0, r0 + 128) of head h of batch b into a 16 KB tile at `dst`:
// rows layout [t][d] in one box; Dh-major two [d][t] boxes of 64 rows.
template <bool kDhMajor>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int h, int b,
                                          int H) {
  if (kDhMajor) {
    const int row = (b * H + h) * kDh;
    tma_load_2d(dst, map, bar, r0, row);
    tma_load_2d(dst + kHalfBytes, map, bar, r0 + 64, row);
  } else {
    tma_load_4d(dst, map, bar, 0, h, r0, b);
  }
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major: SBO is the
// stride between 8-row groups (LBO unused).  MN-major: LBO is the stride
// between 64-element MN blocks, SBO between groups of 8 K rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from touching accumulators across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WTT_F8(op, d, i)                                                   \
  op(d[i]), op(d[i + 1]), op(d[i + 2]), op(d[i + 3]), op(d[i + 4]),        \
      op(d[i + 5]), op(d[i + 6]), op(d[i + 7])
#define WTT_F64(op, d)                                                     \
  WTT_F8(op, d, 0), WTT_F8(op, d, 8), WTT_F8(op, d, 16), WTT_F8(op, d, 24), \
      WTT_F8(op, d, 32), WTT_F8(op, d, 40), WTT_F8(op, d, 48),             \
      WTT_F8(op, d, 56)
#define WTT_F32(op, d) \
  WTT_F8(op, d, 0), WTT_F8(op, d, 8), WTT_F8(op, d, 16), WTT_F8(op, d, 24)
#define WTT_OUT(x) "=f"(x)
#define WTT_INOUT(x) "+f"(x)
#define WTT_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WTT_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// S (64 x 128 f32 per warpgroup) = A B, both from shared memory; the first
// k-step overwrites S, the later ones accumulate.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_s_first(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WTT_D64
      ", %64, %65, p, 1, 1, %67, %68;\n\t}"
      : WTT_F64(WTT_OUT, d)
      : "l"(da), "l"(db), "r"(0), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_s_acc(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WTT_D64
      ", %64, %65, p, 1, 1, %67, %68;\n\t}"
      : WTT_F64(WTT_INOUT, d)
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// O (64 x 64 f32 per warpgroup) += P V, P a 64 x 16 bf16 slice from
// registers (the accumulator layout of S), V from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_o(float (&d)[32], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : WTT_F32(WTT_INOUT, d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the kernel ---------------------------------------------------------

// Grid (ceil(T / 128), H, B).  T is the layout's row count (t_valid for
// the rows entry, Tp otherwise); keys >= t_valid are masked.
// Accumulator fragment of a warpgroup's 64 rows: thread (warp w, lane l)
// holds rows 16w + l/4 and 16w + l/4 + 8; register i is row-half (i >> 1)
// & 1, column 8 (i / 4) + 2 (l % 4) + (i & 1).
template <bool kDhMajor>
__global__ void __launch_bounds__(kThreads, 2)
encoder_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         float* __restrict__ out, int T, int t_valid, int H,
                         float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + kBarOffset;     // full(s) = bar_q + 8 (1 + s)
  // per stage, how many warps have released it (8 per use of the stage)
  uint32_t* released = reinterpret_cast<uint32_t*>(
      smem_raw + (bar_q + 8 * (1 + kStages) - smem_u32(smem_raw)));
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_valid + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;

  // K and V of tile `it` into stage it % kStages, by TMA
  auto load_kv = [&](int it) {
    const int s = it % kStages;
    const uint32_t full = bar_q + 8 * (1 + s);
    const uint32_t k_tile = base + (1 + 2 * s) * kTileBytes;
    mbar_expect_tx(full, 2 * kTileBytes);
    load_tile<kDhMajor>(k_tile, &tm_k, full, it * kBlockK, h, b, H);
    load_tile<kDhMajor>(k_tile + kTileBytes, &tm_v, full, it * kBlockK, h, b, H);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_q + 8 * (1 + s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(bar_q, kTileBytes);
    load_tile<kDhMajor>(base, &tm_q, bar_q, q0, h, b, H);
    for (int it = 0; it < kStages && it < n_tiles; ++it) load_kv(it);
  }
  __syncthreads();

  // this warpgroup's 64 Q rows: rows 64 wg.. of a [t][d] tile, or the
  // [d][t] half wg
  const uint64_t dq = kDhMajor ? smem_desc(base + wg * kHalfBytes, 1024, 1024)
                               : smem_desc(base + wg * kHalfBytes, 16, 1024);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sums

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(bar_q + 8 * (1 + s), (it / kStages) & 1);
    const uint32_t k_tile = base + (1 + 2 * s) * kTileBytes;
    const uint32_t v_tile = k_tile + kTileBytes;

    // S = Q K^T over Dh in four k16 steps
    float sc[64];
    wgmma_fence();
    if (kDhMajor) {   // [d][t]: a k-step is 16 rows of 128 bytes
      const uint64_t dk = smem_desc(k_tile, kHalfBytes, 1024);
      wgmma_s_first<1, 1>(sc, dq, dk);
#pragma unroll
      for (int kk = 1; kk < kDh / 16; ++kk)
        wgmma_s_acc<1, 1>(sc, dq + kk * (2048 >> 4), dk + kk * (2048 >> 4));
    } else {          // [t][d]: a k-step is 32 bytes along each row
      const uint64_t dk = smem_desc(k_tile, 16, 1024);
      wgmma_s_first<0, 0>(sc, dq, dk);
#pragma unroll
      for (int kk = 1; kk < kDh / 16; ++kk)
        wgmma_s_acc<0, 0>(sc, dq + kk * (32 >> 4), dk + kk * (32 >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = it * kBlockK;
    if (k0 + kBlockK > t_valid) {   // the tile that straddles t_valid
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
        if (col >= t_valid) sc[i] = -INFINITY;
      }
    }

    // online softmax on the fragments
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -mn1 : -mn0));
      sc[i] = p;
      if (i & 2) s1 += p;
      else s0 += p;
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? c1 : c0;

    // P in bf16: registers 8kk..8kk+7 of S are the A fragment of keys
    // 16kk..16kk+15
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // O += P V over the tile's 128 keys in eight k16 steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      // Dh-major: V [d][t] is K-major, keys 16kk.. in half kk / 4 at byte
      // (kk % 4) * 32 of each row.  Rows: V [t][d] is MN-major, keys 16kk..
      // from row 16kk (N = 64 is one MN block)
      const uint64_t dv =
          kDhMajor ? smem_desc(v_tile + (kk / 4) * kHalfBytes + (kk % 4) * 32,
                               16, 1024)
                   : smem_desc(v_tile + kk * 2048, 1024, 1024);
      wgmma_o<kDhMajor ? 0 : 1>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                pa[4 * kk + 3], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    // release stage s; the last of the 8 warps refills it with tile
    // it + kStages, so no warp ever waits for another to free a stage
    if (lane == 0 && it + kStages < n_tiles) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1u) % kWarps == kWarps - 1) load_kv(it + kStages);
    }
  }

  // epilogue: O / sum, stored from registers, rows past T clipped
  const float inv0 = 1.f / quad_sum(l0);
  const float inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int c = (lane % 4) * 2;
  if (kDhMajor) {   // [d][t]: per store, 8 lanes write 32 bytes along t
    float* head = out + ((size_t)b * H + h) * kDh * T;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      float* col = head + (size_t)(8 * j + c) * T;
      if (r0 < T) {
        col[r0] = o[4 * j] * inv0;
        col[T + r0] = o[4 * j + 1] * inv0;
      }
      if (r1 < T) {
        col[r1] = o[4 * j + 2] * inv1;
        col[T + r1] = o[4 * j + 3] * inv1;
      }
    }
  } else {          // [t][d]: per store, a quad writes 32 bytes of a row
    const size_t row_stride = (size_t)H * kDh;
    float* row0 = out + ((size_t)b * T + r0) * row_stride + (size_t)h * kDh + c;
    float* row1 = row0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      if (r0 < T)
        *reinterpret_cast<float2*>(row0 + 8 * j) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < T)
        *reinterpret_cast<float2*>(row1 + 8 * j) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Rows: (64, H, T, B) with box (64, 1, 128, 1).  Dh-major: (T, B*H*64)
// with box (64, 64).  bf16, 128-byte swizzle, rows past T read as zero.
template <bool kDhMajor>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int T, int H) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult rc;
  if (kDhMajor) {
    const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)B * H * kDh};
    const cuuint64_t strides[1] = {(cuuint64_t)T * 2};
    const cuuint32_t box[2] = {64, 64};
    rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[4] = {kDh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[3] = {kDh * 2, (cuuint64_t)H * kDh * 2,
                                   (cuuint64_t)T * H * kDh * 2};
    const cuuint32_t box[4] = {kDh, 1, kBlockK, 1};
    rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return rc == CUDA_SUCCESS;
}

template <bool kDhMajor>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int t_valid, int H, int Dh, void* stream) {
  if (Dh != kDh || B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535 ||
      t_valid < 1 || t_valid > T || (kDhMajor && T % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_map<kDhMajor>(encode, &maps[i], ptrs[i], B, T, H))
      return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_kernel<kDhMajor>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)kDh);
  encoder_attention_kernel<kDhMajor>
      <<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
          maps[0], maps[1], maps[2], static_cast<float*>(out), T, t_valid, H,
          scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: (B, T, H, Dh) -> (B, T, H*Dh), every key valid.
extern "C" int wtt_encoder_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int T, int H, int Dh,
                                     void* stream) {
  return launch<false>(q, k, v, out, B, T, T, H, Dh, stream);
}

// K1: (B, H, Dh, Tp) -> (B, H, Dh, Tp), keys >= t_valid masked.
extern "C" int wtt_encoder_attention_bhdt(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int Dh, int Tp, int t_valid,
                                          void* stream) {
  return launch<true>(q, k, v, out, B, Tp, t_valid, H, Dh, stream);
}

// K6: (B, Tp, H*Dh) -> (B, Tp, H*Dh), keys >= t_valid masked.
extern "C" int wtt_encoder_attention_btd(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Tp, int H, int Dh, int t_valid,
                                         void* stream) {
  return launch<false>(q, k, v, out, B, Tp, t_valid, H, Dh, stream);
}
