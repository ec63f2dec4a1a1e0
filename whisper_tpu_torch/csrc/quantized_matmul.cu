// Block-quantized weight matmul, kernel K3 of whisper_tpu_torch.
//
// Replaces whisper_tpu/ops/quantized.py `quantized_matmul` / `_qmm_kernel`
// and `_qmm_kernel_mins` (Pallas, TPU):
//   y[m, n] = sum_k bf16(x[m, k]) * w[k, n]
//   w[k, n] = bf16(code[k, n] * bf16(scale[k/32, n]))
//             (+ bf16(min[k/32, n]), rounded to bf16 again, with mins)
// x (M, K) f32 or bf16, rounded to bf16 in the kernel; codes (K, N) int8
// K-major; scales/mins (K/32, N) f32; y (M, N) f32.  The roundings are the
// TPU kernel's, so only the order of the f32 sums differs.
//
// Bound on the H100.  In the token loop M is the batch (1 in whisper_full,
// 4 in serving), so every call streams K*N code bytes for 2*M FLOP each:
// device-memory bandwidth, at (1, 1280, 1280) 1.8 MB, 0.55 us at 3.35
// TB/s.  Such a call is over in microseconds, so what bounds it in
// practice is how many bytes are in flight at once and how many launches
// it takes.  The carried-prompt pass (M = 232 rows, n_text_ctx / 2 + 8;
// B times that in a serving batch's prompt pass) does 2*M FLOP per code
// byte: past ~150 rows the bf16 tensor cores bound it, and only `wgmma`
// reaches them.
//
// Two device paths:
//   * M <= 8, every decode step (`qmm_decode_kernel`, templated on the M
//     tile 1, 2, 4 or 8): one launch a call.  A CTA owns 64 output columns
//     and a slice of K's 32-row blocks; the slices of one column tile form
//     one thread-block cluster of C CTAs (C <= 16, chosen by the wrapper so
//     the grid reaches ~2 CTAs an SM, e.g. 20 tiles x 16 at K = N = 1280),
//     and the two halves of a CTA's warps take alternate blocks.  At the
//     top one thread requests all of the slice by TMA: per 32-row block one
//     2-D box of codes (64 columns x 32 rows) and one of scales (and of
//     mins), on one mbarrier a block, so the whole slice is in flight before
//     the math starts and each block is used as soon as it lands (the
//     tensor maps are built on the host and kept by pointer and shape, as
//     the weights stay put; 5-9% faster than every thread issuing 16-byte
//     `cp.async`, tools/profile_encoder_torch.py on an H100).  x's slice is
//     read in its own dtype, rounded to bf16 once and kept in shared memory.
//     A warp takes 8 rows of a block, a lane 4 adjacent columns of 4: a
//     code's f32 value times the bf16 scale comes from one byte permute and
//     one FMA (2^23 + code + 128 as float bits; the bias times the scale is
//     exact in f32), the bf16 rounding from one packed convert a pair.  The
//     warps' sums meet in shared memory; each CTA stores its partial sums
//     into a slot of rank 0's shared memory with `st.async` (distributed
//     shared memory, a push whose bytes complete a transaction count on an
//     mbarrier in rank 0: no CTA waits on a remote load or a cluster-wide
//     barrier); rank 0 waits on that mbarrier and adds the slots in rank
//     order, so two launches give the same bits; no workspace, no second
//     kernel.
//   * M > 8, the carried-prompt pass (`qmm_prompt_kernel`): one launch
//     of `wgmma` tiles.  A CTA of two warpgroups owns 128 rows x 128
//     columns of y and walks K in 32-row blocks: one thread keeps a ring
//     of 3 blocks in flight by TMA (x's 128 x 32 box in its own dtype,
//     swizzled so each row is one swizzle span, and the codes and scales
//     boxes the decode path's tensor maps give); every thread rounds x to
//     bf16 into the A buffer (K-major, 64-byte swizzle) and dequantizes 16
//     codes into the B buffer (MN-major, 128-byte swizzle: the codes are
//     N-contiguous and `wgmma` reads B transposed), as the decode path
//     computes them; then each warpgroup runs two m64n128k16 `wgmma` into
//     f32 registers, which overlap the next block's preparation (three
//     operand buffers, one barrier a block; 112 KB of shared memory, so
//     two CTAs share an SM and overlap each other's barriers).  So W is
//     dequantized once per 128 rows, not once per 8 as before.  Where the
//     output tiles alone leave the card short of 132 CTAs, K is split over
//     a cluster of 2-8 CTAs, and each CTA owns a 128 / C-row slice of the
//     tile: after one cluster barrier every CTA pushes its partial rows
//     into their owner's slots (over its own finished ring) with
//     `st.async`, the owner adds them in rank order, so two launches give
//     the same bits; no workspace, no second kernel.  Rows past M are read
//     as zero by TMA and not stored.
// No dequantized copy of W is ever written to device memory.
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError() (or the error that kept it from launching).

#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <functional>
#include <mutex>
#include <unordered_map>

namespace cg = cooperative_groups;

namespace {

constexpr int kQK = 32;        // quantization block
constexpr int kTileN = 128;    // N must be a multiple of this (both paths)
constexpr int kDecodeM = 8;    // rows of x the decode path takes at most
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// prompt path (M > 8): a CTA's output tile, its ring of raw blocks as TMA
// lands them, and its bf16 operand buffers
constexpr int kPrM = 128;                   // rows: two warpgroups of 64
constexpr int kPrN = 128;                   // columns: two 64-column halves
constexpr int kPrStages = 3;                // raw 32-row blocks in flight
constexpr int kPrBufs = 3;                  // bf16 A/B buffers
constexpr int kPrMaxCluster = 8;
constexpr int kPrBBytes = kQK * kPrN * 2;   // B: [2 halves][32 k][64 n] bf16
constexpr int kPrABytes = kPrM * kQK * 2;   // A: [128 m][32 k] bf16
constexpr int kPrBufBytes = kPrBBytes + kPrABytes;
constexpr int kPrXBytes = kPrM * kQK * 4;   // raw x, f32 (bf16 uses half)
constexpr int kPrCodeBytes = kQK * kPrN;    // raw codes [2 halves][32][64]
constexpr int kPrStageBytes = kPrXBytes + kPrCodeBytes + 2 * kPrN * 4;
constexpr int kPrTileBytes = kPrM * kPrN * 4;   // the f32 tile, split K's slots
// decode path
constexpr int kMaxCluster = 16;
constexpr int kMaxPassKb = 16;              // 32-row blocks a CTA holds at once
constexpr int kDecCols = 64;                // output columns per CTA
constexpr int kDecCodeBytes = kQK * kDecCols;   // one 32-row block of a tile
// the blocks' mbarriers and rank 0's slots', padded to keep what follows
// 128-byte aligned (TMA boxes land there)
constexpr int kBarBytes = (8 * (kMaxPassKb + 2) + 127) / 128 * 128;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// x as read, rounded to bf16, as f32
__device__ __forceinline__ float bf16_of(float v) { return round_bf16(v); }
__device__ __forceinline__ float bf16_of(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- M <= 8 -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Box (64 columns, `c1`-th row of boxes) of a 2-D tensor map into shared
// memory at `dst` (128-byte aligned) by TMA, completing on the mbarrier at
// `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
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
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// bf16(a), bf16(b) as f32: one packed convert, two bit moves
__device__ __forceinline__ void round_pair(float& a, float& b) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = r.x;
  b = r.y;
}

// Shared memory of the decode path for a pass of `pass_kb` blocks and a
// cluster of `cluster` CTAs: the mbarriers, then codes [pass_kb][32][64]
// int8, scales and mins [pass_kb][64] f32, x [kM][pass_kb * 32] f32, the
// warps' sums [8][kM][64] and the cluster's partial sums [cluster][kM][64]
// (filled in rank 0 only).
__host__ __device__ constexpr size_t decode_smem(int kM, bool mins, int pass_kb,
                                                 int cluster) {
  return kBarBytes + (size_t)pass_kb * kDecCodeBytes +
         (size_t)(mins ? 2 : 1) * pass_kb * kDecCols * 4 +
         (size_t)kM * pass_kb * kQK * 4 + (size_t)kWarps * kM * kDecCols * 4 +
         (size_t)cluster * kM * kDecCols * 4;
}

// Grid (C, N / 64), cluster (C, 1, 1).  CTA rank r of a cluster takes
// 32-row blocks [r * nkb / C, (r + 1) * nkb / C) of column tile blockIdx.y,
// in passes of at most pass_kb blocks (one pass at every Whisper shape).
// Warps 0-3 take the pass's even blocks, warps 4-7 the odd ones; in a
// block, warp w % 4 takes rows 8 (w % 4) .. + 7, a lane 4 adjacent columns
// (lane % 16) of every other row (lane / 16 picks which).
template <int kM, bool kMins, typename XT>
__global__ void __launch_bounds__(kThreads)
qmm_decode_kernel(const XT* __restrict__ x,
                  const __grid_constant__ CUtensorMap tm_codes,
                  const __grid_constant__ CUtensorMap tm_scales,
                  const __grid_constant__ CUtensorMap tm_mins,
                  float* __restrict__ out, int M, int N, int K, int pass_kb) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int col4 = lane % 16;                   // columns 4 col4 .. + 3
  const int row0 = (warp % 4) * 8 + lane / 16;  // rows row0 + 2 i, i < 4
  const int col0 = blockIdx.y * kDecCols;
  const int nkb = K / kQK;
  const int kb_begin = (int)((long long)rank * nkb / n_ranks);
  const int kb_end = (int)((long long)(rank + 1) * nkb / n_ranks);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int8_t* cs = reinterpret_cast<int8_t*>(smem + kBarBytes);
  float* ss = reinterpret_cast<float*>(cs + (size_t)pass_kb * kDecCodeBytes);
  float* ms = ss + pass_kb * kDecCols;
  float* xs = ms + (kMins ? pass_kb * kDecCols : 0);
  float* red = xs + kM * pass_kb * kQK;
  float* slots = red + kWarps * kM * kDecCols;  // [n_ranks][kM][64]
  const int xs_ld = pass_kb * kQK;

  const uint32_t slots_bar = smem_u32(&bars[kMaxPassKb]);   // rank 0's
  if (tid == 0) {
    for (int j = 0; j < pass_kb; ++j) mbar_init(smem_u32(&bars[j]), 1);
    mbar_init(slots_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // what the cluster's CTAs will store into rank 0's slots
    if (rank == 0) mbar_expect_tx(slots_bar, n_ranks * M * kDecCols * sizeof(float));
  }
  __syncthreads();
  // the wait that matches this arrive, before the first remote store,
  // makes sure every CTA of the cluster is running, its mbarriers set up
  cluster_arrive_relaxed();

  float acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  int pass = 0;
  for (int p0 = kb_begin; p0 < kb_end; p0 += pass_kb, ++pass) {
    const int n = min(pass_kb, kb_end - p0);
    if (pass > 0) __syncthreads();   // every warp is done with the last pass
    // every request of the pass first, by one thread: block j's 32 code
    // rows, its 64 scales and mins, one TMA box each on block j's mbarrier
    if (tid == 0) {
      for (int j = 0; j < n; ++j) {
        const int kb = p0 + j;
        const uint32_t bar = smem_u32(&bars[j]);
        mbar_expect_tx(bar, kDecCodeBytes + (kMins ? 2 : 1) * kDecCols * sizeof(float));
        tma_load_2d(smem_u32(cs + j * kDecCodeBytes), &tm_codes, bar, col0, kb * kQK);
        tma_load_2d(smem_u32(ss + j * kDecCols), &tm_scales, bar, col0, kb);
        if (kMins) tma_load_2d(smem_u32(ms + j * kDecCols), &tm_mins, bar, col0, kb);
      }
    }
    // x's slice, rounded to bf16, while the copies are in flight
    for (int i = tid; i < kM * n * kQK; i += kThreads) {
      const int m = i / (n * kQK), kk = i % (n * kQK);
      xs[m * xs_ld + kk] = m < M ? bf16_of(x[(size_t)m * K + p0 * kQK + kk]) : 0.f;
    }
    __syncthreads();

    for (int j = warp / 4; j < n; j += 2) {
      mbar_wait(smem_u32(&bars[j]), pass & 1);
      // this lane's 4 columns: bf16 scales, and the f32 constant that
      // takes the float bits 2^23 + code + 128 to code * scale in one FMA
      const float4 s4 = *reinterpret_cast<const float4*>(ss + j * kDecCols + col4 * 4);
      const float s[4] = {round_bf16(s4.x), round_bf16(s4.y), round_bf16(s4.z),
                          round_bf16(s4.w)};
      float bias[4], mn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) bias[e] = -8388736.f * s[e];   // exact
      if (kMins) {
        const float4 m4 = *reinterpret_cast<const float4*>(ms + j * kDecCols + col4 * 4);
        mn[0] = round_bf16(m4.x);
        mn[1] = round_bf16(m4.y);
        mn[2] = round_bf16(m4.z);
        mn[3] = round_bf16(m4.w);
      }
      // x at this lane's 4 rows
      float xv[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float* xr = xs + m * xs_ld + j * kQK + row0;
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[m][i] = xr[2 * i];
      }
      const int8_t* crow = cs + j * kDecCodeBytes + row0 * kDecCols + col4 * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(crow + 2 * i * kDecCols) ^ 0x80808080u;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)), s[e],
                      bias[e]);
        round_pair(w[0], w[1]);
        round_pair(w[2], w[3]);
        if (kMins) {
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] += mn[e];
          round_pair(w[0], w[1]);
          round_pair(w[2], w[3]);
        }
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][e] = fmaf(xv[m][i], w[e], acc[m][e]);
      }
    }
  }

  // the two half-warps' sums of the same columns, then the warps' sums in
  // shared memory, then the CTA's partial sums stored into its slot in
  // rank 0
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], 16);
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < kM; ++m)
      *reinterpret_cast<float4*>(red + (warp * kM + m) * kDecCols + col4 * 4) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  cluster_wait();
  // 4 columns a thread
  for (int i = tid; i < M * kDecCols / 4; i += kThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 r = *reinterpret_cast<const float4*>(red + w * kM * kDecCols + 4 * i);
      sum.x += r.x;
      sum.y += r.y;
      sum.z += r.z;
      sum.w += r.w;
    }
    st_async(map_rank(smem_u32(slots + rank * kM * kDecCols + 4 * i), 0), sum,
             map_rank(slots_bar, 0));
  }
  if (rank != 0) return;
  // rank 0: every slot is in; add them in rank order
  mbar_wait(slots_bar, 0);
  for (int i = tid; i < M * kDecCols; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_ranks) sum += slots[r * kM * kDecCols + i];
    out[(size_t)(i / kDecCols) * N + col0 + i % kDecCols] = sum;
  }
}

// ---- M > 8: the prompt pass on wgmma ------------------------------------

// Shared-memory matrix descriptor of `wgmma`: start address, leading and
// stride byte offsets, swizzle mode (1: 128-byte, 2: 64-byte).  K-major:
// SBO is the stride between 8-row groups (LBO unused).  MN-major: LBO is
// the stride between 64-element MN blocks, SBO between groups of 8 K rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most `kPending` committed groups of this warpgroup run.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
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
#define WTT_INOUT(x) "+f"(x)
#define WTT_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (64 x 128 f32 a warpgroup) += A B over 16 of K: A K-major, B MN-major
// (the transpose bit), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WTT_D64
      ", %64, %65, p, 1, 1, 0, 1;\n\t}"
      : WTT_F64(WTT_INOUT, d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats into another CTA's shared memory, counted on its mbarrier
// `bar` (see st_async)
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32"
      " [%0], {%1, %2}, [%3];" ::"r"(addr), "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// Shared memory of the prompt path, past 1 KB of slack that aligns it to
// the swizzle pattern's 1024 bytes: the bf16 buffers and the raw stages
// (112 KB with the mbarriers, so two CTAs share an SM), which the split-K
// slots overlay once the cluster is past its main loops, then the
// mbarriers.
constexpr size_t kPrSmem = 1024 + kPrBufs * kPrBufBytes + kPrStages * kPrStageBytes +
                           8 * (kPrStages + 1);
static_assert(kPrTileBytes <= kPrBufs * kPrBufBytes + kPrStages * kPrStageBytes,
              "the slots overlay the buffers and stages");

// The whole cluster barrier, arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Grid (C, N / 128, ceil(M / 128)), cluster (C, 1, 1): CTA rank r of a
// cluster takes 32-row blocks [r * nkb / C, (r + 1) * nkb / C) of output
// tile (blockIdx.z, blockIdx.y).  Per block: thread 0 requests by TMA x's
// 128 rows x 32 columns in its own dtype (swizzled; rows past M read as
// zero) and the block's codes and scales (and mins) for the tile's 128
// columns, into stage i % 3 of a ring it keeps 3 blocks ahead; every
// thread then writes 16 bytes of A (x rounded to bf16, K-major, 64-byte
// swizzle) twice and 32 of B (16 dequantized bf16 weights of one K row,
// MN-major, 128-byte swizzle) into buffer i % 3; after one barrier each
// warpgroup issues two m64n128k16 wgmma on its 64 rows and lets them run
// while the threads prepare the next block (wgmma.wait_group 1: the
// buffer written next was last read two blocks ago, and the barrier that
// follows each block's writes orders it after both warpgroups' waits).
//   Epilogue: without a split each thread stores its fragment; with one,
// rank r of the cluster owns rows [r R, (r + 1) R) of the tile (R = 128 /
// C): once the whole cluster is past its main loops (one cluster barrier:
// the slots overlay the buffers and stages), every CTA pushes each of its
// partial rows into the slot of its rank in the owner (st.async), and each
// owner adds its C slots in rank order and stores its rows.
template <bool kMins, bool kBf16X>
__global__ void __launch_bounds__(kThreads, 2)
qmm_prompt_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_codes,
                  const __grid_constant__ CUtensorMap tm_scales,
                  const __grid_constant__ CUtensorMap tm_mins,
                  float* __restrict__ out, int M, int N, int K, int n_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw_addr);
  const uint32_t stages = base + kPrBufs * kPrBufBytes;
  const uint32_t slots = base;   // split K: [C][128 / C rows][128] f32
  const uint32_t bars = stages + kPrStages * kPrStageBytes;
  const uint32_t slots_bar = bars + 8 * kPrStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * kPrN;
  const int m0 = blockIdx.z * kPrM;
  const int nkb = K / kQK;
  const int kb_begin = (int)((long long)rank * nkb / n_split);
  const int n_blocks = (int)((long long)(rank + 1) * nkb / n_split) - kb_begin;

  // block i's x, codes, scales (and mins) into stage i % kPrStages
  auto request = [&](int i) {
    const uint32_t st = stages + (i % kPrStages) * kPrStageBytes;
    const uint32_t bar = bars + 8 * (i % kPrStages);
    const int kb = kb_begin + i;
    mbar_expect_tx(bar, (kBf16X ? kPrXBytes / 2 : kPrXBytes) + kPrCodeBytes +
                            (kMins ? 2 : 1) * kPrN * 4);
    tma_load_2d(st, &tm_x, bar, kb * kQK, m0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64;
      tma_load_2d(st + kPrXBytes + h * kDecCodeBytes, &tm_codes, bar, col, kb * kQK);
      tma_load_2d(st + kPrXBytes + kPrCodeBytes + h * 256, &tm_scales, bar, col, kb);
      if (kMins)
        tma_load_2d(st + kPrXBytes + kPrCodeBytes + 512 + h * 256, &tm_mins, bar, col,
                    kb);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= kPrStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // the bytes the cluster's CTAs will push into this one's slots
    if (n_split > 1) mbar_expect_tx(slots_bar, kPrTileBytes);
    for (int i = 0; i < kPrStages && i < n_blocks; ++i) request(i);
  }
  __syncthreads();

  // this thread's share of B: K row krow, columns 64 half + 16 quad .. + 15
  // (a quarter-warp covers two whole 64-byte rows of one half's codes)
  const int half = (tid >> 3) & 1;
  const int krow = 2 * (tid >> 4) + ((tid >> 2) & 1);
  const int quad = tid & 3;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % kPrStages;
    const unsigned char* x_raw = sbase + (stages - base) + s * kPrStageBytes;
    const unsigned char* codes = x_raw + kPrXBytes;
    const float* scl = reinterpret_cast<const float*>(codes + kPrCodeBytes);
    unsigned char* b_buf = sbase + (i % kPrBufs) * kPrBufBytes;
    unsigned char* a_buf = b_buf + kPrBBytes;
    mbar_wait(bars + 8 * s, (i / kPrStages) & 1);

    // A: 512 chunks of 8 bf16, row r's chunk j at j ^ ((r >> 1) & 3)
#pragma unroll
    for (int p = tid; p < kPrM * 4; p += kThreads) {
      if (kBf16X) {   // x landed in A's own layout
        *reinterpret_cast<uint4*>(a_buf + p * 16) =
            *reinterpret_cast<const uint4*>(x_raw + p * 16);
      } else {        // f32 rows of 128 bytes: chunk c at c ^ (r & 7)
        const int r = p >> 2, j = p & 3;
        const unsigned char* row = x_raw + r * 128;
        const float4 lo =
            *reinterpret_cast<const float4*>(row + (((2 * j) ^ (r & 7)) << 4));
        const float4 hi =
            *reinterpret_cast<const float4*>(row + (((2 * j + 1) ^ (r & 7)) << 4));
        *reinterpret_cast<uint4*>(a_buf + r * 64 + ((j ^ ((r >> 1) & 3)) << 4)) =
            make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                       pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
      }
    }

    // B: 16 codes of row krow (one 16-byte load) and their bf16 scales, the
    // weights as in the decode path, two 16-byte stores
    {
      const uint4 cw = *reinterpret_cast<const uint4*>(
          codes + half * kDecCodeBytes + krow * 64 + quad * 16);
      const float* sc = scl + half * 64 + quad * 16;
      const float* mn = sc + 2 * 64;
      const uint32_t words[4] = {cw.x, cw.y, cw.z, cw.w};
      uint32_t packed[8];
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const float4 s4 = *reinterpret_cast<const float4*>(sc + 4 * wi);
        float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        round_pair(sv[0], sv[1]);
        round_pair(sv[2], sv[3]);
        const uint32_t u = words[wi] ^ 0x80808080u;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)), sv[e],
                      -8388736.f * sv[e]);
        if (kMins) {
          const float4 m4 = *reinterpret_cast<const float4*>(mn + 4 * wi);
          float mv[4] = {m4.x, m4.y, m4.z, m4.w};
          round_pair(mv[0], mv[1]);
          round_pair(mv[2], mv[3]);
          round_pair(w[0], w[1]);
          round_pair(w[2], w[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] += mv[e];
        }
        packed[2 * wi] = pack_bf16(w[0], w[1]);
        packed[2 * wi + 1] = pack_bf16(w[2], w[3]);
      }
      unsigned char* row = b_buf + half * (kQK * 128) + krow * 128;
      *reinterpret_cast<uint4*>(row + (((2 * quad) ^ (krow & 7)) << 4)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(row + (((2 * quad + 1) ^ (krow & 7)) << 4)) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    // the generic proxy's writes, visible to wgmma's (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // stage s is read: refill it with block i + kPrStages
    if (tid == 0 && i + kPrStages < n_blocks) request(i + kPrStages);

    // both warpgroups always (a warpgroup whose rows all lie past M adds
    // zeros): a wgmma under a branch is serialized by ptxas
    const uint32_t bb = base + (i % kPrBufs) * kPrBufBytes;
    // B: two MN blocks of 64 columns (4 KB apart), 8-row groups 1 KB
    // apart; A: this warpgroup's 64 rows, 8-row groups 512 bytes apart
    const uint64_t db = smem_desc(bb, kQK * 128, 1024, 1);
    const uint64_t da = smem_desc(bb + kPrBBytes + wg * 64 * 64, 16, 512, 2);
    wgmma_fence();
    wgmma_m64n128(acc, da, db);
    wgmma_m64n128(acc, da + (32 >> 4), db + (2048 >> 4));   // k 16..31
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // fragment: thread (warp w of its warpgroup, lane l) holds rows 16 w +
  // l / 4 (+ 8) of the warpgroup's 64, columns 8 j + 2 (l % 4) (+ 1)
  const int lrow = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int lcol = 2 * (lane % 4);
  if (n_split == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + lrow + 8 * hr;
      if (r >= M) continue;
      float* dst = out + (size_t)r * N + n0 + lcol;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
    return;
  }

  const int rows_each = kPrM / n_split;
  // every CTA of the cluster is past its main loop (the slots overlay its
  // buffers and stages) and has its mbarriers set up
  cluster_sync();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = lrow + 8 * hr;
    const int owner = r / rows_each;
    const uint32_t dst = slots + ((rank * rows_each + r % rows_each) * kPrN + lcol) * 4;
    const uint32_t rdst = map_rank(dst, owner);
    const uint32_t rbar = map_rank(slots_bar, owner);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      st_async2(rdst + 32 * j, acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1], rbar);
  }
  // this CTA's rows: every rank's slot is in; add them in rank order
  mbar_wait(slots_bar, 0);
  const float* sl = reinterpret_cast<const float*>(sbase + (slots - base));
  for (int e = tid; e < rows_each * kPrN / 4; e += kThreads) {
    const int r = e / (kPrN / 4), c = 4 * (e % (kPrN / 4));
    float4 sum = *reinterpret_cast<const float4*>(sl + r * kPrN + c);
    for (int q = 1; q < n_split; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(sl + (q * rows_each + r) * kPrN + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int gr = m0 + rank * rows_each + r;
    if (gr < M) *reinterpret_cast<float4*>(out + (size_t)gr * N + n0 + c) = sum;
  }
}

// ---- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library links no libcuda).
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

// What a tensor map reads: int8 codes (box: 64 columns x 32 rows, one
// 32-row block of a column tile), f32 scales or mins (box: 64 columns x 1
// row), both unswizzled; or x in f32 / bf16 (box: 32 columns x 128 rows,
// one 32-wide K block of a prompt tile, rows past M read as zero) with the
// 128- / 64-byte swizzle that makes each row one swizzle span.
enum MapKind { kCodes, kScales, kXf32, kXbf16 };

// The tensor map of a row-major (rows, cols) array of `kind`.  A map
// depends on nothing but these arguments, and a model's weights stay put,
// so the maps are kept by pointer, shape and kind: encoding them anew
// would add host time to every call of the token loop.  A model holds a
// few hundred such arrays (large-v3: 3 x 8 x 32); the prompt pass adds its
// activations, which the caching allocator hands out at a few recurring
// addresses.  Past kMaxMaps entries (weights freed and reallocated, models
// reloaded) the table starts over.
constexpr size_t kMaxMaps = 4096;
struct MapKey {
  const void* ptr;
  int rows, cols;
  MapKind kind;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && kind == o.kind;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.ptr) ^ ((size_t)k.rows << 32) ^
           ((size_t)k.cols << 2) ^ (size_t)k.kind;
  }
};

bool tensor_map(const void* ptr, int rows, int cols, MapKind kind, CUtensorMap* out) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{ptr, rows, cols, kind};
  std::lock_guard<std::mutex> guard(lock);
  auto it = maps.find(key);
  if (it == maps.end()) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return false;
    static const CUtensorMapDataType types[] = {
        CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16};
    static const int bytes[] = {1, 4, 4, 2};
    static const cuuint32_t box_cols[] = {kDecCols, kDecCols, kQK, kQK};
    static const cuuint32_t box_rows[] = {kQK, 1, kPrM, kPrM};
    static const CUtensorMapSwizzle swizzles[] = {
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_SWIZZLE_64B};
    const cuuint32_t ones[2] = {1, 1};
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes[kind]};
    const cuuint32_t box[2] = {box_cols[kind], box_rows[kind]};
    CUtensorMap map;
    if (encode(&map, types[kind], 2, const_cast<void*>(ptr), dims, strides, box,
               ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzles[kind],
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    if (maps.size() >= kMaxMaps) maps.clear();
    it = maps.emplace(key, map).first;
  }
  *out = it->second;
  return true;
}

struct WeightMaps {
  CUtensorMap codes, scales, mins;   // mins: the scales' when there are none
};

bool weight_maps(const void* codes, const void* scales, const void* mins, int N,
                 int K, WeightMaps* maps) {
  return tensor_map(codes, K, N, kCodes, &maps->codes) &&
         tensor_map(scales, K / kQK, N, kScales, &maps->scales) &&
         tensor_map(mins != nullptr ? mins : scales, K / kQK, N, kScales, &maps->mins);
}

template <int kM, bool kMins, typename XT>
int launch_decode(const void* x, const WeightMaps& maps, void* out, int M, int N,
                  int K, int cluster, cudaStream_t st) {
  auto kernel = qmm_decode_kernel<kM, kMins, XT>;
  // attributes once per device and instance: the largest pass, clusters
  // above the portable 8
  static int ready_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (ready_on != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)decode_smem(kM, kMins, kMaxPassKb, kMaxCluster));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return (int)err;
    ready_on = dev;
  }
  const int nkb = K / kQK;
  const int max_slice = (nkb + cluster - 1) / cluster;
  const int pass_kb = max_slice < kMaxPassKb ? max_slice : kMaxPassKb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N / kDecCols, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = decode_smem(kM, kMins, pass_kb, cluster);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), maps.codes,
                           maps.scales, maps.mins, static_cast<float*>(out), M, N, K,
                           pass_kb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kMins, typename XT>
int dispatch_decode(const void* x, const WeightMaps& maps, void* out, int M, int N,
                    int K, int cluster, cudaStream_t st) {
  if (M == 1) return launch_decode<1, kMins, XT>(x, maps, out, M, N, K, cluster, st);
  if (M == 2) return launch_decode<2, kMins, XT>(x, maps, out, M, N, K, cluster, st);
  if (M <= 4) return launch_decode<4, kMins, XT>(x, maps, out, M, N, K, cluster, st);
  return launch_decode<8, kMins, XT>(x, maps, out, M, N, K, cluster, st);
}

template <bool kMins, bool kBf16X>
int launch_prompt(const CUtensorMap& x_map, const WeightMaps& maps, void* out, int M,
                  int N, int K, int cluster, cudaStream_t st) {
  auto kernel = qmm_prompt_kernel<kMins, kBf16X>;
  // the largest shared memory, once per device and instance
  static int ready_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (ready_on != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kPrSmem);
    // all of the SM's 228 KB as shared memory: two CTAs (112 KB each)
    // share an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready_on = dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N / kPrN, (M + kPrM - 1) / kPrM);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kPrSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, maps.codes, maps.scales, maps.mins,
                           static_cast<float*>(out), M, N, K, cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int N, int K) {
  return M < 1 || N < kTileN || N % kTileN || K < kQK || K % kQK ||
         N / kTileN > 65535;
}

}  // namespace

// M <= 8: one launch, K split over a cluster of `cluster` CTAs (1-16, at
// most K / 32).  x_bf16: x is bf16 (else f32).  mins may be null.
extern "C" int wtt_quantized_matmul_decode(const void* x, int x_bf16,
                                           const void* codes, const void* scales,
                                           const void* mins, void* out, int M,
                                           int N, int K, int cluster,
                                           void* stream) {
  if (bad_shape(M, N, K) || M > kDecodeM || cluster < 1 || cluster > kMaxCluster ||
      cluster > K / kQK)
    return (int)cudaErrorInvalidValue;
  WeightMaps maps;
  if (!weight_maps(codes, scales, mins, N, K, &maps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mins != nullptr)
    return x_bf16 ? dispatch_decode<true, __nv_bfloat16>(x, maps, out, M, N, K, cluster, st)
                  : dispatch_decode<true, float>(x, maps, out, M, N, K, cluster, st);
  return x_bf16 ? dispatch_decode<false, __nv_bfloat16>(x, maps, out, M, N, K, cluster, st)
                : dispatch_decode<false, float>(x, maps, out, M, N, K, cluster, st);
}

// M > 8: one launch, output tiles of 128 x 128, K split over a cluster of
// `cluster` CTAs (1, 2, 4 or 8, at most K / 32).  x_bf16: x is bf16 (else
// f32); x 16-byte aligned.  mins may be null.
extern "C" int wtt_quantized_matmul(const void* x, int x_bf16, const void* codes,
                                    const void* scales, const void* mins, void* out,
                                    int M, int N, int K, int cluster, void* stream) {
  if (bad_shape(M, N, K) || cluster < 1 || cluster > kPrMaxCluster ||
      (cluster & (cluster - 1)) || cluster > K / kQK ||
      (M + kPrM - 1) / kPrM > 65535)
    return (int)cudaErrorInvalidValue;
  WeightMaps maps;
  CUtensorMap x_map;
  if (!weight_maps(codes, scales, mins, N, K, &maps) ||
      !tensor_map(x, M, K, x_bf16 ? kXbf16 : kXf32, &x_map))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mins != nullptr)
    return x_bf16 ? launch_prompt<true, true>(x_map, maps, out, M, N, K, cluster, st)
                  : launch_prompt<true, false>(x_map, maps, out, M, N, K, cluster, st);
  return x_bf16 ? launch_prompt<false, true>(x_map, maps, out, M, N, K, cluster, st)
                : launch_prompt<false, false>(x_map, maps, out, M, N, K, cluster, st);
}
