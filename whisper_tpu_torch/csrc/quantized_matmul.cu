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
// Bound on the H100: device-memory bandwidth.  In the token loop M is the
// batch (1 in whisper_full, 4 in serving), so every call streams K*N code
// bytes for 2*M FLOP each: at (1, 1280, 1280) 1.8 MB, 0.55 us at 3.35 TB/s.
// Such a call is over in microseconds, so what bounds it in practice is how
// many bytes are in flight at once and how many launches it takes.
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
//   * M > 8, the carried-prompt pass (`quantized_matmul_kernel`): a block
//     takes 128 columns and 8 rows of x, its 8 warps whole 32-row blocks of
//     K; when the column tiles alone cannot fill the card, K is split over
//     blocks that write partial sums to a workspace, which a second kernel
//     adds in a fixed order.
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
constexpr int kTileN = 128;    // output columns per block: 32 lanes x 4
constexpr int kTileM = 8;      // rows of x per block (M > 8 path)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
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

// ---- M > 8 --------------------------------------------------------------

template <bool kMins, typename XT>
__global__ void __launch_bounds__(kThreads)
quantized_matmul_kernel(const XT* __restrict__ x,
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
      xs[warp][m][kk] = m < rows ? bf16_of(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
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

template <bool kMins, typename XT>
int launch_split(const void* x, const void* codes, const void* scales,
                 const void* mins, void* work, void* out, int M, int N, int K,
                 int splits, int kb_per_split, cudaStream_t st) {
  const dim3 grid(N / kTileN, splits, (M + kTileM - 1) / kTileM);
  float* dst = static_cast<float*>(splits > 1 ? work : out);
  quantized_matmul_kernel<kMins, XT><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(mins), dst,
      M, N, K, kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)M * N;
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(work),
                                             static_cast<float*>(out), count, splits);
  return (int)cudaGetLastError();
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

// ---- host side of the decode path ---------------------------------------

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

// The tensor map of a row-major (rows, cols) array of int8 codes (box: 64
// columns x 32 rows, one 32-row block of a column tile) or of f32 scales
// or mins (box: 64 columns x 1 row), no swizzle.  A map depends on nothing
// but these arguments, and a model's weights stay put, so the maps are
// kept by pointer and shape: encoding them anew would add host time to
// every call of the token loop.  A model holds a few hundred such arrays
// (large-v3: 3 x 8 x 32); past kMaxMaps entries (weights freed and
// reallocated, models reloaded) the table starts over.
constexpr size_t kMaxMaps = 4096;
struct MapKey {
  const void* ptr;
  int rows, cols;
  bool f32;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && f32 == o.f32;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.ptr) ^ ((size_t)k.rows << 32) ^
           ((size_t)k.cols << 1) ^ (size_t)k.f32;
  }
};

bool weight_map(const void* ptr, int rows, int cols, bool f32, CUtensorMap* out) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{ptr, rows, cols, f32};
  std::lock_guard<std::mutex> guard(lock);
  auto it = maps.find(key);
  if (it == maps.end()) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return false;
    const cuuint32_t ones[2] = {1, 1};
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * (f32 ? 4 : 1)};
    const cuuint32_t box[2] = {kDecCols, f32 ? 1u : (cuuint32_t)kQK};
    CUtensorMap map;
    if (encode(&map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
               2, const_cast<void*>(ptr), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    if (maps.size() >= kMaxMaps) maps.clear();
    it = maps.emplace(key, map).first;
  }
  *out = it->second;
  return true;
}

struct DecodeMaps {
  CUtensorMap codes, scales, mins;   // mins: the scales' when there are none
};

template <int kM, bool kMins, typename XT>
int launch_decode(const void* x, const DecodeMaps& maps, void* out, int M, int N,
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
int dispatch_decode(const void* x, const DecodeMaps& maps, void* out, int M, int N,
                    int K, int cluster, cudaStream_t st) {
  if (M == 1) return launch_decode<1, kMins, XT>(x, maps, out, M, N, K, cluster, st);
  if (M == 2) return launch_decode<2, kMins, XT>(x, maps, out, M, N, K, cluster, st);
  if (M <= 4) return launch_decode<4, kMins, XT>(x, maps, out, M, N, K, cluster, st);
  return launch_decode<8, kMins, XT>(x, maps, out, M, N, K, cluster, st);
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
  if (bad_shape(M, N, K) || M > kTileM || cluster < 1 || cluster > kMaxCluster ||
      cluster > K / kQK)
    return (int)cudaErrorInvalidValue;
  DecodeMaps maps;
  if (!weight_map(codes, K, N, false, &maps.codes) ||
      !weight_map(scales, K / kQK, N, true, &maps.scales) ||
      !weight_map(mins != nullptr ? mins : scales, K / kQK, N, true, &maps.mins))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mins != nullptr)
    return x_bf16 ? dispatch_decode<true, __nv_bfloat16>(x, maps, out, M, N, K, cluster, st)
                  : dispatch_decode<true, float>(x, maps, out, M, N, K, cluster, st);
  return x_bf16 ? dispatch_decode<false, __nv_bfloat16>(x, maps, out, M, N, K, cluster, st)
                : dispatch_decode<false, float>(x, maps, out, M, N, K, cluster, st);
}

// M > 8.  work: (splits, M, N) f32 scratch when splits > 1 (may alias out
// when splits == 1).  x_bf16: x is bf16 (else f32).  mins may be null.
extern "C" int wtt_quantized_matmul(const void* x, int x_bf16, const void* codes,
                                    const void* scales, const void* mins,
                                    void* work, void* out, int M, int N, int K,
                                    int splits, int kb_per_split, void* stream) {
  if (bad_shape(M, N, K) || splits < 1 || kb_per_split < 1 ||
      (long long)splits * kb_per_split < K / kQK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mins != nullptr)
    return x_bf16 ? launch_split<true, __nv_bfloat16>(x, codes, scales, mins, work, out,
                                                      M, N, K, splits, kb_per_split, st)
                  : launch_split<true, float>(x, codes, scales, mins, work, out, M, N,
                                              K, splits, kb_per_split, st);
  return x_bf16 ? launch_split<false, __nv_bfloat16>(x, codes, scales, nullptr, work,
                                                     out, M, N, K, splits,
                                                     kb_per_split, st)
                : launch_split<false, float>(x, codes, scales, nullptr, work, out, M,
                                             N, K, splits, kb_per_split, st);
}
