// Encoder self-attention, kernel K1 of whisper_tpu_torch.
//
// Replaces whisper_tpu/ops/encoder_attention.py `encoder_attention` /
// `_attn_kernel` (Pallas, TPU): out = softmax(Q K^T * scale) V per
// (batch, head), keys at or beyond T masked, no causal mask.
//
// Bound on the H100: tensor cores.  At T=1500, Dh=64 one (b, h) is two
// T x T x 64 products (~0.58 GFLOP) against ~0.6 MB of bf16 q/k/v.
// Design: the TPU kernel holds one head's whole K/V in VMEM (~384 KB at
// T=1500), more than a Hopper block's 227 KB of shared memory, and keeps a
// (256 x T) score block.  Here one block of 4 warps owns 64 queries of one
// (b, h) and streams 64-key tiles of K and V through shared memory with an
// online softmax (running max and sum per query row).  Each warp owns 16
// query rows: S = Q K^T and O += P V run on bf16 wmma 16x16x16 fragments
// with f32 accumulation; the softmax runs in f32.  Scores never reach
// device memory.  q/k/v are read in place from the (B, T, H, Dh) layout
// (row t of head h at ((b*T + t)*H + h)*Dh), rows past T are zero-filled
// in shared memory and their keys masked to -inf, so no padded or
// transposed copy exists.  Output (B, T, H*Dh) f32.
//
// Plain C entry point for ctypes; launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kDh = 64;        // head dim (every Whisper model)
constexpr int kTile = 64;      // queries per block, keys per K/V tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kThreads = kWarps * 32;

constexpr size_t kSmemBytes =
    4 * kTile * kDh * sizeof(__nv_bfloat16)     // Q, K, V, P tiles
    + 2 * kTile * kDh * sizeof(float)           // S scores, O accumulator
    + 2 * kTile * sizeof(float);                // running max and sum

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy a (64 rows x 64) bf16 tile starting at row r0 into shared memory,
// 16 bytes per thread per step; rows at or beyond T are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          size_t row_stride, int r0, int T) {
  for (int c = threadIdx.x; c < kTile * kDh / 8; c += kThreads) {
    const int r = c / (kDh / 8);
    const int col = (c % (kDh / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kDh + col) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         float* __restrict__ out, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kTile * kDh;
  __nv_bfloat16* Vs = Ks + kTile * kDh;
  __nv_bfloat16* Ps = Vs + kTile * kDh;
  float* Ss = reinterpret_cast<float*>(Ps + kTile * kDh);
  float* Os = Ss + kTile * kDh;
  float* row_max = Os + kTile * kDh;
  float* row_sum = row_max + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;                 // this warp's first query row

  const size_t row_stride = (size_t)H * kDh;
  const size_t head_base = (size_t)b * T * row_stride + (size_t)h * kDh;

  load_tile(Qs, q + head_base, row_stride, q0, T);
  for (int i = threadIdx.x; i < kTile * kDh; i += kThreads) Os[i] = 0.f;
  if (threadIdx.x < kTile) {
    row_max[threadIdx.x] = -INFINITY;
    row_sum[threadIdx.x] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();   // previous tile fully consumed (and Q/O set up)
    load_tile(Ks, k + head_base, row_stride, k0, T);
    load_tile(Vs, v + head_base, row_stride, k0, T);
    __syncthreads();

    // S[r0:r0+16, :] = Q K^T  (B operand: K^T, i.e. K read column-major)
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < kDh / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + r0 * kDh + kk * 16, kDh);
        wmma::load_matrix_sync(fb, Ks + n * 16 * kDh + kk * 16, kDh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * kTile + n * 16, acc, kTile, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, 2 columns a lane
    const bool valid0 = k0 + lane < T;
    const bool valid1 = k0 + lane + 32 < T;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const float s0 = valid0 ? Ss[r * kTile + lane] * scale : -INFINITY;
      const float s1 = valid1 ? Ss[r * kTile + lane + 32] * scale : -INFINITY;
      const float m_old = row_max[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float tile_sum = warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);
      Ps[r * kTile + lane] = __float2bfloat16(p0);
      Ps[r * kTile + lane + 32] = __float2bfloat16(p1);
      Os[r * kDh + lane] *= corr;
      Os[r * kDh + lane + 32] *= corr;
      __syncwarp();
      if (lane == 0) {
        row_max[r] = m_new;
        row_sum[r] = row_sum[r] * corr + tile_sum;
      }
    }
    __syncwarp();

    // O[r0:r0+16, :] += P V
    for (int n = 0; n < kDh / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * kDh + n * 16, kDh, wmma::mem_row_major);
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + r0 * kTile + kk * 16, kTile);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * kDh + n * 16, kDh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + r0 * kDh + n * 16, acc, kDh, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const size_t out_row = (size_t)H * kDh;
  for (int i = threadIdx.x; i < kTile * kDh; i += kThreads) {
    const int r = i / kDh;
    const int d = i % kDh;
    const int t = q0 + r;
    if (t < T)
      out[((size_t)b * T + t) * out_row + (size_t)h * kDh + d] = Os[i] / row_sum[r];
  }
}

}  // namespace

extern "C" int wtt_encoder_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int T, int H, int Dh,
                                     void* stream) {
  if (Dh != kDh || B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  encoder_attention_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), T, H,
      1.0f / sqrtf((float)kDh));
  return (int)cudaGetLastError();
}
