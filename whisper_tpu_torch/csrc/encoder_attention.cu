// Encoder self-attention: kernel K1 of whisper_tpu_torch, and K6 on the
// same device code.
//
// K1 replaces whisper_tpu/ops/encoder_attention.py `encoder_attention` /
// `_attn_kernel` (Pallas, TPU); K6 replaces `encoder_attention_btd` /
// `_attn_btd_kernel`.  Both compute out = softmax(Q K^T * scale) V per
// (batch, head), keys at or beyond t_valid masked, no causal mask; rows
// past t_valid (the padding of encode's padded variants) are computed like
// any other row and sliced off by the caller.
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
// device memory.  Tiles past the last valid key are not read at all.
//
// Two layouts, one template:
//   * rows (kDhMajor = false): (B, T, H, Dh), i.e. (B, T, D) with head h
//     the Dh-wide column slice h of each row.  Row t of head h is 128
//     contiguous bytes at ((b*T + t)*H + h)*Dh, read in place.  K1's
//     `self_attention` entry (T = t_valid, ragged last tile zero-filled)
//     and K6 (T = Tp, a multiple of 256; the TPU kernel's 128-lane head
//     groups are a VMEM artefact and are not carried over).  Output
//     (B, T, H*Dh) f32.
//   * Dh-major (kDhMajor = true): (B, H, Dh, T), the TPU kernel's own
//     layout (encode's pallas_dt / pallas_pf).  A tile is copied as it lies,
//     [d][t], 16 bytes a thread along t, and the wmma fragments read it
//     column-major instead of transposing it.  Output (B, H, Dh, T) f32.
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// Copy the 64-row tile starting at row r0 into shared memory, 16 bytes per
// thread per step; rows at or beyond T are zero.
// Rows layout: `base` is row 0 of the head, rows `row_stride` apart; the
// tile lands as [t][d].  Dh-major: `base` is channel 0 of the head,
// channels T apart; the tile lands as [d][t] (T is a multiple of 8).
template <bool kDhMajor>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          size_t row_stride, int r0, int T) {
  for (int c = threadIdx.x; c < kTile * kDh / 8; c += kThreads) {
    const int outer = c / 8;            // row t (rows) or channel d
    const int inner = (c % 8) * 8;      // channel d (rows) or row t
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (kDhMajor) {
      if (r0 + inner < T)
        val = *reinterpret_cast<const uint4*>(base + (size_t)outer * T + r0 + inner);
    } else if (r0 + outer < T) {
      val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + outer) * row_stride + inner);
    }
    *reinterpret_cast<uint4*>(dst + outer * kTile + inner) = val;
  }
}

template <bool kDhMajor>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         float* __restrict__ out, int T, int t_valid, int H,
                         float scale) {
  // [t][d] tiles are read row-major by the Q and P V fragments and
  // column-major as K^T; [d][t] tiles the other way round
  using LayoutQ = std::conditional_t<kDhMajor, wmma::col_major, wmma::row_major>;
  using LayoutKt = std::conditional_t<kDhMajor, wmma::row_major, wmma::col_major>;
  using LayoutV = LayoutQ;

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
  const size_t head_base = kDhMajor ? ((size_t)b * H + h) * kDh * T
                                    : (size_t)b * T * row_stride + (size_t)h * kDh;

  load_tile<kDhMajor>(Qs, q + head_base, row_stride, q0, T);
  for (int i = threadIdx.x; i < kTile * kDh; i += kThreads) Os[i] = 0.f;
  if (threadIdx.x < kTile) {
    row_max[threadIdx.x] = -INFINITY;
    row_sum[threadIdx.x] = 0.f;
  }

  for (int k0 = 0; k0 < t_valid; k0 += kTile) {
    __syncthreads();   // previous tile fully consumed (and Q/O set up)
    load_tile<kDhMajor>(Ks, k + head_base, row_stride, k0, T);
    load_tile<kDhMajor>(Vs, v + head_base, row_stride, k0, T);
    __syncthreads();

    // S[r0:r0+16, :] = Q K^T
    for (int n = 0; n < kTile / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < kDh / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutQ> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutKt> fb;
        if (kDhMajor) {
          wmma::load_matrix_sync(fa, Qs + kk * 16 * kTile + r0, kTile);
          wmma::load_matrix_sync(fb, Ks + kk * 16 * kTile + n * 16, kTile);
        } else {
          wmma::load_matrix_sync(fa, Qs + r0 * kDh + kk * 16, kDh);
          wmma::load_matrix_sync(fb, Ks + n * 16 * kDh + kk * 16, kDh);
        }
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * kTile + n * 16, acc, kTile, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, 2 columns a lane
    const bool valid0 = k0 + lane < t_valid;
    const bool valid1 = k0 + lane + 32 < t_valid;
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
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutV> fb;
        wmma::load_matrix_sync(fa, Ps + r0 * kTile + kk * 16, kTile);
        if (kDhMajor)
          wmma::load_matrix_sync(fb, Vs + n * 16 * kTile + kk * 16, kTile);
        else
          wmma::load_matrix_sync(fb, Vs + kk * 16 * kDh + n * 16, kDh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + r0 * kDh + n * 16, acc, kDh, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kDh; i += kThreads) {
    if (kDhMajor) {               // consecutive threads along t
      const int d = i / kTile;
      const int r = i % kTile;
      if (q0 + r < T)
        out[head_base + (size_t)d * T + q0 + r] = Os[r * kDh + d] / row_sum[r];
    } else {                      // consecutive threads along d
      const int r = i / kDh;
      const int d = i % kDh;
      if (q0 + r < T)
        out[((size_t)b * T + q0 + r) * row_stride + (size_t)h * kDh + d] =
            Os[i] / row_sum[r];
    }
  }
}

template <bool kDhMajor>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int t_valid, int H, int Dh, void* stream) {
  if (Dh != kDh || B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535 ||
      t_valid < 1 || t_valid > T || (kDhMajor && T % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_kernel<kDhMajor>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  encoder_attention_kernel<kDhMajor>
      <<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), T,
          t_valid, H, 1.0f / sqrtf((float)kDh));
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
