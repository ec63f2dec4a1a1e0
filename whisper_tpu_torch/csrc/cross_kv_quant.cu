// One decoder layer's cross-attention K and V, from its two projection
// outputs to the int8 (B, H, Dh, Ta) codes and (B, H, Ta) f32 scales that
// K2 reads (ops/cross_attention.py `cross_kv_quant`), in one launch:
//   K = y_k                          the bf16 GEMM output (no bias)
//   V = bf16(f32(y_v) + b_v)         the bias added in f32, rounded once
//   per (b, t, h), over the head's 64 channels x:
//     amax  = max |x|
//     scale = max(amax, 1e-8) * f32(1/127)
//     inv   = bf16(1 / scale)
//     code  = clamp(rint(bf16(x * inv)), -127, 127)
//
// It replaces no TPU kernel: whisper_tpu runs `quantize_kv_bhdt` under jit,
// and XLA fused the projection's bias add, the transpose to (B, H, Dh, Ta)
// and the quantizer into its own fusions.  Under PyTorch the same sequence
// (models/whisper.py `_make_cross_proj` + `quantize_kv_bhdt`) was ~10
// kernels a tensor and layer: an f32 copy of the GEMM output (the bias add
// for V), a strided transposing cast back to bf16, abs, the amax, the
// product, round, clamp, the int8 cast and a copy into the layer's slot of
// the (L, ...) stack, ~37 bytes of traffic an element.  This pass reads the
// bf16 rows once and writes the codes and scales once: 3 bytes an element.
//
// The arithmetic is PyTorch's, operation for operation, so the codes and
// scales are bit for bit those of the plain sequence: the bias add in f32
// then one rounding to nearest even; the max is exact; the scale is a
// product with f32(1/127), not a division (XLA rewrites the reference's
// division into it; ops/cross_attention.py `_quantize`); the reciprocal is
// correctly rounded (__frcp_rn, as torch's 1 / x); and the product is
// rounded to bf16 before it is rounded half to even to an integer, as
// torch's bf16 `k * inv` and then `torch.round` do.
//
// Bound on the H100: bytes.  A dozen operations an element for 3 bytes:
// at (B 256, Ta 1500, D 1280) K and V move 2.95 GB, 0.88 ms at 3.35 TB/s.
// The design reads and writes every byte once, in whole lines:
//   * a CTA takes one b, a tile of 128 positions t and up to 2 heads, of K
//     or of V (blockIdx.y); its 128 rows of 256 bytes are read once;
//   * 8 lanes take a (t, h) segment's 64 channels, 16 bytes each, and each
//     lane 4 consecutive positions of its 8 channels, twice: all 8 loads
//     of 16 bytes a lane are issued before the first is used (each warp
//     load 4 whole 128-byte segments), 68 registers, 3 CTAs an SM.  On an
//     H100 80GB HBM3 this read 1.08-1.09 ms at the shape above, where the
//     same code with 4 heads a CTA and one round's loads in flight read
//     1.36 ms, and with all 4 rounds' 1.16 ms (2 CTAs an SM);
//   * a segment's amax is reduced by 3 shuffles among its 8 lanes; its
//     scale and inverse are computed once;
//   * few conversions, which issue at 16 a clock an SM (CUDA's throughput
//     table; f32 arithmetic at 128): the bf16 roundings go two at once
//     (cvt.rn.bf16x2.f32), and clamp, rint and the int8 cast are a float
//     clamp and an add of 1.5 * 2^23, which rounds half to even into the
//     low bits, whose low byte is the code (1.09 ms, against 1.28 with a
//     conversion each for the roundings, rint and the cast);
//   * each lane packs its 4 positions' codes of a channel into a 32-bit
//     word and stores its 8 words to shared memory as [h][d][t / 4]: the
//     transpose.  The word column is XOR-swizzled by the channel's group of
//     8, so a warp's 32 stores fall in 32 banks, and so do the reads;
//   * the write-out: a warp a (h, d) row, a word of 4 positions a lane, 128
//     bytes along Ta, the stride-1 axis of (B, H, Dh, Ta) (byte stores
//     where Ta % 4 != 0, as at audio_ctx 750, or the codes are not 4-byte
//     aligned); the scales as [h][t] runs;
//   * the ragged tail of Ta (1500 = 11 x 128 + 92) is masked: nothing is
//     read or written past Ta.
//
// Plain C entry point for ctypes; it launches on the given stream and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or an
// alignment it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;                  // head width: every Whisper
constexpr int kTile = 128;               // positions a CTA
constexpr int kQuads = kTile / 4;        // 4-position code words in a row
constexpr int kHeads = 2;                // heads a CTA, at most
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// rounds of 4 quads a warp: a tile's kHeads x kQuads quads over the CTA
constexpr int kRounds = kHeads * kQuads / (kWarps * 4);
constexpr float kInvQmax = 0x1.020408p-7f;   // f32(1 / 127)
constexpr float kMinAmax = 0x1.5798eep-27f;  // f32(1e-8)
// x + kRound, for |x| <= 2^22, is rint(x) + kRound exactly (the binade's
// spacing is 1, ties to even), and its bits are 0x4b400000 + rint(x)
constexpr float kRound = 12582912.0f;        // 1.5 * 2^23

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// round to the nearest bf16, ties to even, as PyTorch's cast
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the same for f[j] and f[j + 1], in one conversion
__device__ __forceinline__ void round_bf16x2(float* f) {
  const float2 p = __bfloat1622float2(__floats2bfloat162_rn(f[0], f[1]));
  f[0] = p.x;
  f[1] = p.y;
}

// clamp(rint(x), -127, 127) as an int8 in the low byte (rint commutes with
// a clamp to integer bounds)
__device__ __forceinline__ uint32_t code_byte(float x) {
  return __float_as_uint(fminf(fmaxf(x, -127.f), 127.f) + kRound);
}

// One 4-position quad of one head: raw[r] holds the lane's 8 channels
// (c .. c + 7) at position 4q + r.  Codes go to codes[hl * 64 + d][q ^
// (seg * 4)], scales to scales[hl][4q ..]; the segment's 8 lanes call this
// together (their shuffles).
__device__ __forceinline__ void quantize_quad(
    const uint4 (&raw)[4], bool is_v, const float* __restrict__ v_bias,
    int c, int hl, int q, int seg, uint32_t (*codes)[kQuads],
    float (*scales)[kTile]) {
  float bias[8] = {};
  if (is_v) {
    const float4 a = *reinterpret_cast<const float4*>(v_bias + c);
    const float4 e = *reinterpret_cast<const float4*>(v_bias + c + 4);
    bias[0] = a.x; bias[1] = a.y; bias[2] = a.z; bias[3] = a.w;
    bias[4] = e.x; bias[5] = e.y; bias[6] = e.z; bias[7] = e.w;
  }
  uint32_t packed[8];
  float sc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float f[8];
    bf16x8_to_f32(raw[r], f);
    if (is_v) {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] += bias[j];
#pragma unroll
      for (int j = 0; j < 8; j += 2) round_bf16x2(f + j);
    }
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
    const float scale = fmaxf(m, kMinAmax) * kInvQmax;
    const float inv = round_bf16(__frcp_rn(scale));
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= inv;
#pragma unroll
    for (int j = 0; j < 8; j += 2) round_bf16x2(f + j);
    // byte r of packed[j]: position 4q + r, inserted over bytes 0 .. r - 1
    const uint32_t insert = r == 1 ? 0x0040 : r == 2 ? 0x0410 : 0x4210;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      packed[j] = r == 0 ? code_byte(f[j])
                         : __byte_perm(packed[j], code_byte(f[j]), insert);
    sc[r] = scale;
  }
  const int col = q ^ (seg << 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) codes[hl * kDh + seg * 8 + j][col] = packed[j];
  if (seg == 0)
    *reinterpret_cast<float4*>(&scales[hl][4 * q]) =
        make_float4(sc[0], sc[1], sc[2], sc[3]);
}

__global__ void __launch_bounds__(kThreads, 3)
cross_kv_quant_kernel(const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ v_bias,
                      int8_t* __restrict__ k_codes,
                      float* __restrict__ k_scales,
                      int8_t* __restrict__ v_codes,
                      float* __restrict__ v_scales, int H, int Ta,
                      int n_groups, int n_tiles, int words) {
  // codes[h * 64 + d][q ^ (d / 8 * 4)]: positions 4q .. 4q + 3 of (h, d)
  __shared__ uint32_t codes[kHeads * kDh][kQuads];
  __shared__ __align__(16) float scales[kHeads][kTile];

  const bool is_v = blockIdx.y != 0;
  const __nv_bfloat16* __restrict__ x = is_v ? v : k;
  // the head group varies fastest: neighbouring CTAs read whole rows
  const int group = blockIdx.x % n_groups;
  const int tile = (blockIdx.x / n_groups) % n_tiles;
  const int b = blockIdx.x / n_groups / n_tiles;
  const int t0 = tile * kTile;
  const int h0 = group * kHeads;
  const int n_h = min(kHeads, H - h0);
  const int D = H * kDh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = lane & 7;     // the lane's 8 channels: seg * 8 ..
  const int quad = lane >> 3;   // which of the warp's 4 position quads
  const __nv_bfloat16* __restrict__ xb = x + (long long)b * Ta * D;

  // round i: the warp's 4 units are quads warp * 4 + i * 32 .. + 3, 4
  // consecutive quads of one head (kQuads % 4 == 0).  Every round's loads
  // are issued before the first is used
  uint4 raw[kRounds][4];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int u = warp * 4 + i * kWarps * 4 + quad;
    const int hl = u / kQuads;
    const int q = u % kQuads;
    const __nv_bfloat16* src = xb + (h0 + hl) * kDh + seg * 8;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + 4 * q + r;
      raw[i][r] = hl < n_h && t < Ta
                      ? *reinterpret_cast<const uint4*>(src + (long long)t * D)
                      : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int u = warp * 4 + i * kWarps * 4 + quad;
    if (u / kQuads < n_h)   // warp-uniform: the warp's 4 units share a head
      quantize_quad(raw[i], is_v, v_bias, (h0 + u / kQuads) * kDh + seg * 8,
                    u / kQuads, u % kQuads, seg, codes, scales);
  }
  __syncthreads();

  const int n_t = min(kTile, Ta - t0);
  int8_t* __restrict__ out = is_v ? v_codes : k_codes;
  float* __restrict__ out_s = is_v ? v_scales : k_scales;
  const long long bh0 = (long long)b * H + h0;
#pragma unroll 4
  for (int row = warp; row < n_h * kDh; row += kWarps) {
    const int d = row % kDh;
    const uint32_t w = codes[row][lane ^ ((d >> 3) << 2)];
    int8_t* dst = out + ((bh0 + row / kDh) * kDh + d) * Ta + t0 + 4 * lane;
    const int n = n_t - 4 * lane;   // this word's positions inside Ta
    if (words) {
      if (n > 0) *reinterpret_cast<uint32_t*>(dst) = w;   // n % 4 == 0
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < n) dst[r] = (int8_t)(w >> (8 * r));
    }
  }
  for (int i = threadIdx.x; i < n_h * kTile; i += kThreads) {
    const int t = i % kTile;
    if (t < n_t) out_s[(bh0 + i / kTile) * Ta + t0 + t] = scales[i / kTile][t];
  }
}

}  // namespace

extern "C" int wtt_cross_kv_quant(const void* k, const void* v,
                                  const void* v_bias, void* k_codes,
                                  void* k_scales, void* v_codes,
                                  void* v_scales, int B, int H, int Ta,
                                  void* stream) {
  if (B < 1 || H < 1 || Ta < 1 || (long long)H * kDh > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v | (uintptr_t)v_bias) % 16)
    return (int)cudaErrorInvalidValue;
  const long long n_groups = (H + kHeads - 1) / kHeads;
  const long long n_tiles = (Ta + kTile - 1) / kTile;
  const long long grid = (long long)B * n_groups * n_tiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const int words = Ta % 4 == 0 && (uintptr_t)k_codes % 4 == 0 &&
                    (uintptr_t)v_codes % 4 == 0;
  cross_kv_quant_kernel<<<dim3((unsigned)grid, 2), kThreads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(v_bias),
      static_cast<int8_t*>(k_codes), static_cast<float*>(k_scales),
      static_cast<int8_t*>(v_codes), static_cast<float*>(v_scales), H, Ta,
      (int)n_groups, (int)n_tiles, words);
  return (int)cudaGetLastError();
}
