// Row-wise epilogues of the encoder block, five kernels of whisper_tpu_torch
// (ops/encoder_epilogue.py):
//   ln_cast           bf16 LN(x) of f32 rows x (the block's entry)
//   bias_cast         y = bf16(f32(y) + b) in place, one or two (y, b) pairs
//                     (the q and v projections)
//   bias_residual_ln  x' = x + (f32(y) + b) in f32, and bf16 LN(x') (after
//                     the output projection)
//   bias_gelu_cast    y = bf16(gelu_tanh(f32(y) + b)) in place (after mlp0)
//   bias_residual     x' = x + (f32(y) + b) in f32 (after mlp2)
//
// These replace no TPU kernel: on the TPU, XLA fused the encoder block's
// bias adds, layernorms, GELU, residual adds and casts into its own
// fusions.  Under PyTorch each is a kernel of its own, and most write a
// float32 intermediate that only the next one reads: per 1280-wide row and
// layer the passes between the GEMMs moved ~202 KB (the 5120-wide mlp0
// output written in f32, read by GELU, written in f32 again, read by a
// cast).  Each kernel here reads the bf16 GEMM output once and writes only
// what the next GEMM or the residual stream needs: ~74 KB (both counts
// hold the cast of K1's f32 output, which stays).
//
// The arithmetic is PyTorch's, in the same order, so every rounding stays
// where it was: the bias add in f32 then one rounding to bf16; the residual
// sum x + (y + b) in f32; GELU with PyTorch's tanh formula and constants in
// f32 (tanhf); the layernorm's gamma * (rstd * (x - mean)) + beta with
// rstd = rsqrtf(var + eps).  Only the layernorm's mean and variance are
// summed in another order (a two-pass sum over a row held in registers,
// where PyTorch runs Welford), which may move a bf16 output by one ulp.
//
// Bound on the H100: bytes.  A few operations per byte, far below the
// ridge, so the time is the bytes over 3.35 TB/s and the design only moves
// fewer of them and keeps enough in flight:
//   * one warp a row, the rows taken by a grid-stride loop over one wave of
//     blocks (sized by the occupancy calculator), so 1,500 rows (one
//     window) and 384,000 (256 windows) both fill the card;
//   * 16-byte loads and stores: 8 bf16, or 8 f32 as two float4, a lane; D
//     any multiple of 8;
//   * the layernorms keep their row in registers (up to 8 chunks of 8 a
//     lane: D <= 2048), read once, and reduce with warp shuffles only: no
//     shared memory, no block barrier;
//   * the elementwise kernels load 4 chunks a lane before they compute, so
//     each warp keeps 2-4 KB in flight; the bias (a few KB) stays in L1.
//
// Plain C entry points for ctypes; each launches on the given stream and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block, a row each
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;                // chunks a lane loads at once
constexpr int kMaxLnChunks = 8;           // layernorm rows up to 2048 wide

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// round to nearest even, as PyTorch's cast
__device__ __forceinline__ uint4 f32_to_bf16x8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void load_f32x8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store_f32x8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// PyTorch's GeluCUDAKernelImpl with approximate="tanh", in float: its
// constants (the product taken in double, then rounded) and its order
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ long long first_row() {
  return (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

__device__ __forceinline__ long long row_stride() {
  return (long long)gridDim.x * kWarps;
}

// LN of a row held as v[i] = chunk lane + 32 i (zeros past the row's end),
// rounded to bf16 into o
template <int kChunks>
__device__ __forceinline__ void layernorm_store(
    const float (&v)[kChunks][8], const float* __restrict__ w,
    const float* __restrict__ b, __nv_bfloat16* __restrict__ o, int lane,
    int cpr, int D, float eps) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[i][j];
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < cpr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < cpr) {
      float g[8], be[8], f[8];
      load_f32x8(w + c * 8, g);
      load_f32x8(b + c * 8, be);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = g[j] * (rstd * (v[i][j] - mean)) + be[j];
      *reinterpret_cast<uint4*>(o + c * 8) = f32_to_bf16x8(f);
    }
  }
}

template <int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
ln_cast_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, __nv_bfloat16* __restrict__ out,
               int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int cpr = D >> 3;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const float* xr = x + r * D;
    float v[kChunks][8];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < cpr) {
        load_f32x8(xr + c * 8, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
      }
    }
    layernorm_store<kChunks>(v, w, b, out + r * D, lane, cpr, D, eps);
  }
}

template <int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
bias_residual_ln_kernel(const float* __restrict__ x,
                        const __nv_bfloat16* __restrict__ y,
                        const float* __restrict__ bias,
                        const float* __restrict__ w,
                        const float* __restrict__ b,
                        float* __restrict__ x_out,
                        __nv_bfloat16* __restrict__ ln_out, int rows, int D,
                        float eps) {
  const int lane = threadIdx.x & 31;
  const int cpr = D >> 3;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const long long base = r * D;
    float v[kChunks][8];
    uint4 yv[kChunks];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < cpr) {
        load_f32x8(x + base + c * 8, v[i]);
        yv[i] = *reinterpret_cast<const uint4*>(y + base + c * 8);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < cpr) {
        float yf[8], bb[8];
        bf16x8_to_f32(yv[i], yf);
        load_f32x8(bias + c * 8, bb);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = v[i][j] + (yf[j] + bb[j]);
        store_f32x8(x_out + base + c * 8, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
      }
    }
    layernorm_store<kChunks>(v, w, b, ln_out + base, lane, cpr, D, eps);
  }
}

// y = bf16(f32(y) + bias), in place; blockIdx.y picks the pair
__global__ void __launch_bounds__(kThreads)
bias_cast_kernel(__nv_bfloat16* y0, const float* __restrict__ b0,
                 __nv_bfloat16* y1, const float* __restrict__ b1, int rows,
                 int D) {
  __nv_bfloat16* y = blockIdx.y ? y1 : y0;
  const float* bias = blockIdx.y ? b1 : b0;
  const int lane = threadIdx.x & 31;
  const int cpr = D >> 3;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    __nv_bfloat16* yr = y + r * D;
    for (int c0 = lane; c0 < cpr; c0 += 32 * kUnroll) {
      uint4 yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < cpr) yv[u] = *reinterpret_cast<const uint4*>(yr + c * 8);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < cpr) {
          float f[8], bb[8];
          bf16x8_to_f32(yv[u], f);
          load_f32x8(bias + c * 8, bb);
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = f[j] + bb[j];
          *reinterpret_cast<uint4*>(yr + c * 8) = f32_to_bf16x8(f);
        }
      }
    }
  }
}

// y = bf16(gelu_tanh(f32(y) + bias)), in place
__global__ void __launch_bounds__(kThreads)
bias_gelu_cast_kernel(__nv_bfloat16* y, const float* __restrict__ bias,
                      int rows, int D) {
  const int lane = threadIdx.x & 31;
  const int cpr = D >> 3;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    __nv_bfloat16* yr = y + r * D;
    for (int c0 = lane; c0 < cpr; c0 += 32 * kUnroll) {
      uint4 yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < cpr) yv[u] = *reinterpret_cast<const uint4*>(yr + c * 8);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < cpr) {
          float f[8], bb[8];
          bf16x8_to_f32(yv[u], f);
          load_f32x8(bias + c * 8, bb);
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = gelu_tanh(f[j] + bb[j]);
          *reinterpret_cast<uint4*>(yr + c * 8) = f32_to_bf16x8(f);
        }
      }
    }
  }
}

// x_out = x + (f32(y) + bias), f32
__global__ void __launch_bounds__(kThreads)
bias_residual_kernel(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ y,
                     const float* __restrict__ bias,
                     float* __restrict__ x_out, int rows, int D) {
  const int lane = threadIdx.x & 31;
  const int cpr = D >> 3;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const long long base = r * D;
    for (int c0 = lane; c0 < cpr; c0 += 32 * kUnroll) {
      uint4 yv[kUnroll];
      float xv[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < cpr) {
          yv[u] = *reinterpret_cast<const uint4*>(y + base + c * 8);
          load_f32x8(x + base + c * 8, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < cpr) {
          float f[8], bb[8];
          bf16x8_to_f32(yv[u], f);
          load_f32x8(bias + c * 8, bb);
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = xv[u][j] + (f[j] + bb[j]);
          store_f32x8(x_out + base + c * 8, f);
        }
      }
    }
  }
}

// blocks of one wave of `kernel` for `rows` rows (a warp each).  The wave
// (SMs x the kernel's blocks an SM) is looked up once a thread for each
// device and kernel: the occupancy query costs more host time than the
// launch, and the decode step makes ~100 of these launches
cudaError_t one_wave(const void* kernel, int rows, int* grid) {
  struct Wave {
    const void* kernel;
    int dev;
    long long blocks;
  };
  constexpr int kCached = 64;
  static thread_local Wave waves[kCached];
  static thread_local int n_waves = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  long long wave = 0;
  for (int i = 0; i < n_waves; ++i)
    if (waves[i].kernel == kernel && waves[i].dev == dev) {
      wave = waves[i].blocks;
      break;
    }
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (n_waves < kCached) waves[n_waves++] = {kernel, dev, wave};
  }
  const long long want = ((long long)rows + kWarps - 1) / kWarps;
  *grid = (int)(want < wave ? want : wave);
  return cudaSuccess;
}

bool shape_ok(int rows, int D) { return rows >= 1 && D >= 8 && D % 8 == 0; }

int ln_chunks(int D) { return (D / 8 + 31) / 32; }

template <int kChunks>
int launch_ln_cast(const float* x, const float* w, const float* b,
                   __nv_bfloat16* out, int rows, int D, float eps,
                   cudaStream_t s) {
  auto kernel = ln_cast_kernel<kChunks>;
  int grid = 0;
  cudaError_t e = one_wave(reinterpret_cast<const void*>(kernel), rows, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, 0, s>>>(x, w, b, out, rows, D, eps);
  return (int)cudaGetLastError();
}

template <int kChunks>
int launch_bias_residual_ln(const float* x, const __nv_bfloat16* y,
                            const float* bias, const float* w, const float* b,
                            float* x_out, __nv_bfloat16* ln_out, int rows,
                            int D, float eps, cudaStream_t s) {
  auto kernel = bias_residual_ln_kernel<kChunks>;
  int grid = 0;
  cudaError_t e = one_wave(reinterpret_cast<const void*>(kernel), rows, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, 0, s>>>(x, y, bias, w, b, x_out, ln_out, rows, D,
                                   eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wtt_ln_cast(const void* x, const void* w, const void* b,
                           void* out, int rows, int D, float eps,
                           void* stream) {
  if (!shape_ok(rows, D) || ln_chunks(D) > kMaxLnChunks)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ln_chunks(D)) {
    case 1: return launch_ln_cast<1>(xp, wp, bp, o, rows, D, eps, s);
    case 2: return launch_ln_cast<2>(xp, wp, bp, o, rows, D, eps, s);
    case 3: return launch_ln_cast<3>(xp, wp, bp, o, rows, D, eps, s);
    case 4: return launch_ln_cast<4>(xp, wp, bp, o, rows, D, eps, s);
    case 5: return launch_ln_cast<5>(xp, wp, bp, o, rows, D, eps, s);
    case 6: return launch_ln_cast<6>(xp, wp, bp, o, rows, D, eps, s);
    case 7: return launch_ln_cast<7>(xp, wp, bp, o, rows, D, eps, s);
    default: return launch_ln_cast<8>(xp, wp, bp, o, rows, D, eps, s);
  }
}

extern "C" int wtt_bias_residual_ln(const void* x, const void* y,
                                    const void* bias, const void* w,
                                    const void* b, void* x_out, void* ln_out,
                                    int rows, int D, float eps,
                                    void* stream) {
  if (!shape_ok(rows, D) || ln_chunks(D) > kMaxLnChunks)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const __nv_bfloat16* yp = static_cast<const __nv_bfloat16*>(y);
  const float* bi = static_cast<const float*>(bias);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* xo = static_cast<float*>(x_out);
  __nv_bfloat16* lo = static_cast<__nv_bfloat16*>(ln_out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ln_chunks(D)) {
#define WTT_BRLN(n) \
  case n: return launch_bias_residual_ln<n>(xp, yp, bi, wp, bp, xo, lo, rows, D, eps, s);
    WTT_BRLN(1) WTT_BRLN(2) WTT_BRLN(3) WTT_BRLN(4)
    WTT_BRLN(5) WTT_BRLN(6) WTT_BRLN(7)
#undef WTT_BRLN
    default:
      return launch_bias_residual_ln<8>(xp, yp, bi, wp, bp, xo, lo, rows, D,
                                        eps, s);
  }
}

extern "C" int wtt_bias_cast(void* y0, const void* b0, void* y1,
                             const void* b1, int n_pairs, int rows, int D,
                             void* stream) {
  if (!shape_ok(rows, D) || n_pairs < 1 || n_pairs > 2)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = one_wave(reinterpret_cast<const void*>(bias_cast_kernel),
                           rows, &grid);
  if (e != cudaSuccess) return (int)e;
  // two pairs: half a wave each
  if (n_pairs == 2) grid = (grid + 1) / 2;
  bias_cast_kernel<<<dim3(grid, n_pairs), kThreads, 0,
                     (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(y0), static_cast<const float*>(b0),
      static_cast<__nv_bfloat16*>(y1), static_cast<const float*>(b1), rows,
      D);
  return (int)cudaGetLastError();
}

extern "C" int wtt_bias_gelu_cast(void* y, const void* bias, int rows, int D,
                                  void* stream) {
  if (!shape_ok(rows, D)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = one_wave(
      reinterpret_cast<const void*>(bias_gelu_cast_kernel), rows, &grid);
  if (e != cudaSuccess) return (int)e;
  bias_gelu_cast_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(y), static_cast<const float*>(bias), rows,
      D);
  return (int)cudaGetLastError();
}

extern "C" int wtt_bias_residual(const void* x, const void* y,
                                 const void* bias, void* x_out, int rows,
                                 int D, void* stream) {
  if (!shape_ok(rows, D)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = one_wave(
      reinterpret_cast<const void*>(bias_residual_kernel), rows, &grid);
  if (e != cudaSuccess) return (int)e;
  bias_residual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const float*>(bias), static_cast<float*>(x_out), rows, D);
  return (int)cudaGetLastError();
}
