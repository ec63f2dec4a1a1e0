"""Block-quantized weight matmul, kernel K3 (csrc/quantized_matmul.cu).

K3 replaces whisper_tpu/ops/quantized.py `quantized_matmul` / `_qmm_kernel`
and `_qmm_kernel_mins`: y = x @ W^T for W = codes * scales (+ mins) with
32-element blocks, held K-major as in the JAX package:
    x:       (M, K), rounded to bf16 (in the kernel, from f32 or bf16)
    codes_t: (K, N) int8     — W^T codes
    scales_t:(K/32, N) f32   — block scales, rounded to bf16 in the kernel
    mins_t:  (K/32, N) f32 or None — block offsets (q4_1/q5_1)
    w = bf16(code * scale_bf16) [then bf16(w + min_bf16)], f32 sums.

What bounds it on the H100: in the token loop M is the batch (1 in
`full`, 4 in serving), so each call streams K*N code bytes for 2*M FLOP a
byte: memory bound, and over in microseconds, so the bytes in flight and
the launches per call decide its time.  At M <= 8 (`DECODE_M`) K3 is one
launch: each CTA takes 64 columns and a slice of K, the K slices of a
column tile form one thread-block cluster (`_cluster`), all of a slice's
codes and scales are requested by TMA (one 2-D box a 32-row block) before
the math, and the slices' partial sums meet in the cluster's rank 0 through distributed
shared memory, in rank order.  At M > 8 (the carried-prompt pass, 232
rows; B x 232 in a serving batch's) it does 2*M FLOP per code byte, so
the bf16 tensor cores bound it: one launch of `wgmma` tiles of 128 x 128
outputs, x and each 32-row block of codes brought by TMA, rounded and
dequantized once per tile into bf16 operands in shared memory, f32 sums in
registers; where the tiles alone cannot fill the card, K is split over a
cluster of 2-8 CTAs (`_prompt_cluster`) whose partial tiles meet through
distributed shared memory in rank order.  No dequantized copy of W ever
reaches device memory.  Codes stay one byte each, as in the TPU
representation; nibble codes are later work.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..weights import quant

QK = quant.QK            # 32
TILE_N = 128             # N must be a multiple of this
TARGET_BLOCKS = 264      # two blocks per SM of the H100's 132
SMS = 132                # the H100's SMs: the prompt grid reaches one CTA each
PROMPT_TILE = 128        # rows and columns of y per CTA at M > DECODE_M
PROMPT_MAX_CLUSTER = 8   # CTAs splitting one tile's K there
DECODE_M = 8             # up to this many rows of x: the one-launch path
DECODE_TILE_N = 64       # output columns per CTA there
MAX_CLUSTER = 16         # CTAs in a cluster (non-portable above 8)


# ---------------------------------------------------------------------------
# repacking: raw ggml bytes -> (codes, scales, mins)
# ---------------------------------------------------------------------------

def unpack_to_codes(raw: bytes, ttype: int,
                    shape: tuple[int, int]) -> tuple[np.ndarray, np.ndarray,
                                                     np.ndarray | None]:
    """Raw quantized tensor bytes -> (int8 codes, f32 scales, f32 mins|None)
    (copy of whisper_tpu.ops.quantized.unpack_to_codes).

    Bit-exact with quant.decode_tensor: codes * scales (+ mins) == decoded.
    """
    n, k = shape
    nb = (n * k) // QK

    def blocks(block_bytes):
        return np.frombuffer(raw, dtype=np.uint8).reshape(nb, block_bytes)

    if ttype == quant.GGML_TYPE_Q8_0:
        b = blocks(2 + QK)
        scales = b[:, :2].copy().view(np.float16).astype(np.float32)
        codes = b[:, 2:].copy().view(np.int8)
        mins = None
    elif ttype == quant.GGML_TYPE_Q4_0:
        b = blocks(2 + QK // 2)
        scales = b[:, :2].copy().view(np.float16).astype(np.float32)
        qs = b[:, 2:]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        codes = np.concatenate([lo, hi], axis=1)
        mins = None
    elif ttype == quant.GGML_TYPE_Q4_1:
        b = blocks(4 + QK // 2)
        scales = b[:, 0:2].copy().view(np.float16).astype(np.float32)
        mins = b[:, 2:4].copy().view(np.float16).astype(np.float32)
        qs = b[:, 4:]
        codes = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.int8)
    elif ttype == quant.GGML_TYPE_Q5_0:
        b = blocks(2 + 4 + QK // 2)
        scales = b[:, 0:2].copy().view(np.float16).astype(np.float32)
        xh0, xh1 = quant._q5_high_bits(b[:, 2:6])
        qs = b[:, 6:]
        lo = (((qs & 0x0F).astype(np.int32)) | xh0) - 16
        hi = (((qs >> 4).astype(np.int32)) | xh1) - 16
        codes = np.concatenate([lo, hi], axis=1).astype(np.int8)
        mins = None
    elif ttype == quant.GGML_TYPE_Q5_1:
        b = blocks(4 + 4 + QK // 2)
        scales = b[:, 0:2].copy().view(np.float16).astype(np.float32)
        mins = b[:, 2:4].copy().view(np.float16).astype(np.float32)
        xh0, xh1 = quant._q5_high_bits(b[:, 4:8])
        qs = b[:, 8:]
        lo = ((qs & 0x0F).astype(np.int32)) | xh0
        hi = ((qs >> 4).astype(np.int32)) | xh1
        codes = np.concatenate([lo, hi], axis=1).astype(np.int8)
    else:
        raise ValueError(f"not a supported quantized type: {ttype}")

    codes = codes.reshape(n, k)
    scales = scales.reshape(n, k // QK)
    if mins is not None:
        mins = mins.reshape(n, k // QK)
    return codes, scales, mins


# ---------------------------------------------------------------------------
# the matmul
# ---------------------------------------------------------------------------

def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16, computed on as f32."""
    return t.to(torch.bfloat16).float()


def dequantize_t(codes_t, scales_t, mins_t=None) -> torch.Tensor:
    """(K, N) W^T in f32 with K3's roundings: w = bf16(code * bf16(s))
    [then bf16(w + bf16(m))]."""
    s = _bf16(scales_t).repeat_interleave(QK, dim=0)
    w = _bf16(codes_t.float() * s)
    if mins_t is not None:
        w = _bf16(w + _bf16(mins_t).repeat_interleave(QK, dim=0))
    return w


def dequantize_weights(codes, scales, mins=None, dtype=torch.bfloat16):
    """Full dequantization in whisper_tpu's (N, K) layout (copy of
    whisper_tpu.ops.quantized.dequantize_weights): codes (N, K), scales
    and mins (N, K/32); w = code * scale [+ min] in f32, then `dtype`."""
    w = codes.float() * scales.float().repeat_interleave(QK, dim=1)
    if mins is not None:
        w = w + mins.float().repeat_interleave(QK, dim=1)
    return w.to(dtype)


def quantized_matmul_ref(x, codes_t, scales_t, mins_t=None):
    """Plain PyTorch version: the TPU kernel's roundings (x and the scales
    to bf16, each dequantized weight to bf16), then one float32 matmul.
    Only the summation order differs from the kernel.  -> (M, N) f32."""
    return _bf16(x) @ dequantize_t(codes_t, scales_t, mins_t)


@functools.lru_cache(maxsize=None)
def _prompt_cluster(M: int, N: int, K: int) -> int:
    """K3's cluster size C at M > DECODE_M: the CTAs that split one
    128 x 128 output tile's K, the smallest power of two that brings the
    grid (ceil(M / 128) x N / 128 x C CTAs) to SMS, at most
    PROMPT_MAX_CLUSTER and at most one 32-row block a CTA."""
    kblocks = K // QK
    tiles = math.ceil(M / PROMPT_TILE) * (N // PROMPT_TILE)
    c = 1
    while tiles * c < SMS and 2 * c <= min(PROMPT_MAX_CLUSTER, kblocks):
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def _cluster(N: int, K: int) -> int:
    """K3's cluster size C at M <= DECODE_M: the CTAs that split one
    column tile's K, the smallest power of two that brings the grid
    ((N / 64) x C CTAs) to TARGET_BLOCKS, at most MAX_CLUSTER and at most
    one 32-row block a CTA."""
    kblocks, tiles = K // QK, N // DECODE_TILE_N
    c = 1
    while tiles * c < TARGET_BLOCKS and 2 * c <= min(MAX_CLUSTER, kblocks):
        c *= 2
    return c


def _k_slice(rank: int, cluster: int, kblocks: int) -> tuple[int, int]:
    """The 32-row blocks [begin, end) that CTA `rank` of a K3 cluster takes
    (both kernels compute the same)."""
    return rank * kblocks // cluster, (rank + 1) * kblocks // cluster


def _refuse(x, codes_t, scales_t, mins_t, M, K, N) -> str | None:
    """Why K3 cannot take these operands, or None."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return f"x is {x.dtype}, not float32 or bfloat16"
    if M < 1 or K % QK or N % TILE_N:
        return (f"K3 takes M >= 1, K a multiple of {QK} and N of {TILE_N} "
                f"(got M={M}, K={K}, N={N})")
    for name, t, shape, dtype in (
            ("codes_t", codes_t, (K, N), torch.int8),
            ("scales_t", scales_t, (K // QK, N), torch.float32),
            ("mins_t", mins_t, (K // QK, N), torch.float32)):
        if t is None:
            continue
        if t.shape != shape or t.dtype != dtype or t.device != x.device:
            return (f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                    f"expected {shape} {dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            return f"{name} must be contiguous and 16-byte aligned"
    return None


def quantized_matmul(x, codes_t, scales_t, mins_t=None):
    """x (M, K); codes_t (K, N) int8; scales_t/mins_t (K/32, N) f32
    -> (M, N) f32.

    CPU tensors take `quantized_matmul_ref`.  CUDA tensors go through K3,
    which reads x as it is (float32 or bfloat16) and rounds it to bf16
    itself (the TPU kernel's first step); the codes and scales must already
    be int8 and float32, contiguous and 16-byte aligned, with N a multiple
    of 128 and K of 32.  Either path is one launch.
    """
    if x.device.type == "cpu":
        return quantized_matmul_ref(x, codes_t, scales_t, mins_t)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"quantized_matmul: x must be (M, K), got "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    N = codes_t.shape[-1]
    why = _refuse(x, codes_t, scales_t, mins_t, M, K, N)
    if why is not None:
        raise ValueError(f"quantized_matmul: {why}")
    from ._build import library
    x = x.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), codes_t.data_ptr(),
            scales_t.data_ptr(), 0 if mins_t is None else mins_t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if M <= DECODE_M:
        library().call("wtt_quantized_matmul_decode", *args, out.data_ptr(),
                       M, N, K, _cluster(N, K), stream)
    else:
        if x.data_ptr() % 16:     # TMA reads x from a 16-byte boundary
            x = x.clone()
            args = (x.data_ptr(),) + args[1:]
        library().call("wtt_quantized_matmul", *args, out.data_ptr(),
                       M, N, K, _prompt_cluster(M, N, K), stream)
    quantized_matmul.launches += 1
    if mins_t is not None:
        quantized_matmul.launches_mins += 1
    return out


quantized_matmul.launches = 0
quantized_matmul.launches_mins = 0     # the launches with mins (q4_1/q5_1)
