"""Block-quantization codecs for the legacy ggml tensor formats (a copy of
whisper_tpu.weights.quant, which the port cannot import without JAX).

Vectorized numpy re-implementations of the ggml block codecs so the port
reads and writes the same model files as the reference (layouts: reference
ggml/src/ggml-common.h:167-214, codecs: ggml/src/ggml-quants.c:31-360).
Block size is 32 for every supported type.  They run on the host at load
and quantize time; the packed-weight matmul is ops/quantized.py (K3).
"""

from __future__ import annotations

import numpy as np

QK = 32  # elements per quantization block (all of Q4_0..Q8_0)

# ggml_type ids (reference: ggml/include/ggml.h:352-391)
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8
GGML_TYPE_I8 = 24
GGML_TYPE_I16 = 25
GGML_TYPE_I32 = 26
GGML_TYPE_BF16 = 30

TYPE_NAMES = {
    GGML_TYPE_F32: "f32",
    GGML_TYPE_F16: "f16",
    GGML_TYPE_Q4_0: "q4_0",
    GGML_TYPE_Q4_1: "q4_1",
    GGML_TYPE_Q5_0: "q5_0",
    GGML_TYPE_Q5_1: "q5_1",
    GGML_TYPE_Q8_0: "q8_0",
    GGML_TYPE_BF16: "bf16",
}

# bytes per block (or per element for non-quantized types)
TYPE_SIZES = {
    GGML_TYPE_F32: (4, 1),
    GGML_TYPE_F16: (2, 1),
    GGML_TYPE_BF16: (2, 1),
    GGML_TYPE_I8: (1, 1),
    GGML_TYPE_I16: (2, 1),
    GGML_TYPE_I32: (4, 1),
    GGML_TYPE_Q4_0: (2 + QK // 2, QK),
    GGML_TYPE_Q4_1: (4 + QK // 2, QK),
    GGML_TYPE_Q5_0: (2 + 4 + QK // 2, QK),
    GGML_TYPE_Q5_1: (4 + 4 + QK // 2, QK),
    GGML_TYPE_Q8_0: (2 + QK, QK),
}

# ggml_ftype -> ggml_type for the "mostly" weights
# (reference: ggml/include/ggml.h:402-425, ggml_ftype_to_ggml_type in ggml.c)
FTYPE_TO_TYPE = {
    0: GGML_TYPE_F32,
    1: GGML_TYPE_F16,
    2: GGML_TYPE_Q4_0,
    3: GGML_TYPE_Q4_1,
    7: GGML_TYPE_Q8_0,
    8: GGML_TYPE_Q5_0,
    9: GGML_TYPE_Q5_1,
    24: GGML_TYPE_BF16,
}
TYPE_TO_FTYPE = {v: k for k, v in FTYPE_TO_TYPE.items()}


def type_nbytes(ttype: int, nelements: int) -> int:
    """Size in bytes of `nelements` values stored as ggml type `ttype`."""
    bs, blck = TYPE_SIZES[ttype]
    assert nelements % blck == 0, (ttype, nelements)
    return (nelements // blck) * bs


def is_quantized(ttype: int) -> bool:
    return ttype in (GGML_TYPE_Q4_0, GGML_TYPE_Q4_1, GGML_TYPE_Q5_0,
                     GGML_TYPE_Q5_1, GGML_TYPE_Q8_0)


# ---------------------------------------------------------------------------
# dequantize: raw bytes -> float32 (reference ggml-quants.c:255-360)
# ---------------------------------------------------------------------------

def _blocks(raw: bytes, block_bytes: int) -> np.ndarray:
    buf = np.frombuffer(raw, dtype=np.uint8)
    assert buf.size % block_bytes == 0
    return buf.reshape(-1, block_bytes)


def _f16(b: np.ndarray) -> np.ndarray:
    """Interpret pairs of bytes as little-endian float16 -> float32."""
    return b.copy().view(np.float16).astype(np.float32)


def dequantize_q4_0(raw: bytes) -> np.ndarray:
    b = _blocks(raw, 2 + QK // 2)
    d = _f16(b[:, :2])                       # (nb, 1)
    qs = b[:, 2:]
    lo = (qs & 0x0F).astype(np.int32) - 8    # elems 0..15
    hi = (qs >> 4).astype(np.int32) - 8      # elems 16..31
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)


def dequantize_q4_1(raw: bytes) -> np.ndarray:
    b = _blocks(raw, 4 + QK // 2)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)


def _q5_high_bits(qh_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Extract the per-element 5th bits from the packed uint32 qh word."""
    qh = qh_bytes.copy().view(np.uint32).reshape(-1, 1).astype(np.uint32)
    j = np.arange(QK // 2, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10            # for elems j
    xh1 = (qh >> (j + 12)) & 0x10            # for elems j + 16
    return xh0.astype(np.int32), xh1.astype(np.int32)


def dequantize_q5_0(raw: bytes) -> np.ndarray:
    b = _blocks(raw, 2 + 4 + QK // 2)
    d = _f16(b[:, 0:2])
    xh0, xh1 = _q5_high_bits(b[:, 2:6])
    qs = b[:, 6:]
    lo = (((qs & 0x0F).astype(np.int32)) | xh0) - 16
    hi = (((qs >> 4).astype(np.int32)) | xh1) - 16
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return out.reshape(-1)


def dequantize_q5_1(raw: bytes) -> np.ndarray:
    b = _blocks(raw, 4 + 4 + QK // 2)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    xh0, xh1 = _q5_high_bits(b[:, 4:8])
    qs = b[:, 8:]
    lo = ((qs & 0x0F).astype(np.int32)) | xh0
    hi = ((qs >> 4).astype(np.int32)) | xh1
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d + m
    return out.reshape(-1)


def dequantize_q8_0(raw: bytes) -> np.ndarray:
    b = _blocks(raw, 2 + QK)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:].copy().view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)


DEQUANTIZERS = {
    GGML_TYPE_Q4_0: dequantize_q4_0,
    GGML_TYPE_Q4_1: dequantize_q4_1,
    GGML_TYPE_Q5_0: dequantize_q5_0,
    GGML_TYPE_Q5_1: dequantize_q5_1,
    GGML_TYPE_Q8_0: dequantize_q8_0,
}


def decode_tensor(raw: bytes, ttype: int, shape: tuple[int, ...]) -> np.ndarray:
    """Decode raw ggml tensor bytes into a float32/typed numpy array.

    `shape` is the row-major (numpy-order) shape.
    """
    n = int(np.prod(shape)) if shape else 1
    if ttype == GGML_TYPE_F32:
        out = np.frombuffer(raw, dtype=np.float32, count=n)
    elif ttype == GGML_TYPE_F16:
        out = np.frombuffer(raw, dtype=np.float16, count=n).astype(np.float32)
    elif ttype == GGML_TYPE_BF16:
        u = np.frombuffer(raw, dtype=np.uint16, count=n).astype(np.uint32) << 16
        out = u.view(np.float32)
    elif ttype == GGML_TYPE_I32:
        out = np.frombuffer(raw, dtype=np.int32, count=n)
    elif ttype in DEQUANTIZERS:
        out = DEQUANTIZERS[ttype](raw)
    else:
        raise ValueError(f"unsupported ggml type {ttype}")
    return np.ascontiguousarray(out.reshape(shape))


# ---------------------------------------------------------------------------
# quantize: float32 -> raw bytes (reference ggml-quants.c:31-253)
# ---------------------------------------------------------------------------

def _absmax_scale(x: np.ndarray, qmax: float) -> tuple[np.ndarray, np.ndarray]:
    """ggml picks the signed value with the largest magnitude as `max`."""
    idx = np.argmax(np.abs(x), axis=1)
    amax = x[np.arange(x.shape[0]), idx]     # signed value at max |.|
    d = amax / qmax
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    return d.astype(np.float32), inv_d.astype(np.float32)


def quantize_q4_0(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK).astype(np.float32)
    d, inv_d = _absmax_scale(x, -8.0)
    q = np.clip((x * inv_d[:, None] + 8.5).astype(np.int32), 0, 15).astype(np.uint8)
    packed = q[:, :QK // 2] | (q[:, QK // 2:] << 4)
    blocks = np.concatenate(
        [d.astype(np.float16).view(np.uint8).reshape(-1, 2), packed], axis=1)
    return blocks.tobytes()


def quantize_q4_1(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK).astype(np.float32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(((x - mn[:, None]) * inv_d[:, None] + 0.5).astype(np.int32), 0, 15).astype(np.uint8)
    packed = q[:, :QK // 2] | (q[:, QK // 2:] << 4)
    blocks = np.concatenate([
        d.astype(np.float16).view(np.uint8).reshape(-1, 2),
        mn.astype(np.float16).view(np.uint8).reshape(-1, 2),
        packed,
    ], axis=1)
    return blocks.tobytes()


def _pack_q5_qh(q: np.ndarray) -> np.ndarray:
    """Pack 5th bits of 32 elements into a uint32 per block -> 4 uint8."""
    j = np.arange(QK // 2, dtype=np.uint32)
    hi0 = ((q[:, :QK // 2].astype(np.uint64) & 0x10) >> 4) << j
    # second-half bits live at j+16 (the dequant reads (qh >> (j+12)) & 0x10,
    # i.e. bit j+16 — see ggml-quants.c:105-127 vs :296-320)
    hi1 = ((q[:, QK // 2:].astype(np.uint64) & 0x10) >> 4) << (j + 16)
    qh = np.bitwise_or.reduce(hi0, axis=1) | np.bitwise_or.reduce(hi1, axis=1)
    return (qh & 0xFFFFFFFF).astype(np.uint32).view(np.uint8).reshape(-1, 4)


def quantize_q5_0(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK).astype(np.float32)
    d, inv_d = _absmax_scale(x, -16.0)
    q = np.clip((x * inv_d[:, None] + 16.5).astype(np.int32), 0, 31).astype(np.uint8)
    qh = _pack_q5_qh(q)
    packed = (q[:, :QK // 2] & 0x0F) | ((q[:, QK // 2:] & 0x0F) << 4)
    blocks = np.concatenate(
        [d.astype(np.float16).view(np.uint8).reshape(-1, 2), qh, packed], axis=1)
    return blocks.tobytes()


def quantize_q5_1(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK).astype(np.float32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(((x - mn[:, None]) * inv_d[:, None] + 0.5).astype(np.int32), 0, 31).astype(np.uint8)
    qh = _pack_q5_qh(q)
    packed = (q[:, :QK // 2] & 0x0F) | ((q[:, QK // 2:] & 0x0F) << 4)
    blocks = np.concatenate([
        d.astype(np.float16).view(np.uint8).reshape(-1, 2),
        mn.astype(np.float16).view(np.uint8).reshape(-1, 2),
        qh, packed,
    ], axis=1)
    return blocks.tobytes()


def quantize_q8_0(x: np.ndarray) -> bytes:
    x = x.reshape(-1, QK).astype(np.float32)
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    scaled = x * inv_d[:, None]
    # roundf semantics: round half away from zero (not numpy's banker rounding)
    q = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    q = np.clip(q.astype(np.int32), -128, 127).astype(np.int8)
    blocks = np.concatenate(
        [d.astype(np.float16).view(np.uint8).reshape(-1, 2),
         q.view(np.uint8)], axis=1)
    return blocks.tobytes()


QUANTIZERS = {
    GGML_TYPE_Q4_0: quantize_q4_0,
    GGML_TYPE_Q4_1: quantize_q4_1,
    GGML_TYPE_Q5_0: quantize_q5_0,
    GGML_TYPE_Q5_1: quantize_q5_1,
    GGML_TYPE_Q8_0: quantize_q8_0,
}
