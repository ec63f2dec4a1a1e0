"""Encoder self-attention, kernel K1 (csrc/encoder_attention.cu).

Replaces whisper_tpu/ops/encoder_attention.py `encoder_attention` /
`_attn_kernel`: per (batch, head), softmax(Q K^T * Dh^-1/2) V with no
causal mask, keys at or beyond T masked, bf16 inputs, f32 output.

What bounds it on the H100: at T=1500, Dh=64 the work is two (T x T x 64)
products per (batch, head), about 0.58 GFLOP, against 0.6 MB of q/k/v
reads — far above the card's ~295 FLOP/byte bf16 ridge, so it is
tensor-core bound.  The TPU kernel keeps one head's K and V resident in
VMEM (~384 KB in bf16), more than the 227 KB a Hopper block can hold, and
materializes each (256 x T) score block.  K1 instead streams 64-key K/V
tiles through shared memory with an online softmax (one block per
(b, h, 64-query tile), bf16 wmma with f32 accumulation), so neither the
scores nor any padded copy of q/k/v reach device memory.  It reads the
JAX layout (B, T, H, Dh) strided and masks the ragged last tile itself:
no pad to 256, no transposes.
"""

from __future__ import annotations

import torch

HEAD_DIM = 64   # every Whisper model; the kernel is written for it


def self_attention_ref(q, k, v, compute_dtype=torch.bfloat16):
    """Plain PyTorch version: q/k/v (B, T, H, Dh) -> (B, T, H*Dh) f32
    (whisper_tpu.models.whisper._attention without a mask)."""
    B, T, H, Dh = q.shape
    qh = q.to(compute_dtype).permute(0, 2, 1, 3)           # (B, H, T, Dh)
    kh = k.to(compute_dtype).permute(0, 2, 3, 1)           # (B, H, Dh, T)
    vh = v.to(compute_dtype).permute(0, 2, 1, 3)
    qk = torch.matmul(qh, kh).float() * (Dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    out = torch.matmul(w.to(compute_dtype), vh).float()    # (B, H, T, Dh)
    return out.permute(0, 2, 1, 3).reshape(B, T, H * Dh)


def self_attention(q, k, v, compute_dtype=torch.bfloat16):
    """q/k/v (B, T, H, Dh) -> (B, T, H*Dh) f32.

    CPU tensors take `self_attention_ref`.  CUDA tensors are cast to
    `compute_dtype`, which must be bfloat16, and go through K1.
    """
    if q.device.type == "cpu":
        return self_attention_ref(q, k, v, compute_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention: unsupported device {q.device}")
    if compute_dtype != torch.bfloat16:
        raise TypeError("K1 takes bfloat16 inputs only; got compute_dtype "
                        f"{compute_dtype}")
    q, k, v = (x.to(compute_dtype) for x in (q, k, v))
    B, T, H, Dh = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != (B, T, H, Dh) or x.device != q.device:
            raise ValueError(f"self_attention: {name} {tuple(x.shape)} on "
                             f"{x.device}, expected {(B, T, H, Dh)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"self_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if Dh != HEAD_DIM:
        raise ValueError(f"K1 is written for Dh={HEAD_DIM}, got {Dh}")
    from ._build import library
    out = torch.empty((B, T, H * Dh), dtype=torch.float32, device=q.device)
    library().call("wtt_encoder_attention", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), B, T, H, Dh,
                   torch.cuda.current_stream(q.device).cuda_stream)
    self_attention.launches += 1
    return out


self_attention.launches = 0
