"""Encoder self-attention: kernel K1, and K6 on the same device code
(csrc/encoder_attention.cu).

K1 replaces whisper_tpu/ops/encoder_attention.py `encoder_attention` /
`_attn_kernel`, K6 `encoder_attention_btd` / `_attn_btd_kernel`: per
(batch, head), softmax(Q K^T * Dh^-1/2) V with no causal mask, keys at or
beyond `t_valid` masked, bf16 inputs, f32 output.

What bounds them on the H100: at T=1500, Dh=64 the work is two (T x T x 64)
products per (batch, head), about 0.58 GFLOP, against 0.6 MB of q/k/v
reads — far above the card's ~295 FLOP/byte bf16 ridge, so it is
tensor-core bound, and at Dh=64 the softmax's one exp2 a score costs about
as much as the score's products.  The TPU kernel keeps one head's K and V
resident in VMEM (~384 KB in bf16), more than the 227 KB a Hopper block can
hold, and materializes each (256 x T) score block.  The kernel instead
streams 128-key K/V tiles by TMA into a two-stage ring in shared memory
(one CTA per (b, h, 128 queries), two warpgroups of 64 query rows) and
runs Q K^T and P V on `wgmma` with the scores, the online softmax and the
output in registers, so neither the scores nor any padded or transposed
copy of q/k/v reach device memory.

Entries, each with its own launch count:
  * `self_attention` (K1): the JAX layout (B, T, H, Dh) read in place, the
    ragged last tile masked by the kernel: no pad to 256, no transposes;
  * `encoder_attention` (K1): (B, H, Dh, Tp) + t_valid, the TPU kernel's
    Dh-major layout (encode's pallas_dt / pallas_pf), read as it lies;
  * `encoder_attention_btd` (K6): (B, Tp, D) channels-last + t_valid, a
    head being the Dh-wide column slice of each row (encode's pallas_btd).
"""

from __future__ import annotations

import torch

HEAD_DIM = 64   # every Whisper model; the kernel is written for it
BLOCK_Q = 256   # encode's padded variants pad T to a multiple of this


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


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_bf16(fn_name, shape, tensors) -> None:
    """Every operand bf16 of `shape`, on the first one's device, contiguous
    and 16-byte aligned (a TMA tensor map's base address must be)."""
    dev = tensors[0][1].device
    for name, x in tensors:
        if (tuple(x.shape) != tuple(shape) or x.dtype != torch.bfloat16
                or x.device != dev):
            raise ValueError(f"{fn_name}: {name} is {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, expected "
                             f"{tuple(shape)} bfloat16 on {dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be contiguous and "
                             "16-byte aligned")


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
    _check_bf16("self_attention", (B, T, H, Dh),
                (("q", q), ("k", k), ("v", v)))
    if Dh != HEAD_DIM:
        raise ValueError(f"K1 is written for Dh={HEAD_DIM}, got {Dh}")
    from ._build import library
    out = torch.empty((B, T, H * Dh), dtype=torch.float32, device=q.device)
    library().call("wtt_encoder_attention", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), B, T, H, Dh, _stream(q))
    self_attention.launches += 1
    return out


self_attention.launches = 0


def _valid(t_valid, Tp: int) -> int:
    t_valid = Tp if t_valid is None else int(t_valid)
    if not 1 <= t_valid <= Tp:
        raise ValueError(f"t_valid {t_valid} outside [1, {Tp}]")
    return t_valid


def encoder_attention_ref(q, k, v, t_valid: int | None = None):
    """Plain PyTorch version of `encoder_attention`, its products in q's
    dtype with f32 scores and softmax: q/k/v (B, H, Dh, Tp) -> (B, H, Dh,
    Tp) f32, keys >= t_valid masked (whisper_tpu's `_attn_kernel`)."""
    Tp, Dh = q.shape[-1], q.shape[-2]
    t_valid = _valid(t_valid, Tp)
    qk = torch.matmul(q.transpose(-1, -2), k).float() * (Dh ** -0.5)
    if t_valid < Tp:
        qk[..., t_valid:] = -1e30
    w = torch.softmax(qk, dim=-1)                           # (B, H, Tq, Tp)
    return torch.matmul(v, w.to(v.dtype).transpose(-1, -2)).float()


def encoder_attention(q, k, v, t_valid: int | None = None):
    """q/k/v (B, H, Dh, Tp) -> (B, H, Dh, Tp) f32; keys at or beyond
    t_valid (default Tp) masked, every row computed.

    CPU tensors take `encoder_attention_ref`; CUDA tensors go through K1's
    Dh-major instance, which takes bfloat16, Dh = 64 and Tp a multiple of
    8 only."""
    if q.device.type == "cpu":
        return encoder_attention_ref(q, k, v, t_valid)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    B, H, Dh, Tp = q.shape
    t_valid = _valid(t_valid, Tp)
    _check_bf16("encoder_attention", (B, H, Dh, Tp),
                (("q", q), ("k", k), ("v", v)))
    if Dh != HEAD_DIM or Tp % 8:
        raise ValueError(f"K1 takes Dh={HEAD_DIM} and Tp a multiple of 8, "
                         f"got Dh={Dh}, Tp={Tp}")
    from ._build import library
    out = torch.empty((B, H, Dh, Tp), dtype=torch.float32, device=q.device)
    library().call("wtt_encoder_attention_bhdt", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), B, H, Dh, Tp, t_valid,
                   _stream(q))
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0


def encoder_attention_btd_ref(q, k, v, n_head: int,
                              t_valid: int | None = None):
    """Plain PyTorch version of K6: q/k/v (B, Tp, D) -> (B, Tp, D) f32, head
    h the columns [h*Dh, (h+1)*Dh) (whisper_tpu's `_attn_btd_kernel`); the
    arithmetic of `encoder_attention_ref` on the heads' views."""
    B, Tp, D = q.shape

    def heads(x):                                           # (B, H, Dh, Tp)
        return x.reshape(B, Tp, n_head, D // n_head).permute(0, 2, 3, 1)

    out = encoder_attention_ref(heads(q), heads(k), heads(v), t_valid)
    return out.permute(0, 3, 1, 2).reshape(B, Tp, D)


def encoder_attention_btd(q, k, v, n_head: int, t_valid: int | None = None):
    """q/k/v (B, Tp, D) channels-last -> (B, Tp, D) f32; keys at or beyond
    t_valid (default Tp) masked, every row computed.

    CPU tensors take `encoder_attention_btd_ref`; CUDA tensors go through
    K6, which takes bfloat16 and D = n_head * 64 only."""
    if q.device.type == "cpu":
        return encoder_attention_btd_ref(q, k, v, n_head, t_valid)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention_btd: unsupported device "
                         f"{q.device}")
    B, Tp, D = q.shape
    t_valid = _valid(t_valid, Tp)
    _check_bf16("encoder_attention_btd", (B, Tp, D),
                (("q", q), ("k", k), ("v", v)))
    if D != n_head * HEAD_DIM:
        raise ValueError(f"K6 takes D = n_head * {HEAD_DIM}, got D={D}, "
                         f"n_head={n_head}")
    from ._build import library
    out = torch.empty((B, Tp, D), dtype=torch.float32, device=q.device)
    library().call("wtt_encoder_attention_btd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), B, Tp, n_head, HEAD_DIM,
                   t_valid, _stream(q))
    encoder_attention_btd.launches += 1
    return out


encoder_attention_btd.launches = 0
