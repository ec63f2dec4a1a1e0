"""Single-query cross-attention over int8 K/V, kernel K2
(csrc/cross_attention_q8.cu), and the per-position int8 quantizer.

K2 replaces whisper_tpu/ops/cross_attention.py
`cross_attention_decode_q8dt` / `_xattn_kernel_q8dt`, which computes the
same function as the serving path's "q8e" einsum
(whisper_tpu/models/whisper.py `_cross_attn_step`): per (batch, head),
logits = (q . k_q) * k_s * Dh^-1/2, an f32 softmax, weights w * v_s
rounded to the query dtype, and their sum against v_q.

What bounds it on the H100: each decode step reads the whole int8
cross-KV of every layer, 2 * H * Dh * Ta bytes per (batch row, layer),
~3.8 MB per row per layer at large-v3, for 2 FLOP per byte: memory bound,
three orders of magnitude under the compute ridge.  K2 reads the
(B, H, Dh, Ta) int8 layout of `cross_kv_q8` as it is, with consecutive
threads on consecutive key positions (coalesced byte reads along the
contiguous Ta axis), dequantizes in registers, and keeps the (Ta,) logits
and weights in shared memory, so no bf16 copy of K/V and no score tensor
ever reaches device memory — the einsum path writes and re-reads both.
One block per (b, h); splitting Ta over several blocks is later work.
"""

from __future__ import annotations

import torch


def quantize_kv_bhdt(k: torch.Tensor):
    """(..., H, Dh, Ta) -> (int8 codes, same layout; (..., H, Ta) f32
    per-(head, position) scales).  Arithmetic stays in the input dtype;
    torch.round rounds half to even, like jnp.round."""
    amax = torch.amax(torch.abs(k), dim=-2, keepdim=True).float()
    # x * f32(1/127), not x / 127: XLA rewrites the reference's division
    # by a constant into this product, and the scales must match bit for bit
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)    # (..., H, 1, Ta)
    inv = (1.0 / scale).to(k.dtype)
    q = torch.clamp(torch.round(k * inv), -127, 127).to(torch.int8)
    return q, scale[..., 0, :]


def cross_attention_decode_q8dt_ref(q, k_q, k_s, v_q, v_s):
    """Plain PyTorch version (the q8e einsum), computed in q's dtype:
    q (B, H, 1, Dh); k_q/v_q (B, H, Dh, Ta) int8; k_s/v_s (B, H, Ta) f32
    -> (B, H, 1, Dh) f32."""
    cd = q.dtype
    dh = q.shape[-1]
    qk = torch.matmul(q, k_q.to(cd)).float()               # (B, H, 1, Ta)
    qk = qk * k_s[:, :, None, :] * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    wv = w * v_s[:, :, None, :]
    return torch.matmul(wv.to(cd), v_q.to(cd).transpose(-1, -2)).float()


def cross_attention_decode_q8dt(q, k_q, k_s, v_q, v_s):
    """q (B, H, 1, Dh) bf16; k_q/v_q (B, H, Dh, Ta) int8; k_s/v_s
    (B, H, Ta) f32 -> (B, H, 1, Dh) f32.

    CPU tensors take the plain version (in q's dtype); CUDA tensors go
    through K2, which takes a bfloat16 query only.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_q8dt_ref(q, k_q, k_s, v_q, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_decode_q8dt: unsupported device "
                         f"{q.device}")
    B, H, one, Dh = q.shape
    Ta = k_q.shape[-1]
    expect = {
        "q": (q, (B, H, 1, Dh), torch.bfloat16),
        "k_q": (k_q, (B, H, Dh, Ta), torch.int8),
        "k_s": (k_s, (B, H, Ta), torch.float32),
        "v_q": (v_q, (B, H, Dh, Ta), torch.int8),
        "v_s": (v_s, (B, H, Ta), torch.float32),
    }
    for name, (x, shape, dtype) in expect.items():
        if x.shape != shape or x.dtype != dtype or x.device != q.device:
            raise ValueError(
                f"cross_attention_decode_q8dt: {name} is "
                f"{tuple(x.shape)} {x.dtype} on {x.device}, expected "
                f"{shape} {dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"cross_attention_decode_q8dt: {name} must be "
                             "contiguous")
    if one != 1 or Ta < 1:
        raise ValueError(f"K2 takes one query per (b, h) and Ta >= 1 "
                         f"(got {one}, Ta={Ta})")
    from ._build import library
    out = torch.empty((B, H, 1, Dh), dtype=torch.float32, device=q.device)
    library().call("wtt_cross_attention_q8", q.data_ptr(), k_q.data_ptr(),
                   k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                   out.data_ptr(), B, H, Dh, Ta,
                   torch.cuda.current_stream(q.device).cuda_stream)
    cross_attention_decode_q8dt.launches += 1
    return out


cross_attention_decode_q8dt.launches = 0
