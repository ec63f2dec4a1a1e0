"""The decoder step's self-attention over its KV cache as one kernel
(csrc/self_attn_step.cu).

It replaces no TPU kernel: whisper_tpu's decode step is one XLA program.
Under PyTorch the plain step (models/whisper.py `decode_step`) makes ~17
launches a layer for it: the q and v bias adds, a cast and a copy for each
cache column, the additive mask over the C cache columns, and the
attention as two matmuls with casts, a scale, the mask add and a softmax
between them.  `self_attn_step` does all of it in one launch, a CTA per
(b, h), reading only the keys [pad_len[b], kv_len):

    q, v = bf16(f32(q|v) + b)        written back into the q/k/v row
    k_cache[..., cache_index], v_cache[..., cache_index] = k, v
    out = the single query's attention over the valid keys, bf16

with the plain step's roundings (see the kernel's header); only the order
of its f32 sums differs.

`self_attn_step_ref` is that plain sequence, in any dtype: the CPU takes
it, and the card's tests compare the kernel with it.  CUDA tensors go
through the kernel, which takes the (B, 3D) bf16 output of one GEMM over
the concatenated q/k/v weights, f32 (D,) biases, the layer's bf16
(B, H, Dh, C) caches, pad_len (B,) int64 or None, every tensor contiguous,
Dh up to MAX_DH and kv_len up to MAX_KEYS; anything else raises.  Every
row needs at least one valid key (the plain softmax over none is NaN).
"""

from __future__ import annotations

import torch

from ._build import library

MAX_DH = 64         # a warp takes 16 channels of a head, four warps a CTA
MAX_KEYS = 8192     # and the (kv_len,) scores


def step_mask(C: int, kv_len: int, pad_len, device) -> torch.Tensor:
    """The plain step's additive mask over the C cache columns, (B or 1,
    1, 1, C) f32: 0 where pad_len <= column < kv_len, else -inf."""
    idx = torch.arange(C, device=device)
    valid = (idx < kv_len)[None, :]
    if pad_len is not None:
        valid = valid & (idx[None, :] >= pad_len[:, None])
    return torch.where(valid, 0.0, float("-inf"))[:, None, None, :]


def self_attn_step_ref(qkv, q_b, v_b, k_cache, v_cache, cache_index: int,
                       kv_len: int, pad_len, n_head: int, mask=None,
                       dtype=None):
    """The plain step's sequence: qkv (B, 3D) (the q, k and v GEMM outputs
    side by side) in the compute dtype `dtype` (qkv's when None), or in
    f32 from K3; q_b/v_b (D,); q and v get their biases in f32 and one
    rounding to the compute dtype (written back into qkv, as the kernel
    does), k and v go into column cache_index of k_cache/v_cache (B, H,
    Dh, C), and the query attends over the cache under `mask` (step_mask's,
    built here when None) in the compute dtype with an f32 softmax -> (B,
    D) in the compute dtype."""
    cd = dtype or qkv.dtype
    B, D = qkv.shape[0], qkv.shape[-1] // 3
    dh = D // n_head
    for part, bias in ((slice(0, D), q_b), (slice(2 * D, 3 * D), v_b)):
        y = qkv[..., part]
        qkv[..., part] = torch.add(y, bias.float(), out=torch.empty(
            y.shape, dtype=cd, device=y.device))
    q, k, v = (qkv[:, i * D:(i + 1) * D].reshape(B, 1, n_head, dh)
               for i in range(3))
    k_cache[..., cache_index] = k[:, 0].to(k_cache.dtype)
    v_cache[..., cache_index] = v[:, 0].to(v_cache.dtype)
    if mask is None:
        mask = step_mask(k_cache.shape[-1], kv_len, pad_len, qkv.device)
    qh = q.transpose(1, 2).to(cd)                           # (B, H, 1, Dh)
    qk = torch.matmul(qh, k_cache.to(cd)).float() * (dh ** -0.5) + mask
    w = torch.softmax(qk, dim=-1)
    out = torch.matmul(w.to(cd), v_cache.to(cd).transpose(-1, -2)).float()
    return out.transpose(1, 2).reshape(B, D).to(cd)


def self_attn_step(qkv, q_b, v_b, k_cache, v_cache, cache_index: int,
                   kv_len: int, pad_len, n_head: int):
    """One decode step's self-attention for one layer -> (B, D) bf16;
    see the module's docstring.  Writes q and v (with their biases) into
    qkv and the new column into the caches."""
    if not qkv.is_cuda:
        if qkv.device.type == "cpu":
            return self_attn_step_ref(qkv, q_b, v_b, k_cache, v_cache,
                                      cache_index, kv_len, pad_len, n_head)
        raise ValueError(f"self_attn_step: unsupported device {qkv.device}")
    B, D = qkv.shape[0], qkv.shape[-1] // 3
    Dh = D // n_head if n_head > 0 else 0
    C = k_cache.shape[-1]
    cache = (B, n_head, Dh, C)
    bf16 = torch.bfloat16
    dev = qkv.get_device()
    for name, x, dtype, shape in (
            ("qkv", qkv, bf16, (B, 3 * D)),
            ("q_b", q_b, torch.float32, (D,)),
            ("v_b", v_b, torch.float32, (D,)),
            ("k_cache", k_cache, bf16, cache),
            ("v_cache", v_cache, bf16, cache),
            *((("pad_len", pad_len, torch.int64, (B,)),)
              if pad_len is not None else ())):
        if x.shape != shape or x.dtype != dtype or x.get_device() != dev:
            raise ValueError(f"self_attn_step: {name} is {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, expected "
                             f"{tuple(shape)} {dtype} on {qkv.device}")
        if not x.is_contiguous():
            raise ValueError(f"self_attn_step: {name} must be contiguous")
    if (not 1 <= Dh <= MAX_DH or Dh * n_head != D or not 0 <= cache_index < C
            or not 1 <= kv_len <= min(C, MAX_KEYS)):
        raise ValueError(f"self_attn_step takes 1 <= Dh <= {MAX_DH}, "
                         f"0 <= cache_index < C and 1 <= kv_len <= "
                         f"min(C, {MAX_KEYS}) (got D={D}, n_head={n_head}, "
                         f"C={C}, cache_index={cache_index}, kv_len={kv_len})")
    out = torch.empty((B, D), dtype=bf16, device=qkv.device)
    library().call(
        "wtt_self_attn_step", qkv.data_ptr(), q_b.data_ptr(), v_b.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        0 if pad_len is None else pad_len.data_ptr(), out.data_ptr(), B,
        n_head, Dh, C, cache_index, kv_len, Dh ** -0.5,
        torch._C._cuda_getCurrentRawStream(dev))
    self_attn_step.launches += 1
    return out


self_attn_step.launches = 0
