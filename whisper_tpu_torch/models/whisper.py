"""Whisper model forward passes in PyTorch (port of whisper_tpu.models.whisper).

Plain functions over a params dict in whisper_tpu's nested layout (per-layer
weights stacked on a leading L axis, torch (out, in) linear weights; see
weights/convert.py).  Matmuls run in the compute dtype and return float32;
layernorm and softmax run in float32.  Where JAX asks for an f32 matmul
result from bf16 operands (preferred_element_type), torch's bf16 GEMM rounds
its output to bf16 before the cast: the bf16 parity bounds cover that.

Only the serving slice is ported: the dense einsum path of the encoder with
its self-attention through K1 (ops/encoder_attention.py), the int8
cross-KV, the prompt pass with the tagged-q8 dequant, and the decode step
whose "q8e" cross-attention runs through K2 (ops/cross_attention.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.cross_attention import cross_attention_decode_q8dt, quantize_kv_bhdt
from ..ops.encoder_attention import self_attention

# canonical dims per released model; order matches WhisperConfig fields
MODEL_DIMS = {
    "tiny": (51865, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "tiny.en": (51864, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "base": (51865, 1500, 512, 8, 6, 448, 512, 8, 6, 80),
    "base.en": (51864, 1500, 512, 8, 6, 448, 512, 8, 6, 80),
    "small": (51865, 1500, 768, 12, 12, 448, 768, 12, 12, 80),
    "small.en": (51864, 1500, 768, 12, 12, 448, 768, 12, 12, 80),
    "medium": (51865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80),
    "medium.en": (51864, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80),
    "large-v1": (51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80),
    "large-v2": (51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80),
    "large-v3": (51866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 128),
    "large-v3-turbo": (51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128),
}


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_mels: int
    model_type: str = "unknown"

    @property
    def head_dim_audio(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def head_dim_text(self) -> int:
        return self.n_text_state // self.n_text_head


def _layer(blocks: dict, l: int) -> dict:
    return {key: w[l] for key, w in blocks.items()}


def _layernorm(x, w, b, eps: float = 1e-5):
    x = x.float()
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def _linear(x, w, b=None, compute_dtype=torch.bfloat16):
    y = F.linear(x.to(compute_dtype), w.to(compute_dtype)).float()
    if b is not None:
        y = y + b
    return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def _merge_heads(x):
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def _attention(q, k, v, mask=None, compute_dtype=torch.bfloat16):
    """q,k,v: (B, T, H, Dh). mask: additive, broadcastable to (B, H, Tq, Tk)."""
    dh = q.shape[-1]
    qh = q.to(compute_dtype).transpose(1, 2)               # (B, H, Tq, Dh)
    kh = k.to(compute_dtype).permute(0, 2, 3, 1)           # (B, H, Dh, Tk)
    vh = v.to(compute_dtype).transpose(1, 2)
    qk = torch.matmul(qh, kh).float() * (dh ** -0.5)
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1)
    out = torch.matmul(w.to(compute_dtype), vh).float()    # (B, H, Tq, Dh)
    return _merge_heads(out.transpose(1, 2))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def conv_stem(enc_params, mel, compute_dtype=torch.bfloat16):
    """Mel (B, 2*n_ctx, n_mels) -> (B, n_ctx, n_state).

    conv1d(k=3,s=1,p=1)+GELU, conv1d(k=3,s=2,p=1)+GELU on the original
    (out, in, 3) weights (reference: src/whisper.cpp:2033-2046).
    """
    cd = compute_dtype
    x = mel.to(cd).transpose(1, 2)                          # (B, C_in, T)
    x = F.conv1d(x, enc_params["conv1_w"].to(cd), padding=1).float()
    x = _gelu(x + enc_params["conv1_b"][:, None])
    x = F.conv1d(x.to(cd), enc_params["conv2_w"].to(cd), stride=2,
                 padding=1).float()
    x = _gelu(x + enc_params["conv2_b"][:, None])
    return x.transpose(1, 2)                                # (B, T, D)


def _encoder_block(x, blk, n_head, compute_dtype):
    ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"])
    q = _linear(ln, blk["q_w"], blk["q_b"], compute_dtype)
    k = _linear(ln, blk["k_w"], None, compute_dtype)       # K has no bias
    v = _linear(ln, blk["v_w"], blk["v_b"], compute_dtype)
    attn = self_attention(_split_heads(q, n_head), _split_heads(k, n_head),
                          _split_heads(v, n_head), compute_dtype)
    x = x + _linear(attn, blk["o_w"], blk["o_b"], compute_dtype)

    ln = _layernorm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
    h = _gelu(_linear(ln, blk["mlp0_w"], blk["mlp0_b"], compute_dtype))
    return x + _linear(h, blk["mlp2_w"], blk["mlp2_b"], compute_dtype)


def encode(params, mel, n_head: int, compute_dtype=torch.bfloat16):
    """Full encoder: mel (B, 2*n_ctx, n_mels) -> (B, n_ctx, n_state) f32."""
    enc = params["encoder"]
    x = conv_stem(enc, mel, compute_dtype)
    x = x + enc["pos"][:x.shape[1]]
    blocks = enc["blocks"]
    for l in range(blocks["q_w"].shape[0]):
        x = _encoder_block(x, _layer(blocks, l), n_head, compute_dtype)
    return _layernorm(x, enc["ln_post_w"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# cross-attention KV precompute (reference: src/whisper.cpp:2285-2359)
# ---------------------------------------------------------------------------

def cross_kv_q8(params, enc_out, n_head: int, compute_dtype=torch.bfloat16):
    """enc_out (B, Ta, D) -> ((L, B, H, Dh, Ta) int8 codes,
    (L, B, H, Ta) f32 scales) for K and for V.

    Each layer is projected and quantized before the next, so the bf16
    (L, B, H, Dh, Ta) stack never exists in device memory.
    """
    blocks = params["decoder"]["blocks"]
    L = blocks["xk_w"].shape[0]
    B, Ta, _ = enc_out.shape
    kq = ks = vq = vs = None
    for l in range(L):
        k = _linear(enc_out, blocks["xk_w"][l], None, compute_dtype)
        v = _linear(enc_out, blocks["xv_w"][l], blocks["xv_b"][l],
                    compute_dtype)
        # (B, Ta, H, Dh) -> (B, H, Dh, Ta)
        k = _split_heads(k, n_head).permute(0, 2, 3, 1).to(compute_dtype)
        v = _split_heads(v, n_head).permute(0, 2, 3, 1).to(compute_dtype)
        kq_l, ks_l = quantize_kv_bhdt(k)
        vq_l, vs_l = quantize_kv_bhdt(v)
        if kq is None:
            dev = enc_out.device
            kq = torch.empty((L,) + kq_l.shape, dtype=torch.int8, device=dev)
            vq = torch.empty_like(kq)
            ks = torch.empty((L,) + ks_l.shape, dtype=torch.float32,
                             device=dev)
            vs = torch.empty_like(ks)
        kq[l], ks[l], vq[l], vs[l] = kq_l, ks_l, vq_l, vs_l
    return (kq, ks), (vq, vs)


def _cross_attention(xq, kc, vc, compute_dtype, mask=None):
    """Attention with keys/values in (B, H, Dh, T) layout;
    xq (B, Tq, H, Dh).  Returns merged (B, Tq, D)."""
    dh = xq.shape[-1]
    qh = xq.to(compute_dtype).transpose(1, 2)               # (B, H, Tq, Dh)
    qk = torch.matmul(qh, kc.to(compute_dtype)).float() * (dh ** -0.5)
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1)
    out = torch.matmul(w.to(compute_dtype),
                       vc.to(compute_dtype).transpose(-1, -2)).float()
    return _merge_heads(out.transpose(1, 2))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dequant_q8(codes, scales, compute_dtype):
    """(B, H, Dh, Ta) int8 x (B, H, Ta) scales -> compute dtype; the scale
    is cast to the compute dtype before the multiply, as in whisper_tpu."""
    return codes.to(compute_dtype) * scales[:, :, None, :].to(compute_dtype)


def decode_prompt(params, tokens, positions, k_cross, v_cross, n_head: int,
                  self_mask=None, compute_dtype=torch.bfloat16):
    """Parallel decode of a token block (prompt processing).

    tokens: (B, T) int; positions: (T,) or (B, T) int
    k_cross/v_cross: tagged ("q8", codes (L,B,H,Dh,Ta), scales (L,B,H,Ta))
    self_mask: additive mask broadcastable to (B, 1, T, T) (float32), or None
    Returns (logits (B, T, n_vocab), k_self (L, B, T, H, Dh), v_self).
    """
    if not (isinstance(k_cross, tuple) and k_cross[0] == "q8"):
        raise NotImplementedError(
            "decode_prompt: only the tagged int8 cross-KV ('q8', codes, "
            "scales) is ported")
    dec = params["decoder"]
    blocks = dec["blocks"]
    nh = n_head
    cd = compute_dtype
    _, kq, ksc = k_cross
    _, vq, vsc = v_cross

    x = (dec["tok_emb"][tokens] + dec["pos"][positions]).float()
    ks_out, vs_out = [], []
    for l in range(blocks["q_w"].shape[0]):
        blk = _layer(blocks, l)
        kc = _dequant_q8(kq[l], ksc[l], cd)
        vc = _dequant_q8(vq[l], vsc[l], cd)

        ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"])
        q = _split_heads(_linear(ln, blk["q_w"], blk["q_b"], cd), nh)
        k = _split_heads(_linear(ln, blk["k_w"], None, cd), nh)
        v = _split_heads(_linear(ln, blk["v_w"], blk["v_b"], cd), nh)
        attn = _attention(q, k, v, self_mask, cd)
        x = x + _linear(attn, blk["o_w"], blk["o_b"], cd)

        ln = _layernorm(x, blk["xattn_ln_w"], blk["xattn_ln_b"])
        xq = _split_heads(_linear(ln, blk["xq_w"], blk["xq_b"], cd), nh)
        attn = _cross_attention(xq, kc, vc, cd)
        x = x + _linear(attn, blk["xo_w"], blk["xo_b"], cd)

        ln = _layernorm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
        h = _gelu(_linear(ln, blk["mlp0_w"], blk["mlp0_b"], cd))
        x = x + _linear(h, blk["mlp2_w"], blk["mlp2_b"], cd)
        ks_out.append(k)
        vs_out.append(v)

    x = _layernorm(x, dec["ln_w"], dec["ln_b"])
    logits = torch.matmul(x.to(cd), dec["tok_emb"].to(cd).T).float()
    return logits, torch.stack(ks_out), torch.stack(vs_out)


def _cross_attn_step(xq, kc, vc, compute_dtype):
    """Cross attention for one decode step over ("q8e", int8 (B,H,Dh,Ta),
    scales (B,H,Ta)): K2 on CUDA, its plain version on the CPU.
    xq (B, 1, H, Dh) -> (B, 1, D)."""
    if not (isinstance(kc, tuple) and kc[0] == "q8e"):
        raise NotImplementedError(
            "decode_step: only the 'q8e' int8 cross-KV path is ported")
    _, kq, ks = kc
    _, vq, vs = vc
    q = xq.transpose(1, 2).to(compute_dtype).contiguous()   # (B, H, 1, Dh)
    out = cross_attention_decode_q8dt(q, kq, ks, vq, vs)
    return _merge_heads(out.transpose(1, 2))


def decode_step(params, tokens, pos_ids, cache_index, kv_self, k_cross,
                v_cross, kv_len, n_head: int, pad_len=None,
                compute_dtype=torch.bfloat16):
    """One autoregressive step over a preallocated KV cache.

    tokens: (B,) int — one new token per sequence
    pos_ids: (B,) int — positional-embedding index per sequence
    cache_index: int — write index into the cache (same for all B)
    kv_self: dict {"k": (L, B, H, Dh, C), "v": ...}; the new column is
        written IN PLACE (JAX returns an updated copy)
    kv_len: int — number of valid cache entries AFTER this write
    pad_len: (B,) int or None — cache slots [0, pad_len) are left-padding
    k_cross/v_cross: ("q8e", codes (L,B,H,Dh,Ta), scales (L,B,H,Ta)), one
        cross-KV row per sequence (whisper_tpu's group=1, as K2 takes)
    Returns (logits (B, n_vocab), kv_self).
    """
    dec = params["decoder"]
    blocks = dec["blocks"]
    nh = n_head
    cd = compute_dtype
    kk, vv = kv_self["k"], kv_self["v"]
    C = kk.shape[-1]
    dev = kk.device

    x = (dec["tok_emb"][tokens] + dec["pos"][pos_ids]).float()[:, None, :]

    # attention mask over cache positions: valid iff pad_len <= idx < kv_len
    idx = torch.arange(C, device=dev)
    valid = (idx < kv_len)[None, :]
    if pad_len is not None:
        valid = valid & (idx[None, :] >= pad_len[:, None])
    attn_mask = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]

    tag = k_cross[0]
    for l in range(blocks["q_w"].shape[0]):
        blk = _layer(blocks, l)
        ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"])
        q = _split_heads(_linear(ln, blk["q_w"], blk["q_b"], cd), nh)
        k_new = _split_heads(_linear(ln, blk["k_w"], None, cd), nh)
        v_new = _split_heads(_linear(ln, blk["v_w"], blk["v_b"], cd), nh)
        kk[l, :, :, :, cache_index] = k_new[:, 0].to(kk.dtype)
        vv[l, :, :, :, cache_index] = v_new[:, 0].to(vv.dtype)

        attn = _cross_attention(q, kk[l], vv[l], cd, mask=attn_mask)
        x = x + _linear(attn, blk["o_w"], blk["o_b"], cd)

        ln = _layernorm(x, blk["xattn_ln_w"], blk["xattn_ln_b"])
        xq = _split_heads(_linear(ln, blk["xq_w"], blk["xq_b"], cd), nh)
        kc_l = (tag,) + tuple(a[l] for a in k_cross[1:])
        vc_l = (tag,) + tuple(a[l] for a in v_cross[1:])
        attn = _cross_attn_step(xq, kc_l, vc_l, cd)
        x = x + _linear(attn, blk["xo_w"], blk["xo_b"], cd)

        ln = _layernorm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
        h = _gelu(_linear(ln, blk["mlp0_w"], blk["mlp0_b"], cd))
        x = x + _linear(h, blk["mlp2_w"], blk["mlp2_b"], cd)

    x = _layernorm(x, dec["ln_w"], dec["ln_b"])
    logits = torch.matmul(x[:, 0].to(cd), dec["tok_emb"].to(cd).T).float()
    return logits, {"k": kk, "v": vv}


def make_causal_mask(t: int, offset: int = 0, device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, T, T+offset) float32."""
    q = torch.arange(t, device=device)[:, None] + offset
    k = torch.arange(t + offset, device=device)[None, :]
    return torch.where(k <= q, 0.0, float("-inf"))[None, None]
