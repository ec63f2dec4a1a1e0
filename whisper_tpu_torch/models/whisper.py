"""Whisper model forward passes in PyTorch (port of whisper_tpu.models.whisper).

Plain functions over a params dict in whisper_tpu's nested layout (per-layer
weights stacked on a leading L axis, torch (out, in) linear weights; see
weights/convert.py).  Matmuls run in the compute dtype and return float32;
layernorm and softmax run in float32.  Where JAX asks for an f32 matmul
result from bf16 operands (preferred_element_type), torch's bf16 GEMM rounds
its output to bf16 before the cast: the bf16 parity bounds cover that.

Kernels: the encoder's self-attention runs through K1 (`attn_impl`
"pallas", "pallas_dt", "pallas_pf", "flash") or K6 ("pallas_btd")
(ops/encoder_attention.py); block-quantized decoder weights through K3
(ops/quantized.py); the decode step's cross-attention through K2 on "q8e"
and "q8dt", K4 on ("bhtd", K/V) and K5 on {"q", "s"}
(ops/cross_attention.py).  The "q8i" and "q4e" steps and the dense einsum
are plain torch, as whisper_tpu leaves them to XLA.  `*_interpret`
attention impls select the kernels' plain versions on any device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.cross_attention import (cross_attention_decode,
                                   cross_attention_decode_q8,
                                   cross_attention_decode_q8dt,
                                   quantize_kv_bhdt, quantize_kv_bhdt_q4,
                                   unpack_q4_bhdt)
from ..ops.encoder_attention import (BLOCK_Q, encoder_attention,
                                     encoder_attention_btd,
                                     encoder_attention_btd_ref,
                                     encoder_attention_ref, self_attention,
                                     self_attention_ref)
from ..ops.quantized import quantized_matmul

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

    @classmethod
    def from_hparams(cls, hp) -> "WhisperConfig":
        """From a ggml file's Hparams (weights/ggml_reader.py)."""
        return cls(*(getattr(hp, f.name)
                     for f in dataclasses.fields(cls)[:-1]),
                   model_type=hp.model_type)

    @property
    def head_dim_audio(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def head_dim_text(self) -> int:
        return self.n_text_state // self.n_text_head


def _layers(blocks: dict) -> list[dict]:
    """Each layer's views of a stacked block dict (quantized weights are
    dicts), every stacked tensor unbound once."""
    views = {key: _layers(w) if isinstance(w, dict) else w.unbind(0)
             for key, w in blocks.items()}
    n_layer = len(next(iter(views.values())))
    return [{key: v[l] for key, v in views.items()} for l in range(n_layer)]


def _layernorm(x, w, b, eps: float = 1e-5):
    x = x.float()
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def _linear(x, w, b=None, compute_dtype=torch.bfloat16,
            out_dtype=torch.float32):
    """x @ w.T (+ b) -> out_dtype: the product in the compute dtype, plus
    the bias in float32, rounded once to out_dtype.  out_dtype = the
    compute dtype gives what a following `.float().to(compute_dtype)`
    would, in one kernel (the bias add casts on its way out)."""
    if isinstance(w, dict):
        # block-quantized weight {"q": (K, N) int8, "s": (K/32, N)[, "m"]}
        # -> K3, which rounds x to bf16 itself whatever the compute dtype
        # (so x goes in uncast: a cast to bf16 or f32 first changes no bit)
        # and returns f32
        shape = x.shape
        y = quantized_matmul(x.reshape(-1, shape[-1]), w["q"], w["s"],
                             w.get("m"))
        y = y.reshape(shape[:-1] + (w["q"].shape[-1],))
    else:
        y = F.linear(x.to(compute_dtype), w.to(compute_dtype))
    if b is None:
        return y.to(out_dtype)
    # float32 sum of the (exact) widened product and bias, then one rounding
    return torch.add(y, b.float(), out=torch.empty(
        y.shape, dtype=out_dtype, device=y.device))


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


def _flash_self_attention(q, k, v, compute_dtype):
    """attn_impl "flash": whisper_tpu runs JAX's stock Pallas flash kernel
    with T padded to 128 and the pad keys masked by segment ids.  Its
    counterpart is an entry onto K1, which computes the same function on
    (B, T, H, Dh) and masks its ragged last tile itself."""
    return self_attention(q, k, v, compute_dtype)


def _encoder_block(x, blk, n_head, compute_dtype, attn_impl="einsum"):
    cd = compute_dtype
    # rounded to the compute dtype once for the three projections, whose
    # results come out in it: every attention impl casts q/k/v to it first
    ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"]).to(cd)
    q = _split_heads(_linear(ln, blk["q_w"], blk["q_b"], cd, cd), n_head)
    k = _split_heads(_linear(ln, blk["k_w"], None, cd, cd), n_head)
    v = _split_heads(_linear(ln, blk["v_w"], blk["v_b"], cd, cd), n_head)
    if attn_impl == "pallas":
        attn = self_attention(q, k, v, compute_dtype)
    elif attn_impl == "pallas_interpret":
        attn = self_attention_ref(q, k, v, compute_dtype)
    elif attn_impl == "flash":
        attn = _flash_self_attention(q, k, v, compute_dtype)
    elif attn_impl == "einsum":
        attn = _attention(q, k, v, compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unknown encoder attn_impl {attn_impl!r}")
    x = x + _linear(attn, blk["o_w"], blk["o_b"], compute_dtype)

    ln = _layernorm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
    h = _gelu(_linear(ln, blk["mlp0_w"], blk["mlp0_b"], compute_dtype))
    return x + _linear(h, blk["mlp2_w"], blk["mlp2_b"], compute_dtype)


def _layernorm_dt(x, w, b, eps: float = 1e-5):
    """Layernorm of channels-first (B, D, T) activations over D (axis 1)."""
    return _layernorm(x.transpose(1, 2), w, b, eps).transpose(1, 2)


def _linear_dt(x, w, b=None, compute_dtype=torch.bfloat16):
    """Channels-first linear: x (B, I, T), w torch-(O, I) -> (B, O, T) f32,
    the (out, in) weight used as it lies."""
    y = torch.matmul(w.to(compute_dtype), x.to(compute_dtype)).float()
    if b is not None:
        y = y + b[:, None]
    return y


def _encoder_block_dt(x, blk, n_head, compute_dtype, t_valid: int,
                      interpret: bool = False):
    """Encoder layer on (B, D, Tp) channels-first activations: the QKV
    projections emit (B, D, Tp), the head split to (B, H, Dh, Tp) is a
    reshape, and K1's Dh-major entry reads that layout as it lies.  Pad
    columns past t_valid carry garbage, are masked as keys and are sliced
    off by encode()."""
    B, D, Tp = x.shape
    attn_fn = encoder_attention_ref if interpret else encoder_attention
    ln = _layernorm_dt(x, blk["attn_ln_w"], blk["attn_ln_b"])

    def heads(w, b):
        y = _linear_dt(ln, w, b, compute_dtype)
        return y.reshape(B, n_head, D // n_head, Tp).to(compute_dtype)

    attn = attn_fn(heads(blk["q_w"], blk["q_b"]), heads(blk["k_w"], None),
                   heads(blk["v_w"], blk["v_b"]), t_valid)
    x = x + _linear_dt(attn.reshape(B, D, Tp), blk["o_w"], blk["o_b"],
                       compute_dtype)

    ln = _layernorm_dt(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
    h = _gelu(_linear_dt(ln, blk["mlp0_w"], blk["mlp0_b"], compute_dtype))
    return x + _linear_dt(h, blk["mlp2_w"], blk["mlp2_b"], compute_dtype)


def _encoder_block_pf(x, blk, n_head, compute_dtype, t_valid: int,
                      interpret: bool = False):
    """Projection-fused encoder layer: the residual stays (B, Tp, D), the
    QKV projections emit K1's (B, H, Dh, Tp) directly, and the output
    projection contracts the (H, Dh) pair back to (B, Tp, D)."""
    B, Tp, D = x.shape
    attn_fn = encoder_attention_ref if interpret else encoder_attention
    ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"])
    ln_t = ln.transpose(1, 2)                                # (B, D, Tp)

    def proj_ht(w, b):
        y = _linear_dt(ln_t, w, b, compute_dtype)            # (B, D, Tp)
        return y.reshape(B, n_head, D // n_head, Tp).to(compute_dtype)

    attn = attn_fn(proj_ht(blk["q_w"], blk["q_b"]), proj_ht(blk["k_w"], None),
                   proj_ht(blk["v_w"], blk["v_b"]), t_valid)
    x = x + _linear(attn.reshape(B, D, Tp).transpose(1, 2), blk["o_w"],
                    blk["o_b"], compute_dtype)

    ln = _layernorm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
    h = _gelu(_linear(ln, blk["mlp0_w"], blk["mlp0_b"], compute_dtype))
    return x + _linear(h, blk["mlp2_w"], blk["mlp2_b"], compute_dtype)


def _encoder_block_btd(x, blk, n_head, compute_dtype, t_valid: int,
                       interpret: bool = False):
    """Transpose-free encoder layer: K6 reads the projections' natural
    (B, Tp, D) output, each head the Dh-wide column slice of a row."""
    attn_fn = encoder_attention_btd_ref if interpret else \
        encoder_attention_btd
    cd = compute_dtype
    ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"]).to(cd)
    q = _linear(ln, blk["q_w"], blk["q_b"], cd, cd)
    k = _linear(ln, blk["k_w"], None, cd, cd)                # K has no bias
    v = _linear(ln, blk["v_w"], blk["v_b"], cd, cd)
    attn = attn_fn(q, k, v, n_head, t_valid)
    x = x + _linear(attn, blk["o_w"], blk["o_b"], cd)

    ln = _layernorm(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
    h = _gelu(_linear(ln, blk["mlp0_w"], blk["mlp0_b"], cd))
    return x + _linear(h, blk["mlp2_w"], blk["mlp2_b"], cd)


# padded whole-stack variants: impl -> (block fn, channels first)
_PADDED_BLOCKS = {
    "pallas_dt": (_encoder_block_dt, True),
    "pallas_pf": (_encoder_block_pf, False),
    "pallas_btd": (_encoder_block_btd, False),
}
ATTN_IMPLS = ("einsum", "pallas", "flash", *_PADDED_BLOCKS,
              "pallas_interpret",
              *(f"{impl}_interpret" for impl in _PADDED_BLOCKS))


def default_encoder_attn_impl(x: torch.Tensor) -> str:
    """"pallas" (K1) for activations on a CUDA device, "einsum" elsewhere;
    decided by where the tensors lie, as whisper_tpu decides by its
    backend."""
    return "pallas" if x.device.type == "cuda" else "einsum"


def encode(params, mel, n_head: int, compute_dtype=torch.bfloat16,
           attn_impl: str | None = None, out_layout: str = "btd"):
    """Full encoder: mel (B, 2*n_ctx, n_mels) -> (B, n_ctx, n_state) f32,
    or (B, n_state, n_ctx) with out_layout="bdt" (pallas_dt only), which
    cross_kv*(enc_layout="bdt") reads with a reshape.

    attn_impl: see ATTN_IMPLS; None takes default_encoder_attn_impl.  The
    padded variants pad T to a BLOCK_Q multiple once, before the first
    layer; pad rows are masked as attention keys (t_valid) and row-local
    ops never mix rows, so slicing them off at the end is exact.
    """
    if attn_impl not in (None, *ATTN_IMPLS):
        raise ValueError(f"unknown encoder attn_impl {attn_impl!r} (have "
                         f"{ATTN_IMPLS})")
    enc = params["encoder"]
    x = conv_stem(enc, mel, compute_dtype)
    n_ctx = x.shape[1]
    # row-major from here: the stem's (B, T, D) is a transposed view, and
    # every elementwise op would carry its strides on, each layernorm then
    # copying its input back to rows first
    x = (x + enc["pos"][:n_ctx]).contiguous()
    if attn_impl is None:
        attn_impl = default_encoder_attn_impl(x)
    base = attn_impl.removesuffix("_interpret")
    if out_layout not in ("btd", "bdt"):
        raise ValueError(f"unknown out_layout {out_layout!r}")
    if out_layout == "bdt" and base != "pallas_dt":
        raise ValueError("out_layout='bdt' requires attn_impl='pallas_dt'")
    layers = _layers(enc["blocks"])

    if base in _PADDED_BLOCKS:
        block_fn, channels_first = _PADDED_BLOCKS[base]
        interpret = attn_impl.endswith("_interpret")
        Tp = -(-n_ctx // BLOCK_Q) * BLOCK_Q
        x = F.pad(x, (0, 0, 0, Tp - n_ctx))                 # (B, Tp, D)
        if channels_first:
            x = x.transpose(1, 2)                           # (B, D, Tp)
        for blk in layers:
            x = block_fn(x, blk, n_head, compute_dtype, t_valid=n_ctx,
                         interpret=interpret)
        if channels_first:
            x = x[..., :n_ctx]
            if out_layout == "bdt":
                return _layernorm_dt(x, enc["ln_post_w"], enc["ln_post_b"])
            x = x.transpose(1, 2)
        return _layernorm(x[:, :n_ctx], enc["ln_post_w"], enc["ln_post_b"])

    for blk in layers:
        x = _encoder_block(x, blk, n_head, compute_dtype, attn_impl)
    return _layernorm(x, enc["ln_post_w"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# cross-attention KV precompute (reference: src/whisper.cpp:2285-2359)
# ---------------------------------------------------------------------------

def _make_cross_proj(enc_out, n_head: int, compute_dtype, enc_layout: str):
    """Per-layer cross K/V projection from the encoder output in
    `enc_layout`: "btd" (B, Ta, D), projected then split to (B, H, Dh, Ta);
    or "bdt" (B, D, Ta) from encode(out_layout="bdt"), projected to
    (B, D, Ta), where the head split is a reshape.
    Returns blk -> (k, v), each (B, H, Dh, Ta) in the compute dtype."""
    cd = compute_dtype
    if enc_layout == "bdt":
        B, D, Ta = enc_out.shape

        def proj(blk):
            k = _linear_dt(enc_out, blk["xk_w"], None, cd)
            v = _linear_dt(enc_out, blk["xv_w"], blk["xv_b"], cd)
            return (k.reshape(B, n_head, D // n_head, Ta).to(cd),
                    v.reshape(B, n_head, D // n_head, Ta).to(cd))
        return proj
    if enc_layout != "btd":
        raise ValueError(f"unknown enc_layout {enc_layout!r}")

    def proj(blk):
        k = _linear(enc_out, blk["xk_w"], None, cd)
        v = _linear(enc_out, blk["xv_w"], blk["xv_b"], cd)
        # (B, Ta, H, Dh) -> (B, H, Dh, Ta)
        return (_split_heads(k, n_head).permute(0, 2, 3, 1).to(cd),
                _split_heads(v, n_head).permute(0, 2, 3, 1).to(cd))
    return proj


def _stack_layers(params, proj, per_layer):
    """Run per_layer(*proj(blk)) for each decoder layer, writing each
    layer's outputs into preallocated (L, ...) stacks, so only one layer's
    projection is live at a time."""
    layers = _layers(params["decoder"]["blocks"])
    stacks = None
    for l, blk in enumerate(layers):
        outs = per_layer(*proj(blk))
        if stacks is None:
            stacks = [torch.empty((len(layers),) + tuple(o.shape),
                                  dtype=o.dtype, device=o.device)
                      for o in outs]
        for st, o in zip(stacks, outs):
            st[l] = o
    return stacks


def cross_kv(params, enc_out, n_head: int, compute_dtype=torch.bfloat16,
             enc_layout: str = "btd"):
    """enc_out -> (k_cross, v_cross): (L, B, H, Dh, Ta) each, in the compute
    dtype (the dense cross-KV that cross modes "einsum", "pallas" and
    "pallas_q8" read, and that `full` quantizes per window for the
    quantized modes)."""
    proj = _make_cross_proj(enc_out, n_head, compute_dtype, enc_layout)
    kc, vc = _stack_layers(params, proj, lambda k, v: (k, v))
    return kc, vc


def cross_kv_q8(params, enc_out, n_head: int, compute_dtype=torch.bfloat16,
                enc_layout: str = "btd"):
    """enc_out -> ((L, B, H, Dh, Ta) int8 codes, (L, B, H, Ta) f32 scales)
    for K and for V.  Each layer is projected and quantized before the
    next, so the bf16 (L, B, H, Dh, Ta) stack never exists in device
    memory."""
    proj = _make_cross_proj(enc_out, n_head, compute_dtype, enc_layout)
    kq, ks, vq, vs = _stack_layers(
        params, proj, lambda k, v: (*quantize_kv_bhdt(k),
                                    *quantize_kv_bhdt(v)))
    return (kq, ks), (vq, vs)


def cross_kv_q4(params, enc_out, n_head: int, compute_dtype=torch.bfloat16,
                enc_layout: str = "btd"):
    """enc_out -> ((L, B, H, Dh/2, Ta) uint8 nibble-packed codes,
    (L, B, H, Ta) f32 scales) for K and for V, quantized per layer as in
    cross_kv_q8.  4-bit K/V is not token-exact against bf16 in general."""
    proj = _make_cross_proj(enc_out, n_head, compute_dtype, enc_layout)
    kq, ks, vq, vs = _stack_layers(
        params, proj, lambda k, v: (*quantize_kv_bhdt_q4(k),
                                    *quantize_kv_bhdt_q4(v)))
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

def _dequant(tag, codes, scales, compute_dtype):
    """Tagged quantized cross-KV of one layer -> (B, H, Dh, Ta) in the
    compute dtype: int8 codes ("q8"), or nibble-packed ones ("q4", "q4e")
    unpacked first; the (B, H, Ta) scale is cast to the compute dtype
    before the multiply, as in whisper_tpu."""
    if tag in ("q4", "q4e"):
        codes = unpack_q4_bhdt(codes, compute_dtype)
    return (codes.to(compute_dtype)
            * scales[:, :, None, :].to(compute_dtype))


def decode_prompt(params, tokens, positions, k_cross, v_cross, n_head: int,
                  self_mask=None, compute_dtype=torch.bfloat16):
    """Parallel decode of a token block (prompt processing).

    tokens: (B, T) int; positions: (T,) or (B, T) int
    k_cross/v_cross: dense (L, B, H, Dh, Ta) (cross_kv layout), or tagged
        ("q8", codes (L,B,H,Dh,Ta), scales (L,B,H,Ta)) from cross_kv_q8, or
        ("q4" / "q4e", packed (L,B,H,Dh/2,Ta), scales) from cross_kv_q4,
        dequantized one layer at a time
    self_mask: additive mask broadcastable to (B, 1, T, T) (float32), or None
    Returns (logits (B, T, n_vocab), k_self (L, B, T, H, Dh), v_self).
    """
    tagged = isinstance(k_cross, tuple)
    if tagged and k_cross[0] not in ("q8", "q4", "q4e"):
        raise ValueError(f"decode_prompt: unknown cross-KV tag "
                         f"{k_cross[0]!r}")
    dec = params["decoder"]
    blocks = dec["blocks"]
    nh = n_head
    cd = compute_dtype

    x = (dec["tok_emb"][tokens] + dec["pos"][positions]).float()
    ks_out, vs_out = [], []
    for l, blk in enumerate(_layers(blocks)):
        if tagged:
            kc = _dequant(k_cross[0], k_cross[1][l], k_cross[2][l], cd)
            vc = _dequant(v_cross[0], v_cross[1][l], v_cross[2][l], cd)
        else:
            kc, vc = k_cross[l], v_cross[l]

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


def _q8e_attention(xq, kq, ks, vq, vs, compute_dtype):
    """The "q8e" einsum of whisper_tpu in the compute dtype: int8 K/V with
    the per-position scales folded into the logits and the weights."""
    cd = compute_dtype
    dh = xq.shape[-1]
    qk = torch.matmul(xq.to(cd).transpose(1, 2), kq.to(cd)).float()
    qk = qk * ks[:, :, None, :] * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    wv = w * vs[:, :, None, :]
    out = torch.matmul(wv.to(cd), vq.to(cd).transpose(-1, -2)).float()
    return _merge_heads(out.transpose(1, 2))


def _q8i_attention(xq, kq, ks, vq, vs):
    """The "q8i" step: int8 x int8 dots with q quantized per (b, head) and
    the softmax weights (times the V scale) quantized per (b, head) on the
    fly, as whisper_tpu's einsums with int32 results.

    torch has no general int8/int32 matmul on the card, so the dots run in
    f32 on integer values, where they are exact: q.k sums 64 products of at
    most 127^2, ~1.03e6 < 2^24.  w.v over Ta = 1500 keys can reach
    1500 * 127^2 ~ 2.4e7 > 2^24, so the weights are split into high and
    low nibbles (w = 16 hi + lo, hi <= 7, lo <= 15): each partial sum stays
    under 2^24 for Ta < 8808, and the two are combined in f64 before the
    one rounding to f32 that the int32 -> f32 conversion makes."""
    dh = xq.shape[-1]
    amax = torch.amax(torch.abs(xq), dim=-1, keepdim=True)
    # x * f32(1/127): XLA's form of the reference's division (see
    # ops/cross_attention._quantize)
    qs = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)         # (B, Tq, H, 1)
    qi = torch.clamp(torch.round(xq / qs), -127, 127)
    qk = torch.matmul(qi.transpose(1, 2), kq.float())        # (B, H, Tq, Ta)
    qk = qk * qs.transpose(1, 2) * ks[:, :, None, :] * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    wv = w * vs[:, :, None, :]
    wsc = (torch.clamp_min(torch.amax(wv, dim=-1, keepdim=True), 1e-20)
           * (1.0 / 127.0))
    wi = torch.clamp(torch.round(wv / wsc), 0, 127)
    hi = torch.floor(wi / 16.0)
    vt = vq.float().transpose(-1, -2)                        # (B, H, Ta, Dh)
    out = (torch.matmul(hi, vt).double() * 16.0
           + torch.matmul(wi - 16.0 * hi, vt).double()).float()
    return _merge_heads((out * wsc).transpose(1, 2))


def _q4e_attention(xq, kq, ks, vq, vs, compute_dtype):
    """The "q4e" step on nibble-packed K/V: the low and high nibble halves
    contract separately against the even and odd channels, as in
    whisper_tpu (plain torch; whisper_tpu leaves it to XLA)."""
    cd = compute_dtype
    dh = xq.shape[-1]

    def nibbles(p):
        return (((p & 0xF).to(torch.int8) - 8).to(cd),
                ((p >> 4).to(torch.int8) - 8).to(cd))

    xe = xq[..., 0::2].to(cd).transpose(1, 2)                # (B, H, Tq, Dh/2)
    xo = xq[..., 1::2].to(cd).transpose(1, 2)
    klo, khi = nibbles(kq)
    qk = (torch.matmul(xe, klo).float() + torch.matmul(xo, khi).float())
    qk = qk * ks[:, :, None, :] * (dh ** -0.5)
    w = torch.softmax(qk, dim=-1)
    wv = (w * vs[:, :, None, :]).to(cd)
    vlo, vhi = nibbles(vq)
    oe = torch.matmul(wv, vlo.transpose(-1, -2)).float()    # (B, H, Tq, Dh/2)
    oo = torch.matmul(wv, vhi.transpose(-1, -2)).float()
    out = torch.stack([oe, oo], dim=-1).reshape(oe.shape[:-1] + (dh,))
    return _merge_heads(out.transpose(1, 2))


def _cross_attn_step(xq, kc, vc, compute_dtype):
    """Cross attention for one decode step; kc/vc select the path:

      * array (B, H, Dh, Ta)                               — the einsum
      * ("q8e" | "q8dt", int8 (B, H, Dh, Ta), scales (B, H, Ta)) — K2;
        "q8e" in another compute dtype than bf16 is the einsum in that
        dtype (K2 rounds the weights to bf16, as the q8e einsum does only
        in bf16)
      * ("q8i", int8 (B, H, Dh, Ta), scales (B, H, Ta))    — int8 dots
      * ("q4e", uint8 (B, H, Dh/2, Ta), scales (B, H, Ta)) — nibble dots
      * ("bhtd", k (B, H, Ta, Dh))                         — K4
      * {"q": int8 (B, H, Ta, Dh), "s": (B, H, Ta, 1)}     — K5
    Kernels run on CUDA tensors, their plain versions on the CPU; the
    einsum, "q8i" and "q4e" are plain torch on both, as whisper_tpu leaves
    them to XLA.  xq (B, G, H, Dh) -> (B, G, D): G queries a cross-KV
    row (K4 and K5 take G = 1)."""
    if isinstance(kc, torch.Tensor):
        return _cross_attention(xq, kc, vc, compute_dtype)
    if (isinstance(kc, tuple) and kc[0] == "q8e"
            and compute_dtype != torch.bfloat16):
        return _q8e_attention(xq, kc[1], kc[2], vc[1], vc[2], compute_dtype)
    if isinstance(kc, tuple) and kc[0] == "q8i":
        return _q8i_attention(xq, kc[1], kc[2], vc[1], vc[2])
    if isinstance(kc, tuple) and kc[0] == "q4e":
        return _q4e_attention(xq, kc[1], kc[2], vc[1], vc[2], compute_dtype)
    q = xq.transpose(1, 2).to(compute_dtype).contiguous()   # (B, H, G, Dh)
    if isinstance(kc, dict):
        out = cross_attention_decode_q8(q, kc["q"], kc["s"], vc["q"], vc["s"])
    elif kc[0] in ("q8e", "q8dt"):
        out = cross_attention_decode_q8dt(q, kc[1], kc[2], vc[1], vc[2])
    elif kc[0] == "bhtd":
        out = cross_attention_decode(q, kc[1], vc[1])
    else:
        raise ValueError(f"decode_step: unknown cross-KV tag {kc[0]!r}")
    return _merge_heads(out.transpose(1, 2))


def _cross_layer(kc, l: int):
    """Layer l of a stacked cross-KV in any form _cross_attn_step takes."""
    if isinstance(kc, torch.Tensor):
        return kc[l]
    if isinstance(kc, dict):
        return {key: val[l] for key, val in kc.items()}
    return (kc[0],) + tuple(a[l] for a in kc[1:])


def decode_step(params, tokens, pos_ids, cache_index, kv_self, k_cross,
                v_cross, kv_len, n_head: int, pad_len=None,
                compute_dtype=torch.bfloat16, group: int = 1):
    """One autoregressive step over a preallocated KV cache.

    tokens: (B,) int — one new token per sequence
    pos_ids: (B,) int — positional-embedding index per sequence
    cache_index: int — write index into the cache (same for all B)
    kv_self: dict {"k": (L, B, H, Dh, C), "v": ...}; the new column is
        written IN PLACE (JAX returns an updated copy)
    kv_len: int — number of valid cache entries AFTER this write
    pad_len: (B,) int or None — cache slots [0, pad_len) are left-padding
    k_cross/v_cross: (L, ...) stacked cross-KV in any form that
        _cross_attn_step takes, one cross-KV row per `group` sequences
    group: rows per cross-KV row.  Batched beam search packs S streams x
        K beams into B = S*K rows against S cross-KV rows (group = K): the
        K beams of a stream become K query positions against their shared
        row, so nothing is tiled in device memory.  The einsum, "q8e" (K2
        with G = K queries in bf16) and "q8dt", "q8i" and "q4e" take
        group > 1; K4 and K5 take one query.
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

    for l, blk in enumerate(_layers(blocks)):
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
        # (S*K, 1, H, Dh) -> (S, K, H, Dh): a stream's beams as queries
        attn = _cross_attn_step(
            xq.reshape(xq.shape[0] // group, group, nh, xq.shape[-1]),
            _cross_layer(k_cross, l), _cross_layer(v_cross, l), cd)
        x = x + _linear(attn.reshape(x.shape[0], 1, -1), blk["xo_w"],
                        blk["xo_b"], cd)

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
