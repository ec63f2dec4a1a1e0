"""Whisper model forward passes in PyTorch (port of whisper_tpu.models.whisper).

Plain functions over a params dict in whisper_tpu's nested layout (per-layer
weights stacked on a leading L axis, torch (out, in) linear weights; see
weights/convert.py).  Matmuls run in the compute dtype and return float32;
layernorm and softmax run in float32.  Where JAX asks for an f32 matmul
result from bf16 operands (preferred_element_type), torch's bf16 GEMM rounds
its output to bf16 before the cast: the bf16 parity bounds cover that.

Kernels: the encoder's self-attention runs through K1 (`attn_impl`
"pallas", "pallas_dt", "pallas_pf", "flash") or K6 ("pallas_btd")
(ops/encoder_attention.py).  One rule, `_kernels`, decides for an encode,
a decode step and a `cross_kv_q8` call whether the hand-written kernels
run or their plain versions, which make the same roundings: the kernels on
the card in bf16 with dense matrices and no mesh.  Then the elementwise
passes between the GEMMs of an encoder block and of a decoder layer go
through the row-wise epilogues of ops/encoder_epilogue.py (`_ops`), a
decode step's self-attention through one kernel over its KV cache
(ops/decoder_attention.py), and the int8 cross-KV of `cross_kv_q8` through
one quantizing pass a layer (`cross_kv_quant` of ops/cross_attention.py).
Block-quantized decoder weights go through K3 (ops/quantized.py); the
decode step's cross-attention
through K2 on "q8e" and "q8dt", K4 on ("bhtd", K/V) and K5 on {"q", "s"}
(ops/cross_attention.py).  The "q8i" and "q4e" steps and the dense einsum
are plain torch, as whisper_tpu leaves them to XLA.  `*_interpret`
attention impls select the kernels' plain versions on any device.

Tensor parallelism: params from parallel/mesh.shard_params hold one
"model" rank's shard and carry the mesh.  Each function then takes its
head count from the local q/xq shard, all-reduces the f32 partial products
of the row-parallel o, xo and mlp2 (the bias added once, after the
reduce, then the one rounding), looks up tok_emb rows by a masked local
lookup plus an all-reduce (exact: one rank holds each row, the others add
zeros) and all-gathers the vocab-sharded logits in rank order.  Params
without a mesh, or on a mesh of one "model" rank, run no collective.
"""

from __future__ import annotations

import dataclasses
import functools
import types
import weakref

import torch
import torch.nn.functional as F

from ..ops.cross_attention import (DH, cross_attention_decode,
                                   cross_attention_decode_q8,
                                   cross_attention_decode_q8dt,
                                   cross_kv_quant, quantize_kv_bhdt,
                                   quantize_kv_bhdt_q4, unpack_q4_bhdt)
from ..ops.encoder_attention import (BLOCK_Q, encoder_attention,
                                     encoder_attention_btd,
                                     encoder_attention_btd_ref,
                                     encoder_attention_ref, self_attention,
                                     self_attention_ref)
from ..ops.decoder_attention import (MAX_DH, self_attn_step,
                                     self_attn_step_ref, step_mask)
from ..ops.encoder_epilogue import (MAX_LN_WIDTH, bias_cast, bias_cast_ref,
                                    bias_gelu_cast, bias_gelu_cast_ref,
                                    bias_residual, bias_residual_ln,
                                    bias_residual_ln_ref, bias_residual_ref,
                                    ln_cast, ln_cast_ref)
from ..ops.quantized import quantized_matmul
from ..utils.trace import TRACE

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


def _model_axis(params):
    """The mesh of params split over more than one "model" rank
    (parallel/mesh.shard_params), else None: no collective runs."""
    mesh = getattr(params, "mesh", None)
    return mesh if mesh is not None and mesh.n_model > 1 else None


def _local_heads(w, n_head: int) -> int:
    """Heads this rank holds: the out-features of its q/xq shard (L, out,
    in) over the head width; n_head for a whole or packed weight."""
    if isinstance(w, dict):
        return n_head
    return n_head * w.shape[-2] // w.shape[-1]


def _partial_f32(x, w, compute_dtype):
    """A row-parallel shard's x @ w.T as float32 partial sums of the
    compute-dtype operands' exact products, for the all-reduce (its
    rounding comes after the reduce)."""
    return F.linear(x.to(compute_dtype).float(), w.to(compute_dtype).float())


def _linear(x, w, compute_dtype=torch.bfloat16, tp=None):
    """x @ w.T, the product alone (its bias add is an epilogue op's): in
    the compute dtype for a dense w; in f32 from K3 for a block-quantized
    one; for a row-parallel w under tp (this rank's in-features) the f32
    partial products summed over "model"."""
    if tp is not None:
        return tp.all_reduce(_partial_f32(x, w, compute_dtype))
    if isinstance(w, dict):
        # block-quantized weight {"q": (K, N) int8, "s": (K/32, N)[, "m"]}
        # -> K3, which rounds x to bf16 itself whatever the compute dtype
        # (so x goes in uncast: a cast to bf16 or f32 first changes no bit)
        shape = x.shape
        y = quantized_matmul(x.reshape(-1, shape[-1]), w["q"], w["s"],
                             w.get("m"))
        return y.reshape(shape[:-1] + (w["q"].shape[-1],))
    return F.linear(x.to(compute_dtype), w.to(compute_dtype))


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


# an encoder block's matrices: dense tensors, or a block-quantized dict
# that `_linear` sends to K3
_ENCODER_MATRICES = ("q_w", "k_w", "v_w", "o_w", "mlp0_w", "mlp2_w")


def _on_card(x) -> bool:
    return x.device.type == "cuda"


def _kernels(x, blocks, matrices, compute_dtype, tp, counter: str,
             takes: bool = True) -> bool:
    """The one kernel-or-plain rule of an encode, a decode step and a
    cross_kv_q8 call: the hand-written kernels for activations x on a CUDA
    card, bf16 compute, the stacked `blocks`' `matrices` dense and no
    tensor-parallel mesh tp (whose row-parallel products are all-reduced
    f32 partial sums), where `takes`: the caller's widths, layout and
    cache as its kernels take them.  Otherwise the plain versions, which
    make the same roundings.  A yes is counted under `counter`, as the
    blocks' layers."""
    use = (takes and _on_card(x) and compute_dtype == torch.bfloat16
           and tp is None
           and all(isinstance(blocks[k], torch.Tensor) for k in matrices))
    if use:
        TRACE.count(counter, blocks[matrices[0]].shape[0])
    return use


def _ops(kernels: bool, compute_dtype):
    """The five epilogue ops of ops/encoder_epilogue.py: the kernels, or
    their plain versions rounding to the compute dtype."""
    if kernels:
        return types.SimpleNamespace(
            ln_cast=ln_cast, bias_cast=bias_cast,
            bias_residual_ln=bias_residual_ln, bias_gelu_cast=bias_gelu_cast,
            bias_residual=bias_residual)
    cd = compute_dtype
    return types.SimpleNamespace(
        ln_cast=functools.partial(ln_cast_ref, dtype=cd),
        bias_cast=functools.partial(bias_cast_ref, dtype=cd),
        bias_residual_ln=functools.partial(bias_residual_ln_ref, dtype=cd),
        bias_gelu_cast=functools.partial(bias_gelu_cast_ref, dtype=cd),
        bias_residual=bias_residual_ref)


def _qkv(x, blk, cd, ops):
    """The block's entry: the attention layernorm, rounded to the compute
    dtype once for the three projections, whose results come out in it
    (every attention impl casts q/k/v to it first) -> (B, T, D) each."""
    ln = ops.ln_cast(x, blk["attn_ln_w"].float(), blk["attn_ln_b"].float())
    q, k, v = (_linear(ln, blk[w], cd) for w in ("q_w", "k_w", "v_w"))
    q, v = ops.bias_cast((q, blk["q_b"].float()), (v, blk["v_b"].float()))
    return q, k.to(cd), v                                  # K has no bias


def _out_mlp(x, attn, blk, cd, tp, ops):
    """x + the attention's output projection, then + the MLP's: the
    residual stream in f32, each product's operands in the compute
    dtype."""
    x, ln = ops.bias_residual_ln(
        x, _linear(attn, blk["o_w"], cd, tp), blk["o_b"].float(),
        blk["mlp_ln_w"].float(), blk["mlp_ln_b"].float())
    h = ops.bias_gelu_cast(_linear(ln, blk["mlp0_w"], cd),
                           blk["mlp0_b"].float())
    return ops.bias_residual(x, _linear(h, blk["mlp2_w"], cd, tp),
                             blk["mlp2_b"].float())


def _encoder_block(x, blk, n_head, compute_dtype, ops, attn_impl="einsum",
                   tp=None):
    q, k, v = (_split_heads(t, n_head)
               for t in _qkv(x, blk, compute_dtype, ops))
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
    return _out_mlp(x, attn, blk, compute_dtype, tp, ops)


def _layernorm_dt(x, w, b, eps: float = 1e-5):
    """Layernorm of channels-first (B, D, T) activations over D (axis 1)."""
    return _layernorm(x.transpose(1, 2), w, b, eps).transpose(1, 2)


def _linear_dt(x, w, b=None, compute_dtype=torch.bfloat16, tp=None):
    """Channels-first linear: x (B, I, T), w torch-(O, I) -> (B, O, T) f32,
    the (out, in) weight used as it lies.  tp: as _linear's."""
    if tp is not None:
        cd = compute_dtype
        y = tp.all_reduce(torch.matmul(w.to(cd).float(), x.to(cd).float()))
    else:
        y = torch.matmul(w.to(compute_dtype), x.to(compute_dtype)).float()
    if b is not None:
        y = y + b[:, None]
    return y


def _encoder_block_dt(x, blk, n_head, compute_dtype, ops, t_valid: int,
                      interpret: bool = False, tp=None):
    """Encoder layer on (B, D, Tp) channels-first activations: the QKV
    projections emit (B, D, Tp), the head split to (B, H, Dh, Tp) is a
    reshape, and K1's Dh-major entry reads that layout as it lies.  Pad
    columns past t_valid carry garbage, are masked as keys and are sliced
    off by encode().  Its own plain sequence, channels first: ops is
    unused."""
    B, _, Tp = x.shape
    attn_fn = encoder_attention_ref if interpret else encoder_attention
    ln = _layernorm_dt(x, blk["attn_ln_w"], blk["attn_ln_b"])

    def heads(w, b):
        y = _linear_dt(ln, w, b, compute_dtype)
        return y.reshape(B, n_head, -1, Tp).to(compute_dtype)

    attn = attn_fn(heads(blk["q_w"], blk["q_b"]), heads(blk["k_w"], None),
                   heads(blk["v_w"], blk["v_b"]), t_valid)
    x = x + _linear_dt(attn.reshape(B, -1, Tp), blk["o_w"], blk["o_b"],
                       compute_dtype, tp=tp)

    ln = _layernorm_dt(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
    h = _gelu(_linear_dt(ln, blk["mlp0_w"], blk["mlp0_b"], compute_dtype))
    return x + _linear_dt(h, blk["mlp2_w"], blk["mlp2_b"], compute_dtype,
                          tp=tp)


def _encoder_block_pf(x, blk, n_head, compute_dtype, ops, t_valid: int,
                      interpret: bool = False, tp=None):
    """Projection-fused encoder layer: the residual stays (B, Tp, D), the
    QKV projections emit K1's (B, H, Dh, Tp) directly, and the output
    projection contracts the (H, Dh) pair back to (B, Tp, D)."""
    B, Tp, _ = x.shape
    attn_fn = encoder_attention_ref if interpret else encoder_attention
    ln = _layernorm(x, blk["attn_ln_w"], blk["attn_ln_b"])
    ln_t = ln.transpose(1, 2)                                # (B, D, Tp)

    def proj_ht(w, b):
        y = _linear_dt(ln_t, w, b, compute_dtype)            # (B, D, Tp)
        return y.reshape(B, n_head, -1, Tp).to(compute_dtype)

    attn = attn_fn(proj_ht(blk["q_w"], blk["q_b"]), proj_ht(blk["k_w"], None),
                   proj_ht(blk["v_w"], blk["v_b"]), t_valid)
    return _out_mlp(x, attn.reshape(B, -1, Tp).transpose(1, 2), blk,
                    compute_dtype, tp, ops)


def _encoder_block_btd(x, blk, n_head, compute_dtype, ops, t_valid: int,
                       interpret: bool = False, tp=None):
    """Transpose-free encoder layer: K6 reads the projections' natural
    (B, Tp, D) output, each head the Dh-wide column slice of a row."""
    attn_fn = encoder_attention_btd_ref if interpret else \
        encoder_attention_btd
    q, k, v = _qkv(x, blk, compute_dtype, ops)
    attn = attn_fn(q, k, v, n_head, t_valid)
    return _out_mlp(x, attn, blk, compute_dtype, tp, ops)


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
    tp = _model_axis(params)
    n_head = _local_heads(enc["blocks"]["q_w"], n_head)
    ops = _ops(_kernels(x, enc["blocks"], _ENCODER_MATRICES, compute_dtype,
                        tp, "encoder_fused", takes=base != "pallas_dt"),
               compute_dtype)

    if base in _PADDED_BLOCKS:
        block_fn, channels_first = _PADDED_BLOCKS[base]
        interpret = attn_impl.endswith("_interpret")
        Tp = -(-n_ctx // BLOCK_Q) * BLOCK_Q
        x = F.pad(x, (0, 0, 0, Tp - n_ctx))                 # (B, Tp, D)
        if channels_first:
            x = x.transpose(1, 2)                           # (B, D, Tp)
        for blk in layers:
            x = block_fn(x, blk, n_head, compute_dtype, ops, t_valid=n_ctx,
                         interpret=interpret, tp=tp)
        if channels_first:
            x = x[..., :n_ctx]
            if out_layout == "bdt":
                return _layernorm_dt(x, enc["ln_post_w"], enc["ln_post_b"])
            x = x.transpose(1, 2)
        return _layernorm(x[:, :n_ctx], enc["ln_post_w"], enc["ln_post_b"])

    for blk in layers:
        x = _encoder_block(x, blk, n_head, compute_dtype, ops, attn_impl,
                           tp)
    return _layernorm(x, enc["ln_post_w"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# cross-attention KV precompute (reference: src/whisper.cpp:2285-2359)
# ---------------------------------------------------------------------------

def _make_cross_proj(params, enc_out, n_head: int, compute_dtype,
                     enc_layout: str):
    """Per-layer cross K/V projection from the encoder output in
    `enc_layout`: "btd" (B, Ta, D), projected then split to (B, H, Dh, Ta);
    or "bdt" (B, D, Ta) from encode(out_layout="bdt"), projected to
    (B, D, Ta), where the head split is a reshape.
    Returns blk -> (k, v), each (B, H, Dh, Ta) in the compute dtype (H
    this rank's heads under tensor parallelism)."""
    cd = compute_dtype
    n_head = _local_heads(params["decoder"]["blocks"]["xk_w"], n_head)
    if enc_layout == "bdt":
        B, _, Ta = enc_out.shape

        def proj(blk):
            k = _linear_dt(enc_out, blk["xk_w"], None, cd)
            v = _linear_dt(enc_out, blk["xv_w"], blk["xv_b"], cd)
            return (k.reshape(B, n_head, -1, Ta).to(cd),
                    v.reshape(B, n_head, -1, Ta).to(cd))
        return proj
    if enc_layout != "btd":
        raise ValueError(f"unknown enc_layout {enc_layout!r}")

    def proj(blk):
        k = _linear(enc_out, blk["xk_w"], cd)
        v, = bias_cast_ref((_linear(enc_out, blk["xv_w"], cd), blk["xv_b"]),
                           dtype=torch.float32)
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
    proj = _make_cross_proj(params, enc_out, n_head, compute_dtype,
                            enc_layout)
    kc, vc = _stack_layers(params, proj, lambda k, v: (k, v))
    return kc, vc


def _cross_kv_q8_fused(params, enc_out, n_head: int):
    """cross_kv_q8 on the card: each layer's two bf16 products, then one
    launch writes their codes and scales into the layer's slots of the
    (L, ...) stacks.  H: this rank's heads under tensor parallelism."""
    blocks = params["decoder"]["blocks"]
    H = _local_heads(blocks["xk_w"], n_head)
    layers = _layers(blocks)
    cd = torch.bfloat16
    x = enc_out.to(cd)
    B, Ta, _ = x.shape
    L = len(layers)
    codes = [torch.empty((L, B, H, DH, Ta), dtype=torch.int8,
                         device=x.device) for _ in range(2)]
    scales = [torch.empty((L, B, H, Ta), dtype=torch.float32,
                          device=x.device) for _ in range(2)]
    for l, blk in enumerate(layers):
        cross_kv_quant(_linear(x, blk["xk_w"], cd),
                       _linear(x, blk["xv_w"], cd), blk["xv_b"].float(),
                       H, out=(codes[0][l], scales[0][l], codes[1][l],
                               scales[1][l]))
    return (codes[0], scales[0]), (codes[1], scales[1])


def cross_kv_q8(params, enc_out, n_head: int, compute_dtype=torch.bfloat16,
                enc_layout: str = "btd"):
    """enc_out -> ((L, B, H, Dh, Ta) int8 codes, (L, B, H, Ta) f32 scales)
    for K and for V.  Each layer is projected and quantized before the
    next, so the bf16 (L, B, H, Dh, Ta) stack never exists in device
    memory.  Where `_kernels` says so, in one pass a layer: the kernel
    takes the (B, Ta, D) layout and heads DH wide (every Whisper); the
    mesh is not asked, as xk and xv are column-parallel."""
    if _kernels(enc_out, params["decoder"]["blocks"], ("xk_w", "xv_w"),
                compute_dtype, None, "cross_kv_fused",
                takes=(enc_layout == "btd"
                       and enc_out.shape[-1] == n_head * DH)):
        return _cross_kv_q8_fused(params, enc_out, n_head)
    proj = _make_cross_proj(params, enc_out, n_head, compute_dtype,
                            enc_layout)
    kq, ks, vq, vs = _stack_layers(
        params, proj, lambda k, v: (*quantize_kv_bhdt(k),
                                    *quantize_kv_bhdt(v)))
    return (kq, ks), (vq, vs)


def cross_kv_q4(params, enc_out, n_head: int, compute_dtype=torch.bfloat16,
                enc_layout: str = "btd"):
    """enc_out -> ((L, B, H, Dh/2, Ta) uint8 nibble-packed codes,
    (L, B, H, Ta) f32 scales) for K and for V, quantized per layer as in
    cross_kv_q8.  4-bit K/V is not token-exact against bf16 in general."""
    proj = _make_cross_proj(params, enc_out, n_head, compute_dtype,
                            enc_layout)
    kq, ks, vq, vs = _stack_layers(
        params, proj, lambda k, v: (*quantize_kv_bhdt_q4(k),
                                    *quantize_kv_bhdt_q4(v)))
    return (kq, ks), (vq, vs)


def _cross_attention(xq, kc, vc, compute_dtype, mask=None, keep=None):
    """Attention with keys/values in (B, H, Dh, T) layout;
    xq (B, Tq, H, Dh).  Returns merged (B, Tq, D).  keep: called with the
    f32 softmax weights (B, H, Tq, T) (DTW's alignment signal)."""
    dh = xq.shape[-1]
    qh = xq.to(compute_dtype).transpose(1, 2)               # (B, H, Tq, Dh)
    qk = torch.matmul(qh, kc.to(compute_dtype)).float() * (dh ** -0.5)
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1)
    if keep is not None:
        keep(w)
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


def _embed(dec, tokens, positions, tp):
    """tok_emb[tokens] + pos[positions] in float32.  Under tensor
    parallelism each rank looks up the rows of its vocab shard, zeros
    elsewhere, and the all-reduce sums in the one nonzero row exactly."""
    emb = dec["tok_emb"]
    if tp is None:
        rows = emb[tokens]
    else:
        v = emb.shape[0]
        local = tokens - tp.model_rank * v
        held = (local >= 0) & (local < v)
        part = torch.where(held[..., None],
                           emb[local.clamp(0, v - 1)].float(), 0.0)
        rows = tp.all_reduce(part).to(emb.dtype)
    return (rows + dec["pos"][positions]).float()


def _logits(x, tok_emb, compute_dtype, tp):
    """x @ tok_emb.T in float32; under tensor parallelism the vocab
    shards' columns all-gathered in rank order."""
    logits = torch.matmul(x.to(compute_dtype),
                          tok_emb.to(compute_dtype).T).float()
    return logits if tp is None else tp.all_gather(logits, dim=-1)


def _plain_mm(compute_dtype, tp):
    """The plain decoder layer's products (a, w) -> a @ w.T: `_linear` for
    the column-parallel q, xq and mlp0, and for the row-parallel o, xo and
    mlp2 `_linear` all-reduced under tp."""
    return (functools.partial(_linear, compute_dtype=compute_dtype),
            functools.partial(_linear, compute_dtype=compute_dtype, tp=tp))


def _exit_norms(dec, layers) -> list:
    """Each layer's exit layernorm (w, b): the next layer's entry one, the
    last layer's the decoder's final one."""
    return ([(nxt["attn_ln_w"], nxt["attn_ln_b"]) for nxt in layers[1:]]
            + [(dec["ln_w"].float(), dec["ln_b"].float())])


def _decoder_layer(x, ln, blk, ops, mm, self_attn, cross_attn, exit_ln,
                   q_f32: bool = False):
    """One decoder layer from its entry layernorm ln (the compute dtype):
    the self-attention and o, the cross-attention and xo, then the MLP,
    each product's epilogue an op of `ops` (the residual stream in f32),
    the last one carrying the exit layernorm exit_ln (w, b) -> (x, that
    layernorm).  mm: the products (a, w) by a column-parallel and by a
    row-parallel matrix of blk; self_attn(ln) and cross_attn(q) are the
    caller's attentions.  q_f32: q gets its bias in f32 with no rounding
    (the q8i step quantizes an f32 q)."""
    col, row = mm
    x, ln = ops.bias_residual_ln(x, row(self_attn(ln), blk["o_w"]),
                                 blk["o_b"], blk["xattn_ln_w"],
                                 blk["xattn_ln_b"])
    q = (col(ln, blk["xq_w"]), blk["xq_b"])
    q, = (bias_cast_ref(q, dtype=torch.float32) if q_f32
          else ops.bias_cast(q))
    x, ln = ops.bias_residual_ln(x, row(cross_attn(q), blk["xo_w"]),
                                 blk["xo_b"], blk["mlp_ln_w"],
                                 blk["mlp_ln_b"])
    h = ops.bias_gelu_cast(col(ln, blk["mlp0_w"]), blk["mlp0_b"])
    return ops.bias_residual_ln(x, row(h, blk["mlp2_w"]), blk["mlp2_b"],
                                *exit_ln)


def _prompt_pass(params, tokens, positions, k_cross, v_cross, n_head: int,
                 self_mask, compute_dtype, entry: str, keep=None):
    """The decoder on a token block, for decode_prompt and
    decode_prompt_cross_qk (`entry`, for errors): the plain versions on
    every device.  keep(l, w): layer l's cross-attention weights.
    -> (logits (B, T, n_vocab), each layer's k and v (B, T, H, Dh) f32)."""
    tagged = isinstance(k_cross, tuple)
    if tagged and k_cross[0] not in ("q8", "q4", "q4e"):
        raise ValueError(f"{entry}: unknown cross-KV tag {k_cross[0]!r}")
    dec = params["decoder"]
    layers = _layers(dec["blocks"])
    nh = _local_heads(dec["blocks"]["q_w"], n_head)
    cd = compute_dtype
    tp = _model_axis(params)
    ops, mm = _ops(False, cd), _plain_mm(cd, tp)
    ks, vs = [], []

    def self_attn(blk, ln):
        q, k, v = (_linear(ln, blk[w], cd) for w in ("q_w", "k_w", "v_w"))
        # the pass returns its keys and values in f32
        q, v = bias_cast_ref((q, blk["q_b"]), (v, blk["v_b"]),
                             dtype=torch.float32)
        q, k, v = (_split_heads(t, nh) for t in (q, k.float(), v))
        ks.append(k)
        vs.append(v)
        return _attention(q, k, v, self_mask, cd)

    def cross_attn(l, kc, vc, q):
        return _cross_attention(_split_heads(q, nh), kc, vc, cd,
                                keep=keep and functools.partial(keep, l))

    x = _embed(dec, tokens, positions, tp)
    ln = ops.ln_cast(x, layers[0]["attn_ln_w"], layers[0]["attn_ln_b"])
    for l, (blk, exit_ln) in enumerate(zip(layers, _exit_norms(dec, layers))):
        if tagged:
            kc = _dequant(k_cross[0], k_cross[1][l], k_cross[2][l], cd)
            vc = _dequant(v_cross[0], v_cross[1][l], v_cross[2][l], cd)
        else:
            kc, vc = k_cross[l], v_cross[l]
        x, ln = _decoder_layer(x, ln, blk, ops, mm,
                               functools.partial(self_attn, blk),
                               functools.partial(cross_attn, l, kc, vc),
                               exit_ln)
    return _logits(ln, dec["tok_emb"], cd, tp), ks, vs


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
    logits, ks, vs = _prompt_pass(params, tokens, positions, k_cross,
                                  v_cross, n_head, self_mask, compute_dtype,
                                  "decode_prompt")
    return logits, torch.stack(ks), torch.stack(vs)


def decode_prompt_cross_qk(params, tokens, positions, k_cross, v_cross,
                           n_head: int, head_select, self_mask=None,
                           compute_dtype=torch.bfloat16):
    """Teacher-forced decode that also returns the selected cross-attention
    weights (the DTW alignment signal; reference saves KQ_soft_max of the
    alignment heads, src/whisper.cpp:2730-2747).

    head_select: (L, S, H) float32 one-hot rows selecting <= S heads a
    layer (zero rows: unused slots), so deep models capture S maps a layer
    rather than H.  k_cross/v_cross: dense (L, B, H, Dh, Ta), or tagged
    ("q8" / "q4", codes, scales), dequantized a layer at a time.  The pass
    is decode_prompt's (K3 at M = B*T over packed weights), its
    cross-attention softmax in f32 over the compute-dtype QK, as
    whisper_tpu's.  Under tensor parallelism each rank selects from its
    own heads, and an all-reduce over "model" brings every selected
    (global) head's weights to every rank, exactly (one rank holds each
    head, the others add zeros).
    Returns (logits (B, T, V), qk_sel (L, B, S, T, Ta) float32).
    """
    nh = _local_heads(params["decoder"]["blocks"]["q_w"], n_head)
    tp = _model_axis(params)
    head_select = torch.as_tensor(head_select, dtype=torch.float32,
                                  device=tokens.device)
    if tp is not None:
        head_select = head_select[..., tp.model_rank * nh:
                                  (tp.model_rank + 1) * nh]
    qk_all = []

    def keep(l, w):                                       # (B, H, T, Ta)
        qk_all.append(torch.einsum("bhta,sh->bsta", w, head_select[l]))

    logits = _prompt_pass(params, tokens, positions, k_cross, v_cross,
                          n_head, self_mask, compute_dtype,
                          "decode_prompt_cross_qk", keep)[0]
    qk_sel = torch.stack(qk_all)
    return logits, qk_sel if tp is None else tp.all_reduce(qk_sel)


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


def _cross_layers(kc) -> list:
    """Every layer of a stacked cross-KV in any form _cross_attn_step
    takes, from one unbind of each stacked tensor."""
    if isinstance(kc, torch.Tensor):
        return kc.unbind(0)
    if isinstance(kc, dict):
        return [dict(zip(kc, vals))
                for vals in zip(*(v.unbind(0) for v in kc.values()))]
    return [(kc[0],) + vals for vals in zip(*(a.unbind(0) for a in kc[1:]))]


# the decoder block's matrices that a decode step multiplies by
_DECODER_MATRICES = ("q_w", "k_w", "v_w", "o_w", "xq_w", "xo_w", "mlp0_w",
                     "mlp2_w")


# id of a decoder's stacked q_w -> (weak references to its stacked blocks,
# their versions, the fused step's layers); see _fused_layers
_FUSED_LAYERS: dict[int, tuple] = {}


def _fused_layers(blocks: dict, compute_dtype) -> list[dict]:
    """The kernel step's weights a layer, built once a decoder: the
    matrices in the compute dtype as (in, out) views for torch.mm on 2-D
    rows (less host time a GEMM than F.linear on (B, 1, D)), q/k/v
    concatenated into one (D, 3D) matrix for one GEMM (a copy: 32 x 3 x
    1280^2 bf16, 315 MB, at large-v3), and the biases and layernorm
    weights in f32 as the kernels take them.  Rebuilt when a stacked block
    is replaced or written in place.  The layers hold detached views,
    which keep the weights' storage but not the stacked tensors alive, so
    the entry goes with its q_w."""
    srcs = tuple(blocks.values())
    key = id(blocks["q_w"])
    versions = tuple(t._version for t in srcs)
    hit = _FUSED_LAYERS.get(key)
    if (hit is not None and hit[1] == versions
            and all(ref() is t for ref, t in zip(hit[0], srcs))):
        return hit[2]
    cd = compute_dtype
    mats = {"qkv_w": torch.cat([blocks[k].to(cd)
                                for k in ("q_w", "k_w", "v_w")], dim=1)}
    mats.update((k, blocks[k].to(cd))
                for k in ("o_w", "xq_w", "xo_w", "mlp0_w", "mlp2_w"))
    vecs = {k: blocks[k].float() for k in (
        "q_b", "v_b", "o_b", "xq_b", "xo_b", "mlp0_b", "mlp2_b", "attn_ln_w",
        "attn_ln_b", "xattn_ln_w", "xattn_ln_b", "mlp_ln_w", "mlp_ln_b")}
    layers = [{**{k: v[l].detach().t() for k, v in mats.items()},
               **{k: v[l].detach() for k, v in vecs.items()}}
              for l in range(blocks["q_w"].shape[0])]
    _FUSED_LAYERS[key] = (tuple(weakref.ref(t) for t in srcs), versions,
                          layers)
    weakref.finalize(blocks["q_w"], _FUSED_LAYERS.pop, key, None)
    return layers


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
    Where `_kernels` says so, the layers run on their kernels: the
    self-attention kernel, which takes rows D a multiple of 8 up to
    MAX_LN_WIDTH, heads up to MAX_DH and a contiguous cache in the compute
    dtype, on one GEMM over `_fused_layers`' concatenated q/k/v, and the
    epilogues.  Otherwise the plain versions, with the mask built once a
    step.
    Returns (logits (B, n_vocab), kv_self).
    """
    dec = params["decoder"]
    blocks = dec["blocks"]
    nh = _local_heads(blocks["q_w"], n_head)
    cd = compute_dtype
    tp = _model_axis(params)
    kk, vv = kv_self["k"], kv_self["v"]
    x = _embed(dec, tokens, pos_ids, tp)                    # (B, D) rows
    B, D = x.shape
    kernels = _kernels(
        x, blocks, _DECODER_MATRICES, cd, tp, "decoder_fused",
        takes=(D % 8 == 0 and D <= MAX_LN_WIDTH and kk.shape[-2] <= MAX_DH
               and all(c.dtype == cd and c.is_contiguous()
                       for c in (kk, vv))))
    if kernels:
        # torch.mm on `_fused_layers`' (in, out) views of bf16 rows
        layers, mm = _fused_layers(blocks, cd), (torch.mm, torch.mm)
        if pad_len is not None:      # as the kernel reads it
            pad_len = pad_len.to(torch.long).contiguous()

        def self_attn(blk, k_l, v_l, ln):
            return self_attn_step(torch.mm(ln, blk["qkv_w"]), blk["q_b"],
                                  blk["v_b"], k_l, v_l, cache_index, kv_len,
                                  pad_len, nh)
    else:
        layers, mm = _layers(blocks), _plain_mm(cd, tp)
        # over the cache columns: valid iff pad_len <= idx < kv_len
        mask = step_mask(kk.shape[-1], kv_len, pad_len, kk.device)

        def self_attn(blk, k_l, v_l, ln):
            qkv = torch.cat([_linear(ln, blk[w], cd)
                             for w in ("q_w", "k_w", "v_w")], dim=-1)
            return self_attn_step_ref(qkv, blk["q_b"], blk["v_b"], k_l, v_l,
                                      cache_index, kv_len, pad_len, nh,
                                      mask=mask, dtype=cd)

    def cross_attn(kc_l, vc_l, q):
        # (S*K, D) -> (S, K, H, Dh): a stream's beams as queries
        return _cross_attn_step(q.reshape(B // group, group, nh, -1), kc_l,
                                vc_l, cd).reshape(B, -1).to(cd)

    ops = _ops(kernels, cd)
    q_f32 = isinstance(k_cross, tuple) and k_cross[0] == "q8i"
    ln = ops.ln_cast(x, layers[0]["attn_ln_w"], layers[0]["attn_ln_b"])
    for blk, exit_ln, k_l, v_l, kc_l, vc_l in zip(
            layers, _exit_norms(dec, layers), kk.unbind(0), vv.unbind(0),
            _cross_layers(k_cross), _cross_layers(v_cross)):
        x, ln = _decoder_layer(x, ln, blk, ops, mm,
                               functools.partial(self_attn, blk, k_l, v_l),
                               functools.partial(cross_attn, kc_l, vc_l),
                               exit_ln, q_f32)
    return _logits(ln, dec["tok_emb"], cd, tp), kv_self


def make_causal_mask(t: int, offset: int = 0, device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, T, T+offset) float32."""
    q = torch.arange(t, device=device)[:, None] + offset
    k = torch.arange(t + offset, device=device)[None, :]
    return torch.where(k <= q, 0.0, float("-inf"))[None, None]
