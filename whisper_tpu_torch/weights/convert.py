"""Parameter dicts for the port: ggml files, random init and the bridge
from JAX.

The layout is whisper_tpu's (see models/whisper.py): nested dicts, per-layer
weights stacked along a leading L axis, linear weights in the torch
(out, in) layout.  Matmul weights are held in the compute dtype; norms,
biases, positional tables and the conv stem stay float32.  A decoder
weight kept block-quantized is a dict {"q": (L, K, N) int8 codes,
"s": (L, K/32, N) f32 scales[, "m": offsets]}, K-major, which `_linear`
sends to kernel K3.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.whisper import WhisperConfig
from ..ops.quantized import unpack_to_codes
from ..utils.device import resolve_device
from . import quant
from .ggml_reader import GgmlModelFile

# leaves held in the compute dtype (whisper_tpu.weights.convert._cast)
WEIGHT_KEYS = frozenset({
    "q_w", "k_w", "v_w", "o_w", "mlp0_w", "mlp2_w",
    "xq_w", "xk_w", "xv_w", "xo_w", "tok_emb"})


def param_shapes(cfg: WhisperConfig) -> dict:
    """Nested dict of leaf shapes (whisper_tpu.weights.convert.zero_params)."""
    d_a, d_t = cfg.n_audio_state, cfg.n_text_state
    La, Lt = cfg.n_audio_layer, cfg.n_text_layer

    def block(L, d):
        return {
            "attn_ln_w": (L, d), "attn_ln_b": (L, d),
            "q_w": (L, d, d), "q_b": (L, d), "k_w": (L, d, d),
            "v_w": (L, d, d), "v_b": (L, d), "o_w": (L, d, d), "o_b": (L, d),
            "mlp_ln_w": (L, d), "mlp_ln_b": (L, d),
            "mlp0_w": (L, 4 * d, d), "mlp0_b": (L, 4 * d),
            "mlp2_w": (L, d, 4 * d), "mlp2_b": (L, d),
        }

    dec_blocks = block(Lt, d_t)
    dec_blocks.update({
        "xattn_ln_w": (Lt, d_t), "xattn_ln_b": (Lt, d_t),
        "xq_w": (Lt, d_t, d_t), "xq_b": (Lt, d_t), "xk_w": (Lt, d_t, d_t),
        "xv_w": (Lt, d_t, d_t), "xv_b": (Lt, d_t),
        "xo_w": (Lt, d_t, d_t), "xo_b": (Lt, d_t),
    })
    return {
        "encoder": {
            "conv1_w": (d_a, cfg.n_mels, 3), "conv1_b": (d_a,),
            "conv2_w": (d_a, d_a, 3), "conv2_b": (d_a,),
            "pos": (cfg.n_audio_ctx, d_a),
            "ln_post_w": (d_a,), "ln_post_b": (d_a,),
            "blocks": block(La, d_a),
        },
        "decoder": {
            "tok_emb": (cfg.n_vocab, d_t), "pos": (cfg.n_text_ctx, d_t),
            "ln_w": (d_t,), "ln_b": (d_t,),
            "blocks": dec_blocks,
        },
    }


# (our key, reference tensor name suffix): names from reference
# src/whisper-arch.h:42-141 (whisper_tpu.weights.convert)
_ENC_BLOCK = [
    ("attn_ln_w", "attn_ln.weight"),
    ("attn_ln_b", "attn_ln.bias"),
    ("q_w", "attn.query.weight"),
    ("q_b", "attn.query.bias"),
    ("k_w", "attn.key.weight"),
    ("v_w", "attn.value.weight"),
    ("v_b", "attn.value.bias"),
    ("o_w", "attn.out.weight"),
    ("o_b", "attn.out.bias"),
    ("mlp_ln_w", "mlp_ln.weight"),
    ("mlp_ln_b", "mlp_ln.bias"),
    ("mlp0_w", "mlp.0.weight"),
    ("mlp0_b", "mlp.0.bias"),
    ("mlp2_w", "mlp.2.weight"),
    ("mlp2_b", "mlp.2.bias"),
]

_DEC_BLOCK = _ENC_BLOCK + [
    ("xattn_ln_w", "cross_attn_ln.weight"),
    ("xattn_ln_b", "cross_attn_ln.bias"),
    ("xq_w", "cross_attn.query.weight"),
    ("xq_b", "cross_attn.query.bias"),
    ("xk_w", "cross_attn.key.weight"),
    ("xv_w", "cross_attn.value.weight"),
    ("xv_b", "cross_attn.value.bias"),
    ("xo_w", "cross_attn.out.weight"),
    ("xo_b", "cross_attn.out.bias"),
]

_PACKED_TYPES = (quant.GGML_TYPE_Q4_0, quant.GGML_TYPE_Q4_1,
                 quant.GGML_TYPE_Q5_0, quant.GGML_TYPE_Q5_1,
                 quant.GGML_TYPE_Q8_0)


def _leaf_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    return dtype if key in WEIGHT_KEYS else torch.float32


def _file_dtype(key: str, ndim: int, dtype: torch.dtype) -> torch.dtype:
    """whisper_tpu.weights.convert._cast on a (stacked) file tensor: rank
    >= 2 leaves not named *_b or *pos go to `dtype` (so the stacked
    (L, d) layernorm scales do too), the rest stay float32."""
    if ndim >= 2 and not key.endswith(("_b", "pos")):
        return dtype
    return torch.float32


def _is_packed(tree: dict) -> bool:
    return "q" in tree and "s" in tree


def _keeps_packed(name: str, rt) -> bool:
    """whisper_tpu's packing rule (weights/convert.py:79-103): decoder
    block 2-D weights in the five block codecs whose shapes are multiples
    of 128, except the cross-attention key/value projections (they run
    once per window at M = B * Ta, where a dense GEMM wins)."""
    if name.endswith(("cross_attn.key.weight", "cross_attn.value.weight")):
        return False
    return (name.startswith("decoder.blocks.")
            and rt.ttype in _PACKED_TYPES
            and len(rt.shape) == 2
            and rt.shape[1] % quant.QK == 0
            and rt.shape[1] % 128 == 0 and rt.shape[0] % 128 == 0)


def params_from_ggml(mf: GgmlModelFile, dtype: torch.dtype = torch.bfloat16,
                     keep_quantized: bool = True,
                     device: str | torch.device = "cuda"):
    """-> (params dict on `device`, WhisperConfig), leaf for leaf what
    whisper_tpu.weights.convert.params_from_ggml gives.

    keep_quantized: decoder block weights that the packing rule keeps stay
    block-quantized ({"q", "s"[, "m"]}) and run through K3; the encoder,
    the token embedding and every f16/f32 tensor are densified.  Unlike
    whisper_tpu, which densifies on its CPU backend, the port keeps them
    packed on every device: on the CPU K3 runs its plain version.

    Layers are decoded and moved to `device` one at a time, so the host
    never holds a dense copy of a whole stack.  A file with no tensors (the
    reference's stub-model test path) gives zero parameters.
    """
    device = resolve_device(device)
    cfg = WhisperConfig.from_hparams(mf.hparams)
    if len(mf.tensors) == 0:
        return zero_params(cfg, dtype=dtype, device=device), cfg
    tensors = mf.tensors

    def dense(name: str, dt: torch.dtype) -> torch.Tensor:
        arr = np.ascontiguousarray(tensors[name].to_numpy())
        if not arr.flags.writeable:       # f32 data read straight from the file
            arr = arr.copy()
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    def stack(prefix: str, n_layer: int, table) -> dict:
        out = {}
        for key, suffix in table:
            names = [f"{prefix}.blocks.{i}.{suffix}" for i in range(n_layer)]
            if keep_quantized and all(_keeps_packed(n, tensors[n])
                                      for n in names):
                leaves = {}
                for i, n in enumerate(names):
                    rt = tensors[n]
                    parts = zip(("q", "s", "m"),
                                unpack_to_codes(rt.data, rt.ttype, rt.shape))
                    for part, arr in parts:
                        if arr is None:
                            continue
                        t = torch.from_numpy(np.ascontiguousarray(arr.T))
                        if part not in leaves:
                            leaves[part] = torch.empty(
                                (n_layer,) + tuple(t.shape), dtype=t.dtype,
                                device=device)
                        leaves[part][i] = t
                out[key] = leaves
                continue
            shape = tensors[names[0]].shape
            dt = _file_dtype(key, 1 + len(shape), dtype)
            out[key] = torch.empty((n_layer,) + tuple(shape), dtype=dt,
                                   device=device)
            for i, n in enumerate(names):
                out[key][i] = dense(n, dt)
        return out

    f32 = torch.float32
    enc = {
        "conv1_w": dense("encoder.conv1.weight", f32),
        "conv1_b": dense("encoder.conv1.bias", f32).reshape(-1),
        "conv2_w": dense("encoder.conv2.weight", f32),
        "conv2_b": dense("encoder.conv2.bias", f32).reshape(-1),
        "pos": dense("encoder.positional_embedding", f32),
        "ln_post_w": dense("encoder.ln_post.weight", f32),
        "ln_post_b": dense("encoder.ln_post.bias", f32),
        "blocks": stack("encoder", cfg.n_audio_layer, _ENC_BLOCK),
    }
    dec = {
        "tok_emb": dense("decoder.token_embedding.weight",
                         _file_dtype("tok_emb", 2, dtype)),
        "pos": dense("decoder.positional_embedding", f32),
        "ln_w": dense("decoder.ln.weight", f32),
        "ln_b": dense("decoder.ln.bias", f32),
        "blocks": stack("decoder", cfg.n_text_layer, _DEC_BLOCK),
    }
    return {"encoder": enc, "decoder": dec}, cfg


def zero_params(cfg: WhisperConfig, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> dict:
    """Zero-weight parameters with the right shapes (the stub-model path;
    whisper_tpu.weights.convert.zero_params)."""
    device = resolve_device(device)

    def build(tree):
        return {key: build(val) if isinstance(val, dict)
                else torch.zeros(val, dtype=_leaf_dtype(key, dtype),
                                 device=device)
                for key, val in tree.items()}

    return build(param_shapes(cfg))


def random_params(cfg: WhisperConfig, seed: int = 0,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device = "cuda",
                  scale: float = 0.02) -> dict:
    """Random-weight parameters drawn on `device` from a torch.Generator.

    Same shapes, dtypes and scales as whisper_tpu's random_params (every
    leaf of rank >= 2 is N(0, scale^2), rank-1 leaves are zero, layernorm
    scales are one); the numbers differ, since the generators differ.
    device="meta" gives the shapes and dtypes without allocating.
    """
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def build(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = build(val)
                continue
            dt = _leaf_dtype(key, dtype)
            if key.endswith("ln_w") or key == "ln_post_w":
                out[key] = torch.ones(val, dtype=dt, device=device)
            elif len(val) >= 2:
                out[key] = (torch.randn(val, generator=gen, device=device,
                                        dtype=torch.float32) * scale).to(dt)
            else:
                out[key] = torch.zeros(val, dtype=dt, device=device)
        return out

    return build(param_shapes(cfg))


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """numpy leaf -> CPU tensor, bit-exact; bfloat16 (ml_dtypes) arrays are
    reinterpreted through their 16-bit storage."""
    arr = np.array(arr, order="C")   # a writable copy the tensor owns
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax(params_np: dict, device: str | torch.device = "cuda",
             dtype: torch.dtype | None = None) -> dict:
    """Build the port's params from whisper_tpu's pytree given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    dtype=None keeps every leaf's own dtype, so each leaf is reproduced
    exactly; a dtype casts the matmul weights (WEIGHT_KEYS) to it.  A
    block-quantized weight ({"q", "s"[, "m"]}) is carried bit for bit
    whatever `dtype` says.
    """
    device = resolve_device(device)
    out = {}
    for key, val in params_np.items():
        if isinstance(val, dict):
            out[key] = from_jax(val, device,
                                None if _is_packed(val) else dtype)
            continue
        t = _to_torch(np.asarray(val))
        if dtype is not None:
            t = t.to(_leaf_dtype(key, dtype))
        out[key] = t.to(device)
    return out
