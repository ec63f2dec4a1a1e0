"""Parameter dicts for the port: random init and the bridge from JAX.

The layout is whisper_tpu's (see models/whisper.py): nested dicts, per-layer
weights stacked along a leading L axis, linear weights in the torch
(out, in) layout.  Matmul weights are held in the compute dtype; norms,
biases, positional tables and the conv stem stay float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.whisper import WhisperConfig

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


def _leaf_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    return dtype if key in WEIGHT_KEYS else torch.float32


def random_params(cfg: WhisperConfig, seed: int = 0,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device = "cpu",
                  scale: float = 0.02) -> dict:
    """Random-weight parameters drawn on `device` from a torch.Generator.

    Same shapes, dtypes and scales as whisper_tpu's random_params (every
    leaf of rank >= 2 is N(0, scale^2), rank-1 leaves are zero, layernorm
    scales are one); the numbers differ, since the generators differ.
    device="meta" gives the shapes and dtypes without allocating.
    """
    gen = None
    if torch.device(device).type != "meta":
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


def from_jax(params_np: dict, device: str | torch.device = "cpu",
             dtype: torch.dtype | None = None) -> dict:
    """Build the port's params from whisper_tpu's pytree given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    dtype=None keeps every leaf's own dtype, so each leaf is reproduced
    exactly; a dtype casts the matmul weights (WEIGHT_KEYS) to it.
    """
    out = {}
    for key, val in params_np.items():
        if isinstance(val, dict):
            out[key] = from_jax(val, device, dtype)
            continue
        t = _to_torch(np.asarray(val))
        if dtype is not None:
            t = t.to(_leaf_dtype(key, dtype))
        out[key] = t.to(device)
    return out
