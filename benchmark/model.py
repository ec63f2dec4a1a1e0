"""The model a cell runs: its weights made from the seed, and the port's
context over them.

Weights are drawn on the device from a torch.Generator seeded from the
run's seed, in two calls (one for the matrices held in the compute dtype,
one for the float32 leaves), and cut into the port's parameter layout.
The same call gives the reference the same tensors again, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .traffic import seed_for

ALIGN = 128            # each leaf starts on a multiple of this many elements


def port_config(cfg: dict):
    """The port's WhisperConfig of a configuration file (HF names)."""
    from whisper_tpu_torch.models.whisper import WhisperConfig
    for key in ("encoder_ffn_dim", "decoder_ffn_dim"):
        if cfg[key] != 4 * cfg["d_model"]:
            raise ValueError(f"{key} {cfg[key]}: the port's layers are "
                             "4 x d_model wide")
    return WhisperConfig(
        n_vocab=cfg["vocab_size"], n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_text_ctx=cfg["max_target_positions"], n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"], n_mels=cfg["num_mel_bins"],
        model_type=cfg["name"])


def make_params(cfg: dict, seed: int, device) -> dict:
    """Random weights of `cfg` from `seed` on `device`: matrices
    N(0, init_std^2) in the compute dtype, biases and embeddings
    N(0, init_std^2) and layernorm scales 1 + N(0, init_std^2) in
    float32."""
    from whisper_tpu_torch.weights.convert import WEIGHT_KEYS, param_shapes
    dtype = getattr(torch, cfg["compute_dtype"])
    shapes = param_shapes(port_config(cfg))
    leaves = []

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                leaves.append((path + (key,), tuple(val)))
    walk(shapes, ())

    def padded(n):
        return -(-n // ALIGN) * ALIGN

    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, 1))
    bufs = {}
    for dt in (dtype, torch.float32):
        n = sum(padded(int(np.prod(s))) for p, s in leaves
                if (dtype if p[-1] in WEIGHT_KEYS else torch.float32) == dt)
        bufs[dt] = torch.randn(n, generator=gen, dtype=dt, device=device)
        bufs[dt].mul_(cfg["init_std"])
    offsets = {dtype: 0, torch.float32: 0}
    params: dict = {}
    for path, shape in leaves:
        dt = dtype if path[-1] in WEIGHT_KEYS else torch.float32
        n = int(np.prod(shape))
        leaf = bufs[dt][offsets[dt]:offsets[dt] + n].view(shape)
        offsets[dt] += padded(n)
        if path[-1].endswith("ln_w") or path[-1] == "ln_post_w":
            leaf.add_(1.0)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def make_context(cfg: dict, params: dict, device):
    """The port's WhisperContext over `params`, with its own vocabulary
    (synthetic token strings, the real special ids) and mel filterbank."""
    from whisper_tpu_torch.api import WhisperContext
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.weights.vocab import synthetic_vocab
    config = port_config(cfg)
    return WhisperContext(
        config=config, vocab=synthetic_vocab(config.n_vocab),
        filters=mel_filterbank(config.n_mels), params=params, device=device,
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        cross_mode=cfg["cross_mode"])
