"""Mapping between HuggingFace Whisper checkpoints and the ggml tensor names
(copy of whisper_tpu.weights.hf).

Replicates the rename table of the reference converter
(models/convert-h5-to-ggml.py:51-80) so `transformers` checkpoints can be
written into the legacy ggml container.
"""

from __future__ import annotations

import numpy as np

# HF name fragment -> openai/ggml name fragment
_RENAMES = [
    ("model.encoder.", "encoder."),
    ("model.decoder.", "decoder."),
    ("layers.", "blocks."),
    ("fc1", "mlp.0"),
    ("fc2", "mlp.2"),
    ("final_layer_norm", "mlp_ln"),
    ("encoder_attn_layer_norm", "cross_attn_ln"),
    ("encoder_attn", "cross_attn"),
    ("self_attn_layer_norm", "attn_ln"),
    ("self_attn", "attn"),
    (".q_proj", ".query"),
    (".k_proj", ".key"),
    (".v_proj", ".value"),
    (".out_proj", ".out"),
    ("embed_positions.weight", "positional_embedding"),
    ("embed_tokens", "token_embedding"),
    ("encoder.layer_norm", "encoder.ln_post"),
    ("decoder.layer_norm", "decoder.ln"),
]


def hf_name_to_ggml(name: str) -> str | None:
    """Map one HF state-dict key to its ggml tensor name (None = skip)."""
    if name in ("proj_out.weight", "model.decoder.embed_tokens.weight_orig"):
        return None  # tied to decoder.token_embedding.weight
    for old, new in _RENAMES:
        name = name.replace(old, new)
    if name.startswith(("encoder.", "decoder.")):
        return name
    return None


def tensors_from_hf_state_dict(state_dict) -> dict[str, np.ndarray]:
    """torch state_dict -> {ggml name: numpy array} (tied lm head dropped)."""
    out: dict[str, np.ndarray] = {}
    for hf_name, tensor in state_dict.items():
        name = hf_name_to_ggml(hf_name)
        if name is None:
            continue
        out[name] = tensor.detach().cpu().float().numpy()
    return out


def hparams_from_hf_config(config) -> dict:
    """transformers.WhisperConfig -> ggml hparams dict."""
    return {
        "n_vocab": config.vocab_size,
        "n_audio_ctx": config.max_source_positions,
        "n_audio_state": config.d_model,
        "n_audio_head": config.encoder_attention_heads,
        "n_audio_layer": config.encoder_layers,
        "n_text_ctx": config.max_target_positions,
        "n_text_state": config.d_model,
        "n_text_head": config.decoder_attention_heads,
        "n_text_layer": config.decoder_layers,
        "n_mels": config.num_mel_bins,
    }
