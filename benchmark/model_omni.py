"""The audio-LLM a cell runs (configs/uni-moe-2.0-omni.json): its weights
made from the seed, and the port's AudioLLMContext over them.

As model.py does for Whisper: the weights are drawn on the device from a
torch.Generator seeded from the run's seed, into two buffers (one for the
matrices held in the compute dtype, one for the float32 leaves), and cut
into the port's parameter layout (the encoder's as Whisper's, the
connector's and the language model's as models/uni_moe_omni.py's).  The
same call gives the reference the same tensors again, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .traffic import seed_for

ALIGN = 128            # each leaf starts on a multiple of this many elements
CHUNK = 1 << 28        # numbers drawn a call


def encoder_config(cfg: dict):
    """The port's WhisperConfig of the audio tower (its encoder fields;
    the text fields repeat them and are not used)."""
    from whisper_tpu_torch.models.whisper import WhisperConfig
    enc = cfg["whisper_encoder"]
    if enc["encoder_ffn_dim"] != 4 * enc["d_model"]:
        raise ValueError("the port's encoder layers are 4 x d_model wide")
    if enc["d_model"] != cfg["whisper_hidden_size"]:
        raise ValueError("whisper_hidden_size is the encoder's d_model")
    return WhisperConfig(
        n_vocab=enc["vocab_size"], n_audio_ctx=enc["max_source_positions"],
        n_audio_state=enc["d_model"],
        n_audio_head=enc["encoder_attention_heads"],
        n_audio_layer=enc["encoder_layers"],
        n_text_ctx=enc["max_source_positions"], n_text_state=enc["d_model"],
        n_text_head=enc["encoder_attention_heads"], n_text_layer=0,
        n_mels=enc["num_mel_bins"], model_type=cfg["name"])


def llm_config(cfg: dict):
    """The port's OmniConfig of a configuration file (HF names)."""
    from whisper_tpu_torch.models.uni_moe_omni import OmniConfig
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return OmniConfig(
        n_vocab=cfg["vocab_size"], d_model=d,
        n_layer=cfg["num_hidden_layers"], n_head=heads,
        n_kv_head=cfg["num_key_value_heads"], head_dim=d // heads,
        n_routed=cfg["mlp_dynamic_expert_num"],
        n_null=cfg["mlp_dynamic_null_expert_num"],
        n_shared=cfg["mlp_fixed_expert_num"],
        routed_ffn=cfg["dynamic_intermediate_size"],
        shared_ffn=cfg["shared_intermediate_size"],
        top_p=cfg["mlp_dynamic_top_p"], top_k=cfg["mlp_dynamic_top_k"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        n_audio_tokens=cfg["whisper_query_tokens_size"],
        audio_state=cfg["whisper_hidden_size"],
        prompt_head=tuple(cfg["prompt_head"]),
        prompt_tail=tuple(cfg["prompt_tail"]), eos=cfg["eos_token_id"])


def _leaves(cfg: dict) -> list:
    """[(path, shape, held in the compute dtype)] of every leaf."""
    from whisper_tpu_torch.models import uni_moe_omni as omni
    from whisper_tpu_torch.weights.convert import WEIGHT_KEYS, param_shapes
    out = []

    def walk(tree, path, keys):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,), keys)
            else:
                out.append((path + (key,), tuple(val), key in keys))
    walk(param_shapes(encoder_config(cfg))["encoder"], ("encoder",),
         WEIGHT_KEYS)
    walk(omni.param_shapes(llm_config(cfg)), (), omni.WEIGHT_KEYS)
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """Random weights of `cfg` from `seed` on `device`: matrices
    N(0, init_std^2) in the compute dtype, the router, biases and the
    encoder's embeddings N(0, init_std^2) and norm scales
    1 + N(0, init_std^2) in float32."""
    dtype = getattr(torch, cfg["compute_dtype"])
    leaves = _leaves(cfg)

    def padded(n):
        return -(-n // ALIGN) * ALIGN

    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, 1))
    bufs = {}
    for low in (True, False):
        n = sum(padded(int(np.prod(s))) for _, s, lo in leaves if lo == low)
        buf = torch.empty(n, device=device,
                          dtype=dtype if low else torch.float32)
        # in pieces: the compute dtype's buffer holds ~2.7e10 numbers
        for a in range(0, n, CHUNK):
            buf[a:a + CHUNK].normal_(generator=gen).mul_(cfg["init_std"])
        bufs[low] = buf
    offsets = {True: 0, False: 0}
    params: dict = {}
    for path, shape, low in leaves:
        n = int(np.prod(shape))
        leaf = bufs[low][offsets[low]:offsets[low] + n].view(shape)
        offsets[low] += padded(n)
        if path[-1].endswith(("norm", "ln_w")) or path[-1] == "ln_post_w":
            leaf.add_(1.0)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def make_context(cfg: dict, params: dict, device):
    """The port's AudioLLMContext over `params`, with the mel filterbank
    of the encoder's bands."""
    from whisper_tpu_torch.api import AudioLLMContext
    return AudioLLMContext(encoder_config(cfg), llm_config(cfg), params,
                           device=device,
                           compute_dtype=getattr(torch, cfg["compute_dtype"]))
