"""Window decode loop (port of whisper_tpu.decode.loop).

One window decode: the prompt pass, then token sampling (argmax at t = 0,
a draw from JAX's threefry stream at t > 0, decode/rng.py), the
logit-filter chain, the timestamp/sliding-window state update and the
stop conditions, per token.  The JAX package runs this as one
`lax.while_loop` on device; here it is a Python loop over static KV
buffers that stops when every row is completed or failed (one host read
of that flag per token).

Variable-length prompts are LEFT-padded inside a fixed prompt buffer: pad
slots are masked out of attention and position ids are shifted, so the
math matches a dense prompt decode.

Traced (utils/trace.py), the host's time in the token loop splits into
`step` spans (one a decode step: its launches and the token's draw and
bookkeeping, enqueued without a wait) and `wait` spans (every host read
of the device: the stop flag once a token, the results at the end).  The
window's inputs go up from pinned memory without a wait.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..constants import CHUNK_SIZE, TICKS_PER_SECOND
from ..models import whisper as wm
from ..utils.trace import TRACE
from . import rng
from .filters import (FilterConsts, FilterOptions, make_process_logits,
                      sample_token_data)

DELTA_MIN = 10  # 100 ms in ticks (reference: src/whisper.cpp:5533)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Static knobs of the loop."""
    n_head: int
    n_text_ctx: int
    prompt_size: int      # P: fixed prompt buffer length
    max_tokens_loop: int  # N: loop bound = n_text_ctx // 2 - 4
    max_tokens_param: int  # params.max_tokens (0 = unlimited)
    single_segment: bool
    no_timestamps: bool
    compute_dtype: torch.dtype = torch.bfloat16
    # cross-attention path of the token loop, one of CROSS_MODES; the
    # prompt pass always runs the einsum (over dequantized K/V)
    cross_mode: str = "einsum_q8"


# cross mode -> the decode step's tag for its (codes, scales) cross-KV:
# "einsum_q8" and "pallas_q8dt" through K2, "einsum_q8i" int8 dots and
# "einsum_q4" nibble dots in plain torch (models/whisper._cross_attn_step)
QUANT_TAGS = {"einsum_q8": "q8e", "pallas_q8dt": "q8dt", "einsum_q8i": "q8i",
              "einsum_q4": "q4e"}
# the dense modes: "einsum" (plain torch), "pallas" (bf16 (.., Ta, Dh) K/V
# through K4), "pallas_q8" (int8 (.., Ta, Dh) K/V through K5)
CROSS_MODES = ("einsum", "einsum_q8", "pallas_q8dt", "einsum_q8i",
               "einsum_q4", "pallas", "pallas_q8")


def loop_cross_kv(cross_mode: str, k_cross, v_cross, compute_dtype):
    """The cross-KV layout the token loop reads, made once per window
    (whisper_tpu.decode.loop, loop.py:252-280).  The quantized modes take
    the (codes, scales) pairs of cross_kv_q8 / cross_kv_q4 as they are (the
    batched path), or quantize the dense (L, B, H, Dh, Ta) of cross_kv here
    (the `full` path); "pallas" and "pallas_q8" transpose the dense one."""
    prequant = not isinstance(k_cross, torch.Tensor)
    if cross_mode in QUANT_TAGS:
        tag = QUANT_TAGS[cross_mode]
        if not prequant:
            from ..ops.cross_attention import (quantize_kv_bhdt,
                                               quantize_kv_bhdt_q4)
            qfn = quantize_kv_bhdt_q4 if tag == "q4e" else quantize_kv_bhdt
            k_cross, v_cross = qfn(k_cross), qfn(v_cross)
        return (tag,) + tuple(k_cross), (tag,) + tuple(v_cross)
    if prequant:
        raise ValueError(f"cross_mode {cross_mode!r} takes the dense "
                         "cross-KV of cross_kv, not a (codes, scales) pair")
    if cross_mode == "einsum":
        return k_cross, v_cross
    # (L, B, H, Dh, Ta) -> (L, B, H, Ta, Dh), contiguous as K4/K5 read it
    k_t, v_t = (x.transpose(-1, -2).to(compute_dtype).contiguous()
                for x in (k_cross, v_cross))
    if cross_mode == "pallas":
        return ("bhtd", k_t), ("bhtd", v_t)
    if cross_mode != "pallas_q8":
        raise ValueError(f"unknown cross_mode {cross_mode!r}")
    from ..ops.cross_attention import quantize_kv
    kq, ks = quantize_kv(k_t)
    vq, vs = quantize_kv(v_t)
    return {"q": kq, "s": ks}, {"q": vq, "s": vs}


def token_state_update(consts, cfg, *, i, tok, live, has_ts, seek_delta,
                       result_len, completed, failed, seek, seek_end, N):
    """Per-token decoder state update (reference: src/whisper.cpp:5990-6065):
    timestamp-driven sliding-window update, end-of-segment detection,
    repetition-loop bailout.  i and N are ints, the rest (B,) tensors.
    Returns (has_ts, seek_delta, result_len, completed, failed)."""
    token_beg = consts.token_beg
    token_eot = consts.token_eot

    is_ts_update = live & (tok > token_beg)
    seek_delta_new = 2 * (tok - token_beg)
    goes_back = has_ts & (seek_delta > seek_delta_new) & (result_len < i)
    failed = failed | (is_ts_update & goes_back)
    apply_ts = is_ts_update & ~goes_back
    seek_delta = torch.where(apply_ts, seek_delta_new, seek_delta)
    result_len = torch.where(apply_ts, i + 1, result_len)
    has_ts = has_ts | apply_ts

    still_live = live & ~(is_ts_update & goes_back)
    eos = tok == token_eot
    if cfg.max_tokens_param > 0 and i >= cfg.max_tokens_param:
        eos = torch.ones_like(eos)
    eos = eos | (has_ts & (seek + seek_delta + DELTA_MIN >= seek_end))
    eos = still_live & eos

    if not cfg.no_timestamps:
        zero_len = eos & (result_len == 0)
        at_end = seek + seek_delta + DELTA_MIN >= seek_end
        result_len = torch.where(zero_len & at_end, i + 1, result_len)
        failed = failed | (zero_len & ~at_end)
        eos = eos & ~(zero_len & ~at_end)
    if cfg.single_segment or cfg.no_timestamps:
        result_len = torch.where(eos, i + 1, result_len)
        seek_delta = torch.where(eos, TICKS_PER_SECOND * CHUNK_SIZE,
                                 seek_delta)
    completed = completed | eos

    live2 = still_live & ~eos
    if i == N - 1:
        rep = ((result_len == 0)
               | (seek_delta < TICKS_PER_SECOND * CHUNK_SIZE // 2))
        failed = failed | (live2 & rep)
    return has_ts, seek_delta, result_len, completed, failed


def check_cross_mode(cfg: LoopConfig) -> None:
    if cfg.cross_mode not in CROSS_MODES:
        raise ValueError(f"unknown cross_mode {cfg.cross_mode!r} (have "
                         f"{CROSS_MODES})")


def prompt_mask(pad_len: torch.Tensor, P: int):
    """(positions (B, P), additive causal + pad mask (B, 1, P, P)) of a
    LEFT-padded prompt buffer.  Pad queries keep one valid key
    (themselves): a fully masked softmax row is NaN and would poison later
    layers' K/V."""
    idx = torch.arange(P, device=pad_len.device)
    positions = torch.clamp_min(idx[None, :] - pad_len[:, None], 0)
    q = idx[None, :, None]
    k = idx[None, None, :]
    valid = (k <= q) & ((k >= pad_len[:, None, None]) | (k == q))
    return positions, torch.where(valid, 0.0, float("-inf"))[:, None]


def prompt_cross_kv(cross_mode: str, k_cross, v_cross):
    """decode_prompt's form of the window's cross-KV: the dense stack as
    it is, (codes, scales) pairs tagged "q8" or "q4"."""
    if isinstance(k_cross, torch.Tensor):
        return k_cross, v_cross
    if cross_mode not in QUANT_TAGS:
        raise ValueError(f"pre-quantized cross-KV needs a q8/q4 "
                         f"cross_mode, got {cross_mode!r}")
    tag = "q4" if cross_mode == "einsum_q4" else "q8"
    return (tag,) + tuple(k_cross), (tag,) + tuple(v_cross)


def draw_or_argmax(probs, logprobs, temperature: float, keys):
    """The token of each row: the argmax of probs at t < 1e-6, else a
    categorical draw from logprobs under a split of `keys` ((2,): one
    stream over the rows; (B, 2): a stream a row, as jax.vmap), as
    whisper_tpu's `sample`.  -> (tokens (B,) int32, the advanced keys)."""
    if temperature < 1e-6:
        return torch.argmax(probs, dim=-1).to(torch.int32), keys
    pairs = rng.split(keys)
    drawn = rng.categorical(pairs[..., 1, :], logprobs)
    return drawn.to(torch.int32), pairs[..., 0, :]


def token_data(tok, probs, logprobs, consts: FilterConsts):
    """(p, plog, tid, pt, ptsum) of each row's token; a sampled timestamp
    token overrides tid and pt (whisper.cpp:5348)."""
    rows = torch.arange(tok.shape[0], device=tok.device)
    p = probs[rows, tok]
    plog = logprobs[rows, tok]
    tid, pt, ptsum = sample_token_data(probs, logprobs, consts)
    is_ts = tok >= consts.token_beg
    tid = torch.where(is_ts, tok, tid.to(torch.int32))
    pt = torch.where(is_ts, p, pt)
    return p, plog, tid, pt, ptsum


def make_decode_window(*, consts: FilterConsts, options: FilterOptions,
                       cfg: LoopConfig, extra_suppress: tuple = (),
                       device: str | torch.device = "cuda"):
    """Build the window-decode function (whisper_tpu's "greedy" strategy:
    argmax at t = 0, a multinomial draw at t > 0), its logit filters on
    `device`.  Beam search is decode/beam.py."""
    check_cross_mode(cfg)
    process_logits = make_process_logits(consts, options, extra_suppress,
                                         device)
    P = cfg.prompt_size
    N = cfg.max_tokens_loop
    token_beg = consts.token_beg
    token_eot = consts.token_eot
    cd = cfg.compute_dtype

    @torch.no_grad()
    def decode_window(params, k_cross, v_cross, prompt, pad_len,
                      temperature, seek, seek_end, rng_key=None,
                      row_live=None):
        """Run one full window decode.

        k_cross/v_cross: dense (L,B,H,Dh,Ta) from cross_kv, or for the
        quantized modes the (codes, scales (L,B,H,Ta)) pairs of
        cross_kv_q8 (int8 (L,B,H,Dh,Ta)) or, for "einsum_q4", cross_kv_q4
        (uint8 (L,B,H,Dh/2,Ta)), whose bf16 stack never exists.
        prompt: (B, P) int — LEFT-padded prompt (pad value irrelevant)
        pad_len: (B,) int — number of pad slots at the start of each row
        temperature: a float; at t >= 1e-6 each token is drawn from
        rng_key's stream, at t = 0 it is the argmax (rng_key unused)
        seek/seek_end: (B,) or scalar ticks
        rng_key: uint32 key words, (2,) (one stream over the batch) or
        (B, 2) (a stream a row: draws independent of the row's slot), as
        whisper_tpu's window_rng gives them
        row_live: optional (B,) bool — rows marked dead start completed
        Returns a dict of numpy result arrays + no_speech_prob.
        """
        temperature = float(np.float32(temperature))
        prequant = not isinstance(k_cross, torch.Tensor)
        kc_p, vc_p = prompt_cross_kv(cfg.cross_mode, k_cross, v_cross)
        L, _, H, Dh, _ = (k_cross[0] if prequant else k_cross).shape
        if prequant and cfg.cross_mode == "einsum_q4":
            Dh *= 2   # codes are nibble-packed along Dh
        dev = (k_cross[0] if prequant else k_cross).device

        def dev_tensor(a, dtype):
            host = torch.as_tensor(np.asarray(a))
            if dev.type == "cuda":
                # from pinned memory the copy is queued, not waited for
                host = host.pin_memory()
            return host.to(dev, non_blocking=True).to(dtype)

        prompt = dev_tensor(prompt, torch.long)
        B = prompt.shape[0]
        pad_len = dev_tensor(pad_len, torch.long)
        seek = dev_tensor(seek, torch.int32).expand(B)
        seek_end = dev_tensor(seek_end, torch.int32).expand(B)
        keys = None if temperature < 1e-6 else rng.as_key(rng_key, dev)
        C = P + N + 1

        # ---- prompt processing -------------------------------------------
        positions, mask = prompt_mask(pad_len, P)
        logits_all, k_self, v_self = wm.decode_prompt(
            params, prompt, positions, kc_p, vc_p, cfg.n_head,
            self_mask=mask, compute_dtype=cd)
        logits0 = logits_all[:, -1]
        del logits_all

        # no-speech probability from the raw first logits
        # (reference: src/whisper.cpp:5812-5820)
        no_speech_prob = torch.softmax(logits0, dim=-1)[:, consts.token_nosp]

        kc_loop, vc_loop = loop_cross_kv(cfg.cross_mode, k_cross, v_cross,
                                         cd)

        # self-KV cache (L, B, H, Dh, C); slots [0, P) hold the prompt.  On
        # a mesh B and H are this rank's rows and heads (the prompt rows
        # and the cross-KV it was given)
        kv_k = torch.zeros((L, B, H, Dh, C), dtype=cd, device=dev)
        kv_v = torch.zeros((L, B, H, Dh, C), dtype=cd, device=dev)
        kv_k[..., :P] = k_self.permute(0, 1, 3, 4, 2).to(cd)
        kv_v[..., :P] = v_self.permute(0, 1, 3, 4, 2).to(cd)
        del k_self, v_self
        kv = {"k": kv_k, "v": kv_v}

        false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
        true_b = torch.ones((B,), dtype=torch.bool, device=dev)
        dead = false_b if row_live is None else ~dev_tensor(row_live,
                                                            torch.bool)
        zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
        lg, lp, pr = process_logits(
            logits0, temperature, is_initial=true_b, last_was_ts=false_b,
            penult_was_ts=true_b, has_ts=false_b, seek_delta=zeros_i)

        tokens = torch.full((B, N), token_eot, dtype=torch.int32, device=dev)
        p_arr = torch.zeros((B, N), device=dev)
        plog_arr = torch.zeros((B, N), device=dev)
        tid_arr = torch.zeros((B, N), dtype=torch.int32, device=dev)
        pt_arr = torch.zeros((B, N), device=dev)
        ptsum_arr = torch.zeros((B, N), device=dev)
        # last_was_ts=True: its first USE is as next step's penultimate
        # flag, which must be true while size < 2 (reference: whisper.cpp:5133)
        last_was_ts = true_b
        penult_was_ts = true_b
        has_ts = false_b
        seek_delta = torch.full((B,), TICKS_PER_SECOND * CHUNK_SIZE,
                                dtype=torch.int32, device=dev)
        result_len = zeros_i
        sum_lp = torch.zeros((B,), device=dev)
        completed = dead
        failed = false_b

        i = 0
        with TRACE.span("wait"):    # one host read a token
            done = bool(torch.all(completed | failed))
        # token i: its logits (a decode step past the first token), the
        # draw, the bookkeeping; the next token's logits are skipped when
        # every row is done
        while i < N and not done:
            with TRACE.span("step") if i else contextlib.nullcontext():
                if i:
                    pos_ids = torch.clamp_max(P - pad_len + (i - 1),
                                              cfg.n_text_ctx - 1)
                    lg_raw, kv = wm.decode_step(
                        params, tok, pos_ids, P + i - 1, kv, kc_loop,
                        vc_loop, kv_len=P + i, n_head=cfg.n_head,
                        pad_len=pad_len, compute_dtype=cd)

                    penult_was_ts = torch.where(live, last_was_ts,
                                                penult_was_ts)
                    last_was_ts = torch.where(live, tok >= token_beg,
                                              last_was_ts)

                    lg, lp, pr = process_logits(
                        lg_raw, temperature, is_initial=false_b,
                        last_was_ts=last_was_ts, penult_was_ts=penult_was_ts,
                        has_ts=has_ts, seek_delta=seek_delta)
                live = ~(completed | failed)

                tok, keys = draw_or_argmax(pr, lp, temperature, keys)
                p, plog, tid, pt, ptsum = token_data(tok, pr, lp, consts)

                tokens[:, i] = torch.where(live, tok, tokens[:, i])
                p_arr[:, i] = torch.where(live, p, 0.0)
                plog_arr[:, i] = torch.where(live, plog, 0.0)
                tid_arr[:, i] = torch.where(live, tid, 0)
                pt_arr[:, i] = torch.where(live, pt, 0.0)
                ptsum_arr[:, i] = torch.where(live, ptsum, 0.0)
                sum_lp = sum_lp + torch.where(live, plog, 0.0)

                has_ts, seek_delta, result_len, completed, failed = \
                    token_state_update(
                        consts, cfg, i=i, tok=tok, live=live, has_ts=has_ts,
                        seek_delta=seek_delta, result_len=result_len,
                        completed=completed, failed=failed,
                        seek=seek, seek_end=seek_end, N=N)

            i += 1
            with TRACE.span("wait"):
                done = bool(torch.all(completed | failed))

        out = {
            "tokens": tokens, "p": p_arr, "plog": plog_arr, "tid": tid_arr,
            "pt": pt_arr, "ptsum": ptsum_arr,
            "has_ts": has_ts, "seek_delta": seek_delta,
            "result_len": result_len, "sum_logprobs_all": sum_lp,
            "completed": completed, "failed": failed,
            "no_speech_prob": no_speech_prob,
        }
        with TRACE.span("wait"):
            res = {key: val.cpu().numpy() for key, val in out.items()}
        res["n_tokens"] = np.int32(i)
        return res

    return decode_window
