"""Window decode loop (port of whisper_tpu.decode.loop, greedy at t=0).

One window decode: the prompt pass, then token sampling, the logit-filter
chain, the timestamp/sliding-window state update and the stop conditions,
per token.  The JAX package runs this as one `lax.while_loop` on device;
here it is a Python loop over static KV buffers that stops when every row
is completed or failed (one host read of that flag per token).

Variable-length prompts are LEFT-padded inside a fixed prompt buffer: pad
slots are masked out of attention and position ids are shifted, so the
math matches a dense prompt decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import CHUNK_SIZE, TICKS_PER_SECOND
from ..models import whisper as wm
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
    # cross-attention path of the token loop; the port has "einsum_q8"
    # (int8 cross-KV, through K2 on the card)
    cross_mode: str = "einsum_q8"


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


def make_decode_window(*, consts: FilterConsts, options: FilterOptions,
                       cfg: LoopConfig, strategy: str = "greedy",
                       extra_suppress: tuple = (),
                       device: str | torch.device = "cpu"):
    """Build the window-decode function (greedy at temperature 0)."""
    if strategy != "greedy":
        raise NotImplementedError(f"decode strategy {strategy!r} is not "
                                  "ported (greedy only)")
    if cfg.cross_mode != "einsum_q8":
        raise NotImplementedError(f"cross_mode {cfg.cross_mode!r} is not "
                                  "ported (einsum_q8 only)")
    process_logits = make_process_logits(consts, options, extra_suppress,
                                         device)
    P = cfg.prompt_size
    N = cfg.max_tokens_loop
    token_beg = consts.token_beg
    token_eot = consts.token_eot
    cd = cfg.compute_dtype

    @torch.no_grad()
    def decode_window(params, k_cross, v_cross, prompt, pad_len,
                      temperature, seek, seek_end, row_live=None):
        """Run one full window decode.

        k_cross/v_cross: (codes int8 (L,B,H,Dh,Ta), scales f32 (L,B,H,Ta))
        pairs from cross_kv_q8.
        prompt: (B, P) int — LEFT-padded prompt (pad value irrelevant)
        pad_len: (B,) int — number of pad slots at the start of each row
        temperature: must be 0 (greedy); sampled draws need JAX's threefry
        stream, which is not ported
        seek/seek_end: (B,) or scalar ticks
        row_live: optional (B,) bool — rows marked dead start completed
        Returns a dict of numpy result arrays + no_speech_prob.
        """
        if float(temperature) > 0.0:
            raise NotImplementedError(
                "sampling at temperature > 0 is not ported (it needs JAX's "
                "threefry draws to match the reference)")
        temperature = 0.0
        (kq, ks), (vq, vs) = k_cross, v_cross
        L, _, H, Dh, _ = kq.shape
        dev = kq.device

        def dev_tensor(a, dtype):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        prompt = dev_tensor(prompt, torch.long)
        B = prompt.shape[0]
        pad_len = dev_tensor(pad_len, torch.long)
        seek = dev_tensor(seek, torch.int32).expand(B)
        seek_end = dev_tensor(seek_end, torch.int32).expand(B)
        C = P + N + 1

        # ---- prompt processing -------------------------------------------
        idx = torch.arange(P, device=dev)
        positions = torch.clamp_min(idx[None, :] - pad_len[:, None], 0)
        q = idx[None, :, None]
        k = idx[None, None, :]
        # pad queries keep one valid key (themselves): a fully masked
        # softmax row is NaN and would poison later layers' K/V
        valid = (k <= q) & ((k >= pad_len[:, None, None]) | (k == q))
        mask = torch.where(valid, 0.0, float("-inf"))[:, None]

        logits_all, k_self, v_self = wm.decode_prompt(
            params, prompt, positions, ("q8", kq, ks), ("q8", vq, vs),
            cfg.n_head, self_mask=mask, compute_dtype=cd)
        logits0 = logits_all[:, -1]
        del logits_all

        # no-speech probability from the raw first logits
        # (reference: src/whisper.cpp:5812-5820)
        no_speech_prob = torch.softmax(logits0, dim=-1)[:, consts.token_nosp]

        kc_loop = ("q8e", kq, ks)
        vc_loop = ("q8e", vq, vs)

        # self-KV cache (L, B, H, Dh, C); slots [0, P) hold the prompt
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
        rows = torch.arange(B, device=dev)

        i = 0
        done = bool(torch.all(completed | failed))   # one host read a token
        while i < N and not done:
            live = ~(completed | failed)

            tok = torch.argmax(pr, dim=-1).to(torch.int32)
            p = pr[rows, tok]
            plog = lp[rows, tok]
            tid, pt, ptsum = sample_token_data(pr, lp, consts)
            # a sampled timestamp token overrides tid/pt (whisper.cpp:5348)
            is_ts = tok >= token_beg
            tid = torch.where(is_ts, tok, tid.to(torch.int32))
            pt = torch.where(is_ts, p, pt)

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
            # the next token's logits are skipped when everyone is done
            done = bool(torch.all(completed | failed))
            if i >= N or done:
                break
            pos_ids = torch.clamp_max(P - pad_len + (i - 1),
                                      cfg.n_text_ctx - 1)
            lg_raw, kv = wm.decode_step(
                params, tok, pos_ids, P + i - 1, kv, kc_loop, vc_loop,
                kv_len=P + i, n_head=cfg.n_head, pad_len=pad_len,
                compute_dtype=cd)

            penult_was_ts = torch.where(live, last_was_ts, penult_was_ts)
            last_was_ts = torch.where(live, tok >= token_beg, last_was_ts)

            lg, lp, pr = process_logits(
                lg_raw, temperature, is_initial=false_b,
                last_was_ts=last_was_ts, penult_was_ts=penult_was_ts,
                has_ts=has_ts, seek_delta=seek_delta)

        out = {
            "tokens": tokens, "p": p_arr, "plog": plog_arr, "tid": tid_arr,
            "pt": pt_arr, "ptsum": ptsum_arr,
            "has_ts": has_ts, "seek_delta": seek_delta,
            "result_len": result_len, "sum_logprobs_all": sum_lp,
            "completed": completed, "failed": failed,
            "no_speech_prob": no_speech_prob,
        }
        res = {key: val.cpu().numpy() for key, val in out.items()}
        res["n_tokens"] = np.int32(i)
        return res

    return decode_window
