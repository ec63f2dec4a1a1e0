"""Beam search over a window (port of whisper_tpu.decode.beam).

The reference (src/whisper.cpp:5885-5977) keeps up to beam_size decoder
slots, draws candidates per live decoder, sorts them by cumulative
log-prob and shuffles KV cells between slots.  As in whisper_tpu, the
beams here are a dense leading row axis: each step scores all beam x vocab
continuations, takes a top-k over the live beams, and reorders every
per-row tensor (the self-KV cache included) with one gather on the row
axis.  Finished beams keep their slot and contribute no candidates; live
slots take the top-k candidates in rank order.  At t = 0 the candidates
are the top-k by score; at t > 0 each expanding beam draws K candidates
from JAX's threefry stream (decode/rng.py), duplicates collapse, and the
top-k runs over the drawn set only.

One function serves both whisper_tpu forms:
  * the serial beam of `full` (make_beam_decode_window): one stream of K
    beams, the window's cross-KV broadcast to K rows and read by the
    einsum as whisper_tpu's serial beam reads it, one (2,) key;
  * the batched beam of the serving path
    (make_batched_beam_decode_window): S streams x K beams as R = S*K rows,
    row s*K + k beam k of stream s, the cross-KV kept at S rows and read
    by the K beams of a stream as K queries (decode_step group=K: K2 with
    G = K in "einsum_q8"), a per-stream top-k, (S, 2) per-stream keys.
At S = 1 the two draw and rank the same candidates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CHUNK_SIZE, TICKS_PER_SECOND
from ..models import whisper as wm
from . import rng
from .filters import FilterConsts, FilterOptions, make_process_logits
from .loop import (LoopConfig, check_cross_mode, loop_cross_kv,
                   prompt_cross_kv, prompt_mask, token_data,
                   token_state_update)

NEG_INF = float("-inf")
# the quantized cross modes whose step takes K queries a cross-KV row;
# whisper_tpu's batched beam refuses a pre-quantized cross-KV in any other
# and reads a dense one with the einsum
GROUPED_QUANT_MODES = ("einsum_q8", "einsum_q8i", "einsum_q4")


def _top_k(scores: torch.Tensor, k: int):
    """jax.lax.top_k over the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _make_window(*, consts: FilterConsts, options: FilterOptions,
                 cfg: LoopConfig, n_streams: int, beam_size: int,
                 grouped: bool, extra_suppress: tuple, device):
    check_cross_mode(cfg)
    process_logits = make_process_logits(consts, options, extra_suppress,
                                         device)
    P = cfg.prompt_size
    N = cfg.max_tokens_loop
    S, K = n_streams, beam_size
    R = S * K
    V = consts.n_vocab
    token_beg = consts.token_beg
    cd = cfg.compute_dtype

    @torch.no_grad()
    def decode_window(params, k_cross, v_cross, prompt, pad_len,
                      temperature, seeks, ends, rng_keys, row_live=None):
        """grouped: per-stream inputs (prompt (S, P), pad_len, seeks, ends,
        row_live (S,), rng_keys (S, 2)) and cross-KV rows, per-row outputs
        (R rows, no_speech_prob repeated to rows).  Serial: prompt (K, P)
        of K copies, the cross-KV at K rows, scalar seek/end, one (2,)
        key.  Returns a dict of numpy result arrays."""
        temperature = float(np.float32(temperature))
        prequant = not isinstance(k_cross, torch.Tensor)
        if prequant and not (grouped
                             and cfg.cross_mode in GROUPED_QUANT_MODES):
            raise ValueError(f"beam search over a pre-quantized cross-KV "
                             f"needs the batched window and an einsum "
                             f"cross_mode, got {cfg.cross_mode!r}")
        kc_p, vc_p = prompt_cross_kv(cfg.cross_mode, k_cross, v_cross)
        L, _, H, Dh, _ = (k_cross[0] if prequant else k_cross).shape
        if prequant and cfg.cross_mode == "einsum_q4":
            Dh *= 2   # codes are nibble-packed along Dh
        dev = (k_cross[0] if prequant else k_cross).device

        def dev_tensor(a, dtype):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        prompt = dev_tensor(prompt, torch.long)
        n_prompt = prompt.shape[0]          # S (grouped) or K (serial)
        rep = R // n_prompt                 # rows a prompt row becomes
        pad_len = dev_tensor(pad_len, torch.long).expand(n_prompt)
        seeks = dev_tensor(seeks, torch.int32).expand(n_prompt)
        ends = dev_tensor(ends, torch.int32).expand(n_prompt)
        keys = (None if temperature < 1e-6
                else rng.as_key(rng_keys, dev).reshape(S, 2))
        C = P + N + 1

        # ---- the prompt pass, at S rows when grouped ----------------------
        positions, mask = prompt_mask(pad_len, P)
        logits_all, k_self, v_self = wm.decode_prompt(
            params, prompt, positions, kc_p, vc_p, cfg.n_head,
            self_mask=mask, compute_dtype=cd)
        logits0 = logits_all[:, -1]
        del logits_all
        no_speech_prob = torch.softmax(logits0, dim=-1)[:, consts.token_nosp]

        if grouped and cfg.cross_mode in GROUPED_QUANT_MODES:
            kc_loop, vc_loop = loop_cross_kv(cfg.cross_mode, k_cross,
                                             v_cross, cd)
        else:   # the dense rows through the einsum, as whisper_tpu reads them
            kc_loop, vc_loop = k_cross, v_cross

        def rows(x):
            return x.repeat_interleave(rep, dim=0) if rep > 1 else x

        kv_k = torch.zeros((L, R, H, Dh, C), dtype=cd, device=dev)
        kv_v = torch.zeros((L, R, H, Dh, C), dtype=cd, device=dev)
        kv_k[..., :P] = k_self.permute(0, 1, 3, 4, 2).to(cd).repeat_interleave(
            rep, dim=1)
        kv_v[..., :P] = v_self.permute(0, 1, 3, 4, 2).to(cd).repeat_interleave(
            rep, dim=1)
        del k_self, v_self
        pad_r, seeks_r, ends_r = rows(pad_len), rows(seeks), rows(ends)

        false_r = torch.zeros((R,), dtype=torch.bool, device=dev)
        true_r = torch.ones((R,), dtype=torch.bool, device=dev)
        dead = (false_r if row_live is None
                else rows(~dev_tensor(row_live, torch.bool)))
        zeros_i = torch.zeros((R,), dtype=torch.int32, device=dev)
        _, lp, pr = process_logits(
            rows(logits0), temperature, is_initial=true_r,
            last_was_ts=false_r, penult_was_ts=true_r, has_ts=false_r,
            seek_delta=zeros_i)

        tokens = torch.full((R, N), consts.token_eot, dtype=torch.int32,
                            device=dev)
        p_arr = torch.zeros((R, N), device=dev)
        plog_arr = torch.zeros((R, N), device=dev)
        tid_arr = torch.zeros((R, N), dtype=torch.int32, device=dev)
        pt_arr = torch.zeros((R, N), device=dev)
        ptsum_arr = torch.zeros((R, N), device=dev)
        # True so the i = 0 penultimate flag (size < 2) is right
        last_was_ts = true_r
        penult_was_ts = true_r
        has_ts = false_r
        seek_delta = torch.full((R,), TICKS_PER_SECOND * CHUNK_SIZE,
                                dtype=torch.int32, device=dev)
        result_len = zeros_i
        cum = torch.zeros((R,), device=dev)      # sum_logprobs_all
        completed = dead
        failed = false_r
        row_ids = torch.arange(R, device=dev)
        # at step 0 a stream's beams are copies: only its beam 0 expands
        first_beam = (row_ids % K) == 0
        stream_base = (torch.arange(S, device=dev) * K)[:, None]

        i = 0
        done = bool(torch.all(completed | failed))   # one host read a token
        while i < N and not done:
            live = ~(completed | failed)
            expand = live & first_beam if i == 0 else live

            # ---- candidate scores over (R, V) ----------------------------
            scores = cum[:, None] + lp
            scores = torch.where(expand[:, None], scores, NEG_INF)
            if temperature >= 1e-6:
                # each expanding beam draws K candidates from its stream's
                # key (whisper.cpp:5357-5430); only drawn (beam, token)
                # cells keep their score, so duplicates collapse
                pairs = rng.split(keys)                       # (S, 2, 2)
                keys = pairs[:, 0]
                drawn = rng.categorical(pairs[:, 1], lp.reshape(S, K, V),
                                        (K, K)).transpose(1, 2)   # (S, K, K)
                drawn_mask = torch.zeros((R, V), dtype=torch.bool,
                                         device=dev)
                drawn_mask[row_ids[:, None], drawn.reshape(R, K)] = True
                scores = torch.where(drawn_mask, scores, NEG_INF)

            # a top-k over each stream's K * V continuations
            top_vals, top_idx = _top_k(scores.reshape(S, K * V), K)
            cand_parent = (top_idx // V + stream_base).reshape(R)
            cand_tok = (top_idx % V).to(torch.int32).reshape(R)
            cand_val = top_vals.reshape(R)

            # live slots take the candidates in rank order within their
            # stream; the others keep their own row
            slot_rank = torch.cumsum(live.reshape(S, K).to(torch.int32),
                                     dim=1) - 1
            rank_glob = (torch.clamp(slot_rank, 0, K - 1)
                         + stream_base).reshape(R)
            parent = torch.where(live, cand_parent[rank_glob], row_ids)
            tok = torch.where(live, cand_tok[rank_glob],
                              tokens[:, max(i - 1, 0)])
            cum = torch.where(live, cand_val[rank_glob], cum)

            # ---- the parents' state into every slot: index_select makes
            # fresh tensors, so no slot reads a row another slot rewrote
            tokens, p_arr, plog_arr, tid_arr, pt_arr, ptsum_arr, \
                has_ts, seek_delta, result_len, last_was_ts_p, pr, lp = (
                    x.index_select(0, parent) for x in (
                        tokens, p_arr, plog_arr, tid_arr, pt_arr, ptsum_arr,
                        has_ts, seek_delta, result_len, last_was_ts, pr, lp))
            kv = {"k": kv_k.index_select(1, parent),
                  "v": kv_v.index_select(1, parent)}
            del kv_k, kv_v

            # ---- record the token ----------------------------------------
            p, plog, tid, pt, ptsum = token_data(tok, pr, lp, consts)
            tokens[:, i] = torch.where(live, tok, tokens[:, i])
            p_arr[:, i] = torch.where(live, p, 0.0)
            plog_arr[:, i] = torch.where(live, plog, 0.0)
            tid_arr[:, i] = torch.where(live, tid, 0)
            pt_arr[:, i] = torch.where(live, pt, 0.0)
            ptsum_arr[:, i] = torch.where(live, ptsum, 0.0)

            has_ts, seek_delta, result_len, completed, failed = \
                token_state_update(
                    consts, cfg, i=i, tok=tok, live=live, has_ts=has_ts,
                    seek_delta=seek_delta, result_len=result_len,
                    completed=completed, failed=failed,
                    seek=seeks_r, seek_end=ends_r, N=N)

            i += 1
            done = bool(torch.all(completed | failed))
            kv_k, kv_v = kv["k"], kv["v"]
            if i >= N or done:
                break
            pos_ids = torch.clamp_max(P - pad_r + (i - 1), cfg.n_text_ctx - 1)
            lg_raw, kv = wm.decode_step(
                params, tok, pos_ids, P + i - 1, kv, kc_loop, vc_loop,
                kv_len=P + i, n_head=cfg.n_head, pad_len=pad_r,
                compute_dtype=cd, group=K if grouped else 1)
            kv_k, kv_v = kv["k"], kv["v"]

            penult_was_ts = torch.where(live, last_was_ts_p, penult_was_ts)
            last_was_ts = torch.where(live, tok >= token_beg, last_was_ts)
            _, lp, pr = process_logits(
                lg_raw, temperature, is_initial=false_r,
                last_was_ts=last_was_ts, penult_was_ts=penult_was_ts,
                has_ts=has_ts, seek_delta=seek_delta)

        out = {
            "tokens": tokens, "p": p_arr, "plog": plog_arr, "tid": tid_arr,
            "pt": pt_arr, "ptsum": ptsum_arr,
            "has_ts": has_ts, "seek_delta": seek_delta,
            "result_len": result_len, "sum_logprobs_all": cum,
            "completed": completed, "failed": failed,
            # at rows, so the host ranks stream s over rows [s*K, (s+1)*K)
            "no_speech_prob": rows(no_speech_prob),
        }
        res = {key: val.cpu().numpy() for key, val in out.items()}
        res["n_tokens"] = np.int32(i)
        return res

    return decode_window


def make_beam_decode_window(*, consts: FilterConsts, options: FilterOptions,
                            cfg: LoopConfig, beam_size: int,
                            extra_suppress: tuple = (),
                            device: str | torch.device = "cuda"):
    """The serial beam window of `full`, B = beam_size rows:
    fn(params, k_cross, v_cross, prompt (B, P), pad_len (B,), temperature,
    seek, seek_end, rng_key (2,)), k_cross/v_cross the window's dense
    (L, B, H, Dh, Ta) cross-KV (broadcast from batch 1), read by the
    einsum in every cross mode, as whisper_tpu's serial beam reads it."""
    return _make_window(consts=consts, options=options, cfg=cfg, n_streams=1,
                        beam_size=beam_size, grouped=False,
                        extra_suppress=extra_suppress, device=device)


def make_batched_beam_decode_window(*, consts: FilterConsts,
                                    options: FilterOptions, cfg: LoopConfig,
                                    n_streams: int, beam_size: int,
                                    extra_suppress: tuple = (),
                                    device: str | torch.device = "cuda"):
    """S = n_streams streams x K = beam_size beams in one batch:
    fn(params, k_cross, v_cross, prompt (S, P), pad_len (S,), temperature,
    seeks (S,), ends (S,), rng_keys (S, 2), row_live (S,)), the cross-KV at
    S rows (the (codes, scales) pairs of cross_kv_q8 / cross_kv_q4 in the
    quantized modes; a pre-quantized cross-KV needs an einsum mode, as in
    whisper_tpu).  Outputs are per row, stream s at rows [s*K, (s+1)*K)."""
    return _make_window(consts=consts, options=options, cfg=cfg,
                        n_streams=n_streams, beam_size=beam_size,
                        grouped=True, extra_suppress=extra_suppress,
                        device=device)
