"""Host-stepped beam search with per-beam grammar state (port of
whisper_tpu.decode.host_beam).

The device beam (beam.py) filters and expands on the device and cannot
consult host-side GBNF state.  This path provides the reference's
beam-search + grammar combination (reference: src/whisper.cpp:5925-5977 —
grammar suppression applied per decoder each step, then
whisper_grammar_accept_token on the sampled token; beam bookkeeping
:5357-5430): the B-beam token step is ONE batched device call per token
(the reference pays one graph per decoder), while the logit-filter chain,
grammar masks and beam expansion run on the host.  Grammar states fork
with their parent beam via Grammar.copy() (native engine clone).

Expansion semantics mirror decode/beam.py exactly (deterministic top-k over
cum + logprob, candidates assigned to live slots in rank order, only slot 0
expands at i == 0), so beam_size=1 degenerates to greedy and the grammar
masks match the greedy oracle for identical prefixes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import CHUNK_SIZE, TICKS_PER_SECOND
from .filters import FilterConsts
from .host_filters import process_logits_host
from .loop import DELTA_MIN


def decode_window_host_beam(ctx, prompt, kc, vc, t_cur, seek, seek_end,
                            params, opts, no_timestamps, grammar,
                            beam_size: int, seed: int = 0):
    """Beam-search one window with host-applied grammar/logit filters.

    kc/vc: the window's dense (L, 1 or B, H, Dh, Ta) cross-KV, read
    through the einsum whatever the cross mode, as whisper_tpu's host loop
    does.  Returns the same result dict as the window loop, with
    beam_size rows (full() ranks them like any multi-decoder result).
    At t_cur > 0 candidate tokens are drawn multinomially per expanding
    beam instead of deterministic top-k, like the reference's
    whisper_sample_token_topk (src/whisper.cpp:5357-5430); `seed` makes
    the draws reproducible per ladder rung.
    """
    B = beam_size
    rng = np.random.RandomState(seed * 7919 + 13)
    vocab = ctx.vocab
    consts = FilterConsts.from_vocab(vocab, ctx.hparams.n_audio_ctx)
    prompt_fn, step_fn = ctx._prompt_step_fns()
    N = ctx.hparams.n_text_ctx // 2 - 4
    if params.max_tokens > 0:
        N = min(N, params.max_tokens + 1)
    P = len(prompt)
    C = P + N + 1
    L, H, Dh = (ctx.config.n_text_layer, ctx.config.n_text_head,
                ctx.config.head_dim_text)
    dev = ctx.device
    cd = ctx.compute_dtype
    timings = ctx.timings

    if kc.shape[1] == 1 and B > 1:
        kc = kc.expand((kc.shape[0], B) + kc.shape[2:])
        vc = vc.expand((vc.shape[0], B) + vc.shape[2:])

    logits0, ks, vs = prompt_fn(
        ctx.params, torch.tensor([prompt] * B, dtype=torch.long, device=dev),
        kc, vc)
    raw = logits0[:, -1].float().cpu().numpy()          # (B, V)
    del logits0
    lp0 = np.exp(raw[0] - raw[0].max())
    no_speech_prob = float((lp0 / lp0.sum())[vocab.token_nosp])

    kv = {"k": torch.zeros((L, B, H, Dh, C), dtype=cd, device=dev),
          "v": torch.zeros((L, B, H, Dh, C), dtype=cd, device=dev)}
    kv["k"][..., :P] = ks.permute(0, 1, 3, 4, 2).to(cd)
    kv["v"][..., :P] = vs.permute(0, 1, 3, 4, 2).to(cd)
    del ks, vs

    # per-beam host state
    tokens = [[] for _ in range(B)]
    p_a = [[] for _ in range(B)]
    plog_a = [[] for _ in range(B)]
    tid_a = [[] for _ in range(B)]
    pt_a = [[] for _ in range(B)]
    ptsum_a = [[] for _ in range(B)]
    has_ts = [False] * B
    seek_delta = [TICKS_PER_SECOND * CHUNK_SIZE] * B
    result_len = [0] * B
    completed = [False] * B
    failed = [False] * B
    cum = [0.0] * B
    grams = [grammar.copy() if grammar is not None else None
             for _ in range(B)]

    n_steps = 0
    for i in range(N):
        live = [not (completed[b] or failed[b]) for b in range(B)]
        if not any(live):
            break
        n_steps = i + 1

        # ---- filter chain + grammar per live beam ------------------------
        lps = [None] * B
        prs = [None] * B
        for b in range(B):
            if not live[b]:
                continue
            t0 = time.perf_counter()
            _, lps[b], prs[b] = process_logits_host(
                raw[b], consts, opts, temperature=t_cur,
                tokens_cur=tokens[b], has_ts=has_ts[b],
                seek_delta=seek_delta[b] if has_ts[b] else 0,
                grammar=grams[b], vocab=vocab,
                grammar_penalty=params.grammar_penalty,
                suppress_regex=params.suppress_regex,
                logits_filter_callback=params.logits_filter_callback)
            timings.t_grammar_us += int((time.perf_counter() - t0) * 1e6)
            timings.n_grammar += 1

        # ---- expansion: top-B candidates over (expand beams x V) ---------
        V = raw.shape[1]
        scores = np.full((B, V), -np.inf, np.float64)
        for b in range(B):
            if live[b] and (i > 0 or b == 0):   # only slot 0 expands at i==0
                scores[b] = cum[b] + lps[b]
        flat = scores.reshape(-1)
        live_slots = [b for b in range(B) if live[b]]
        if t_cur > 0.0:
            # multinomial candidate draws per expanding beam (the
            # reference keeps BEAM_SEARCH sampling at t > 0 with
            # stochastic top-k; whisper.cpp:5882-5890)
            draws = max(2, int(params.beam_search.beam_size))
            cand_ids: set[int] = set()
            for b in range(B):
                if live[b] and (i > 0 or b == 0):
                    pr = np.asarray(prs[b], np.float64).clip(0)
                    s = pr.sum()
                    if s > 0:
                        toks = rng.choice(len(pr), size=draws, p=pr / s)
                        cand_ids.update(b * V + int(t) for t in toks)
            top = (np.fromiter(cand_ids, np.int64)
                   if cand_ids else np.empty((0,), np.int64))
            top = top[np.argsort(flat[top])[::-1]][:B]
            if len(top) < len(live_slots):
                # dedup can leave fewer candidates than slots to fill;
                # complete from the deterministic order
                extra = [c for c in np.argsort(flat)[::-1]
                         if c not in set(top.tolist())]
                top = np.concatenate(
                    [top, np.asarray(extra[:len(live_slots) - len(top)],
                                     np.int64)])
        else:
            top = np.argsort(flat)[::-1][:B]    # deterministic top-k

        parent_full = list(range(B))
        tok_full = [tokens[b][-1] if tokens[b] else consts.token_eot
                    for b in range(B)]
        new_state = {}
        for r, slot in enumerate(live_slots):
            cand = top[r]
            pb, tok = int(cand // V), int(cand % V)
            parent_full[slot] = pb
            tok_full[slot] = tok
            pr, lp = prs[pb], lps[pb]
            ts_probs = pr[consts.token_beg:]
            ptsum = float(ts_probs.sum())
            tid = int(np.argmax(ts_probs)) + consts.token_beg
            pt = float(ts_probs.max() / (ptsum + 1e-10))
            if tok >= consts.token_beg:
                tid, pt = tok, float(pr[tok])
            g = grams[pb].copy() if grams[pb] is not None else None
            if g is not None:
                g.accept_token(vocab, tok)
            new_state[slot] = dict(
                tokens=tokens[pb] + [tok],
                p=p_a[pb] + [float(pr[tok])],
                plog=plog_a[pb] + [float(lp[tok])],
                tid=tid_a[pb] + [tid], pt=pt_a[pb] + [pt],
                ptsum=ptsum_a[pb] + [ptsum],
                cum=float(scores[pb, tok]),
                has_ts=has_ts[pb], seek_delta=seek_delta[pb],
                result_len=result_len[pb], gram=g)

        for slot, st in new_state.items():
            tokens[slot] = st["tokens"]
            p_a[slot] = st["p"]; plog_a[slot] = st["plog"]
            tid_a[slot] = st["tid"]; pt_a[slot] = st["pt"]
            ptsum_a[slot] = st["ptsum"]
            cum[slot] = st["cum"]
            has_ts[slot] = st["has_ts"]
            seek_delta[slot] = st["seek_delta"]
            result_len[slot] = st["result_len"]
            grams[slot] = st["gram"]

        # KV reorder: one device gather on the beam axis
        if parent_full != list(range(B)):
            g_idx = torch.tensor(parent_full, dtype=torch.long, device=dev)
            kv = {"k": kv["k"].index_select(1, g_idx),
                  "v": kv["v"].index_select(1, g_idx)}

        # ---- per-token state rules (same as the device loops) ------------
        for b in live_slots:
            tok = tok_full[b]
            if tok > consts.token_beg:
                sdn = 2 * (tok - consts.token_beg)
                if has_ts[b] and seek_delta[b] > sdn and result_len[b] < i:
                    failed[b] = True
                    continue
                seek_delta[b] = sdn
                result_len[b] = i + 1
                has_ts[b] = True
            eos = tok == consts.token_eot
            if params.max_tokens > 0 and i >= params.max_tokens:
                eos = True
            if has_ts[b] and seek + seek_delta[b] + DELTA_MIN >= seek_end:
                eos = True
            if eos:
                if result_len[b] == 0 and not no_timestamps:
                    if seek + seek_delta[b] + DELTA_MIN >= seek_end:
                        result_len[b] = i + 1
                    else:
                        failed[b] = True
                        continue
                if params.single_segment or no_timestamps:
                    result_len[b] = i + 1
                    seek_delta[b] = TICKS_PER_SECOND * CHUNK_SIZE
                completed[b] = True
                continue
            if i == N - 1 and (result_len[b] == 0
                               or seek_delta[b]
                               < TICKS_PER_SECOND * CHUNK_SIZE // 2):
                failed[b] = True

        if all(completed[b] or failed[b] for b in range(B)) or i + 1 >= N:
            break

        # ---- one batched device step --------------------------------------
        lg_next, kv = step_fn(
            ctx.params, torch.tensor(tok_full, dtype=torch.long, device=dev),
            torch.full((B,), P + i, dtype=torch.long, device=dev), P + i,
            kv, kc, vc, P + i + 1)
        raw = lg_next.float().cpu().numpy()
        timings.n_decode += 1

    def pad_rows(rows, fill, dtype):
        out = np.full((B, N), fill, dtype)
        for b, r in enumerate(rows):
            out[b, :len(r)] = r
        return out

    return {
        "tokens": pad_rows(tokens, consts.token_eot, np.int32),
        "p": pad_rows(p_a, 0.0, np.float32),
        "plog": pad_rows(plog_a, 0.0, np.float32),
        "tid": pad_rows(tid_a, 0, np.int32),
        "pt": pad_rows(pt_a, 0.0, np.float32),
        "ptsum": pad_rows(ptsum_a, 0.0, np.float32),
        "n_tokens": np.int32(n_steps),
        "has_ts": np.asarray(has_ts),
        "seek_delta": np.asarray(seek_delta, np.int32),
        "result_len": np.asarray(result_len, np.int32),
        "sum_logprobs_all": np.asarray(cum, np.float32),
        "completed": np.asarray(completed),
        "failed": np.asarray(failed),
        "no_speech_prob": np.full((B,), no_speech_prob, np.float32),
    }
