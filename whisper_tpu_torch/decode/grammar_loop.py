"""Host-grammar decode paths: batched multi-decoder + device-chunked (port
of whisper_tpu.decode.grammar_loop).

The reference runs GBNF grammar inside its up-to-8-decoder batch at every
ladder temperature (reference: src/whisper.cpp:5718-5724, 5925-5977) and
round-trips the device once per token (:2960-2966).  Two paths:

1. `decode_window_grammar` with n_decoders > 1: one batched device step a
   token for all decoders at once (lockstep positions, per-decoder grammar
   pushdown state, per-decoder multinomial draws from a
   np.random.RandomState(seed)).

2. The same function at n_decoders == 1 and t == 0 switches to
   speculative chunking: the device decodes up to k_max tokens a host sync
   through the device filter chain WITHOUT grammar (plus the host's
   grammar mask on the chunk's first token), returning the sampled tokens
   and their raw logits in one packed tensor; the host replays each
   position through the reference filter chain INCLUDING grammar and
   accepts the longest matching prefix.  On a mismatch the host's token
   wins and the device restarts from it (one decode_step).  The host's
   tokens are exactly the one-token loop's; the device's are only a guess.

whisper_tpu's chunk is a `lax.while_loop` that exits at the device's own
stop and skips the step after it with `lax.cond`.  Here the chunk is a
Python loop of k_max steps that never syncs: `stop` is carried on the
device, and once it is set the raw logits stay as they were
(`torch.where`).  The steps past a stop still write the self-KV cache, at
slots beyond the kv_len of any later step, which masks them (the next
restart rewrites from the last accepted token).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..constants import CHUNK_SIZE, TICKS_PER_SECOND
from ..models import whisper as wm
from .filters import FilterConsts, FilterOptions, make_process_logits
from .host_filters import process_logits_host
from .loop import DELTA_MIN

SPEC_CHUNK = 8   # device tokens per host grammar sync (speculative path)


def _make_chunk_fn(ctx, consts: FilterConsts, opts: FilterOptions,
                   extra_suppress: tuple = ()):
    """Up-to-SPEC_CHUNK-step speculative decoder (B = 1, greedy) on the
    context's device.  Carries the filter-chain state (ts pairing flags, has_ts,
    seek_delta) as decode/loop.py does; failure and eos bookkeeping stay
    on the host, which is the oracle.  Returns (packed, raw_next, kv):
    packed is one f32 tensor [n sampled, stopped, tokens (k_max,),
    raw logits (k_max, V)], fetched by the host in one copy."""
    nh = ctx.config.n_text_head
    cd = ctx.compute_dtype
    # suppress_regex ids are static per window, so the device chain applies
    # them at every chunk step: otherwise a regex that suppresses the
    # unconstrained argmax would mismatch at position 0 of every chunk
    process = make_process_logits(consts, opts, extra_suppress, ctx.device)
    beg = consts.token_beg
    eot = consts.token_eot

    @torch.no_grad()
    def chunk_fn(params, raw, kv, kc, vc, ci0: int, i0: int, last_was_ts,
                 penult_was_ts, has_ts, seek_delta, is_initial, seek: int,
                 seek_end: int, i_stop: int, mask0, k_max: int):
        """raw (1, V) f32 and the state flags (1,) on the device; mask0
        (V,) the additive grammar penalty for the chunk's FIRST position
        (the host knows the pushdown state there, so token 0 never
        mismatches on grammar grounds); k_max <= SPEC_CHUNK the chunk
        length."""
        dev = raw.device
        toks = []
        raws = []
        li, pi, hi, sd, init = (last_was_ts, penult_was_ts, has_ts,
                                seek_delta, is_initial)
        stop = torch.zeros((), dtype=torch.bool, device=dev)
        n = torch.zeros((), dtype=torch.int32, device=dev)
        for t in range(k_max):
            n = n + (~stop).to(torch.int32)
            lg, _, _ = process(raw, 0.0, init, li, pi, hi, sd)
            if t == 0:
                lg = lg + mask0[None, :]
            tok = torch.argmax(lg, dim=-1).to(torch.int32)      # (1,)
            toks.append(tok)
            raws.append(raw[0])

            # filter-state update (loop.token_state_update's apply_ts part;
            # a divergence costs a restart, never correctness)
            is_ts_update = tok > beg
            sdn = 2 * (tok - beg)
            goes_back = hi & (sd > sdn)
            apply_ts = is_ts_update & ~goes_back
            sd = torch.where(apply_ts, sdn, sd)
            hi = hi | apply_ts
            li, pi = tok >= beg, li
            init = torch.zeros_like(init)

            # the device's own stop prediction (the host re-derives it)
            stop = stop | (tok[0] == eot) | (hi[0] & (
                seek + sd[0] + DELTA_MIN >= seek_end))
            if i0 + t >= i_stop:
                stop = torch.ones_like(stop)
            lg_raw, kv = wm.decode_step(
                params, tok, torch.full((1,), ci0 + t, dtype=torch.long,
                                        device=dev),
                ci0 + t, kv, kc, vc, kv_len=ci0 + t + 1, n_head=nh,
                compute_dtype=cd)
            raw = torch.where(stop, raw, lg_raw.float())
        packed = torch.cat([
            torch.stack([n.float(), stop.float()]),
            torch.cat(toks).float(), torch.stack(raws).reshape(-1)])
        return packed, raw, kv

    return chunk_fn


def decode_window_grammar(ctx, prompt, kc, vc, t_cur, seek, seek_end,
                          params, opts, no_timestamps, grammar=None,
                          n_decoders: int = 1, seed: int = 0):
    """Window decode with host-side grammar / logits-filter semantics.

    kc/vc: the window's dense (L, 1 or B, H, Dh, Ta) cross-KV (the steps
    read it through the einsum, whatever the cross mode, as whisper_tpu's
    host loop does).  Same result contract as the window loop (dict of
    (B, N) arrays), with B = n_decoders rows.  Rule order and state machine
    match the reference (src/whisper.cpp:5015-5283 filters, :5990-6065
    per-token state update).
    """
    B = max(1, int(n_decoders))
    consts = FilterConsts.from_vocab(ctx.vocab, ctx.hparams.n_audio_ctx)
    prompt_fn, step_fn = ctx._prompt_step_fns()
    N = ctx.hparams.n_text_ctx // 2 - 4
    P = len(prompt)
    C = P + N + 1
    L, H, Dh = (ctx.config.n_text_layer, ctx.config.n_text_head,
                ctx.config.head_dim_text)
    vocab = ctx.vocab
    beg = vocab.token_beg
    eot = vocab.token_eot
    dev = ctx.device
    cd = ctx.compute_dtype
    timings = ctx.timings

    prompt_b = torch.tensor([prompt] * B, dtype=torch.long, device=dev)
    kc_b, vc_b = kc, vc
    if B > 1 and kc.shape[1] == 1:
        kc_b = kc.expand((kc.shape[0], B) + kc.shape[2:])
        vc_b = vc.expand((vc.shape[0], B) + vc.shape[2:])

    logits0, ks, vs = prompt_fn(ctx.params, prompt_b, kc_b, vc_b)
    raw_dev = logits0[:, -1].float()                      # (B, V)
    del logits0
    raw0 = raw_dev.cpu().numpy()
    lp0 = np.exp(raw0[0] - raw0[0].max())
    no_speech_prob = float((lp0 / lp0.sum())[vocab.token_nosp])

    kv = {"k": torch.zeros((L, B, H, Dh, C), dtype=cd, device=dev),
          "v": torch.zeros((L, B, H, Dh, C), dtype=cd, device=dev)}
    kv["k"][..., :P] = ks.permute(0, 1, 3, 4, 2).to(cd)
    kv["v"][..., :P] = vs.permute(0, 1, 3, 4, 2).to(cd)
    del ks, vs

    rng = np.random.RandomState(seed)

    # load the vocab tables into the ORIGINAL grammar engine once so every
    # per-decoder/per-window copy() inherits them (the native clone copies
    # the C++ tables; re-loading per window cost more than the decode)
    if grammar is not None and hasattr(grammar, "_ensure_vocab"):
        grammar._ensure_vocab(vocab)

    # per-decoder host state (reference keeps one whisper_decoder each,
    # whisper.cpp:5733-5755)
    toks = [[] for _ in range(B)]
    p_a = [[] for _ in range(B)]
    plog_a = [[] for _ in range(B)]
    tid_a = [[] for _ in range(B)]
    pt_a = [[] for _ in range(B)]
    ptsum_a = [[] for _ in range(B)]
    grams = [grammar.copy() if grammar is not None else None
             for _ in range(B)]
    has_ts = [False] * B
    seek_delta = [TICKS_PER_SECOND * CHUNK_SIZE] * B
    result_len = [0] * B
    completed = [False] * B
    failed = [False] * B
    sum_lp = [0.0] * B
    raw = raw0                                   # (B, V) raw logits
    last_tok = [eot] * B

    def host_choose(b, i, raw_b):
        """Exact reference filter chain + sampler for decoder b at step i.
        Returns (tok, p, plog, tid, pt, ptsum)."""
        t0 = time.perf_counter()
        lg, lp, pr = process_logits_host(
            raw_b, consts, opts, temperature=t_cur, tokens_cur=toks[b],
            has_ts=has_ts[b], seek_delta=seek_delta[b] if has_ts[b] else 0,
            grammar=grams[b], vocab=vocab,
            grammar_penalty=params.grammar_penalty,
            suppress_regex=params.suppress_regex,
            logits_filter_callback=params.logits_filter_callback)
        timings.t_grammar_us += int((time.perf_counter() - t0) * 1e6)
        timings.n_grammar += 1
        if t_cur < 1e-6:
            tok = int(np.argmax(pr))
        else:
            tok = int(rng.choice(len(pr), p=pr / pr.sum()))
        ts_probs = pr[beg:]
        ptsum = float(ts_probs.sum())
        tid = int(np.argmax(ts_probs)) + beg
        pt = float(ts_probs.max() / (ptsum + 1e-10))
        if tok >= beg:
            tid, pt = tok, float(pr[tok])
        return tok, float(pr[tok]), float(lp[tok]), tid, pt, ptsum

    def accept(b, i, choice):
        """Record token + run the reference per-token state update
        (src/whisper.cpp:5990-6065).  Returns True while decoder b
        continues."""
        tok, p, plog, tid, pt, ptsum = choice
        toks[b].append(tok)
        p_a[b].append(p)
        plog_a[b].append(plog)
        tid_a[b].append(tid)
        pt_a[b].append(pt)
        ptsum_a[b].append(ptsum)
        sum_lp[b] += plog
        last_tok[b] = tok
        if grams[b] is not None:
            grams[b].accept_token(vocab, tok)

        if tok > beg:
            sdn = 2 * (tok - beg)
            if has_ts[b] and seek_delta[b] > sdn and result_len[b] < i:
                failed[b] = True
                return False
            seek_delta[b] = sdn
            result_len[b] = i + 1
            has_ts[b] = True
        eos = tok == eot
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
                    return False
            if params.single_segment or no_timestamps:
                result_len[b] = i + 1
                seek_delta[b] = TICKS_PER_SECOND * CHUNK_SIZE
            completed[b] = True
            return False
        if i == N - 1 and (result_len[b] == 0
                           or seek_delta[b]
                           < TICKS_PER_SECOND * CHUNK_SIZE // 2):
            failed[b] = True
            return False
        return True

    def flags(*vals, dtype=torch.bool):
        return torch.tensor(vals, dtype=dtype, device=dev)

    # ---- speculative chunked path (B=1, greedy, no user callback) --------
    speculative = (B == 1 and t_cur < 1e-6
                   and params.logits_filter_callback is None
                   and grammar is not None)
    if speculative:
        extra = (ctx._regex_suppress_ids(params.suppress_regex)
                 if params.suppress_regex else ())
        chunk_fn = ctx._cached(("gchunk", opts, extra),
                               lambda: _make_chunk_fn(ctx, consts, opts,
                                                      extra))
        i_stop = params.max_tokens if params.max_tokens > 0 else 1 << 30

        i = 0
        # adaptive: x2 on clean chunks, reset on a miss; never more than
        # SPEC_CHUNK
        cur_k = min(2, SPEC_CHUNK)
        need_step = False   # device must be resumed with last_tok[0]
        # `raw` stays on the device end to end: the host validates from the
        # raw rows inside each packed result, so the only host round trip
        # a chunk is the packed fetch itself
        raw = raw_dev
        while i < N:
            if need_step:
                # resume from the last ACCEPTED token: its KV slot is
                # (re)written; stale later entries sit beyond kv_len and
                # are masked out
                pos = P + i - 1
                lg, kv = step_fn(ctx.params, flags(last_tok[0],
                                                   dtype=torch.long),
                                 flags(pos, dtype=torch.long), pos, kv,
                                 kc_b, vc_b, pos + 1)
                raw = lg.float()
                timings.n_decode += 1
                timings.n_grammar_restart += 1
                need_step = False

            # filter-chain state snapshot for the device (same derivation
            # as host_filters.py)
            lts = len(toks[0]) > 0 and toks[0][-1] >= beg
            pts = len(toks[0]) < 2 or toks[0][-2] >= beg
            mask0 = np.zeros((raw.shape[-1],), np.float32)
            t0 = time.perf_counter()
            grams[0].suppress_invalid(vocab, mask0, params.grammar_penalty)
            timings.t_grammar_us += int((time.perf_counter() - t0) * 1e6)
            k_max = min(cur_k, N - i)
            packed, raw_next, kv = chunk_fn(
                ctx.params, raw, kv, kc_b, vc_b, P + i, i, flags(lts),
                flags(pts), flags(has_ts[0]),
                flags(seek_delta[0] if has_ts[0] else 0, dtype=torch.int32),
                flags(len(toks[0]) == 0), seek, seek_end, i_stop,
                torch.from_numpy(mask0).to(dev), k_max)
            packed = packed.cpu().numpy()     # the single host round trip
            timings.n_grammar_chunk += 1
            n_dev = int(packed[0])
            dev_stop = bool(packed[1])
            ctoks = packed[2:2 + k_max].astype(np.int32)
            craws = packed[2 + k_max:].reshape(k_max, -1)
            # the device took n_dev - 1 useful steps when it stopped early
            timings.n_decode += n_dev - (1 if dev_stop else 0)

            stopped = False
            mismatched = False
            for j in range(n_dev):
                choice = host_choose(0, i + j, craws[j])
                cont = accept(0, i + j, choice)
                if not cont:
                    stopped = True
                    i += j + 1
                    break
                if choice[0] != int(ctoks[j]):
                    mismatched = True
                    i += j + 1
                    break
            else:
                i += n_dev
            if stopped:
                break
            if mismatched:
                cur_k = min(2, SPEC_CHUNK)
                need_step = True
            elif dev_stop:
                need_step = True
            else:
                cur_k = min(SPEC_CHUNK, cur_k * 2)
                raw = raw_next
    else:
        # ---- batched one-token-per-sync path (reference-shaped) ----------
        for i in range(N):
            for b in range(B):
                if completed[b] or failed[b]:
                    continue
                choice = host_choose(b, i, raw[b])
                accept(b, i, choice)
            if all(c or f for c, f in zip(completed, failed)):
                break
            if i == N - 1:
                break
            lg_next, kv = step_fn(
                ctx.params, torch.tensor(last_tok, dtype=torch.long,
                                         device=dev),
                torch.full((B,), P + i, dtype=torch.long, device=dev),
                P + i, kv, kc_b, vc_b, P + i + 1)
            raw = lg_next.float().cpu().numpy()
            timings.n_decode += 1

    def pad_rows(rows, fill, dtype):
        return np.asarray([r + [fill] * (N - len(r)) for r in rows], dtype)

    return {
        # EOT padding matches the device loop's EOT-initialized buffer:
        # api._own_sampled_len strips trailing EOTs to recover a failed
        # row's own length inside the batch-global step budget
        "tokens": pad_rows(toks, eot, np.int32),
        "p": pad_rows(p_a, 0.0, np.float32),
        "plog": pad_rows(plog_a, 0.0, np.float32),
        "tid": pad_rows(tid_a, 0, np.int32),
        "pt": pad_rows(pt_a, 0.0, np.float32),
        "ptsum": pad_rows(ptsum_a, 0.0, np.float32),
        "n_tokens": np.int32(max(len(r) for r in toks)),
        "has_ts": np.asarray(has_ts),
        "seek_delta": np.asarray(seek_delta, np.int32),
        "result_len": np.asarray(result_len, np.int32),
        "sum_logprobs_all": np.asarray(sum_lp, np.float32),
        "completed": np.asarray(completed),
        "failed": np.asarray(failed),
        "no_speech_prob": np.full((B,), no_speech_prob, np.float32),
    }
