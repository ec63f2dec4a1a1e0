"""Host (numpy) implementation of whisper_process_logits (copy of
whisper_tpu.decode.host_filters).

Used by the grammar / user-callback compatibility path, where decoding must
round-trip through the host every token (like the reference does always),
and as the test oracle for the device filter chain in filters.py.

Rule order matches reference src/whisper.cpp:5015-5283 exactly, including
grammar suppression + re-log-softmax.
"""

from __future__ import annotations

import re

import numpy as np

from .filters import FilterConsts, FilterOptions

NEG_INF = float("-inf")


def compute_logprobs(logits: np.ndarray) -> np.ndarray:
    mx = logits.max()
    lse = np.log(np.exp(logits[logits > NEG_INF] - mx).sum()) + mx
    out = np.where(logits > NEG_INF, logits - lse, NEG_INF)
    return out


def process_logits_host(
        logits: np.ndarray,
        c: FilterConsts,
        o: FilterOptions,
        *,
        temperature: float,
        tokens_cur: list[int],
        has_ts: bool,
        seek_delta: int,
        grammar=None,
        vocab=None,
        grammar_penalty: float = 100.0,
        suppress_regex: str | None = None,
        logits_filter_callback=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (logits, logprobs, probs), all float32 (V,)."""
    logits = logits.astype(np.float64).copy()
    is_initial = len(tokens_cur) == 0

    if temperature > 0.0:
        logits /= temperature

    if o.suppress_blank and is_initial:
        logits[c.token_eot] = NEG_INF
        logits[c.token_space] = NEG_INF

    logits[c.token_not] = NEG_INF
    if o.no_timestamps:
        logits[c.token_beg:] = NEG_INF

    logits[c.token_sot] = NEG_INF
    logits[c.token_nosp] = NEG_INF
    if not o.tdrz_enable:
        logits[c.token_solm] = NEG_INF
    logits[c.token_translate] = NEG_INF
    logits[c.token_transcribe] = NEG_INF
    logits[c.token_prev] = NEG_INF
    for lid in c.lang_ids:
        if lid < len(logits):
            logits[lid] = NEG_INF

    if logits_filter_callback is not None:
        logits_filter_callback(tokens_cur, logits)

    if suppress_regex and vocab is not None:
        pat = re.compile(suppress_regex)
        for tok, tid in vocab.token_to_id.items():
            if pat.fullmatch(tok.decode("utf-8", errors="replace")):
                logits[tid] = NEG_INF

    if o.suppress_nst:
        for tid in c.nst_ids:
            logits[tid] = NEG_INF

    last_was_ts = len(tokens_cur) > 0 and tokens_cur[-1] >= c.token_beg
    penult_was_ts = len(tokens_cur) < 2 or tokens_cur[-2] >= c.token_beg
    if last_was_ts:
        if penult_was_ts:
            logits[c.token_beg:] = NEG_INF
        else:
            logits[:c.token_eot] = NEG_INF

    if is_initial and o.max_initial_ts > 0.0:
        tid0 = round(o.max_initial_ts / c.precision)
        logits[c.token_beg + tid0 + 1:] = NEG_INF

    if has_ts:
        tid0 = seek_delta // 2
        logits[c.token_beg:c.token_beg + tid0] = NEG_INF

    logprobs = compute_logprobs(logits)

    # timestamp-sum rule
    ts_lp = logprobs[c.token_beg:]
    finite = ts_lp[ts_lp > NEG_INF]
    if finite.size:
        mx = finite.max()
        ts_logprob = np.log(np.exp(finite - mx).sum()) + mx
    else:
        ts_logprob = NEG_INF
    max_text = logprobs[:c.token_beg].max()
    if ts_logprob > max_text:
        logits[:c.token_beg] = NEG_INF
        logprobs[:c.token_beg] = NEG_INF
    elif grammar is not None and vocab is not None:
        # engines (python or native) write into a float32 penalty mask
        mask = np.zeros(len(logits), dtype=np.float32)
        grammar.suppress_invalid(vocab, mask, grammar_penalty)
        logits += mask
        logprobs = compute_logprobs(logits)

    probs = np.where(logprobs > NEG_INF, np.exp(logprobs), 0.0)
    return (logits.astype(np.float32), logprobs.astype(np.float32),
            probs.astype(np.float32))
