"""Vectorized logit-filter chain (port of whisper_tpu.decode.filters).

The exact rule order of the reference `whisper_process_logits`
(reference: src/whisper.cpp:5015-5283) as masked tensor ops over a batch
of decoders, on the device that holds the logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import CHUNK_SIZE
from ..utils.device import resolve_device
from ..weights.vocab import Vocab

NEG_INF = float("-inf")

# reference: src/whisper.cpp:4968-4973
NON_SPEECH_TOKENS = [
    "\"", "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">", "@", "[",
    "\\", "]", "^", "_", "`", "{", "|", "}", "~", "「", "」", "『", "』",
    "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"", "((",
    "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪", "♩", "♪",
    "♫", "♬", "♭", "♮", "♯",
]


@dataclasses.dataclass(frozen=True)
class FilterConsts:
    """Static per-model constants of the filter chain."""
    n_vocab: int
    token_eot: int
    token_sot: int
    token_beg: int
    token_not: int
    token_nosp: int
    token_solm: int
    token_prev: int
    token_translate: int
    token_transcribe: int
    token_space: int            # id of " " (suppress-blank rule)
    lang_ids: tuple[int, ...]   # language token ids
    nst_ids: tuple[int, ...]    # non-speech token ids present in the vocab
    precision: float            # CHUNK_SIZE / n_audio_ctx (ts resolution, s)

    @classmethod
    def from_vocab(cls, vocab: Vocab, n_audio_ctx: int) -> "FilterConsts":
        lang_ids = tuple(vocab.token_lang(i) for i in range(100))
        nst = []
        for token in NON_SPEECH_TOKENS:
            for cand in (token, " " + token):
                tid = vocab.token_to_id.get(cand.encode("utf-8"))
                if tid is not None:
                    nst.append(tid)
        # allow "-"/"'" only inside words (reference: whisper.cpp:5121-5127)
        for cand in (" -", " '"):
            tid = vocab.token_to_id.get(cand.encode("utf-8"))
            if tid is not None:
                nst.append(tid)
        space = vocab.token_to_id.get(b" ", 220)
        return cls(
            n_vocab=vocab.n_vocab,
            token_eot=vocab.token_eot,
            token_sot=vocab.token_sot,
            token_beg=vocab.token_beg,
            token_not=vocab.token_not,
            token_nosp=vocab.token_nosp,
            token_solm=vocab.token_solm,
            token_prev=vocab.token_prev,
            token_translate=vocab.token_translate,
            token_transcribe=vocab.token_transcribe,
            token_space=space,
            lang_ids=lang_ids,
            nst_ids=tuple(sorted(set(nst))),
            precision=float(CHUNK_SIZE) / n_audio_ctx,
        )


@dataclasses.dataclass(frozen=True)
class FilterOptions:
    """Static decode options affecting the filter chain."""
    suppress_blank: bool = True
    no_timestamps: bool = False
    tdrz_enable: bool = False
    suppress_nst: bool = False
    max_initial_ts: float = 1.0


def _static_suppress_mask(c: FilterConsts, o: FilterOptions,
                          extra_suppress: tuple[int, ...] = ()) -> np.ndarray:
    """Additive mask of the state-independent suppressions (f32, (V,))."""
    m = np.zeros((c.n_vocab,), dtype=np.float32)
    m[c.token_not] = NEG_INF
    if o.no_timestamps:
        m[c.token_beg:] = NEG_INF
    m[c.token_sot] = NEG_INF
    m[c.token_nosp] = NEG_INF
    if not o.tdrz_enable:
        m[c.token_solm] = NEG_INF
    m[c.token_translate] = NEG_INF
    m[c.token_transcribe] = NEG_INF
    m[c.token_prev] = NEG_INF
    for lid in c.lang_ids:
        if lid < c.n_vocab:
            m[lid] = NEG_INF
    if o.suppress_nst:
        for tid in c.nst_ids:
            m[tid] = NEG_INF
    for tid in extra_suppress:
        m[tid] = NEG_INF
    return m


def make_process_logits(c: FilterConsts, o: FilterOptions,
                        extra_suppress: tuple[int, ...] = (),
                        device: str | torch.device = "cuda"):
    """Build `process(logits, temperature, is_initial, last_was_ts,
    penult_was_ts, has_ts, seek_delta) -> (logits, logprobs, probs)`.

    logits (B, V) float; temperature a Python float; the state flags (B,)
    bool and seek_delta (B,) int tensors on `device`.  Reference order:
    temperature scale -> suppressions -> timestamp pairing ->
    max_initial_ts -> monotonic ts floor -> log_softmax -> timestamp-sum
    rule -> softmax.
    """
    device = resolve_device(device)
    static_mask = torch.from_numpy(
        _static_suppress_mask(c, o, extra_suppress)).to(device)
    V = c.n_vocab
    ids = torch.arange(V, device=device)
    is_ts_token = ids >= c.token_beg                    # (V,)
    is_text_token = ids < c.token_beg
    is_before_eot = ids < c.token_eot
    tid0_init = int(round(o.max_initial_ts / c.precision))
    too_late = ids > (c.token_beg + tid0_init)
    blank = torch.zeros((V,), dtype=torch.float32, device=device)
    blank[c.token_eot] = NEG_INF
    blank[c.token_space] = NEG_INF

    def process(logits, temperature, is_initial, last_was_ts,
                penult_was_ts, has_ts, seek_delta):
        logits = logits.float()
        if temperature > 0.0:
            logits = logits / max(temperature, 1e-6)

        logits = logits + static_mask

        if o.suppress_blank:
            logits = torch.where(is_initial[:, None], logits + blank, logits)

        # timestamps appear in pairs (reference: whisper.cpp:5128-5147)
        suppress_ts = last_was_ts & penult_was_ts
        suppress_text = last_was_ts & ~penult_was_ts
        logits = logits.masked_fill(suppress_ts[:, None] & is_ts_token,
                                    NEG_INF)
        logits = logits.masked_fill(suppress_text[:, None] & is_before_eot,
                                    NEG_INF)

        # initial timestamp <= max_initial_ts (reference: whisper.cpp:5149-5158)
        if o.max_initial_ts > 0.0:
            logits = logits.masked_fill(is_initial[:, None] & too_late,
                                        NEG_INF)

        # timestamps must not decrease (reference: whisper.cpp:5160-5168)
        floor_id = c.token_beg + torch.div(seek_delta, 2,
                                           rounding_mode="floor")
        below = is_ts_token & (ids[None, :] < floor_id[:, None])
        logits = logits.masked_fill(has_ts[:, None] & below, NEG_INF)

        logprobs = torch.log_softmax(logits, dim=-1)

        # timestamp-sum rule (reference: whisper.cpp:5173-5199)
        ts_lse = torch.logsumexp(
            logprobs.masked_fill(~is_ts_token, NEG_INF), dim=-1)   # (B,)
        max_text = torch.amax(
            logprobs.masked_fill(~is_text_token, NEG_INF), dim=-1)
        force_ts = (ts_lse > max_text)[:, None] & is_text_token
        logits = logits.masked_fill(force_ts, NEG_INF)
        logprobs = logprobs.masked_fill(force_ts, NEG_INF)

        probs = torch.exp(logprobs)
        return logits, logprobs, probs

    return process


def sample_token_data(probs, logprobs, c: FilterConsts):
    """Per-token metadata shared by all samplers: most-probable timestamp
    token and the timestamp probability mass
    (reference: whisper_sample_token src/whisper.cpp:5298-5330).

    probs/logprobs: (B, V).  Returns (tid (B,), pt (B,), ptsum (B,)).
    """
    ids = torch.arange(c.n_vocab, device=probs.device)
    ts_probs = torch.where(ids >= c.token_beg, probs, 0.0)
    ptsum = torch.sum(ts_probs, dim=-1)
    max_ts, tid = torch.max(ts_probs, dim=-1)
    pt = max_ts / (ptsum + 1e-10)
    return tid, pt, ptsum
