"""Token-level timestamps — signal-energy heuristic (copy of
whisper_tpu.timestamps).

Re-implements `whisper_exp_compute_token_level_timestamps`
(reference: src/whisper.cpp:6915-7198) and `whisper_wrap_segment`
(reference: src/whisper.cpp:4915-4966).  The DTW method is dtw.py.
These are host-side post-processing passes over tiny arrays.
"""

from __future__ import annotations

import numpy as np

from .constants import SAMPLE_RATE


def timestamp_to_sample(t: int, n_samples: int) -> int:
    return max(0, min(n_samples - 1, int((t * SAMPLE_RATE) // 100)))


def sample_to_timestamp(i_sample: int) -> int:
    return (100 * i_sample) // SAMPLE_RATE


def voice_length(text: str) -> float:
    """Pronunciation-time heuristic (reference: src/whisper.cpp:6922-6946).

    The reference iterates UTF-8 BYTES (C++ `for (char c : text)`), so a
    multibyte character weighs 1.0 per byte; match that exactly."""
    res = 0.0
    for b in text.encode("utf-8"):
        if b == 0x20:        # ' '
            res += 0.01
        elif b == 0x2C:      # ','
            res += 2.0
        elif b in (0x2E, 0x21, 0x3F):  # '.' '!' '?'
            res += 3.0
        elif 0x30 <= b <= 0x39:        # '0'-'9'
            res += 3.0
        else:
            res += 1.0
    return res


def get_signal_energy(signal: np.ndarray, n_samples_per_half_window: int) -> np.ndarray:
    """Moving average of |signal| (reference: src/whisper.cpp:6949-6965)."""
    hw = n_samples_per_half_window
    a = np.abs(np.asarray(signal, dtype=np.float32))
    # windowed sum via cumsum with edge clamping (window truncated at edges,
    # but the divisor is always 2*hw+1 — matching the reference)
    c = np.concatenate([[0.0], np.cumsum(a, dtype=np.float64)])
    n = len(a)
    i = np.arange(n)
    lo = np.maximum(i - hw, 0)
    hi = np.minimum(i + hw + 1, n)
    return ((c[hi] - c[lo]) / (2 * hw + 1)).astype(np.float32)


def compute_token_level_timestamps(ctx, i_segment: int,
                                   thold_pt: float, thold_ptsum: float) -> None:
    """Fill tokens[].t0/t1 for segment `i_segment` of `ctx.result_all`."""
    segment = ctx.result_all[i_segment]
    tokens = segment.tokens
    vocab = ctx.vocab

    energy = ctx.energy
    if energy is None or len(energy) == 0:
        return
    n_samples = len(energy)

    t0, t1 = segment.t0, segment.t1
    n = len(tokens)
    if n == 0:
        return
    if n == 1:
        tokens[0].t0 = t0
        tokens[0].t1 = t1
        return

    for tok in tokens:
        tok.t0 = -1
        tok.t1 = -1

    for j in range(n):
        token = tokens[j]
        if j == 0:
            if token.id == vocab.token_beg:
                tokens[0].t0 = t0
                tokens[0].t1 = t0
                tokens[1].t0 = t0
                ctx.t_beg = t0
                ctx.t_last = t0
                ctx.tid_last = vocab.token_beg
            else:
                tokens[0].t0 = ctx.t_last

        tt = ctx.t_beg + 2 * (token.tid - vocab.token_beg)
        token.vlen = voice_length(vocab.token_str(token.id))

        if (token.pt > thold_pt and token.ptsum > thold_ptsum
                and token.tid > ctx.tid_last and tt <= t1):
            if j > 0:
                tokens[j - 1].t1 = tt
            token.t0 = tt
            ctx.tid_last = token.tid

    tokens[n - 2].t1 = t1
    tokens[n - 1].t0 = t1
    tokens[n - 1].t1 = t1
    ctx.t_last = t1

    # proportional fill of unknown intervals by voice length
    # (reference: src/whisper.cpp:7050-7090)
    p0 = 0
    p1 = 0
    while True:
        while p1 < n and tokens[p1].t1 < 0:
            p1 += 1
        if p1 >= n:
            p1 = n - 1
        if p1 > p0:
            psum = sum(tokens[j].vlen for j in range(p0, p1 + 1))
            dt = tokens[p1].t1 - tokens[p0].t0
            for j in range(p0 + 1, p1 + 1):
                ct = tokens[j - 1].t0 + dt * tokens[j - 1].vlen / psum
                tokens[j - 1].t1 = int(ct)
                tokens[j].t0 = int(ct)
        p1 += 1
        p0 = p1
        if p1 >= n:
            break

    # fix-up overlaps (reference: src/whisper.cpp:7092-7104)
    for j in range(n - 1):
        if tokens[j].t1 < 0:
            tokens[j + 1].t0 = tokens[j].t1
        if j > 0 and tokens[j - 1].t1 > tokens[j].t0:
            tokens[j].t0 = tokens[j - 1].t1
            tokens[j].t1 = max(tokens[j].t0, tokens[j].t1)

    # energy-VAD expand/contract (reference: src/whisper.cpp:7106-7171)
    hw = SAMPLE_RATE // 8
    for j in range(n):
        if tokens[j].id >= vocab.token_eot:
            continue
        s0 = timestamp_to_sample(tokens[j].t0, n_samples)
        s1 = timestamp_to_sample(tokens[j].t1, n_samples)
        ss0 = max(s0 - hw, 0)
        ss1 = min(s1 + hw, n_samples)
        ns = ss1 - ss0
        if ns <= 0:
            continue
        thold = 0.5 * float(energy[ss0:ss1].sum()) / ns

        k = s0
        if energy[k] > thold and j > 0:
            while k > 0 and energy[k] > thold:
                k -= 1
            tokens[j].t0 = sample_to_timestamp(k)
            if tokens[j].t0 < tokens[j - 1].t1:
                tokens[j].t0 = tokens[j - 1].t1
            else:
                s0 = k
        else:
            while k < s1 and energy[k] < thold:
                k += 1
            s0 = k
            tokens[j].t0 = sample_to_timestamp(k)

        k = s1
        if energy[k] > thold:
            while k < n_samples - 1 and energy[k] > thold:
                k += 1
            tokens[j].t1 = sample_to_timestamp(k)
            if j < n - 1 and tokens[j].t1 > tokens[j + 1].t0:
                tokens[j].t1 = tokens[j + 1].t0
            else:
                s1 = k
        else:
            while k > s0 and energy[k] < thold:
                k -= 1
            s1 = k
            tokens[j].t1 = sample_to_timestamp(k)


def _should_split_on_word(txt: str, split_on_word: bool) -> bool:
    if not split_on_word:
        return True
    return txt.startswith(" ")


def wrap_segment(ctx, max_len: int, split_on_word: bool) -> int:
    """Wrap the last segment to max_len characters; returns #segments."""
    from .api import Segment

    segment = ctx.result_all[-1]
    res = 1
    acc = 0
    text = ""

    i = 0
    while i < len(segment.tokens):
        token = segment.tokens[i]
        if token.id >= ctx.vocab.token_eot:
            i += 1
            continue
        txt = ctx.vocab.token_str(token.id)
        cur = len(txt.encode("utf-8"))

        if acc + cur > max_len and i > 0 and _should_split_on_word(txt, split_on_word):
            # `segment` IS result_all[-1] — snapshot the fields the new
            # segment needs BEFORE truncating (the reference copies the
            # whole segment by value, examples/cli token-timestamp wrap)
            rest_tokens = segment.tokens[i:]
            seg_t1 = segment.t1
            seg_turn = segment.speaker_turn_next

            last = ctx.result_all[-1]
            last.text = text
            last.t1 = token.t0
            last.tokens = segment.tokens[:i]
            last.speaker_turn_next = False

            new_seg = Segment(
                t0=token.t0, t1=seg_t1, text="",
                no_speech_prob=segment.no_speech_prob,
                tokens=rest_tokens,
                speaker_turn_next=seg_turn)
            ctx.result_all.append(new_seg)

            acc = 0
            text = ""
            segment = new_seg
            i = 0
            res += 1
        else:
            acc += cur
            text += txt
            i += 1

    ctx.result_all[-1].text = text
    return res
