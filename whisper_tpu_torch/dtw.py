"""DTW token-level timestamps (copy of whisper_tpu.dtw).

Equivalent of `whisper_exp_compute_token_level_timestamps_dtw`
(reference: src/whisper.cpp:7200-7516): the cross-attention weights of the
alignment heads are an extra output of one teacher-forced decode
(models/whisper.py decode_prompt_cross_qk).  The normalization, median
filter and monotonic backtrace run on the host in numpy.

Pipeline (mirrors openai/whisper timing.py and the reference):
  1. re-decode segment tokens [sot,(lang),not] + text + [eot]
  2. take softmax cross-attention of the model's alignment heads,
     truncated to the audible frames
  3. per-head mean/std normalization over the token axis (eps 1e-9)
  4. median filter (width 7, reflect) along the frame axis
  5. mean over heads, negate -> DTW cost; monotonic backtrace
  6. token boundaries at path steps; timestamps = 2 * frame_index + seek
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .languages import lang_id as _lang_id

# Alignment-head presets: model -> [(text_layer, head), ...]
# (data table from reference: src/whisper.cpp:428-455, itself from
#  openai/whisper model cards)
AHEADS_PRESETS: dict[str, list[tuple[int, int]]] = {
    "tiny.en": [(1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)],
    "tiny": [(2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)],
    "base.en": [(3, 3), (4, 7), (5, 1), (5, 5), (5, 7)],
    "base": [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)],
    "small.en": [(6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7),
                 (9, 0), (9, 4), (9, 8), (9, 10), (10, 0), (10, 1), (10, 2),
                 (10, 3), (10, 6), (10, 11), (11, 2), (11, 4)],
    "small": [(5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)],
    "medium.en": [(11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0),
                  (16, 4), (16, 9), (17, 12), (17, 14), (18, 7), (18, 10),
                  (18, 15), (20, 0), (20, 3), (20, 9), (20, 14), (21, 12)],
    "medium": [(13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)],
    "large-v1": [(9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
                 (22, 17), (23, 2), (23, 15)],
    "large-v2": [(10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15),
                 (17, 16), (18, 4), (18, 11), (18, 19), (19, 11), (21, 2),
                 (21, 3), (22, 3), (22, 9), (22, 12), (23, 5), (23, 7),
                 (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)],
    "large-v3": [(7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14),
                 (19, 11), (21, 4), (24, 1), (25, 6)],
    "large-v3-turbo": [(2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)],
}
AHEADS_PRESETS["large"] = AHEADS_PRESETS["large-v3"]


def aheads_for(preset: str, n_text_layer: int, n_head: int,
               n_top: int = 0,
               custom: list[tuple[int, int]] | None = None
               ) -> list[tuple[int, int]]:
    """Resolve a preset name / "n_top_most" / "custom" to (layer, head)s
    (reference: get_alignment_heads_by_layer, src/whisper.cpp:7206-7226)."""
    if preset == "custom":
        return list(custom or [])
    if preset == "n_top_most":
        return [(l, h) for l in range(n_text_layer - n_top, n_text_layer)
                for h in range(n_head)]
    if preset in AHEADS_PRESETS:
        return AHEADS_PRESETS[preset]
    raise ValueError(f"unknown alignment-heads preset '{preset}'")


def head_select_matrix(aheads: list[tuple[int, int]], n_layer: int,
                       n_head: int) -> np.ndarray:
    """(L, S, H) one-hot selection rows; S = max heads used in any layer."""
    per_layer: dict[int, list[int]] = {}
    for l, h in aheads:
        per_layer.setdefault(l, []).append(h)
    S = max((len(v) for v in per_layer.values()), default=1)
    sel = np.zeros((n_layer, S, n_head), dtype=np.float32)
    for l, heads in per_layer.items():
        for s, h in enumerate(heads):
            sel[l, s, h] = 1.0
    return sel


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median along the last axis, reflect padding
    (reference: src/whisper.cpp:7316-7353)."""
    assert width % 2 == 1
    half = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)],
                    mode="reflect")
    stack = np.stack([padded[..., i:i + x.shape[-1]] for i in range(width)],
                     axis=-1)
    return np.median(stack, axis=-1)


def dtw_backtrace(cost_matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW (reference: dtw_and_backtrace, src/whisper.cpp:7230-7314;
    openai/whisper timing.py:83).  Returns (text_indices, time_indices)."""
    N, M = cost_matrix.shape
    cost = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    trace = np.full((N + 1, M + 1), -1, dtype=np.int32)
    cost[0, 0] = 0.0

    for j in range(1, M + 1):
        for i in range(1, N + 1):
            c0 = cost[i - 1, j - 1]
            c1 = cost[i - 1, j]
            c2 = cost[i, j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = cost_matrix[i - 1, j - 1] + c
            trace[i, j] = t

    trace[0, :] = 2
    trace[:, 0] = 1
    ti, tj = [], []
    i, j = N, M
    while i > 0 or j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(tj[::-1])


def dtw_token_sequence(ctx, params, segments) -> tuple[list, int]:
    """Teacher-forcing token sequence for a window's new segments:
    sot + [lang] + <not> + text + eot.  Returns (tokens, sot_len)."""
    vocab = ctx.vocab
    tokens = [vocab.token_sot]
    if vocab.is_multilingual:
        # params.language is the resolved language here (full() writes the
        # auto-detection back); guard the unresolved forms anyway
        lang = params.language
        if not lang or lang == "auto":
            lang = "en"
        tokens.append(vocab.token_lang(_lang_id(lang)))
    sot_len = len(tokens)
    tokens.append(vocab.token_not)
    for seg in segments:
        for t in seg.tokens:
            if t.id < vocab.token_eot:
                tokens.append(t.id)
    tokens.append(vocab.token_eot)
    return tokens, sot_len


def dtw_aheads_select(ctx):
    """-> (aheads, sel) for the loaded model's alignment-head preset
    (None, None when the preset yields nothing)."""
    aheads = aheads_for(ctx.dtw_aheads_preset, ctx.hparams.n_text_layer,
                        ctx.hparams.n_text_head, ctx.dtw_n_top,
                        ctx.dtw_aheads)
    if not aheads:
        return None, None
    sel = head_select_matrix(aheads, ctx.hparams.n_text_layer,
                             ctx.hparams.n_text_head)
    return aheads, sel


def dtw_stamp_segments(ctx, qk_row, aheads, T: int, sot_len: int, seek: int,
                       n_frames: int, segments,
                       medfilt_width: int = 7) -> None:
    """Normalize/filter one row's captured cross-attention and stamp
    t_dtw into `segments`' tokens (reference: src/whisper.cpp:7440-7502).

    qk_row: (L, S_slots, T_pad, Ta) float32 numpy for ONE window."""
    vocab = ctx.vocab
    n_audio_ctx = ctx.exp_n_audio_ctx or ctx.hparams.n_audio_ctx
    n_frames = min(n_frames, 2 * n_audio_ctx)

    # gather the real (layer, slot) pairs in preset order
    per_layer_count: dict[int, int] = {}
    maps = []
    for l, h in aheads:
        s = per_layer_count.get(l, 0)
        per_layer_count[l] = s + 1
        maps.append(qk_row[l, s, :T])          # (T, Ta)
    w = np.stack(maps)                         # (n_heads, T, Ta)

    n_audio_tokens = n_frames // 2
    w = w[:, :, :n_audio_tokens]

    # normalize over the token axis (eps matches ggml_norm call, 1e-9)
    mean = w.mean(axis=1, keepdims=True)
    std = w.std(axis=1, keepdims=True)
    w = (w - mean) / np.sqrt(std ** 2 + 1e-9)

    w = median_filter(w, medfilt_width)
    matrix = w.mean(axis=0)                   # (T, Ta)
    matrix = matrix[sot_len:-1]               # drop sot seq + eot row? no:
    # reference drops sot_sequence_length rows at the start and 1 at the end
    # of the TOKEN axis (src/whisper.cpp:7466-7468); the <not> token stays
    # as row 0 so the first boundary is detected against it.

    text_indices, time_indices = dtw_backtrace(-matrix)

    # place timestamps (reference: src/whisper.cpp:7477-7502): each time the
    # DTW path advances to a new token row, stamp the next text token
    text_toks = [t for seg in segments for t in seg.tokens
                 if t.id < vocab.token_eot]
    p = 0
    last_v = 0
    for v, tix in zip(text_indices, time_indices):
        if v != last_v:
            last_v = v
            if p >= len(text_toks):
                break
            text_toks[p].t_dtw = int(tix) * 2 + seek
            p += 1


def dtw_cross_qk(ctx, toks: np.ndarray, kc, vc, sel: np.ndarray):
    """Teacher-forced cross-QK capture for a (B, T_pad) token batch ->
    (L, B, S, T_pad, Ta) float32 numpy.  The quantized cross modes' untagged
    (codes, scales) pairs are tagged "q8" / "q4" first, as the prompt pass
    tags them (decode/loop.py prompt_cross_kv) and whisper_tpu's jitted
    capture does."""
    from .decode.loop import prompt_cross_kv
    from .models import whisper as wm
    kc, vc = prompt_cross_kv(ctx.cross_mode, kc, vc)
    T = toks.shape[1]
    dev = ctx.device
    with torch.no_grad():
        qk = wm.decode_prompt_cross_qk(
            ctx.params, torch.as_tensor(toks, dtype=torch.long, device=dev),
            torch.arange(T, device=dev), kc, vc,
            n_head=ctx.config.n_text_head, head_select=sel,
            self_mask=wm.make_causal_mask(T, device=dev),
            compute_dtype=ctx.compute_dtype)[1]
    return qk.cpu().numpy()


def dtw_pad_tokens(ctx, tokens: list, T_pad: int | None = None):
    """Pad a teacher-forcing sequence to a 64-token bucket (one K3
    shape, M = B * T_pad, a bucket)."""
    T = len(tokens)
    if T_pad is None:
        T_pad = min(((T + 63) // 64) * 64, ctx.hparams.n_text_ctx)
    return tokens + [ctx.vocab.token_eot] * (T_pad - T), T_pad


def compute_token_level_timestamps_dtw(ctx, params, i_segment: int,
                                       n_segments: int, seek: int,
                                       n_frames: int,
                                       medfilt_width: int = 7) -> None:
    """Fill tokens[].t_dtw for segments [i_segment, i_segment+n_segments)."""
    segments = ctx.result_all[i_segment:i_segment + n_segments]
    tokens, sot_len = dtw_token_sequence(ctx, params, segments)
    aheads, sel = dtw_aheads_select(ctx)
    if aheads is None:
        return

    # teacher-forced decode of the window at `seek`, the token count
    # padded to a bucket
    _, kc, vc = ctx.encode_window(seek)
    T = len(tokens)
    padded, _ = dtw_pad_tokens(ctx, tokens)
    t0 = time.perf_counter()
    qk = dtw_cross_qk(ctx, np.asarray([padded], np.int64), kc, vc, sel)
    t1 = time.perf_counter()
    dtw_stamp_segments(ctx, qk[:, 0], aheads, T, sot_len, seek, n_frames,
                       segments, medfilt_width)
    ctx.timings.t_dtw_qk_us += int((t1 - t0) * 1e6)
    ctx.timings.t_dtw_host_us += int((time.perf_counter() - t1) * 1e6)
    ctx.timings.n_dtw += 1
