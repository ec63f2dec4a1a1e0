"""Batched multi-stream transcription (port of whisper_tpu.parallel.batch,
greedy serving path).

B independent 30 s windows (from different streams, or chunks of one long
stream) ride one batched encoder pass and one window-decode loop.  Each
stream keeps its own sliding-window state (seek, prompt-past, segments) on
the host, so streams may advance by different seek deltas.

With device_mel, every stream's padded PCM (packed int16 when the input
is int16) is uploaded once; per iteration only row indices and sample
offsets choose the windows, which are cut, converted to f32 and turned
into log-mel on the device.

The port decodes in every cross mode of whisper_tpu
(decode/loop.CROSS_MODES), over dense or block-quantized (K3) decoder
weights; the batched encode produces the cross-KV each mode reads
(`_cross_fn_for`).  Greedy windows run the temperature-fallback ladder,
rebatching only the failed rows, with best_of candidates a stream at
t > 0 drawn from per-row keys (`window_rng`), so a window's candidates do
not depend on its slot or its batch.  Beam search decodes S streams x K
beams as rows of one batch against S cross-KV rows (decode/beam.py).
Everything else the JAX class offers is refused with an error rather than
run on another path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..api import (FullParams, SamplingStrategy, Segment, WhisperContext,
                   WhisperState, _ladder, _rank_window_candidates,
                   full_default_params, window_rng)
from ..audio.mel import log_mel_spectrogram_torch, pad_audio
from ..constants import (CHUNK_SIZE, HOP_LENGTH, MAX_DECODERS, N_FFT,
                         TICKS_PER_SECOND)
from ..decode.filters import FilterOptions
from ..decode.loop import DELTA_MIN
from ..languages import lang_id as _lang_id
from ..models import whisper as wm


def _merge_candidate_rows(outs):
    """Merge window decode results of several passes into one whose rows
    are each pass's first n_live rows, so _rank_window_candidates sees
    best_of > batch_size candidates as if they had decoded in one call.

    outs: [(result_dict, n_live_rows), ...].  Per-row arrays concatenate;
    the batch-global step count n_tokens takes the max (only an upper
    bound for _own_sampled_len, which trims each row's own EOT tail)."""
    merged = {}
    for key in outs[0][0]:
        if key == "n_tokens":
            merged[key] = max(int(o[key]) for o, _ in outs)
        else:
            merged[key] = np.concatenate(
                [np.asarray(o[key])[:cc] for o, cc in outs], axis=0)
    return merged


def _cross_fn_for(cross_mode: str):
    """Which cross-KV producer the batched encode uses for a cross_mode:
    the quantization is fused into the layer loop for the quantized modes,
    so their bf16 (L, B, H, Dh, Ta) stack never exists."""
    if cross_mode == "einsum_q4":
        return wm.cross_kv_q4
    if cross_mode in ("einsum_q8", "pallas_q8dt", "einsum_q8i"):
        return wm.cross_kv_q8
    return wm.cross_kv


def _check_supported(ctx: WhisperContext, p: FullParams, mesh,
                     batch_size: int) -> None:
    """Refuse what the port has not ported yet, with the reason."""
    refused = []
    if mesh is not None:
        refused.append("a device mesh")
    if p.language in (None, "", "auto") or p.detect_language:
        refused.append("language auto-detection / detect_language")
    if p.token_timestamps or ctx.dtw_token_timestamps:
        refused.append("token timestamps and DTW")
    if p.grammar_rules is not None or p.logits_filter_callback:
        refused.append("grammar / logits-filter callbacks")
    if p.suppress_regex:
        refused.append("suppress_regex")
    if refused:
        raise NotImplementedError(
            "whisper_tpu_torch BatchTranscriber does not port: "
            + "; ".join(refused))
    beam = p.strategy == SamplingStrategy.BEAM_SEARCH
    if max(1, p.greedy.best_of,
           p.beam_search.beam_size if beam else 0) > MAX_DECODERS:
        raise ValueError(f"too many decoders requested, max = {MAX_DECODERS}")
    if beam:
        # a stream's beams are coupled rows of one decode call, so unlike
        # greedy best_of they cannot span passes; best_of sizes the t > 0
        # rungs when the ladder is live
        need = p.beam_search.beam_size
        if p.temperature_inc > 0.0:
            need = max(need, p.greedy.best_of)
        if need > batch_size:
            raise ValueError(
                f"beam search needs batch_size >= max(beam_size, ladder "
                f"best_of) = {need} (got {batch_size}): beam and candidate "
                f"rows decode as coupled rows of one batch")
    if _lang_id(p.language) < 0:
        raise ValueError(f"unknown language {p.language!r}")


class StreamState(WhisperState):
    """Per-stream sliding-window session: a WhisperState plus window
    scheduling fields and the stream's padded PCM (the mel is computed on
    the device per window)."""

    def __init__(self, pcm_padded: np.ndarray, seek: int, seek_end: int):
        super().__init__()
        self.pcm_padded = pcm_padded
        self.seek = seek
        self.seek_end = seek_end
        self.done = False
        self.prompt_init: list[int] | None = None


class BatchTranscriber:
    """Transcribe many audio streams concurrently on one device."""

    def __init__(self, ctx: WhisperContext, batch_size: int = 8,
                 params: FullParams | None = None, mesh=None,
                 device_mel: bool = False):
        """device_mel: compute the log-mel on the device, fused into the
        batched encode.  The log-mel max normalization is then per 30 s
        window rather than per stream, as in whisper_tpu.  The host-mel
        path (device_mel=False) is not ported."""
        self.ctx = ctx
        self.B = batch_size
        self.params = params or full_default_params()
        p = self.params
        _check_supported(ctx, p, mesh, batch_size)
        if not device_mel:
            raise NotImplementedError(
                "whisper_tpu_torch BatchTranscriber runs the device-mel "
                "path only (device_mel=True)")
        self.no_timestamps = p.no_timestamps
        self.opts = FilterOptions(
            suppress_blank=p.suppress_blank,
            no_timestamps=p.no_timestamps,
            tdrz_enable=p.tdrz_enable,
            suppress_nst=p.suppress_nst,
            max_initial_ts=p.max_initial_ts,
        )
        # phase wall-time accounting + per-iteration latencies; reset by
        # transcribe(), accumulated by _iterate()
        self.phase_times: dict[str, float] = {
            "upload": 0.0, "prep": 0.0, "encode": 0.0, "decode": 0.0,
            "finish": 0.0}
        self.window_times: list[tuple[int, float]] = []
        # ladder telemetry: windows decoded, and windows that needed at
        # least one retry rung
        self.n_windows = 0
        self.n_retried_windows = 0
        self.prompt_init = self._prompt_init_for(_lang_id(p.language))

    def _prompt_init_for(self, lang_id: int) -> list[int]:
        """[sot, lang?, task?, not?] (reference: whisper.cpp:5627-5651)."""
        ctx = self.ctx
        p = self.params
        prompt = [ctx.vocab.token_sot]
        if ctx.vocab.is_multilingual:
            prompt.append(ctx.vocab.token_lang(lang_id))
            prompt.append(ctx.vocab.token_translate if p.translate
                          else ctx.vocab.token_transcribe)
        if p.no_timestamps:
            prompt.append(ctx.vocab.token_not)
        return prompt

    # -- batched encode ----------------------------------------------------

    def _encode_batch(self, pcm_windows: torch.Tensor):
        """(B, S) padded PCM windows on the device -> the cross-KV of the
        context's cross mode."""
        ctx = self.ctx
        n_ctx = ctx.config.n_audio_ctx
        with torch.no_grad():
            if pcm_windows.dtype == torch.int16:
                pcm_windows = pcm_windows.float() * (1.0 / 32768.0)
            filters = torch.from_numpy(ctx.filters).to(ctx.device)
            mel = log_mel_spectrogram_torch(pcm_windows, filters)
            mel = mel[:, :2 * n_ctx]
            enc = wm.encode(ctx.params, mel, n_head=ctx.config.n_audio_head,
                            compute_dtype=ctx.compute_dtype)
            return _cross_fn_for(ctx.cross_mode)(
                ctx.params, enc, n_head=ctx.config.n_text_head,
                compute_dtype=ctx.compute_dtype)

    def _build_prompts(self, states, batch):
        """(carried-past prompts, bare prompts) for the streams in batch
        (reference prompt assembly: whisper.cpp:5759-5771; the bare ones
        serve the rungs at t >= 0.5)."""
        ctx = self.ctx
        p = self.params
        prompts, prompts_bare = [], []
        for i in batch:
            st = states[i]
            prompt = []
            if st.prompt_past and p.n_max_text_ctx > 0:
                n_take = min(p.n_max_text_ctx,
                             ctx.config.n_text_ctx // 2,
                             len(st.prompt_past))
                prompt = [ctx.vocab.token_prev] + st.prompt_past[-n_take:]
            init = st.prompt_init if st.prompt_init is not None \
                else self.prompt_init
            prompts.append(prompt + init)
            prompts_bare.append(list(init))
        return prompts, prompts_bare

    def _encode_batch_sliced(self, pcm_all: torch.Tensor, rows, starts):
        """Windows cut from the device-resident PCM stack: only (B,) row
        indices and sample offsets cross from the host.  int16 windows are
        converted to f32 after the slice."""
        n_ctx = self.ctx.config.n_audio_ctx
        S = 2 * n_ctx * HOP_LENGTH + N_FFT
        dev = pcm_all.device
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
        # clamp like jax.lax.dynamic_slice: the window always fits
        starts = torch.clamp(starts, 0, pcm_all.shape[1] - S)
        cols = starts[:, None] + torch.arange(S, device=dev)[None, :]
        windows = pcm_all[rows[:, None], cols]
        return self._encode_batch(windows)

    # -- stream scheduling -------------------------------------------------

    def _make_stream(self, pcm) -> StreamState:
        """Host-side per-stream prep: padded PCM (the mel runs on the
        device) and window scheduling fields."""
        p = self.params
        arr = np.asarray(pcm)
        if arr.dtype != np.int16:
            arr = arr.astype(np.float32)
        if len(arr) < 1 + N_FFT // 2:
            # too short for the reflect pad; zero-extend like a silent signal
            arr = np.pad(arr, (0, 1 + N_FFT // 2 - len(arr)))
        padded, _, n_len_org = pad_audio(arr)
        st = StreamState(
            padded, seek=p.offset_ms // 10,
            seek_end=(n_len_org if p.duration_ms == 0
                      else p.offset_ms // 10 + p.duration_ms // 10))
        st.prompt_init = list(self.prompt_init)
        if st.seek_end < st.seek + DELTA_MIN:
            st.done = True
        return st

    def _upload_pcm(self, states) -> torch.Tensor:
        """Every stream's padded PCM in one device tensor (rows padded to
        a batch multiple, length to a 30 s multiple); int16 when every
        stream is int16."""
        s_max = max(len(st.pcm_padded) for st in states)
        gran = 16000 * CHUNK_SIZE
        s_max = -(-s_max // gran) * gran
        n_rows = -(-len(states) // self.B) * self.B
        all_i16 = all(st.pcm_padded.dtype == np.int16 for st in states)
        stack = np.zeros((n_rows, s_max), np.int16 if all_i16 else np.float32)
        for i, st in enumerate(states):
            row = st.pcm_padded
            if not all_i16 and row.dtype == np.int16:
                row = row.astype(np.float32) / 32768.0
            stack[i, :len(row)] = row
        return torch.from_numpy(stack).to(self.ctx.device)

    def transcribe(self, streams: list[np.ndarray]) -> list[list[Segment]]:
        """-> per-stream segment lists."""
        states = [self._make_stream(pcm) for pcm in streams]
        self.phase_times = {
            "upload": 0.0, "prep": 0.0, "encode": 0.0, "decode": 0.0,
            "finish": 0.0}
        self.window_times = []
        t0 = time.perf_counter()
        pcm_dev = self._upload_pcm(states) if states else None
        self.phase_times["upload"] = time.perf_counter() - t0

        while True:
            active = [i for i, st in enumerate(states) if not st.done]
            if not active:
                break
            self._iterate(states, active[:self.B], pcm_dev)

        return [st.result_all for st in states]

    def _iterate(self, states, batch, pcm_dev) -> None:
        """One batched window iteration over the streams in `batch`
        (indices into `states`): encode every stream's current window, run
        the temperature-fallback ladder (or the beam rungs), emit segments
        and advance seeks."""
        p = self.params
        t_iter = time.perf_counter()
        B = len(batch)
        prompts, prompts_bare = self._build_prompts(states, batch)
        self.phase_times["prep"] += time.perf_counter() - t_iter

        # the ladder, rebatching only the failed rows (reference
        # per-decoder ladder: src/whisper.cpp:5706-6230)
        temps = _ladder(p.temperature, p.temperature_inc) or [p.temperature]
        beam = p.strategy == SamplingStrategy.BEAM_SEARCH
        kc = vc = None
        tiled_cache: dict = {}   # the first retry rung's cross-KV, reused
        self.n_windows += B
        pending = list(range(B))   # row indices into batch
        for it, t_cur in enumerate(temps):
            if not pending:
                break
            if it == 1:
                self.n_retried_windows += len(pending)
            last = it == len(temps) - 1
            cur_prompts = prompts if t_cur < 0.5 else prompts_bare
            if beam:
                # slots a stream: beam_size at t = 0, best_of at t > 0
                # (serial: api._full_impl)
                K = (p.beam_search.beam_size if t_cur <= 0.0
                     else p.greedy.best_of)
                pending = self._beam_rung(
                    states, batch, pending, cur_prompts, t_cur, it, last,
                    max(1, min(K, self.B)), pcm_dev)
                continue
            # candidates a window: best_of at t > 0 (whisper.cpp:5718-5724),
            # one at t = 0; not capped at the batch: past it a stream's
            # candidates span passes (_ladder_retry_multipass)
            n_cand = max(1, p.greedy.best_of) if t_cur > 0.0 else 1
            if n_cand > 1:
                # the previous rung's cross-KV goes first: two stacks alive
                # at once is the memory hazard
                kc = vc = None
                pending = self._ladder_retry_tiled(
                    states, batch, pending, cur_prompts, t_cur, it, last,
                    n_cand, pcm_dev, tiled_cache)
                continue
            # one candidate a stream, rows in their batch positions, slots
            # padded to the fixed batch size
            if kc is None:
                t0 = time.perf_counter()
                kc, vc = self._encode_slots(
                    states, list(batch) + [None] * (self.B - B), pcm_dev)
                self.phase_times["encode"] += time.perf_counter() - t0
            live = np.zeros((self.B,), bool)
            live[pending] = True
            seeks = np.zeros((self.B,), np.int32)
            ends = np.zeros((self.B,), np.int32)
            keys = np.zeros((self.B, 2), np.uint32)
            for r in pending:
                st = states[batch[r]]
                seeks[r] = st.seek
                ends[r] = st.seek_end
                keys[r] = window_rng(st.seek, it, 1)[0]
            t0 = time.perf_counter()
            out = self._decode_rows(
                [cur_prompts[r] if live[r] else list(self.prompt_init)
                 for r in range(self.B)],
                kc, vc, live, seeks, ends, t_cur, keys)
            self.phase_times["decode"] += time.perf_counter() - t0
            pending = self._finish_groups(
                states, batch, [(r, r, cur_prompts[r]) for r in pending],
                out, 1, last)
        self.window_times.append((B, time.perf_counter() - t_iter))

    def _finish_groups(self, states, batch, groups, out, n_cand, last):
        """Rank each group's n_cand candidate rows of `out` and emit the
        winner of every group whose rung succeeded.  groups: (batch row r,
        the group's first row in out, its prompt).  -> rows still failed."""
        t0 = time.perf_counter()
        still_failed = []
        for r, row0, prompt in groups:
            best, _ = _rank_window_candidates(
                out, n_cand, self.params, last, self.ctx.vocab.token_eot,
                row0=row0)
            if best is None:
                still_failed.append(r)
            else:
                best["prompt"] = prompt
                self._finish_window(states[batch[r]], best)
        self.phase_times["finish"] += time.perf_counter() - t0
        return still_failed

    def _ladder_retry_tiled(self, states, batch, pending, cur_prompts,
                            t_cur, it, last, n_cand, pcm_dev,
                            tiled_cache: dict) -> list[int]:
        """A rung of best_of > 1 candidates a pending stream: each stream
        gets n_cand consecutive slots of the fixed-B batch, its window
        encoded into each, and keeps the best by sequence score (the
        reference's GREEDY best_of, whisper.cpp:5718-5724).  Keys come from
        (seek, attempt, candidate), so the candidates are the serial
        `full` ladder's.  tiled_cache keeps a single-chunk layout's
        cross-KV for the later rungs (a stream that succeeds leaves its
        slots dead).  -> rows still failed."""
        if n_cand > self.B:
            return self._ladder_retry_multipass(
                states, batch, pending, cur_prompts, t_cur, it, last,
                n_cand, pcm_dev)
        groups_per_pass = max(1, self.B // n_cand)
        reuse = (tiled_cache.get("n_cand") == n_cand
                 and set(pending) <= set(tiled_cache["layout"]))
        chunks = ([tiled_cache["layout"]] if reuse else
                  [pending[c0:c0 + groups_per_pass]
                   for c0 in range(0, len(pending), groups_per_pass)])
        still_failed: list[int] = []
        for chunk in chunks:
            if reuse:
                kc, vc = tiled_cache["kv"]
            else:
                slots: list = []
                for r in chunk:
                    slots.extend([batch[r]] * n_cand)
                slots.extend([None] * (self.B - len(slots)))
                t0 = time.perf_counter()
                kc = vc = None   # the previous chunk's stack goes first
                kc, vc = self._encode_slots(states, slots, pcm_dev)
                self.phase_times["encode"] += time.perf_counter() - t0
                if len(chunks) == 1:
                    tiled_cache.update(n_cand=n_cand, layout=list(chunk),
                                       kv=(kc, vc))

            prompts_t = [list(self.prompt_init) for _ in range(self.B)]
            live = np.zeros((self.B,), bool)
            seeks = np.zeros((self.B,), np.int32)
            ends = np.zeros((self.B,), np.int32)
            keys = np.zeros((self.B, 2), np.uint32)
            groups = []
            for g, r in enumerate(chunk):
                if r not in pending:
                    continue   # succeeded at an earlier rung: slots dead
                st = states[batch[r]]
                s0 = g * n_cand
                groups.append((r, s0, cur_prompts[r]))
                live[s0:s0 + n_cand] = True
                seeks[s0:s0 + n_cand] = st.seek
                ends[s0:s0 + n_cand] = st.seek_end
                keys[s0:s0 + n_cand] = window_rng(st.seek, it, n_cand)
                for c in range(n_cand):
                    prompts_t[s0 + c] = cur_prompts[r]
            t0 = time.perf_counter()
            out = self._decode_rows(prompts_t, kc, vc, live, seeks, ends,
                                    t_cur, keys)
            self.phase_times["decode"] += time.perf_counter() - t0
            still_failed += self._finish_groups(states, batch, groups, out,
                                                n_cand, last)
        return still_failed

    def _ladder_retry_multipass(self, states, batch, pending, cur_prompts,
                                t_cur, it, last, n_cand,
                                pcm_dev) -> list[int]:
        """A rung with best_of > batch_size: one stream at a time, its
        n_cand candidates decoded B a pass (the keys of the one-pass
        tiling: window_rng is keyed by candidate index, not slot), ranked
        over the merged passes.  -> rows still failed."""
        still_failed: list[int] = []
        for r in pending:
            st = states[batch[r]]
            # every slot carries this stream's window, encoded once
            t0 = time.perf_counter()
            kc, vc = self._encode_slots(states, [batch[r]] * self.B, pcm_dev)
            self.phase_times["encode"] += time.perf_counter() - t0
            group_keys = window_rng(st.seek, it, n_cand)
            outs = []
            for c0 in range(0, n_cand, self.B):
                cc = min(self.B, n_cand - c0)
                live = np.arange(self.B) < cc
                keys = np.zeros((self.B, 2), np.uint32)
                keys[:cc] = group_keys[c0:c0 + cc]
                t0 = time.perf_counter()
                out = self._decode_rows(
                    [cur_prompts[r] if c < cc else list(self.prompt_init)
                     for c in range(self.B)], kc, vc, live,
                    np.full((self.B,), st.seek, np.int32),
                    np.full((self.B,), st.seek_end, np.int32), t_cur, keys)
                self.phase_times["decode"] += time.perf_counter() - t0
                outs.append((out, cc))
            kc = vc = None
            still_failed += self._finish_groups(
                states, batch, [(r, 0, cur_prompts[r])],
                _merge_candidate_rows(outs), n_cand, last)
        return still_failed

    def _beam_rung(self, states, batch, pending, cur_prompts, t_cur, it,
                   last, K, pcm_dev) -> list[int]:
        """One beam rung: chunks of S = B // K streams a decode call, each
        stream K beam rows against its one cross-KV row, per-stream keys
        (window_rng(seek, attempt), the serial beam's).  -> rows still
        failed."""
        S = max(1, self.B // K)
        still_failed: list[int] = []
        for c0 in range(0, len(pending), S):
            chunk = pending[c0:c0 + S]
            t0 = time.perf_counter()
            kc, vc = self._encode_slots(
                states, [batch[r] for r in chunk] + [None] * (S - len(chunk)),
                pcm_dev)
            self.phase_times["encode"] += time.perf_counter() - t0
            prompts_t = [list(self.prompt_init) for _ in range(S)]
            live = np.zeros((S,), bool)
            seeks = np.zeros((S,), np.int32)
            ends = np.zeros((S,), np.int32)
            keys = np.zeros((S, 2), np.uint32)
            for g, r in enumerate(chunk):
                st = states[batch[r]]
                prompts_t[g] = cur_prompts[r]
                live[g] = True
                seeks[g] = st.seek
                ends[g] = st.seek_end
                keys[g] = window_rng(st.seek, it, 1, per_row=False)
            t0 = time.perf_counter()
            out = self._decode_rows(prompts_t, kc, vc, live, seeks, ends,
                                    t_cur, keys, beam_size=K)
            self.phase_times["decode"] += time.perf_counter() - t0
            still_failed += self._finish_groups(
                states, batch,
                [(r, g * K, cur_prompts[r]) for g, r in enumerate(chunk)],
                out, K, last)
        return still_failed

    def _encode_slots(self, states, slot_streams, pcm_dev):
        """Batched encode where slot i carries stream slot_streams[i]'s
        current window (None = dead slot, row 0 at offset 0)."""
        nB = len(slot_streams)
        rows_idx = np.zeros((nB,), np.int64)
        starts = np.zeros((nB,), np.int64)
        for row, si in enumerate(slot_streams):
            if si is None:
                continue
            rows_idx[row] = si
            starts[row] = states[si].seek * HOP_LENGTH
        return self._encode_batch_sliced(pcm_dev, rows_idx, starts)

    def _prompt_bucket(self, prompts) -> int:
        """Fixed prompt-buffer size: one small bucket for bare prompts, one
        carried-past bucket sized by how much past the params allow."""
        if max(len(q) for q in prompts) <= 8:
            return 8
        cap = min(self.params.n_max_text_ctx, self.ctx.config.n_text_ctx // 2)
        need = 1 + cap + len(self.prompt_init)   # token_prev + past + init
        return max(8, (need + 7) // 8 * 8)

    def _decode_rows(self, prompts, kc, vc, live, seeks, ends, t_cur,
                     keys, beam_size: int = 0):
        """Decode `prompts[r]` against cross-KV row r for every live row,
        with per-row keys (B, 2); dead rows decode their own (masked,
        ignored) window.  beam_size K > 0: per-stream rows and (S, 2)
        keys, K beams a stream, per-beam output rows (stream s at rows
        [s*K, (s+1)*K))."""
        ctx = self.ctx
        p = self.params
        P = self._prompt_bucket([q for r, q in enumerate(prompts)
                                 if live[r]] or [self.prompt_init])
        n = len(prompts)
        buf = np.zeros((n, P), np.int32)
        pad_len = np.full((n,), P - 1, np.int32)
        for row, q in enumerate(prompts):
            pad_len[row] = P - len(q)
            buf[row, P - len(q):] = q
        if beam_size:
            fn = ctx._beam_batch_window_fn(
                n, beam_size, P, self.opts, p.single_segment,
                self.no_timestamps, p.max_tokens)
        else:
            assert n == self.B
            fn = ctx._decode_window_fn(
                n, P, self.opts, p.single_segment, self.no_timestamps,
                p.max_tokens, "greedy")
        return fn(ctx.params, kc, vc, buf, pad_len, t_cur, seeks, ends,
                  keys, live)

    def warmup(self, pcm_dtype=np.float32) -> None:
        """Run the encoder and both prompt-bucket decode variants once, so
        the first request pays no one-time set-up (kernel build, cuBLAS
        handles, allocator growth)."""
        ctx = self.ctx
        S = 2 * ctx.config.n_audio_ctx * HOP_LENGTH + N_FFT
        pcm = torch.from_numpy(np.zeros((self.B, S), pcm_dtype))
        kc, vc = self._encode_batch(pcm.to(ctx.device))
        bare = list(self.prompt_init)
        cap = min(self.params.n_max_text_ctx, ctx.config.n_text_ctx // 2)
        carried = [ctx.vocab.token_prev] + [0] * cap + bare
        live = np.zeros((self.B,), bool)
        live[0] = True
        zeros = np.zeros((self.B,), np.int32)
        keys = np.zeros((self.B, 2), np.uint32)
        for prompt in (bare, carried):
            self._decode_rows([prompt] * self.B, kc, vc, live, zeros, zeros,
                              0.0, keys)

    def _finish_window(self, st: StreamState, best: dict) -> None:
        """Emit one window's winning candidate into the stream's session
        state and advance its seek (best: _rank_window_candidates output
        plus "prompt")."""
        ctx = self.ctx
        p = self.params
        st.no_speech_prob = best["no_speech_prob"]

        if ctx.n_loaded == 0:
            st.seek += TICKS_PER_SECOND * CHUNK_SIZE
        else:
            with ctx.use_state(st):
                ctx.no_speech_prob = st.no_speech_prob
                st.seek = ctx._emit_segments(best, st.seek, st.seek_end, p,
                                             st.prompt_init
                                             or self.prompt_init,
                                             self.no_timestamps)

        if st.seek + DELTA_MIN >= st.seek_end:
            st.done = True
        if st.seek > 0 and st.seek + 500 >= st.seek_end:
            st.prompt_past = []
