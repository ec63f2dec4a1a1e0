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

The port decodes greedily at temperature 0 with the int8 cross-KV
("einsum_q8").  Everything else the JAX class offers is refused with an
error rather than run on another path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..api import (FullParams, SamplingStrategy, Segment, WhisperContext,
                   WhisperState, _rank_window_candidates,
                   full_default_params)
from ..audio.mel import log_mel_spectrogram_torch, pad_audio
from ..constants import (CHUNK_SIZE, HOP_LENGTH, MAX_DECODERS, N_FFT,
                         TICKS_PER_SECOND)
from ..decode.filters import FilterOptions
from ..decode.loop import DELTA_MIN
from ..languages import lang_id as _lang_id
from ..models import whisper as wm


def _check_supported(ctx: WhisperContext, p: FullParams, mesh) -> None:
    """Refuse what the port has not ported yet, with the reason."""
    refused = []
    if mesh is not None:
        refused.append("a device mesh")
    if p.strategy == SamplingStrategy.BEAM_SEARCH:
        refused.append("beam search")
    if p.temperature > 0.0 or p.temperature_inc > 0.0:
        refused.append("temperature > 0 / the fallback ladder "
                       "(temperature_inc > 0 needs JAX's threefry draws)")
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
    # best_of only sizes the t > 0 rungs, refused above; the default of 5
    # is accepted and, as in whisper_tpu, unused at t = 0
    if max(1, p.greedy.best_of) > MAX_DECODERS:
        raise ValueError(f"too many decoders requested, max = {MAX_DECODERS}")
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
        _check_supported(ctx, p, mesh)
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
        self.n_windows = 0
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
        """(B, S) padded PCM windows on the device -> int8 cross-KV."""
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
            return wm.cross_kv_q8(ctx.params, enc,
                                  n_head=ctx.config.n_text_head,
                                  compute_dtype=ctx.compute_dtype)

    def _build_prompts(self, states, batch):
        """Carried-past prompts for the streams in batch (reference prompt
        assembly: whisper.cpp:5759-5771)."""
        ctx = self.ctx
        p = self.params
        prompts = []
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
        return prompts

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
        (indices into `states`): encode every stream's current window,
        decode greedily, emit segments and advance seeks."""
        ctx = self.ctx
        p = self.params
        t_iter = time.perf_counter()
        B = len(batch)
        prompts = self._build_prompts(states, batch)
        self.phase_times["prep"] += time.perf_counter() - t_iter

        # the single greedy rung: one candidate per stream, rows stay in
        # their batch positions; slots are padded to the fixed batch size
        self.n_windows += B
        t0 = time.perf_counter()
        kc, vc = self._encode_slots(
            states, list(batch) + [None] * (self.B - B), pcm_dev)
        self.phase_times["encode"] += time.perf_counter() - t0
        live = np.zeros((self.B,), bool)
        live[:B] = True
        seeks = np.zeros((self.B,), np.int32)
        ends = np.zeros((self.B,), np.int32)
        for r in range(B):
            st = states[batch[r]]
            seeks[r] = st.seek
            ends[r] = st.seek_end
        t0 = time.perf_counter()
        out = self._decode_rows(
            [prompts[r] if r < B else list(self.prompt_init)
             for r in range(self.B)],
            kc, vc, live, seeks, ends, p.temperature)
        self.phase_times["decode"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in range(B):
            best, _ = _rank_window_candidates(
                out, 1, p, True, ctx.vocab.token_eot, row0=r)
            best["prompt"] = prompts[r]
            self._finish_window(states[batch[r]], best)
        self.phase_times["finish"] += time.perf_counter() - t0
        self.window_times.append((B, time.perf_counter() - t_iter))

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

    def _decode_rows(self, prompts, kc, vc, live, seeks, ends, t_cur):
        """Decode `prompts[r]` against cross-KV row r for every live row;
        dead rows decode their own (masked, ignored) window."""
        ctx = self.ctx
        p = self.params
        B = self.B
        assert len(prompts) == B
        P = self._prompt_bucket([q for r, q in enumerate(prompts)
                                 if live[r]] or [self.prompt_init])
        buf = np.zeros((B, P), np.int32)
        pad_len = np.full((B,), P - 1, np.int32)
        for row, q in enumerate(prompts):
            pad_len[row] = P - len(q)
            buf[row, P - len(q):] = q
        fn = ctx._decode_window_fn(
            B, P, self.opts, p.single_segment, self.no_timestamps,
            p.max_tokens, "greedy")
        return fn(ctx.params, kc, vc, buf, pad_len, t_cur, seeks, ends,
                  live)

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
        for prompt in (bare, carried):
            self._decode_rows([prompt] * self.B, kc, vc, live, zeros, zeros,
                              0.0)

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
