"""Batched multi-stream transcription (port of whisper_tpu.parallel.batch).

B independent 30 s windows (from different streams, or chunks of one long
stream) ride one batched encoder pass and one window-decode loop.  Each
stream keeps its own sliding-window state (seek, prompt-past, segments) on
the host, so streams may advance by different seek deltas.

By default (device_mel=False) each stream's log-mel is computed on the
host once (audio/mel.log_mel_spectrogram) and every iteration uploads the
(B, 2*n_ctx, n_mels) windows.  With device_mel, every stream's padded PCM
(packed int16 when the input is int16) is uploaded once when the stack
stays under 1 GiB; per iteration only row indices and sample offsets
choose the windows, which are cut, converted to f32 and turned into
log-mel on the device (otherwise each iteration uploads its PCM windows).

Language "auto" (and detect_language) rides the batch: a batched [sot]
step over each fresh stream's first window resolves its language before
its first window decodes.  Token timestamps use the signal-energy
heuristic on each stream's energy.  `ContinuousBatcher` refills the batch
between window iterations: the serving engine of server.py.

The port decodes in every cross mode of whisper_tpu
(decode/loop.CROSS_MODES), over dense or block-quantized (K3) decoder
weights; the batched encode produces the cross-KV each mode reads
(`_cross_fn_for`).  Greedy windows run the temperature-fallback ladder,
rebatching only the failed rows, with best_of candidates a stream at
t > 0 drawn from per-row keys (`window_rng`), so a window's candidates do
not depend on its slot or its batch.  Beam search decodes S streams x K
beams as rows of one batch against S cross-KV rows (decode/beam.py).
On an audio-LLM context (api.AudioLLMContext: Whisper's encoder feeding
the language model of models/uni_moe_omni.py) the same staging, device
mel and batched encode feed `_iterate_llm`: the window's audio tokens,
a prefill and greedy steps, one segment of token ids a window.
With the context's dtw_token_timestamps, an iteration's finished windows
share one teacher-forced cross-QK re-decode per DTW_QK_ROWS rows, and the
host stamps each row's tokens (dtw.py).  Grammars and logits-filter
callbacks decode on the serial `full`'s host loop, and are refused here
with ValueError, as whisper_tpu refuses them.

With a device mesh (parallel/mesh.py; one process per card, every rank
calling transcribe with the same streams) the context's params are
sharded over "model", and each encode, language pre-pass, window decode
and DTW pass whose slot count divides over the data axes runs this rank's
rows and all-gathers the host results, so every rank's stream states
advance alike.  The resident PCM stack of transcribe is off under a mesh,
as in whisper_tpu.  ContinuousBatcher runs over a tensor-parallel mesh
(n_data = n_slice = 1) under parallel/conductor.py: rank 0 schedules and
broadcasts each iteration's plan, and every other rank replays it (see the
class).  It refuses a data-parallel mesh (NotImplementedError), where
whisper_tpu's engine fails every job.
"""

from __future__ import annotations

import hashlib
import math
import os
import queue
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..api import (AudioLLMContext, FullParams, SamplingStrategy, Segment,
                   TokenData, WhisperContext, WhisperState, _ladder,
                   _rank_window_candidates, full_default_params, window_rng)
from ..audio.mel import (frames_org, log_mel_spectrogram,
                         log_mel_spectrogram_torch, pad_audio,
                         pad_audio_into, padded_length)
from ..constants import (CHUNK_SIZE, HOP_LENGTH, MAX_DECODERS, N_FFT,
                         SAMPLE_RATE, TICKS_PER_SECOND)
from ..decode.filters import FilterOptions
from ..decode.loop import DELTA_MIN, prompt_cross_kv
from ..dtw import (dtw_aheads_select, dtw_cross_qk, dtw_pad_tokens,
                   dtw_stamp_segments, dtw_token_sequence)
from ..languages import lang_id as _lang_id, lang_str
from ..models import uni_moe_omni as omni
from ..models import whisper as wm
from ..timestamps import get_signal_energy
from ..utils.logging import log_error, log_info
from ..utils.trace import TRACE


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
    """Refuse what the batch cannot decode, with the reason."""
    if isinstance(ctx, AudioLLMContext):
        _check_llm_supported(p, mesh)
        return
    if mesh is not None:
        # imported here: `python -m whisper_tpu_torch.parallel.mesh` runs
        # that module as __main__, which the package import must not load
        from .mesh import Mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh),"
                            f" got {type(mesh).__name__}")
        if batch_size % mesh.n_data:
            raise ValueError(f"batch_size {batch_size} must divide over "
                             f"data={mesh.n_data}")
    if p.grammar_rules is not None or p.logits_filter_callback:
        # grammar decoding is a host-coupled pushdown automaton between
        # device steps: the serial full() decodes it
        raise ValueError(
            "grammar / logits-filter decoding is host-looped — use the "
            "serial ctx.full() path (the server routes this "
            "automatically)")
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
    if not _auto_lang(p) and _lang_id(p.language) < 0:
        raise ValueError(f"unknown language {p.language!r}")


def _check_llm_supported(p: FullParams, mesh) -> None:
    """Refuse what an audio-LLM context's windows have no meaning for: it
    decodes each 30 s window greedily to token ids, on one device, with
    no text carried between windows."""
    refused = {
        "a device mesh": mesh is not None,
        "timestamps (no_timestamps must be set)": not p.no_timestamps,
        "token timestamps and DTW": p.token_timestamps,
        "beam search": p.strategy == SamplingStrategy.BEAM_SEARCH,
        "sampling and the temperature ladder (temperature and "
        "temperature_inc must be 0)": p.temperature > 0
        or p.temperature_inc > 0,
        "language detection": _auto_lang(p),
        "carried prompts (initial_prompt, prompt_tokens, no_context "
        "off)": bool(p.initial_prompt or p.prompt_tokens)
        or not p.no_context,
        "grammars and logits filters": p.grammar_rules is not None
        or p.logits_filter_callback is not None,
        "an unbounded window (max_tokens must be > 0)": p.max_tokens <= 0,
    }
    for what, asked in refused.items():
        if asked:
            raise ValueError(f"an audio-LLM context transcribes greedy "
                             f"windows of token ids: {what} is not "
                             "supported")


def _auto_lang(p: FullParams) -> bool:
    """Whether a batched [sot] pre-pass resolves each stream's language."""
    return p.language in (None, "", "auto") or p.detect_language


def _device_pcm(pcm) -> np.ndarray:
    """A stream as the device mel takes it: int16 stays packed until after
    the window slice on the device, anything else is f32; too short for
    the reflect pad, it is zero-extended like silence."""
    arr = np.asarray(pcm)
    if arr.dtype != np.int16:
        arr = np.asarray(arr, np.float32)
    if len(arr) < 1 + N_FFT // 2:
        arr = np.pad(arr, (0, 1 + N_FFT // 2 - len(arr)))
    return arr


# threads that write the resident stack's rows (numpy's copies release the
# interpreter lock): 256 x 90 s int16 rows took 0.19-0.21 s on one thread
# of an 8-core H100 host, 0.07 s on 4 and 0.045-0.05 s on 8
_FILL_THREADS = min(8, len(os.sched_getaffinity(0))
                    if hasattr(os, "sched_getaffinity")
                    else os.cpu_count() or 1)


class StreamState(WhisperState):
    """Per-stream sliding-window session: a WhisperState plus window
    scheduling fields.  `mel` is the host log-mel (device_mel=False), or
    `pcm_padded` the padded PCM the device turns into log-mel (None when
    the stream's row of transcribe's resident stack holds it); `pcm_row`
    is the stream's row of a resident PCM pool (ContinuousBatcher)."""

    def __init__(self, mel, seek: int, seek_end: int):
        super().__init__()
        self.mel = mel
        self.pcm_padded: np.ndarray | None = None
        self.pcm_row: int | None = None
        self.seek = seek
        self.seek_end = seek_end
        self.done = False
        # [sot, lang, task, ...]: None until the language pre-pass
        # resolves an auto-language stream
        self.prompt_init: list[int] | None = None
        self.lang_probs: np.ndarray | None = None


class BatchTranscriber:
    """Transcribe many audio streams concurrently on one device, or over a
    device mesh (one process a card)."""

    def __init__(self, ctx: WhisperContext, batch_size: int = 8,
                 params: FullParams | None = None, mesh=None,
                 device_mel: bool = False):
        """device_mel: compute the log-mel on the device, fused into the
        batched encode.  The log-mel max normalization is then per 30 s
        window rather than per stream, as in whisper_tpu; off by default,
        so that batch == serial stays token-exact.

        mesh: a parallel.mesh.Mesh; batch_size must divide over its data
        axes.  The context's params are replaced by this rank's shard and
        the context keeps the mesh (a later BatchTranscriber without one
        runs on it too)."""
        self.ctx = ctx
        self.B = batch_size
        self.device_mel = device_mel
        self.params = params or full_default_params()
        p = self.params
        _check_supported(ctx, p, mesh, batch_size)
        # an audio-LLM context's language model (its windows decode through
        # _iterate_llm), None for a WhisperContext
        self.llm = ctx.llm if isinstance(ctx, AudioLLMContext) else None
        if mesh is not None and ctx.mesh is not mesh:
            from .mesh import shard_params
            ctx.params = shard_params(ctx.params, mesh)
            ctx.mesh = mesh
            ctx._fn_cache.clear()   # window fns built for the whole batch
        self.mesh = ctx.mesh
        self.auto_lang = _auto_lang(p)
        self.no_timestamps = p.no_timestamps
        self.opts = FilterOptions(
            suppress_blank=p.suppress_blank,
            no_timestamps=p.no_timestamps,
            tdrz_enable=p.tdrz_enable,
            suppress_nst=p.suppress_nst,
            max_initial_ts=p.max_initial_ts,
        )
        # ladder telemetry: windows decoded, and windows that needed at
        # least one retry rung
        self.n_windows = 0
        self.n_retried_windows = 0
        self.last_states: list[StreamState] = []
        # transcribe's reused host buffer for the resident PCM stack (pinned
        # on the card), and the event of its last copy to the device
        self._stage: torch.Tensor | None = None
        self._staged = None
        # finished windows awaiting the batched DTW cross-QK pass
        # (ctx.dtw_token_timestamps): (st, i_seg, n_new, seek, n_frames,
        # the stream's index into `states`)
        self._dtw_jobs: list[tuple] = []
        # the template prompt (pad rows, warmup, bucket sizing); an
        # auto-language stream gets a copy with its detected language token,
        # of the same length
        self.prompt_init = [] if self.llm is not None else \
            self._prompt_init_for(0 if self.auto_lang
                                  else _lang_id(p.language))
        # the language model's KV cache, made at its first window; and
        # when a dict, each window's routing, {(stream index, seek): (kept
        # experts (T, L, top_k) int8, router probabilities (T, L, E + N0))}
        self._kv: dict | None = None
        self.routes: dict | None = None

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

    def _encode_batch(self, windows: torch.Tensor):
        """Windows on the device -> the cross-KV of the context's cross
        mode: (B, S) padded PCM (device mel) or (B, 2*n_ctx, n_mels)
        log-mel (host mel)."""
        ctx = self.ctx
        n_ctx = ctx.config.n_audio_ctx
        with torch.no_grad():
            mel = windows
            if windows.ndim == 2:
                if windows.dtype == torch.int16:
                    windows = windows.float() * (1.0 / 32768.0)
                filters = torch.from_numpy(ctx.filters).to(ctx.device)
                mel = log_mel_spectrogram_torch(windows, filters)
                mel = mel[:, :2 * n_ctx]
            enc = wm.encode(ctx.params, mel, n_head=ctx.config.n_audio_head,
                            compute_dtype=ctx.compute_dtype)
            if self.llm is not None:
                return omni.connect(ctx.params, enc, self.llm)
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

    # -- batched language auto-detection ----------------------------------

    def _detect_probs(self, kc, vc) -> np.ndarray:
        """One [sot] step over the batch's cross-KV -> (B, 100) f32 softmax
        over the language-token logits (reference serial form:
        whisper_lang_auto_detect_with_state, whisper.cpp:4027-4108).  The
        quantized modes' (codes, scales) pairs are tagged for
        decode_prompt, as the window loop's prompt pass tags them."""
        ctx = self.ctx
        kc, vc = prompt_cross_kv(ctx.cross_mode, kc, vc)
        B = (kc[1] if isinstance(kc, tuple) else kc).shape[1]
        dev = ctx.device
        with torch.no_grad():
            logits, _, _ = wm.decode_prompt(
                ctx.params,
                torch.full((B, 1), ctx.vocab.token_sot, dtype=torch.long,
                           device=dev),
                torch.zeros((B, 1), dtype=torch.long, device=dev), kc, vc,
                n_head=ctx.config.n_text_head,
                compute_dtype=ctx.compute_dtype)
            lang_tok = torch.tensor(
                [ctx.vocab.token_lang(i) for i in range(100)], device=dev)
            ll = logits[:, -1, :].float()[:, lang_tok]
            return torch.softmax(ll, dim=-1).cpu().numpy()

    def _detect_languages(self, states, rows, pcm_dev=None) -> None:
        """Resolve auto-language streams in one batched pre-pass: encode
        each stream's first window (offset 0, like the serial path), run
        one [sot] decode step, take the most probable language and pin the
        stream's prompt language token (the reference's parallel path
        detects per chunk the same way: whisper_full_parallel -> :5504 ->
        :4027-4108)."""
        slot_streams = [rows[i] if i < len(rows) else None
                        for i in range(self.B)]
        kc, vc = self._encode_slots(states, slot_streams, pcm_dev,
                                    seeks=np.zeros((self.B,), np.int64))
        probs = self._gather(self.B, self._detect_probs(kc, vc))
        for i, si in enumerate(rows):
            st = states[si]
            lid = int(np.argmax(probs[i]))
            st.lang_id_state = lid
            st.lang_probs = probs[i].copy()
            st.prompt_init = self._prompt_init_for(lid)
            log_info(f"auto-detected language: {lang_str(lid)} "
                     f"(p = {probs[i][lid]:.6f})")

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

    def _make_stream(self, pcm, arr=None) -> StreamState:
        """Host-side per-stream prep: the log-mel (or the padded PCM for
        device_mel), the signal energy for token timestamps, and window
        scheduling fields.  arr: the stream's `_device_pcm` when its row
        of transcribe's resident stack is its padded PCM (no copy here)."""
        p = self.params
        if self.device_mel:
            # the device computes the mel; the host only pads (reflect
            # head, 30 s zero tail)
            st = StreamState(None, 0, 0)
            if arr is None:
                st.pcm_padded, _, n_len_org = pad_audio(_device_pcm(pcm))
            else:
                n_len_org = frames_org(len(arr))
        else:
            mel, n_len_org = log_mel_spectrogram(np.asarray(pcm),
                                                 self.ctx.filters)
            st = StreamState(mel, 0, 0)
        st.seek = p.offset_ms // 10
        st.seek_end = (n_len_org if p.duration_ms == 0
                       else p.offset_ms // 10 + p.duration_ms // 10)
        if p.token_timestamps:
            # the per-stream signal energy the serial full() computes
            # (reference: whisper.cpp:5523), which segment emission reads
            arr = np.asarray(pcm)
            if arr.dtype == np.int16:
                arr = arr.astype(np.float32) / 32768.0
            st.energy = get_signal_energy(arr, 32)
        if not self.auto_lang:
            st.prompt_init = list(self.prompt_init)
        if st.seek_end < st.seek + DELTA_MIN:
            st.done = True
        return st

    def _resident_pcm(self, streams) -> list[np.ndarray] | None:
        """Each stream's `_device_pcm` when transcribe keeps the call's
        padded PCM resident on the device (device_mel, no mesh: each rank
        cuts its own rows, and the padded streams within RESIDENT_BYTES),
        else None."""
        if not (self.device_mel and self.mesh is None and len(streams)):
            return None
        arrs = [_device_pcm(pcm) for pcm in streams]
        if sum(padded_length(len(a)) * a.itemsize for a in arrs) \
                > self.RESIDENT_BYTES:
            return None
        return arrs

    def _upload_pcm(self, arrs) -> torch.Tensor:
        """The streams' padded PCM in one device tensor (rows padded to a
        batch multiple, length to a 30 s multiple); int16 when every
        stream is int16, else f32.  Each row is written once
        (pad_audio_into) into the reused staging buffer, which one
        asynchronous copy takes to the device."""
        with TRACE.span("upload") as sp:
            gran = SAMPLE_RATE * CHUNK_SIZE
            s_max = max(padded_length(len(a)) for a in arrs)
            s_max = -(-s_max // gran) * gran
            n_rows = -(-len(arrs) // self.B) * self.B
            dtype = (np.int16 if all(a.dtype == np.int16 for a in arrs)
                     else np.float32)
            host = self._staging((n_rows, s_max), dtype)
            stack = host.numpy()

            def fill(rows):
                for i in rows:
                    pad_audio_into(arrs[i], stack[i])

            k = min(_FILL_THREADS, len(arrs))
            with ThreadPoolExecutor(k) as ex:
                list(ex.map(fill, [range(j, len(arrs), k) for j in range(k)]))
            stack[len(arrs):] = 0
            sp.value = stack.nbytes
            dev = self.ctx.device
            if dev.type != "cuda":
                return host     # read in place until the next call refills it
            pcm_dev = host.to(dev, non_blocking=True)
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(dev))
            TRACE.count("pcm_staged", stack.nbytes)
            return pcm_dev

    def _staging(self, shape, dtype) -> torch.Tensor:
        """A (shape) dtype view of the transcriber's reused host buffer:
        pinned for a CUDA device, grown when a call needs more, and handed
        out only once its last copy to the device has ended."""
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if self._staged is not None:
            self._staged.synchronize()
        if self._stage is None or self._stage.numel() < nbytes:
            self._stage = None
            self._stage = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.ctx.device.type == "cuda")
        tdtype = torch.int16 if dtype == np.int16 else torch.float32
        return self._stage[:nbytes].view(tdtype).view(shape)

    # the resident PCM stack of transcribe() stays under this many bytes;
    # past it each iteration uploads its windows
    RESIDENT_BYTES = 1 << 30

    def transcribe(self, streams: list[np.ndarray]) -> list[list[Segment]]:
        """-> per-stream segment lists; the streams' states (detected
        languages among them) are left in `last_states`."""
        with TRACE.span("transcribe", len(streams)):
            with TRACE.span("prep", len(streams)):
                arrs = self._resident_pcm(streams)
                states = [self._make_stream(
                    pcm, None if arrs is None else arrs[i])
                    for i, pcm in enumerate(streams)]
            pcm_dev = None if arrs is None else self._upload_pcm(arrs)

            iterate = self._iterate if self.llm is None else self._iterate_llm
            while True:
                active = [i for i, st in enumerate(states) if not st.done]
                if not active:
                    break
                iterate(states, active[:self.B], pcm_dev)

        self.last_states = states
        return [st.result_all for st in states]

    def _iterate(self, states, batch, pcm_dev=None) -> None:
        """One batched window iteration over the streams in `batch`
        (indices into `states`): encode every stream's current window, run
        the temperature-fallback ladder (or the beam rungs), emit segments
        and advance seeks.  ContinuousBatcher calls it directly, refilling
        `batch` between iterations."""
        with TRACE.span("iterate", len(batch)):
            p = self.params
            B = len(batch)

            # the language pre-pass for auto-language streams joining the batch
            # (fresh streams of the continuous engine arrive unresolved)
            fresh = [i for i in batch if states[i].prompt_init is None]
            if fresh:
                self._detect_languages(states, fresh, pcm_dev)
                if p.detect_language:
                    # detection is the request (reference: whisper.cpp:5515)
                    for i in fresh:
                        states[i].done = True
                    return

            prompts, prompts_bare = self._build_prompts(states, batch)

            # the ladder, rebatching only the failed rows (reference
            # per-decoder ladder: src/whisper.cpp:5706-6230)
            temps = (_ladder(p.temperature, p.temperature_inc)
                     or [p.temperature])
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
                # candidates a window: best_of at t > 0
                # (whisper.cpp:5718-5724), one at t = 0; not capped at the
                # batch: past it a stream's candidates span passes
                # (_ladder_retry_multipass)
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
                    kc, vc = self._encode_slots(
                        states, list(batch) + [None] * (self.B - B), pcm_dev)
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
                out = self._decode_rows(
                    [cur_prompts[r] if live[r] else list(self.prompt_init)
                     for r in range(self.B)],
                    kc, vc, live, seeks, ends, t_cur, keys)
                pending = self._finish_groups(
                    states, batch, [(r, r, cur_prompts[r]) for r in pending],
                    out, 1, last)
            if self._dtw_jobs:
                # the ladder's cross-KV goes before the DTW pass makes its own
                kc = vc = None
                tiled_cache.clear()
                self._run_dtw_jobs(states, pcm_dev)

    def _iterate_llm(self, states, batch, pcm_dev=None) -> None:
        """One batched window iteration on an audio-LLM context: encode
        every stream's current window, pool and project it to audio
        tokens, transcribe greedily through the language model, emit one
        segment a window (the token ids before eos, each with its
        log-probability) and move every seek 30 s on."""
        with TRACE.span("iterate", len(batch)):
            B = len(batch)
            audio = self._encode_slots(
                states, list(batch) + [None] * (self.B - B), pcm_dev)
            routes = [] if self.routes is not None else None
            ids, lps = self._llm_decode(audio, routes)
            if routes is not None:
                kept, probs = self._window_routes(routes, ids.shape[1])
            eos = self.llm.eos
            with TRACE.span("finish", B):
                for r, si in enumerate(batch):
                    st = states[si]
                    row = ids[r].tolist()
                    n = row.index(eos) if eos in row else len(row)
                    toks = [TokenData(t, t, math.exp(lp), lp, 0.0, 0.0)
                            for t, lp in zip(row[:n], lps[r, :n].tolist())]
                    text = "".join(map(AudioLLMContext.token_str, row[:n]))
                    t1 = min(st.seek + TICKS_PER_SECOND * CHUNK_SIZE,
                             st.seek_end)
                    st.result_all.append(Segment(st.seek, t1, text, 0.0,
                                                 toks))
                    if routes is not None:
                        self.routes[(si, st.seek)] = (kept[r], probs[r])
                    st.seek += TICKS_PER_SECOND * CHUNK_SIZE
                    if st.seek + DELTA_MIN >= st.seek_end:
                        st.done = True
            self.n_windows += B

    def _llm_decode(self, audio, routes=None):
        """Greedy transcripts of the batch's audio tokens (B, n, d) ->
        (ids, log-probabilities), each (B, n_tokens) on the host."""
        cfg = self.llm
        if self._kv is None:
            self._kv = omni.new_cache(
                cfg, self.B, cfg.prompt_len + self.params.max_tokens,
                self.ctx.device, self.ctx.compute_dtype)
        with torch.no_grad():
            return omni.greedy(self.ctx.params, cfg, audio, self._kv,
                               self.params.max_tokens, routes)

    def _window_routes(self, routes, n_tokens: int):
        """The MoE calls' records of one window round (the prefill's
        layers, then each step's) -> (kept (B, T, L, top_k), probabilities
        (B, T, L, E + N0)) on the host, T the positions computed."""
        L = self.llm.n_layer
        T = self.llm.prompt_len
        out = []
        for part in (0, 1):
            rows = [torch.stack([c[part].view(self.B, T, -1)
                                 for c in routes[:L]], dim=2)]
            if n_tokens > 1:
                steps = torch.stack([c[part] for c in routes[L:]])
                rows.append(steps.view(n_tokens - 1, L, self.B, -1).permute(
                    2, 0, 1, 3))
            out.append(torch.cat(rows, dim=1).cpu().numpy())
        return out

    def _finish_groups(self, states, batch, groups, out, n_cand, last):
        """Rank each group's n_cand candidate rows of `out` and emit the
        winner of every group whose rung succeeded.  groups: (batch row r,
        the group's first row in out, its prompt).  -> rows still failed."""
        still_failed = []
        with TRACE.span("finish", len(groups)):
            for r, row0, prompt in groups:
                best, _ = _rank_window_candidates(
                    out, n_cand, self.params, last,
                    self.ctx.vocab.token_eot, row0=row0)
                if best is None:
                    still_failed.append(r)
                else:
                    best["prompt"] = prompt
                    self._finish_window(states[batch[r]], best, batch[r])
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
                kc = vc = None   # the previous chunk's stack goes first
                kc, vc = self._encode_slots(states, slots, pcm_dev)
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
            out = self._decode_rows(prompts_t, kc, vc, live, seeks, ends,
                                    t_cur, keys)
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
            kc, vc = self._encode_slots(states, [batch[r]] * self.B, pcm_dev)
            group_keys = window_rng(st.seek, it, n_cand)
            outs = []
            for c0 in range(0, n_cand, self.B):
                cc = min(self.B, n_cand - c0)
                live = np.arange(self.B) < cc
                keys = np.zeros((self.B, 2), np.uint32)
                keys[:cc] = group_keys[c0:c0 + cc]
                out = self._decode_rows(
                    [cur_prompts[r] if c < cc else list(self.prompt_init)
                     for c in range(self.B)], kc, vc, live,
                    np.full((self.B,), st.seek, np.int32),
                    np.full((self.B,), st.seek_end, np.int32), t_cur, keys)
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
            kc, vc = self._encode_slots(
                states, [batch[r] for r in chunk] + [None] * (S - len(chunk)),
                pcm_dev)
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
            out = self._decode_rows(prompts_t, kc, vc, live, seeks, ends,
                                    t_cur, keys, beam_size=K)
            still_failed += self._finish_groups(
                states, batch,
                [(r, g * K, cur_prompts[r]) for g, r in enumerate(chunk)],
                out, K, last)
        return still_failed

    # rows per DTW cross-QK pass: the captured (L, B, S, T, Ta) f32 tensor
    # bounds it (~100 MB a row at large-v3), not the decode itself
    DTW_QK_ROWS = 8

    def _run_dtw_jobs(self, states, pcm_dev=None) -> None:
        """The batched DTW token-timestamp pass over this iteration's
        finished windows: one teacher-forced cross-QK re-decode per chunk
        of rows (the serial path re-decodes per window, reference:
        whisper.cpp:6364-6378), then the host DTW of each row."""
        jobs, self._dtw_jobs = self._dtw_jobs, []
        ctx = self.ctx
        aheads, sel = dtw_aheads_select(ctx)
        if aheads is None:
            return
        nB = max(1, min(self.B, self.DTW_QK_ROWS))
        for c0 in range(0, len(jobs), nB):
            chunk = jobs[c0:c0 + nB]
            seqs = []
            for st, i_seg, n_new, _, _, _ in chunk:
                segs = st.result_all[i_seg:i_seg + n_new]
                toks, sot_len = dtw_token_sequence(ctx, self.params, segs)
                seqs.append((toks, sot_len, segs))
            # one shared token bucket a chunk: one K3 shape
            T_pad = max(dtw_pad_tokens(ctx, toks)[1] for toks, _, _ in seqs)
            toks_arr = np.full((nB, T_pad), ctx.vocab.token_eot, np.int64)
            for r, (toks, _, _) in enumerate(seqs):
                toks_arr[r, :min(len(toks), T_pad)] = toks[:T_pad]
            seeks = np.zeros((nB,), np.int64)
            seeks[:len(chunk)] = [seek for _, _, _, seek, _, _ in chunk]
            slot_streams = [si for *_, si in chunk]
            slot_streams += [None] * (nB - len(chunk))
            kc, vc = self._encode_slots(states, slot_streams, pcm_dev,
                                        seeks=seeks)
            t0 = time.perf_counter()
            sl = self._rows(nB)
            qk = dtw_cross_qk(ctx, toks_arr if sl is None else toks_arr[sl],
                              kc, vc, sel)
            # (L, B, S, T, Ta): rows on axis 1
            qk = self._gather(nB, qk.swapaxes(0, 1)).swapaxes(0, 1)
            kc = vc = None
            t1 = time.perf_counter()
            for r, ((_, _, _, seek, n_frames, _), (toks, sot_len, segs)) in \
                    enumerate(zip(chunk, seqs)):
                dtw_stamp_segments(ctx, qk[:, r], aheads,
                                   min(len(toks), T_pad), sot_len, seek,
                                   n_frames, segs)
            ctx.timings.t_dtw_qk_us += int((t1 - t0) * 1e6)
            ctx.timings.t_dtw_host_us += int((time.perf_counter() - t1) * 1e6)
            ctx.timings.n_dtw += len(chunk)

    def _encode_slots(self, states, slot_streams, pcm_dev, seeks=None):
        """Batched encode where slot i carries stream slot_streams[i]'s
        window at its seek, or at seeks[i] when given (None = dead slot:
        row 0 at offset 0 of the resident stack, else zeros).  The encode
        batch is len(slot_streams): callers pad to their fixed slot count.

        Three sources: the resident PCM stack `pcm_dev` (indexed by the
        stream's pool row when it has one, else by its position), PCM
        windows uploaded this iteration (device_mel without a resident
        stack), or host log-mel windows.  On a mesh the slots that divide
        over the data axes are encoded this rank's rows only."""
        ctx = self.ctx
        n_ctx = ctx.config.n_audio_ctx
        nB = len(slot_streams)

        def seek_of(row, si):
            return int(seeks[row]) if seeks is not None else states[si].seek

        with TRACE.span("encode", nB, device=ctx.device.type == "cuda"):
            if pcm_dev is not None:
                rows_idx = np.zeros((nB,), np.int64)
                starts = np.zeros((nB,), np.int64)
                for row, si in enumerate(slot_streams):
                    if si is None:
                        continue
                    pr = states[si].pcm_row
                    rows_idx[row] = si if pr is None else pr
                    starts[row] = seek_of(row, si) * HOP_LENGTH
                return self._encode_batch_sliced(pcm_dev, rows_idx, starts)
            if self.device_mel:
                S = 2 * n_ctx * HOP_LENGTH + N_FFT
                all_i16 = all(states[si].pcm_padded.dtype == np.int16
                              for si in slot_streams if si is not None)
                windows = np.zeros((nB, S),
                                   np.int16 if all_i16 else np.float32)
                for row, si in enumerate(slot_streams):
                    if si is None:
                        continue
                    start = seek_of(row, si) * HOP_LENGTH
                    chunk = states[si].pcm_padded[start:start + S]
                    if chunk.dtype == np.int16 and not all_i16:
                        chunk = chunk.astype(np.float32) / 32768.0
                    windows[row, :len(chunk)] = chunk
            else:
                windows = np.zeros((nB, 2 * n_ctx, ctx.config.n_mels),
                                   np.float32)
                for row, si in enumerate(slot_streams):
                    if si is None:
                        continue
                    mel, sk = states[si].mel, seek_of(row, si)
                    avail = max(0, min(2 * n_ctx, mel.shape[0] - sk))
                    windows[row, :avail] = mel[sk:sk + avail]
            return self._encode_local(windows)

    def _encode_local(self, windows: np.ndarray):
        """_encode_batch of this rank's rows of the host windows (all of
        them off a mesh, or when they do not divide over its data axes)."""
        sl = self._rows(len(windows))
        if sl is not None:
            windows = windows[sl]
        return self._encode_batch(
            torch.from_numpy(windows).to(self.ctx.device))

    def _rows(self, n: int) -> slice | None:
        """This rank's rows of n slots on a mesh (parallel/mesh.row_slice),
        None when all n run here."""
        if self.mesh is None:
            return None
        from .mesh import row_slice
        return row_slice(self.mesh, n)

    def _gather(self, n: int, rows: np.ndarray) -> np.ndarray:
        """The whole n-row result from this rank's rows: all-gathered over
        the data axes when the n rows were split over them."""
        if self._rows(n) is None:
            return rows
        from .mesh import gather_rows
        return gather_rows(self.mesh, rows)

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
            # suppress_regex reaches the batched beam only: whisper_tpu's
            # batched greedy rows pass no extra suppression either
            extra = (ctx._regex_suppress_ids(p.suppress_regex)
                     if p.suppress_regex else ())
            fn = ctx._beam_batch_window_fn(
                n, beam_size, P, self.opts, p.single_segment,
                self.no_timestamps, p.max_tokens, extra)
        else:
            assert n == self.B
            fn = ctx._decode_window_fn(
                n, P, self.opts, p.single_segment, self.no_timestamps,
                p.max_tokens, "greedy")
        with TRACE.span("decode") as span:
            out = fn(ctx.params, kc, vc, buf, pad_len, t_cur, seeks, ends,
                     keys, live)
            span.value = int(out["n_tokens"])
        return out

    def warmup(self, pcm_dtype=np.float32) -> None:
        """Run the encoder, both prompt-bucket decode variants and (for
        auto language) the detection step once, so the first request pays
        no one-time set-up (kernel build, cuBLAS handles, allocator
        growth).  pcm_dtype: the streams' dtype (device_mel only)."""
        ctx = self.ctx
        n_ctx = ctx.config.n_audio_ctx
        if self.device_mel:
            windows = np.zeros((self.B, 2 * n_ctx * HOP_LENGTH + N_FFT),
                               pcm_dtype)
        else:
            windows = np.zeros((self.B, 2 * n_ctx, ctx.config.n_mels),
                               np.float32)
        with TRACE.span("warmup"):
            with TRACE.span("encode", self.B,
                            device=ctx.device.type == "cuda"):
                enc = self._encode_local(windows)
            if self.llm is not None:
                # a whole window: the prompt and every cache length
                self._llm_decode(enc)
                return
            kc, vc = enc
            bare = list(self.prompt_init)
            cap = min(self.params.n_max_text_ctx, ctx.config.n_text_ctx // 2)
            carried = [ctx.vocab.token_prev] + [0] * cap + bare
            live = np.zeros((self.B,), bool)
            live[0] = True
            zeros = np.zeros((self.B,), np.int32)
            keys = np.zeros((self.B, 2), np.uint32)
            for prompt in (bare, carried):
                self._decode_rows([prompt] * self.B, kc, vc, live, zeros,
                                  zeros, 0.0, keys)
            if self.auto_lang:
                self._detect_probs(kc, vc)

    def _finish_window(self, st: StreamState, best: dict, si: int) -> None:
        """Emit one window's winning candidate into the stream's session
        state and advance its seek (best: _rank_window_candidates output
        plus "prompt").  si: the stream's index into the iteration's
        `states`, which queues the window for the batched DTW pass when
        the context has dtw_token_timestamps on."""
        ctx = self.ctx
        p = self.params
        st.no_speech_prob = best["no_speech_prob"]
        seek_old = st.seek

        if ctx.n_loaded == 0:
            st.seek += TICKS_PER_SECOND * CHUNK_SIZE
        else:
            n_seg_before = len(st.result_all)
            with ctx.use_state(st):
                ctx.no_speech_prob = st.no_speech_prob
                st.seek = ctx._emit_segments(best, st.seek, st.seek_end, p,
                                             st.prompt_init
                                             or self.prompt_init,
                                             self.no_timestamps)
            n_new = len(st.result_all) - n_seg_before
            if ctx.dtw_token_timestamps and n_new:
                # deferred: the iteration's finished windows share one
                # batched cross-QK re-decode
                n_frames = min(TICKS_PER_SECOND * CHUNK_SIZE,
                               best["seek_delta"], st.seek_end - seek_old)
                self._dtw_jobs.append(
                    (st, n_seg_before, n_new, seek_old, n_frames, si))

        if st.seek + DELTA_MIN >= st.seek_end:
            st.done = True
        if st.seek > 0 and st.seek + 500 >= st.seek_end:
            st.prompt_past = []


class _Job:
    """One submitted stream riding the continuous batch.  Its stamps are
    time.time_ns() (the tracer's clock); with tracing on, the job carries
    the request id and the span of the thread that built it, and records
    its request spans when it completes (`_resolve`)."""

    __slots__ = ("pcm", "st", "done", "error", "t_submit", "t_admit",
                 "t_admitted", "t_first_segment", "t_done", "iter_joined",
                 "iter_done", "iter_first", "_had_segment", "on_segment",
                 "_n_emitted", "_last_sched", "rid", "parent")

    def __init__(self, pcm, on_segment=None):
        self.pcm = pcm
        self.st: StreamState | None = None
        self.done = threading.Event()
        self.error: str | None = None
        self.t_submit = time.time_ns()
        self.rid, self.parent = TRACE.origin()
        # admission: _admit's start and end
        self.t_admit: int | None = None
        self.t_admitted: int | None = None
        self.t_first_segment: int | None = None
        self.t_done: int | None = None
        self.iter_joined: int | None = None
        self.iter_done: int | None = None
        self.iter_first: int | None = None   # iteration of the first segment
        self._had_segment = False
        # called with each finalized Segment between window iterations,
        # from the scheduler thread: it must be quick
        self.on_segment = on_segment
        self._n_emitted = 0
        # iteration of the last slot this job held; -1 = never scheduled
        # (first-window-first, then round-robin)
        self._last_sched = -1

    def _resolve(self, t_done: int, n_iterations: int) -> None:
        """Complete the job at t_done; with tracing on, its spans `request`
        (submit to done), `queued` (submit to admission) and `admit`."""
        self.t_done = t_done
        self.iter_done = n_iterations
        sid = TRACE.add("request", self.t_submit, t_done, parent=self.parent,
                        rid=self.rid)
        TRACE.add("queued", self.t_submit, self.t_admit, parent=sid,
                  rid=self.rid)
        TRACE.add("admit", self.t_admit, self.t_admitted, parent=sid,
                  rid=self.rid)
        self.done.set()


class ContinuousBatcher:
    """Continuous batching: a persistent batch whose rows are refilled
    between window iterations (port of whisper_tpu's).

    A scheduler thread re-picks the batch before every window iteration:
    finished streams free their slot at once and queued or new requests
    join mid-flight, so a request that arrives while a long batch decodes
    gets its first segment within about one iteration.  Scheduling is
    first-window-first (never-scheduled streams take slots before
    in-flight ones, FIFO among themselves), then round-robin (in-flight
    streams least recently scheduled first).  Admission is just in time:
    at most one iteration's worth of fresh streams is prepared a cycle,
    and at most max_active (2 x batch_size by default) are admitted.

    With device_mel, each admitted stream's padded PCM is copied once into
    its row of a resident (max_active, plen) pool on the device, and the
    windows are cut there; a stream the pool declines (no free row, another
    dtype, over POOL_BYTES) takes the per-iteration upload.

    Over a tensor-parallel mesh (the context's `mesh` with n_data =
    n_slice = 1; parallel/mesh.py) every rank constructs the engine with
    the same arguments, and the engine starts no thread of its own: it
    runs under a Conductor (parallel/conductor.py), the one thread a rank
    that runs the mesh's collectives -- `conductor`, the server's, or one
    of its own, started by the constructor, when none is given.  Rank 0
    takes the requests; its conductor calls `schedule()` (admission and
    the batch, as above) and broadcasts each iteration's plan (the PCM of
    the streams admitted this cycle, in order, and the batch's indices
    into `active`) on the mesh's host group, and every rank's conductor
    calls `run(plan)`, so the model's collectives pair up and the ranks'
    stream states move in lockstep (`plan_digest` hashes each rank's view
    of every iteration).  Around each iteration every rank all-reduces a
    flag: if any rank failed to admit the plan's streams or raised in the
    iteration, every rank fails its active jobs alike.  A data-parallel
    mesh is refused: whisper_tpu's engine fails every job there.
    """

    # the pool's rows x row length stay under this many bytes (it shares
    # device memory with the weights, the cross-KV and the decode caches)
    POOL_BYTES = 1 << 30

    def __init__(self, ctx: WhisperContext, batch_size: int = 8,
                 params: FullParams | None = None, device_mel: bool = False,
                 max_active: int | None = None, warmup: bool = False,
                 conductor=None):
        if isinstance(ctx, AudioLLMContext):
            raise ValueError("ContinuousBatcher serves WhisperContexts; "
                             "an audio-LLM context transcribes through "
                             "BatchTranscriber.transcribe")
        mesh = ctx.mesh
        if mesh is not None and mesh.n_data > 1:
            raise NotImplementedError(
                f"ContinuousBatcher over a data-parallel mesh "
                f"({mesh.shape}): whisper_tpu's engine fails every job there "
                "(its batch does not put the cross-KV on the data axes that "
                "the window decode expects); only n_data = n_slice = 1 runs "
                "(ROADMAP.md, queue 1)")
        self.bt = BatchTranscriber(ctx, batch_size=batch_size, params=params,
                                   device_mel=device_mel)
        if warmup:
            self.bt.warmup()
        self.B = batch_size
        # admission cap: streams past it wait in the queue unprepared
        self.max_active = max_active or 2 * batch_size
        self._pool: torch.Tensor | None = None
        self._pool_len = 0
        self._pool_dtype: np.dtype | None = None
        self._pool_free = list(range(self.max_active))
        # per-row high-water mark: a recycled row is rewritten up to its
        # previous occupant's extent, so no stale tail is ever read
        self._pool_water = [0] * self.max_active
        self.queue: "queue.Queue[_Job | None]" = queue.Queue()
        self.active: list[_Job] = []
        self.n_iterations = 0
        # called as iteration_hook(n_iterations) at the top of every
        # scheduler cycle (on a follower rank: as each plan arrives),
        # before admission: lets tests and metrics observe (or pause) the
        # engine between iterations
        self.iteration_hook = None
        self._closed = False
        self.mesh = mesh
        # rank 0 (coordinates all 0) schedules; the others follow its plans
        self.leader = mesh is None or not any(mesh.coords.values())
        # a running hash of each iteration's streams, as this rank sees
        # them: equal on every rank of a mesh when they move in lockstep
        self.plan_digest = ""
        self.conductor = conductor
        if mesh is None:
            # the current CUDA device is per thread, and the kernels launch
            # on it: the engine thread takes the context's (or this one's)
            dev = ctx.device
            self._cuda_index = None if dev.type != "cuda" else (
                torch.cuda.current_device() if dev.index is None
                else dev.index)
            self.thread = threading.Thread(target=self._run, daemon=True,
                                           name="ContinuousBatcher")
            self.thread.start()
        elif conductor is None:
            from .conductor import Conductor
            self.conductor = Conductor(ctx, {None: self})
            self.conductor.start()
            self.thread = self.conductor.thread
        else:
            self.thread = None

    # -- client side -------------------------------------------------------

    def _check_leader(self) -> None:
        if not self.leader:
            raise RuntimeError("requests enter the engine on rank 0 of the "
                               "mesh; this rank replays its plans")

    def submit(self, pcm) -> list[Segment]:
        """Blocks until this stream finishes; returns its segments.
        Thread-safe."""
        self._check_leader()
        if self._closed:
            raise RuntimeError("ContinuousBatcher is closed")
        job = _Job(pcm)
        self.queue.put(job)
        job.done.wait()
        if job.error is not None:
            raise RuntimeError(job.error)
        return job.st.result_all

    def submit_async(self, pcm, on_segment=None) -> _Job:
        """Non-blocking submit: wait on job.done, then read
        job.st.result_all.  on_segment(Segment) is called for each
        finalized segment as the engine produces it, from the scheduler
        thread (the server's /stream endpoint rides it)."""
        self._check_leader()
        job = _Job(pcm, on_segment=on_segment)
        self.queue.put(job)
        if self.conductor is not None:
            self.conductor.wake()
        return job

    def close(self) -> None:
        """Stop the engine once its active streams finish.  On a mesh every
        rank calls it, and each returns once rank 0's conductor has sent
        its close plan (a rank still in the engine would cross the
        caller's next collectives); the conductor's other engines end with
        it."""
        self._closed = True
        if self.conductor is not None:
            self.conductor.close()
            return
        self.queue.put(None)   # wake the engine
        self.thread.join(timeout=30)

    def _finish(self) -> None:
        """The conductor's close plan: take no more work, fail what is
        queued."""
        self._closed = True
        self._fail_queued()

    # -- the resident PCM pool ---------------------------------------------

    def _pool_admit(self, st: StreamState) -> None:
        """Copy st's padded PCM into a free pool row, once for the stream's
        life.  Declines (the stream then uploads its windows each
        iteration) when no row is free, the dtype differs from the pool's,
        or the pool would pass POOL_BYTES.  Growth doubles the row length:
        a new pool, the old rows copied in."""
        arr = st.pcm_padded
        if arr is None or not self._pool_free:
            return
        if self._pool_dtype is None:
            self._pool_dtype = arr.dtype
        if arr.dtype != self._pool_dtype:
            return
        gran = 16000 * CHUNK_SIZE            # 30 s of samples
        plen = max(self._pool_len, 2 * gran)
        while plen < len(arr):
            plen *= 2
        if self.max_active * plen * arr.itemsize > self.POOL_BYTES:
            return
        dev = self.bt.ctx.device
        if self._pool is None or plen > self._pool_len:
            old, old_len = self._pool, self._pool_len
            self._pool = torch.zeros(
                (self.max_active, plen),
                dtype=torch.from_numpy(arr[:0]).dtype, device=dev)
            if old is not None:
                self._pool[:, :old_len].copy_(old)
            self._pool_len = plen
        row = self._pool_free.pop()
        # only the stream's own samples (rounded up to 30 s) are written, or
        # the previous occupant's extent if longer: window reads never pass
        # len(arr), whose 30 s + N_FFT tail covers the last window
        ulen = min(self._pool_len,
                   max(-(-len(arr) // gran) * gran, self._pool_water[row]))
        self._pool_water[row] = ulen
        pinned = dev.type == "cuda"
        host = torch.zeros((ulen,), dtype=self._pool.dtype, pin_memory=pinned)
        host[:len(arr)] = torch.from_numpy(arr)
        self._pool[row, :ulen].copy_(host, non_blocking=pinned)
        st.pcm_row = row

    def _pool_release(self, st: StreamState | None) -> None:
        if st is not None and st.pcm_row is not None:
            self._pool_free.append(st.pcm_row)
            st.pcm_row = None

    # -- engine ------------------------------------------------------------

    def _admit(self, job: _Job | None, plan: list | None = None) -> bool:
        """Prepare `job`'s stream and add it to `active`; -> whether it was
        added (a stream that fails its prep, or is too short to decode,
        resolves at once).  `plan` collects the PCM of each added job."""
        if job is None:
            return False
        pcm = job.pcm
        job.t_admit = time.time_ns()
        try:
            job.st = self.bt._make_stream(job.pcm)
            job.pcm = None          # the mel / padded PCM is what is needed
            job.iter_joined = self.n_iterations
            if self.bt.device_mel and not job.st.done:
                self._pool_admit(job.st)
        except Exception as e:  # noqa: BLE001 - fail this job, not the engine
            job.error = f"stream prep failed: {e}"
            self._pool_release(job.st)
            job.done.set()
            return False
        job.t_admitted = time.time_ns()
        if job.st.done:             # too short to decode: resolved at once
            job._resolve(job.t_admitted, self.n_iterations)
            return False
        self.active.append(job)
        if plan is not None:
            plan.append(pcm)
        return True

    def _run(self):
        """The thread of an engine without a mesh."""
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        # grad mode is thread-local: this thread sets its own
        with torch.no_grad():
            self._loop()
        self._fail_queued()

    def _fail_queued(self) -> None:
        """Fail anything still queued after close."""
        while True:
            try:
                job = self.queue.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                job.error = "ContinuousBatcher closed"
                job.done.set()

    def _any_failed(self, failed: bool) -> bool:
        """Whether any rank failed (this rank's `failed` without a mesh)."""
        return failed if self.conductor is None else \
            self.conductor.any_rank(failed)

    def _fail_active(self, error: str) -> None:
        for j in self.active:
            j.error = error
            j.done.set()
            self._pool_release(j.st)
        self.active.clear()

    def _loop(self):
        """The scheduler of an engine without a mesh."""
        while True:
            hook = self.iteration_hook
            if hook is not None:
                hook(self.n_iterations)
            # admit new work: block when idle, drain when busy
            if not self.active:
                try:
                    job = self.queue.get(timeout=0.25)
                except queue.Empty:
                    if self._closed:
                        return
                    continue
                if job is None and self._closed:
                    return
                self._admit(job)
            plan = self.schedule()
            if plan is None:
                if self._closed:
                    return
                continue
            self.run(plan)

    def schedule(self) -> dict | None:
        """Rank 0 (or the only rank): admit queued streams (at most one
        iteration's worth of fresh ones, up to max_active) and pick the
        batch: first-window-first, then round-robin.  -> the iteration's
        plan {"admit": the admitted streams' PCM, "batch": indices into
        `active`}, or None when no stream is active."""
        admitted: list = []
        while len(self.active) < self.max_active:
            # just in time: at most one iteration's worth of
            # never-scheduled streams is prepared a cycle
            if sum(1 for j in self.active if j._last_sched < 0) >= self.B:
                break
            try:
                job = self.queue.get_nowait()
            except queue.Empty:
                break
            if job is None and self._closed:
                break
            self._admit(job, admitted)
        if not self.active:
            return None
        fresh = [i for i, j in enumerate(self.active) if j._last_sched < 0]
        inflight = sorted(
            (i for i, j in enumerate(self.active) if j._last_sched >= 0),
            key=lambda i: self.active[i]._last_sched)
        batch = (fresh + inflight)[:min(len(self.active), self.B)]
        for i in batch:
            self.active[i]._last_sched = self.n_iterations
        return {"admit": admitted, "batch": batch}

    def run(self, plan: dict) -> None:
        """One iteration of `plan`: rank 0's from its own schedule, a
        follower's from rank 0 (every admission first, even after one
        fails)."""
        if self.leader:
            self._step(plan["batch"])
        else:
            added = [self._admit(_Job(pcm)) for pcm in plan["admit"]]
            self._step(plan["batch"], all(added))

    def _step(self, batch: list[int], admitted: bool = True) -> None:
        """One window iteration over `batch` (indices into `active`), then
        each job's segments, callbacks and completion.  On a mesh every rank
        runs it with the same plan, and a failure on any rank fails every
        rank's active jobs alike."""
        if self._any_failed(not admitted):
            self._fail_active("stream prep failed on another rank")
            return
        sts = [j.st for j in self.active]
        h = hashlib.sha1(self.plan_digest.encode())
        h.update(repr((len(sts), batch, [(sts[i].seek, sts[i].seek_end,
                                          len(sts[i].result_all))
                                         for i in batch])).encode())
        self.plan_digest = h.hexdigest()
        # the resident pool only when every scheduled stream holds a row
        pcm_dev = (self._pool if self._pool is not None and all(
            sts[i].pcm_row is not None for i in batch) else None)
        error = None
        try:
            self.bt._iterate(sts, batch, pcm_dev)
        except Exception as e:  # noqa: BLE001 - a dead engine thread
            # would leave every submitter waiting forever
            log_error("ContinuousBatcher: batch iteration failed:\n"
                      + traceback.format_exc())
            error = f"batch iteration failed: {e}"
        if self._any_failed(error is not None):
            self._fail_active(error or "batch iteration failed on another "
                              "rank")
            return
        self.n_iterations += 1

        now = time.time_ns()
        still = []
        for idx, j in enumerate(self.active):
            if not j._had_segment and idx in batch and j.st.result_all:
                j._had_segment = True
                j.t_first_segment = now
                j.iter_first = self.n_iterations
            if j.on_segment is not None:
                segs = j.st.result_all
                while j._n_emitted < len(segs):
                    try:
                        j.on_segment(segs[j._n_emitted])
                    except Exception:  # noqa: BLE001 - a client's
                        pass           # callback must not kill the engine
                    j._n_emitted += 1
            if j.st.done:
                self._pool_release(j.st)
                j._resolve(now, self.n_iterations)
            else:
                still.append(j)
        self.active = still
