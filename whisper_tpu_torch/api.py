"""Public API of the port: parameters, context, the serial orchestrator
`full` (whisper_full) and segment assembly (port of whisper_tpu.api).

The dataclasses keep whisper_tpu's fields and defaults.  `WhisperContext`
is built from a ggml file (`from_file`, `from_buffer`), from random
weights (`from_random`) or from a whisper_tpu context (`from_jax`).
`full` runs the sliding 30 s window loop in every cross mode of
whisper_tpu (decode/loop.CROSS_MODES), greedy or beam search, with the
temperature-fallback ladder: at t > 0 it draws best_of candidates from
JAX's threefry stream with whisper_tpu's keys (decode/rng.py), so sampled
windows equal whisper_tpu's.  The quantized modes quantize the window's
dense cross-KV once, as whisper_tpu's `full` does.  Token timestamps come
from the signal-energy heuristic (timestamps.py), with `wrap_segment` at
max_len > 0, and DTW token timestamps (dtw.py) from a teacher-forced
cross-attention re-decode of each window; suppress_regex suppresses the
token ids whose text matches.  Grammars (GBNF, grammar.py) and
logits-filter callbacks decode on the host loop of decode/grammar_loop.py
(greedy, speculative device chunks at t = 0) or decode/host_beam.py (beam
search).  `full_parallel` splits the audio into chunks, batched through
parallel/batch.BatchTranscriber where it can, else serially on fresh
states.  Its entry points run on the card (device="cuda") unless the
caller asks for the CPU.  On a context that parallel/batch.BatchTranscriber
attached to a device mesh (parallel/mesh.py: one process per card, every
rank calling with the same inputs), `full` runs over the sharded params:
a window decode whose rows divide over the data axes splits them
(greedy and the batched beam; the serial beam's coupled rows run on every
data group) and all-gathers its results.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .audio.filters import mel_filterbank
from .audio.mel import full_f32_matmuls, log_mel_spectrogram
from .constants import CHUNK_SIZE, MAX_DECODERS, TICKS_PER_SECOND
from .decode.filters import FilterConsts, FilterOptions
from .decode.beam import (make_batched_beam_decode_window,
                          make_beam_decode_window)
from .decode.grammar_loop import decode_window_grammar
from .decode.host_beam import decode_window_host_beam
from .decode.loop import (CROSS_MODES, DELTA_MIN, LoopConfig,
                          make_decode_window)
from .dtw import compute_token_level_timestamps_dtw
from .languages import lang_id as _lang_id, lang_str
from .models import whisper as wm
from .models.whisper import MODEL_DIMS, WhisperConfig
from .outputs import to_timestamp
from .timestamps import (compute_token_level_timestamps, get_signal_energy,
                         wrap_segment)
from .tokenizer import tokenize
from .utils.device import resolve_device
from .utils.logging import log_error, log_info, log_warn
from .utils.timings import Timings
from .utils.trace import TRACE
from .weights.convert import from_jax, params_from_ggml, random_params
from .weights.ggml_reader import Hparams, read_ggml_file
from .weights.vocab import Vocab, synthetic_vocab


class SamplingStrategy:
    GREEDY = 0
    BEAM_SEARCH = 1


@dataclasses.dataclass
class GreedyParams:
    best_of: int = 5  # reference default for GREEDY (whisper.cpp:4867)


@dataclasses.dataclass
class BeamSearchParams:
    beam_size: int = 5
    patience: float = -1.0


@dataclasses.dataclass
class FullParams:
    """whisper_full_params (reference: include/whisper.h:476-573,
    defaults src/whisper.cpp:4785-4885)."""
    strategy: int = SamplingStrategy.GREEDY

    n_threads: int = 4
    n_max_text_ctx: int = 16384
    offset_ms: int = 0
    duration_ms: int = 0

    translate: bool = False
    no_context: bool = True
    no_timestamps: bool = False
    single_segment: bool = False
    print_special: bool = False
    print_progress: bool = True
    print_realtime: bool = False
    print_timestamps: bool = True

    token_timestamps: bool = False
    thold_pt: float = 0.01
    thold_ptsum: float = 0.01
    max_len: int = 0
    split_on_word: bool = False
    max_tokens: int = 0

    debug_mode: bool = False
    audio_ctx: int = 0

    tdrz_enable: bool = False

    suppress_regex: Optional[str] = None

    initial_prompt: Optional[str] = None
    prompt_tokens: Optional[list[int]] = None

    language: Optional[str] = "en"
    detect_language: bool = False

    suppress_blank: bool = True
    suppress_nst: bool = False

    temperature: float = 0.0
    max_initial_ts: float = 1.0
    length_penalty: float = -1.0

    temperature_inc: float = 0.2
    entropy_thold: float = 2.4
    logprob_thold: float = -1.0
    no_speech_thold: float = 0.6

    greedy: GreedyParams = dataclasses.field(default_factory=GreedyParams)
    beam_search: BeamSearchParams = dataclasses.field(
        default_factory=BeamSearchParams)

    new_segment_callback: Optional[Callable] = None
    progress_callback: Optional[Callable] = None
    encoder_begin_callback: Optional[Callable] = None
    abort_callback: Optional[Callable] = None
    logits_filter_callback: Optional[Callable] = None

    grammar_rules: Optional[list] = None
    i_start_rule: int = 0
    grammar_penalty: float = 100.0


def full_default_params(strategy: int = SamplingStrategy.GREEDY) -> FullParams:
    p = FullParams(strategy=strategy)
    if strategy == SamplingStrategy.BEAM_SEARCH:
        p.beam_search = BeamSearchParams(beam_size=5)
    return p


@dataclasses.dataclass
class TokenData:
    """whisper_token_data (reference: include/whisper.h:88-108)."""
    id: int
    tid: int
    p: float
    plog: float
    pt: float
    ptsum: float
    t0: int = -1
    t1: int = -1
    t_dtw: int = -1
    vlen: float = 0.0


@dataclasses.dataclass
class Segment:
    """whisper_segment (reference: src/whisper.cpp:504-514)."""
    t0: int
    t1: int
    text: str
    no_speech_prob: float
    tokens: list[TokenData]
    speaker_turn_next: bool = False


class WhisperState:
    """Per-session decoding state (whisper_state; reference:
    src/whisper.cpp:830-975)."""

    def __init__(self):
        self.mel: np.ndarray | None = None
        self.mel_n_len_org = 0
        self.lang_id_state = 0
        self.no_speech_prob = 0.0
        self.result_all: list[Segment] = []
        self.prompt_past: list[int] = []
        self.energy: np.ndarray | None = None
        self.t_beg = 0
        self.t_last = 0
        self.tid_last = 0
        self.exp_n_audio_ctx = 0
        self.timings = Timings()
        # capi's raw encode/decode session (capi.py): whisper_encode/
        # decode_with_state keep the cross-KV, self-KV and logits on their
        # own state, not on the context's default one
        self._capi_logits = None
        self._capi_kv = None
        self._encoded = None

    def full_n_segments(self): return len(self.result_all)
    def full_lang_id(self): return self.lang_id_state
    def full_get_segment_t0(self, i): return self.result_all[i].t0
    def full_get_segment_t1(self, i): return self.result_all[i].t1
    def full_get_segment_text(self, i): return self.result_all[i].text
    def full_get_segment_speaker_turn_next(self, i):
        return self.result_all[i].speaker_turn_next
    def full_get_segment_no_speech_prob(self, i):
        return self.result_all[i].no_speech_prob
    def full_n_tokens(self, i): return len(self.result_all[i].tokens)
    def full_get_token_id(self, i, j): return self.result_all[i].tokens[j].id
    def full_get_token_data(self, i, j): return self.result_all[i].tokens[j]
    def full_get_token_p(self, i, j): return self.result_all[i].tokens[j].p


def _session_property(name):
    def get(self):
        return getattr(self._cur_state, name)

    def set_(self, value):
        setattr(self._cur_state, name, value)

    return property(get, set_)


class WhisperContext:
    """Model weights, vocab and filters on one torch device, plus the
    session state that `full` and segment assembly write (whisper_context
    + whisper_state).

    Use `WhisperContext.from_file(path, device=...)` then
    `ctx.full(params, samples)`.
    """

    def __init__(self, model_file=None, compute_dtype=torch.bfloat16,
                 device="cuda", keep_quantized: bool = True,
                 cross_mode: str = "einsum",
                 dtw_token_timestamps: bool = False, *,
                 dtw_aheads_preset: str = "none", dtw_n_top: int = 0,
                 dtw_aheads: list | None = None,
                 config: WhisperConfig | None = None,
                 vocab: Vocab | None = None, filters=None,
                 params: dict | None = None, hparams: Hparams | None = None):
        """From a parsed ggml file (`model_file`), or from ready parts
        (config, vocab, filters, params) when model_file is None.

        device: "cuda" (the default) or "cpu"; a CUDA device without a
        card raises.  keep_quantized: the decoder's block-quantized
        weights stay packed and run through K3 on every device (on the CPU
        as its plain version).  cross_mode: one of CROSS_MODES — "einsum"
        (dense K/V), "einsum_q8" and "pallas_q8dt" (int8 K/V through K2),
        "einsum_q8i" (int8 dots), "einsum_q4" (4-bit K/V), "pallas" (K4)
        or "pallas_q8" (K5).  dtw_token_timestamps: stamp each token's
        t_dtw from the alignment heads of dtw_aheads_preset (a model name
        of dtw.AHEADS_PRESETS, "n_top_most" with dtw_n_top, or "custom"
        with dtw_aheads, (layer, head) pairs).
        """
        if cross_mode not in CROSS_MODES:
            raise ValueError(f"unknown cross_mode {cross_mode!r} (have "
                             f"{CROSS_MODES})")
        device = resolve_device(device)
        if device.type == "cuda":
            full_f32_matmuls()
        self.model_file = model_file
        if model_file is not None:
            params, config = params_from_ggml(
                model_file, dtype=compute_dtype,
                keep_quantized=keep_quantized, device=device)
            vocab, filters = model_file.vocab, model_file.filters
            hparams = model_file.hparams
            self.n_loaded = model_file.n_loaded
        else:
            self.n_loaded = sum(1 for _ in _leaves(params))
        self.config = config
        self.hparams = hparams or Hparams(
            *(getattr(config, f.name)
              for f in dataclasses.fields(WhisperConfig)[:-1]), ftype=1)
        self.vocab = vocab
        self.filters = np.asarray(filters, np.float32)
        self.params = params
        self.device = device
        self.compute_dtype = compute_dtype
        self.cross_mode = cross_mode
        self.dtw_token_timestamps = dtw_token_timestamps
        self.dtw_aheads_preset = dtw_aheads_preset
        self.dtw_n_top = dtw_n_top
        self.dtw_aheads = dtw_aheads
        self._default_state = WhisperState()
        # the state that use_state / full(state=) select is per thread: the
        # server's engine threads and its serial fallback share one context
        self._tls = threading.local()
        self._fn_cache: dict = {}
        # set by BatchTranscriber(mesh=...): params then hold this rank's
        # shard (parallel/mesh.py)
        self.mesh = None

    # ---- constructors (whisper_init_*; reference: whisper.h:195-228) -----

    @classmethod
    def from_file(cls, path: str, compute_dtype=torch.bfloat16,
                  **kwargs) -> "WhisperContext":
        mf = read_ggml_file(path)
        ctx = cls(mf, compute_dtype=compute_dtype, **kwargs)
        hp = mf.hparams
        loaded = (f"{ctx.n_loaded} tensors" if ctx.n_loaded
                  else "no tensors (stub)")
        log_info(f"loaded model '{path}': type {hp.model_type}, "
                 f"n_vocab {hp.n_vocab}, n_audio_ctx {hp.n_audio_ctx}, "
                 f"n_text_layer {hp.n_text_layer}, {loaded}")
        return ctx

    @classmethod
    def from_buffer(cls, buf: bytes, compute_dtype=torch.bfloat16,
                    **kwargs) -> "WhisperContext":
        return cls(read_ggml_file(buf), compute_dtype=compute_dtype, **kwargs)

    @classmethod
    def from_random(cls, size: str = "large-v3", seed: int = 0,
                    device="cuda", compute_dtype=torch.bfloat16,
                    cross_mode: str = "einsum_q8",
                    dims: tuple | None = None) -> "WhisperContext":
        """Random-weight context at exact named dims with a synthetic
        vocab: every tensor shape, special-token id and filter constant
        matches the real model; the weights are drawn on `device` from a
        torch.Generator seeded with `seed`."""
        cfg = WhisperConfig(*(dims or MODEL_DIMS[size]), model_type=size)
        return cls(config=cfg, vocab=synthetic_vocab(cfg.n_vocab),
                   filters=mel_filterbank(cfg.n_mels),
                   params=random_params(cfg, seed=seed, dtype=compute_dtype,
                                        device=device),
                   device=device, compute_dtype=compute_dtype,
                   cross_mode=cross_mode)

    @classmethod
    def from_jax(cls, jax_ctx, device="cuda") -> "WhisperContext":
        """The same model as a whisper_tpu WhisperContext, bit for bit.
        Takes the JAX context as duck-typed data: its params must already
        be numpy leaves or convert through np.asarray."""
        cfg = WhisperConfig(**{f.name: getattr(jax_ctx.config, f.name)
                               for f in dataclasses.fields(WhisperConfig)})
        v = jax_ctx.vocab
        vocab = Vocab(n_vocab=v.n_vocab, id_to_token=list(v.id_to_token),
                      token_to_id=dict(v.token_to_id),
                      **{f.name: getattr(v, f.name)
                         for f in dataclasses.fields(Vocab)
                         if f.name.startswith("token_")
                         and f.name != "token_to_id"})
        params_np = _map_leaves(jax_ctx.params, np.asarray)
        dtype = _torch_dtype(np.dtype(jax_ctx.compute_dtype))
        hp = getattr(jax_ctx, "hparams", None)
        return cls(config=cfg, vocab=vocab, filters=jax_ctx.filters,
                   params=from_jax(params_np, device),
                   device=device, compute_dtype=dtype,
                   cross_mode=jax_ctx.cross_mode,
                   hparams=None if hp is None else Hparams(
                       **{f.name: getattr(hp, f.name)
                          for f in dataclasses.fields(Hparams)}))

    # ---- introspection (reference: whisper.h:380-439) --------------------

    def n_vocab(self) -> int: return self.hparams.n_vocab
    def n_audio_ctx(self) -> int: return self.hparams.n_audio_ctx
    def n_text_ctx(self) -> int: return self.hparams.n_text_ctx
    def is_multilingual(self) -> bool: return self.vocab.is_multilingual
    def token_to_str(self, tid: int) -> str: return self.vocab.token_str(tid)
    def token_eot(self) -> int: return self.vocab.token_eot
    def token_sot(self) -> int: return self.vocab.token_sot
    def token_prev(self) -> int: return self.vocab.token_prev
    def token_nosp(self) -> int: return self.vocab.token_nosp
    def token_not(self) -> int: return self.vocab.token_not
    def token_beg(self) -> int: return self.vocab.token_beg
    def token_translate(self) -> int: return self.vocab.token_translate
    def token_transcribe(self) -> int: return self.vocab.token_transcribe
    def token_lang(self, lid: int) -> int: return self.vocab.token_lang(lid)
    def tokenize(self, text: str) -> list[int]: return tokenize(self.vocab, text)

    # ---- mel (whisper_pcm_to_mel / whisper_set_mel) ----------------------

    def pcm_to_mel(self, samples: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.mel, self.mel_n_len_org = log_mel_spectrogram(samples,
                                                           self.filters)
        self.timings.t_mel_us += int((time.perf_counter() - t0) * 1e6)

    def set_mel(self, mel: np.ndarray) -> None:
        """Custom mel injection (reference: whisper_set_mel, whisper.cpp:3894).
        mel: (n_len, n_mel); n_mel must match the model."""
        if mel.shape[1] != self.hparams.n_mels:
            raise ValueError(
                f"invalid number of mel bands: {mel.shape[1]} "
                f"(expected {self.hparams.n_mels})")
        self.mel = np.asarray(mel, dtype=np.float32)
        self.mel_n_len_org = mel.shape[0]

    def n_len_from_state(self) -> int:
        return self.mel_n_len_org

    # ---- encoder ---------------------------------------------------------

    @torch.no_grad()
    def _encode_fn(self, mel: torch.Tensor):
        """mel (B, 2*n_ctx, n_mels) -> (encoder output, dense cross-KV), as
        whisper_tpu's jitted encode fn: every cross mode starts from the
        dense (L, B, H, Dh, Ta) cross-KV, which the window loop transposes
        or quantizes once per window."""
        cd = self.compute_dtype
        enc = wm.encode(self.params, mel, n_head=self.config.n_audio_head,
                        compute_dtype=cd)
        kc, vc = wm.cross_kv(self.params, enc,
                             n_head=self.config.n_text_head, compute_dtype=cd)
        return enc, kc, vc

    def _loop_config(self, P: int, single_segment: bool,
                     no_timestamps: bool, max_tokens: int) -> LoopConfig:
        n_text_ctx = self.config.n_text_ctx
        return LoopConfig(
            n_head=self.config.n_text_head,
            n_text_ctx=n_text_ctx,
            prompt_size=P,
            # max_tokens caps the loop at i >= max_tokens, so the (B, N)
            # buffers and the (..., C) cache shrink to match
            max_tokens_loop=(min(n_text_ctx // 2 - 4, max_tokens + 1)
                             if max_tokens > 0 else n_text_ctx // 2 - 4),
            max_tokens_param=max_tokens,
            single_segment=single_segment,
            no_timestamps=no_timestamps,
            compute_dtype=self.compute_dtype,
            cross_mode=self.cross_mode,
        )

    def _regex_suppress_ids(self, pattern: str) -> tuple:
        """Token ids whose text fully matches `pattern`
        (reference: suppress_regex, src/whisper.cpp:5098-5106)."""
        def make():
            pat = re.compile(pattern)
            return tuple(sorted(
                tid for tok, tid in self.vocab.token_to_id.items()
                if pat.fullmatch(tok.decode("utf-8", errors="replace"))))
        return self._cached(("regex", pattern), make)

    def _cached(self, key, make):
        """_fn_cache[key], made by make() on a miss (traced: the counter
        `fn_built`, which stays 0 once the shapes a caller uses are warm)."""
        fn = self._fn_cache.get(key)
        if fn is None:
            TRACE.count("fn_built")
            fn = self._fn_cache[key] = make()
        return fn

    def _decode_window_fn(self, B: int, P: int, opts: FilterOptions,
                          single_segment: bool, no_timestamps: bool,
                          max_tokens: int, strategy: str = "greedy",
                          extra_suppress: tuple = ()):
        """The window decode of B rows: "greedy" (decode/loop.py, keys
        (B, 2) or (2,)) or "beam" (decode/beam.py's serial beam, B =
        beam_size, one (2,) key).  On a mesh, greedy rows split over the
        data axes when B divides over them (parallel/mesh.split_window_fn);
        the serial beam's rows are coupled and run replicated."""
        def make():
            kw = dict(consts=FilterConsts.from_vocab(
                          self.vocab, self.config.n_audio_ctx),
                      options=opts,
                      cfg=self._loop_config(P, single_segment,
                                            no_timestamps, max_tokens),
                      extra_suppress=extra_suppress, device=self.device)
            if strategy == "beam":
                return make_beam_decode_window(beam_size=B, **kw)
            if strategy != "greedy":
                raise ValueError(f"unknown decode strategy {strategy!r}")
            fn = make_decode_window(**kw)
            if self.mesh is not None:
                from .parallel.mesh import split_window_fn
                fn = split_window_fn(fn, self.mesh, B)
            return fn
        return self._cached(("dec", B, P, opts, single_segment,
                             no_timestamps, max_tokens, strategy,
                             extra_suppress), make)

    def _beam_batch_window_fn(self, S: int, K: int, P: int,
                              opts: FilterOptions, single_segment: bool,
                              no_timestamps: bool, max_tokens: int,
                              extra_suppress: tuple = ()):
        """Batched beam search: S streams x K beams in one batch
        (decode/beam.make_batched_beam_decode_window); per-stream inputs
        and (S, 2) keys, per-beam outputs (S*K rows).  On a mesh the
        streams split over the data axes when S divides over them, a
        stream's K beams staying on one rank."""
        def make():
            from .parallel.mesh import row_slice, split_window_fn
            sl = row_slice(self.mesh, S)
            fn = make_batched_beam_decode_window(
                consts=FilterConsts.from_vocab(self.vocab,
                                               self.config.n_audio_ctx),
                options=opts,
                cfg=self._loop_config(P, single_segment, no_timestamps,
                                      max_tokens),
                n_streams=S if sl is None else sl.stop - sl.start,
                beam_size=K, extra_suppress=extra_suppress,
                device=self.device)
            return fn if sl is None else split_window_fn(fn, self.mesh, S)
        return self._cached(("decbb", S, K, P, opts, single_segment,
                             no_timestamps, max_tokens, extra_suppress), make)

    @property
    def _cur_state(self) -> WhisperState:
        return getattr(self._tls, "state", self._default_state)

    @_cur_state.setter
    def _cur_state(self, state: WhisperState) -> None:
        self._tls.state = state

    def use_state(self, state: WhisperState):
        """Context manager routing session fields to `state`."""
        @contextlib.contextmanager
        def _cm():
            prev = self._cur_state
            self._cur_state = state or prev
            try:
                yield self
            finally:
                self._cur_state = prev
        return _cm()

    def init_state(self) -> WhisperState:
        """whisper_init_state: a fresh session sharing this model."""
        return WhisperState()

    # ---- windows ---------------------------------------------------------

    def _mel_window(self, seek: int) -> np.ndarray:
        """(1, 2*n_ctx, n_mels) mel slice at `seek` (zero-padded)."""
        n_ctx = self.exp_n_audio_ctx or self.hparams.n_audio_ctx
        want = 2 * n_ctx
        mel = self.mel
        out = np.zeros((want, mel.shape[1]), dtype=np.float32)
        avail = max(0, min(want, mel.shape[0] - seek))
        out[:avail] = mel[seek:seek + avail]
        return out[None]

    def encode_window(self, seek: int):
        """Encoder + dense cross-KV for the 30 s window at `seek` (ticks)."""
        t0 = time.perf_counter()
        mel_win = torch.from_numpy(self._mel_window(seek)).to(self.device)
        enc, kc, vc = self._encode_fn(mel_win)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings.t_encode_us += int((time.perf_counter() - t0) * 1e6)
        self.timings.n_encode += 1
        return enc, kc, vc

    # ---- language detection (reference: src/whisper.cpp:4027-4108) -------

    def lang_auto_detect(self, offset_ms: int = 0) -> tuple[int, np.ndarray]:
        seek = offset_ms // 10
        if seek >= self.mel_n_len_org:
            raise ValueError("offset is past the end of the audio")
        _, kc, vc = self.encode_window(seek)

        prompt = torch.tensor([[self.vocab.token_sot]], device=self.device)
        with torch.no_grad():
            logits, _, _ = wm.decode_prompt(
                self.params, prompt,
                torch.zeros((1, 1), dtype=torch.long, device=self.device),
                kc, vc, n_head=self.config.n_text_head,
                compute_dtype=self.compute_dtype)
        logits = logits[0, -1].cpu().numpy()

        lang_ids = [self.vocab.token_lang(i) for i in range(100)]
        lang_logits = logits[lang_ids]
        probs = np.exp(lang_logits - lang_logits.max())
        probs /= probs.sum()
        best = int(np.argmax(probs))
        return best, probs

    # ---- the orchestrator (whisper_full) ---------------------------------

    def full(self, params: FullParams, samples: Optional[np.ndarray],
             state: Optional[WhisperState] = None) -> int:
        if state is not None:
            prev = self._cur_state
            self._cur_state = state
            try:
                return self._full_impl(params, samples)
            finally:
                self._cur_state = prev
        return self._full_impl(params, samples)

    def _full_impl(self, params: FullParams,
                   samples: Optional[np.ndarray]) -> int:
        """The sliding-window loop of whisper_full_with_state (reference:
        src/whisper.cpp:5481-6397): a window decode per 30 s window, then
        the temperature-fallback ladder's rungs until one succeeds."""
        self.result_all = []
        language = params.language

        if samples is not None and len(samples) > 0:
            self.pcm_to_mel(samples)

        if (language is None or language == "" or language == "auto"
                or params.detect_language):
            lid, probs = self.lang_auto_detect()
            self.lang_id_state = lid
            language = lang_str(lid)
            # the resolved language is written back, as the reference does
            # (src/whisper.cpp:5510)
            params.language = language
            log_info(f"auto-detected language: {language} "
                     f"(p = {probs[lid]:.6f})")
            if params.detect_language:
                return 0

        if params.token_timestamps:
            self.t_beg = self.t_last = self.tid_last = 0
            if samples is not None and len(samples) > 0:
                self.energy = get_signal_energy(samples, 32)

        seek_start = params.offset_ms // 10
        seek_end = (self.n_len_from_state() if params.duration_ms == 0
                    else seek_start + params.duration_ms // 10)

        if seek_end < seek_start + DELTA_MIN:
            log_warn(f"input is too short - {(seek_end - seek_start) * 10} ms "
                     "< 100 ms. consider padding the input audio with silence")
            return 0

        # temperature ladder (reference: src/whisper.cpp:5541-5549)
        temperatures = _ladder(params.temperature, params.temperature_inc)

        if params.strategy == SamplingStrategy.GREEDY:
            n_decoders = params.greedy.best_of
        else:
            n_decoders = max(params.greedy.best_of,
                             params.beam_search.beam_size)
        n_decoders = max(1, n_decoders)
        if n_decoders > MAX_DECODERS:
            log_error(f"too many decoders requested ({n_decoders}), "
                      f"max = {MAX_DECODERS}")
            return -4

        if params.no_context:
            self.prompt_past = []

        # initial prompt handling (reference: src/whisper.cpp:5592-5617)
        prompt_tokens = params.prompt_tokens
        if prompt_tokens is None and params.initial_prompt:
            prompt_tokens = tokenize(self.vocab, params.initial_prompt)
        if prompt_tokens:
            self.prompt_past = list(prompt_tokens) + self.prompt_past

        if params.audio_ctx > self.hparams.n_audio_ctx:
            log_error("audio_ctx is larger than the maximum allowed")
            return -5
        self.exp_n_audio_ctx = params.audio_ctx

        # task prompt (reference: src/whisper.cpp:5627-5651)
        prompt_init = [self.vocab.token_sot]
        if self.vocab.is_multilingual:
            lid = _lang_id(language or "en")
            self.lang_id_state = lid
            prompt_init.append(self.vocab.token_lang(lid))
            prompt_init.append(self.vocab.token_translate if params.translate
                               else self.vocab.token_transcribe)

        is_distil = (self.hparams.n_text_layer == 2
                     and self.hparams.n_vocab != 51866)
        no_timestamps = params.no_timestamps
        if is_distil and not no_timestamps:
            log_warn("using first release distilled models - forcing "
                     "no_timestamps")
            no_timestamps = True
        if no_timestamps:
            prompt_init.append(self.vocab.token_not)

        opts = FilterOptions(
            suppress_blank=params.suppress_blank,
            no_timestamps=no_timestamps,
            tdrz_enable=params.tdrz_enable,
            suppress_nst=params.suppress_nst,
            max_initial_ts=params.max_initial_ts,
        )

        seek = seek_start
        while True:
            if params.progress_callback:
                progress = ((100 * (seek - seek_start))
                            // max(1, seek_end - seek_start))
                params.progress_callback(self, progress)

            if seek + DELTA_MIN >= seek_end:
                break

            if params.encoder_begin_callback:
                if not params.encoder_begin_callback(self):
                    log_error("encoder_begin_callback returned false - "
                              "aborting")
                    break

            if params.abort_callback and params.abort_callback(self):
                log_warn("abort_callback requested stop")
                break

            _, kc, vc = self.encode_window(seek)

            # drop confusing old prompt near the very end
            # (reference: src/whisper.cpp:5697-5700)
            if seek > seek_start and seek + 500 >= seek_end:
                self.prompt_past = []

            if self.n_loaded == 0:
                # stub model (reference: whisper.cpp:6050-6055): no weights,
                # skip decoding and consume the whole window
                seek += TICKS_PER_SECOND * CHUNK_SIZE
                continue

            use_beam = params.strategy == SamplingStrategy.BEAM_SEARCH
            best = None
            for it, t_cur in enumerate(temperatures):
                # best_of candidates at t > 0, else beam_size beams or one
                # greedy decoder (reference: src/whisper.cpp:5718-5724)
                if t_cur > 0.0:
                    n_cur = params.greedy.best_of
                else:
                    n_cur = params.beam_search.beam_size if use_beam else 1
                n_cur = max(1, n_cur)

                # prompt assembly (reference: src/whisper.cpp:5759-5771);
                # hot rungs drop the carried past
                prompt: list[int] = []
                if (self.prompt_past and t_cur < 0.5
                        and params.n_max_text_ctx > 0):
                    n_take = min(params.n_max_text_ctx,
                                 self.hparams.n_text_ctx // 2,
                                 len(self.prompt_past))
                    prompt = ([self.vocab.token_prev]
                              + self.prompt_past[-n_take:])
                prompt = prompt + prompt_init

                if (params.grammar_rules is not None
                        or params.logits_filter_callback is not None):
                    result, n_cur = self._decode_window_host(
                        prompt, kc, vc, t_cur, seek, seek_end, params, opts,
                        no_timestamps, it)
                else:
                    # beam search runs at every rung, with best_of slots
                    # and drawn candidates at t > 0 (whisper.cpp:5881-5890)
                    result = self._decode_window(
                        prompt, kc, vc, n_cur, t_cur, seek, seek_end, params,
                        opts, no_timestamps, attempt=it,
                        strategy="beam" if use_beam else "greedy")
                self.no_speech_prob = float(result["no_speech_prob"][0])

                # rank the candidates; the last rung always emits
                # (reference: src/whisper.cpp:6169-6230)
                best, n_fail_h = _rank_window_candidates(
                    result, n_cur, params,
                    last=it == len(temperatures) - 1,
                    token_eot=self.vocab.token_eot)
                self.timings.n_fail_h += n_fail_h
                if best is not None:
                    best["prompt"] = prompt
                    break
                self.timings.n_fail_p += 1

            if best is None:
                # every temperature failed: consume the window
                seek += TICKS_PER_SECOND * CHUNK_SIZE
                continue
            n_seg_before = len(self.result_all)
            seek_new = self._emit_segments(best, seek, seek_end, params,
                                           prompt_init, no_timestamps)

            # DTW pass over the new segments (reference: whisper.cpp:6364-6378)
            n_new = len(self.result_all) - n_seg_before
            if self.dtw_token_timestamps and n_new:
                n_frames = min(CHUNK_SIZE * TICKS_PER_SECOND,
                               best["seek_delta"], seek_end - seek)
                compute_token_level_timestamps_dtw(
                    self, params, n_seg_before, n_new, seek, n_frames,
                    medfilt_width=7)
                if params.new_segment_callback:
                    # deferred until DTW stamped the tokens: one call for
                    # every new segment (the reference's per-segment loop
                    # at whisper.cpp:6372-6376 double-reports)
                    params.new_segment_callback(self, n_new)
            seek = seek_new
        return 0

    def _decode_window_host(self, prompt, kc, vc, t_cur, seek, seek_end,
                            params, opts, no_timestamps, attempt):
        """The host-loop window decode of grammars and logits-filter
        callbacks -> (result, candidate count).  Beam search with
        beam_size > 1 forks grammar states on the host
        (decode/host_beam.py; the reference applies grammar per decoder
        in its beam loop, whisper.cpp:5925-5977); greedy decodes best_of
        decoders at t > 0 and speculative device chunks at t = 0
        (decode/grammar_loop.py).  At t > 0 both take best_of candidates
        (reference: whisper.cpp:5718-5724)."""
        if (params.strategy == SamplingStrategy.BEAM_SEARCH
                and params.beam_search.beam_size > 1):
            n_cur = (params.beam_search.beam_size if t_cur <= 0.0
                     else max(1, params.greedy.best_of))
            result = decode_window_host_beam(
                self, prompt, kc, vc, t_cur, seek, seek_end, params, opts,
                no_timestamps, grammar=params.grammar_rules,
                beam_size=n_cur, seed=attempt)
        else:
            n_cur = 1 if t_cur < 1e-6 else max(1, params.greedy.best_of)
            result = decode_window_grammar(
                self, prompt, kc, vc, t_cur, seek, seek_end, params, opts,
                no_timestamps, grammar=params.grammar_rules,
                n_decoders=n_cur, seed=attempt)
        return result, n_cur

    def _prompt_step_fns(self):
        """(prompt_fn, step_fn) of the host loops: the causal prompt pass
        -> (logits (B, T, V), k_self, v_self), and one decode step over
        the (L, B, H, Dh, C) self-KV -> (logits (B, V), kv)."""
        nh = self.config.n_text_head
        cd = self.compute_dtype

        @torch.no_grad()
        def prompt_fn(params, tokens, kc, vc):
            T = tokens.shape[1]
            return wm.decode_prompt(
                params, tokens, torch.arange(T, device=tokens.device), kc,
                vc, n_head=nh,
                self_mask=wm.make_causal_mask(T, device=tokens.device),
                compute_dtype=cd)

        @torch.no_grad()
        def step_fn(params, tok, pos, cache_idx, kv, kc, vc, kv_len):
            return wm.decode_step(params, tok, pos, cache_idx, kv, kc, vc,
                                  kv_len=kv_len, n_head=nh, compute_dtype=cd)

        return prompt_fn, step_fn

    def _decode_window(self, prompt, kc, vc, n_cur, t_cur, seek, seek_end,
                       params, opts, no_timestamps, attempt=0,
                       strategy="greedy"):
        """One window decode of n_cur candidates (greedy decoders or
        beams) of the same prompt against the window's cross-KV."""
        # prompt buffer: tiny when unconditioned, full when carrying past
        P = 8 if len(prompt) <= 8 else self.hparams.n_text_ctx // 2 + 8
        extra = (self._regex_suppress_ids(params.suppress_regex)
                 if params.suppress_regex else ())
        fn = self._decode_window_fn(n_cur, P, opts, params.single_segment,
                                    no_timestamps, params.max_tokens,
                                    strategy, extra)
        pad = P - len(prompt)
        buf = np.zeros((n_cur, P), dtype=np.int32)
        buf[:, pad:] = np.asarray(prompt, dtype=np.int32)
        pad_len = np.full((n_cur,), pad, dtype=np.int32)

        # cross-KV computed for batch 1, broadcast across the decoders
        if n_cur > 1 and kc.shape[1] == 1:
            kc = kc.expand((kc.shape[0], n_cur) + kc.shape[2:])
            vc = vc.expand((vc.shape[0], n_cur) + vc.shape[2:])

        t0 = time.perf_counter()
        # draw keys from (window seek, ladder attempt, candidate): the same
        # window re-decoded by the batched serving path draws the same
        # numbers (one stream for the beam)
        if strategy == "beam":
            out = fn(self.params, kc, vc, buf, pad_len, t_cur, seek,
                     seek_end, window_rng(seek, attempt, n_cur,
                                          per_row=False))
        else:
            out = fn(self.params, kc, vc, buf, pad_len, t_cur, seek,
                     seek_end, window_rng(seek, attempt, n_cur),
                     np.ones((n_cur,), bool))
        n_tok = int(out["n_tokens"])
        self.timings.t_decode_us += int((time.perf_counter() - t0) * 1e6)
        self.timings.n_decode += max(n_tok, 1)
        self.timings.n_sample += max(n_tok, 1)
        self.timings.n_prompt += len(prompt)
        return out

    def _emit_segments(self, best, seek, seek_end, params, prompt_init,
                       no_timestamps) -> int:
        """Segment assembly (reference: src/whisper.cpp:6232-6390).
        Returns the new seek."""
        vocab = self.vocab
        result_len = best["result_len"]
        seek_delta = best["seek_delta"]
        prompt = best["prompt"]

        # the sequence is truncated to result_len before emission
        # (reference: whisper.cpp:6180 tokens.resize(result_len))
        n_emit = best.get("n_emit", result_len)
        tokens_cur = [
            TokenData(id=int(best["tokens"][i]), tid=int(best["tid"][i]),
                      p=float(best["p"][i]), plog=float(best["plog"][i]),
                      pt=float(best["pt"][i]), ptsum=float(best["ptsum"][i]))
            for i in range(n_emit)
        ]

        is_no_speech = (self.no_speech_prob > params.no_speech_thold
                        and best["avg_logprobs"] < params.logprob_thold)

        # update prompt_past (reference: src/whisper.cpp:6248-6257)
        self.prompt_past = []
        if prompt and prompt[0] == vocab.token_prev:
            self.prompt_past = prompt[1:len(prompt) - len(prompt_init)]
        if not is_no_speech:
            self.prompt_past += [t.id for t in tokens_cur[:result_len]]

        if tokens_cur and self.n_loaded > 0 and not is_no_speech:
            i0 = 0
            # with no timestamp sampled, tid is 0 and t0 lands before seek:
            # kept as the reference computes it
            t0 = seek + 2 * (tokens_cur[0].tid - vocab.token_beg)
            text = ""
            speaker_turn_next = False

            i = 0
            while i < len(tokens_cur):
                tok = tokens_cur[i]
                if params.print_special or tok.id < vocab.token_eot:
                    text += vocab.token_str(tok.id)

                if params.tdrz_enable and tok.id == vocab.token_solm:
                    speaker_turn_next = True

                if tok.id > vocab.token_beg and not params.single_segment:
                    t1 = seek + 2 * (tok.tid - vocab.token_beg)
                    if text:
                        self._push_segment(t0, t1, text, tokens_cur[i0:i + 1],
                                           speaker_turn_next, params)
                    text = ""
                    while (i < len(tokens_cur)
                           and tokens_cur[i].id > vocab.token_beg):
                        i += 1
                    i -= 1
                    t0 = t1
                    i0 = i + 1
                    speaker_turn_next = False
                i += 1

            if text:
                t1 = seek + seek_delta
                self._push_segment(t0, t1, text, tokens_cur[i0:],
                                   speaker_turn_next, params)

        # single-timestamp ending: skip the whole chunk
        # (reference: src/whisper.cpp:6380-6387)
        if (len(tokens_cur) > 1
                and tokens_cur[-2].id < vocab.token_beg
                and tokens_cur[-1].id > vocab.token_beg):
            seek_delta = min(seek_end - seek, CHUNK_SIZE * TICKS_PER_SECOND)

        return seek + seek_delta

    # ---- segment accessors (reference: src/whisper.cpp:6522-6617) --------

    def full_n_segments(self) -> int: return len(self.result_all)
    def full_lang_id(self) -> int: return self.lang_id_state
    def full_get_segment_t0(self, i: int) -> int: return self.result_all[i].t0
    def full_get_segment_t1(self, i: int) -> int: return self.result_all[i].t1
    def full_get_segment_text(self, i: int) -> str: return self.result_all[i].text
    def full_get_segment_speaker_turn_next(self, i: int) -> bool:
        return self.result_all[i].speaker_turn_next
    def full_n_tokens(self, i: int) -> int: return len(self.result_all[i].tokens)
    def full_get_token_id(self, i: int, j: int) -> int:
        return self.result_all[i].tokens[j].id
    def full_get_token_text(self, i: int, j: int) -> str:
        return self.vocab.token_str(self.result_all[i].tokens[j].id)
    def full_get_token_data(self, i: int, j: int) -> TokenData:
        return self.result_all[i].tokens[j]
    def full_get_token_p(self, i: int, j: int) -> float:
        return self.result_all[i].tokens[j].p
    def full_get_segment_no_speech_prob(self, i: int) -> float:
        return self.result_all[i].no_speech_prob

    def _push_segment(self, t0, t1, text, tokens, speaker_turn_next, params):
        if params.print_realtime:
            if params.print_timestamps:
                print(f"[{to_timestamp(int(t0))} --> "
                      f"{to_timestamp(int(t1))}]  {text}", flush=True)
            else:
                print(text, end="", flush=True)
        self.result_all.append(Segment(
            t0=int(t0), t1=int(t1), text=text,
            no_speech_prob=self.no_speech_prob, tokens=list(tokens),
            speaker_turn_next=speaker_turn_next))
        n_new = 1
        if params.token_timestamps:
            compute_token_level_timestamps(
                self, len(self.result_all) - 1, params.thold_pt,
                params.thold_ptsum)
            if params.max_len > 0:
                n_new = wrap_segment(self, params.max_len,
                                     params.split_on_word)
        if params.new_segment_callback and not self.dtw_token_timestamps:
            params.new_segment_callback(self, n_new)


    # ---- whisper_full_parallel (reference: src/whisper.cpp:6407-6520) ----

    def full_parallel(self, params: FullParams, samples: np.ndarray,
                      n_processors: int = 1) -> int:
        """whisper_full_parallel: the audio split into n_processors chunks,
        their segments merged with timestamp shifts and overlap clamps as
        in the reference.

        The reference gives each chunk a CPU thread; here the device is the
        shared resource.  Chunks ride one batched decode
        (`_full_parallel_batched`, chunk = batch row) unless the params
        need what only the serial `full` does (grammars, callbacks, beam
        search, detect-only, token timestamps, DTW); then they run back
        to back, each on a fresh state."""
        if n_processors <= 1:
            return self.full(params, samples)

        can_batch = (params.grammar_rules is None
                     and params.logits_filter_callback is None
                     and params.encoder_begin_callback is None
                     and params.abort_callback is None
                     and params.strategy == SamplingStrategy.GREEDY
                     and not params.detect_language
                     and not params.token_timestamps
                     and not self.dtw_token_timestamps
                     and self.n_loaded > 0)
        if can_batch:
            return self._full_parallel_batched(params, samples, n_processors)

        offset_samples = (16000 * params.offset_ms) // 1000
        n_per = (len(samples) - offset_samples) // n_processors
        offset_t = params.offset_ms // 10

        # chunk 0 runs on the default state (includes the leading offset)
        ret = self.full(params, samples[:offset_samples + n_per])
        merged = list(self.result_all)

        chunk_params = dataclasses.replace(
            params, offset_ms=0, print_progress=False, print_realtime=False,
            new_segment_callback=None, progress_callback=None)

        for i in range(n_processors - 1):
            start = offset_samples + (i + 1) * n_per
            end = len(samples) if i == n_processors - 2 else start + n_per
            state = self.init_state()
            rc = self.full(chunk_params, samples[start:end], state=state)
            if rc != 0:
                ret = rc
            shift = 100 * ((i + 1) * n_per) // 16000 + offset_t
            for seg in state.result_all:
                seg.t0 += shift
                seg.t1 += shift
                if merged:
                    seg.t0 = max(seg.t0, merged[-1].t1)
                merged.append(seg)
                if params.new_segment_callback:
                    self.result_all = merged  # accessor view during callback
                    params.new_segment_callback(self, 1)

        self.result_all = merged
        self._log_splits(n_processors, n_per, offset_t)
        return ret

    def _full_parallel_batched(self, params: FullParams, samples,
                               n_processors: int) -> int:
        """full_parallel through the batched pipeline: every chunk is a row
        of one BatchTranscriber batch (parallel/batch.py).  Segment
        merging, timestamp shifts and overlap clamps are the serial
        path's."""
        from .parallel.batch import BatchTranscriber

        offset_samples = (16000 * params.offset_ms) // 1000
        n_per = (len(samples) - offset_samples) // n_processors
        offset_t = params.offset_ms // 10

        chunks = []
        for i in range(n_processors):
            start = offset_samples + i * n_per
            end = (len(samples) if i == n_processors - 1
                   else start + n_per)
            chunks.append(np.asarray(samples[start:end], np.float32))

        chunk_params = dataclasses.replace(
            params, offset_ms=0, print_progress=False, print_realtime=False,
            new_segment_callback=None, progress_callback=None)
        bt = BatchTranscriber(self, batch_size=n_processors,
                              params=chunk_params)
        results = bt.transcribe(chunks)
        if bt.auto_lang and bt.last_states:
            # each chunk detected its own language (as each reference
            # thread does); the context's lang id is chunk 0's, the state
            # the reference merges results into (whisper.cpp:6450)
            lid = bt.last_states[0].full_lang_id()
            self.lang_id_state = lid
            params.language = lang_str(lid)

        merged: list[Segment] = []
        for i, segs in enumerate(results):
            shift = 100 * (i * n_per) // 16000 + offset_t
            for seg in segs:
                seg.t0 += shift
                seg.t1 += shift
                if merged:
                    seg.t0 = max(seg.t0, merged[-1].t1)
                merged.append(seg)
                if params.new_segment_callback:
                    self.result_all = merged
                    params.new_segment_callback(self, 1)
        self.result_all = merged
        self._log_splits(n_processors, n_per, offset_t)
        return 0

    def _log_splits(self, n_processors: int, n_per: int,
                    offset_t: int) -> None:
        log_warn(f"the audio has been split into {n_processors} chunks at "
                 "the following times:")
        for i in range(n_processors - 1):
            t = 100 * ((i + 1) * n_per) // 16000 + offset_t
            log_warn(f"split {i + 1} - {to_timestamp(t)}")
        log_warn("the transcription quality may be degraded near these "
                 "boundaries")


# session-state attribute proxies: WhisperContext.<field> reads/writes the
# state selected by use_state() in the calling thread
for _f in ("mel", "mel_n_len_org", "lang_id_state", "no_speech_prob",
           "result_all", "prompt_past", "energy", "t_beg", "t_last",
           "tid_last", "exp_n_audio_ctx", "timings",
           "_capi_logits", "_capi_kv", "_encoded"):
    setattr(WhisperContext, _f, _session_property(_f))
del _f


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    if dt.name == "bfloat16":
        return torch.bfloat16
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float16): torch.float16}[dt]


def _ladder(temperature: float, temperature_inc: float) -> list[float]:
    """The temperature-fallback rungs (reference: src/whisper.cpp:5541-5549):
    temperature, then steps of temperature_inc up to 1.0."""
    if temperature_inc <= 0.0:
        return [temperature]
    temps, t = [], temperature
    while t < 1.0 + 1e-6:
        temps.append(t)
        t += temperature_inc
    return temps


def window_rng(seek, attempt: int, n_cur: int, per_row: bool = True):
    """Sampling keys for one window decode, derived from (window seek,
    ladder attempt, candidate index), as whisper_tpu derives its threefry
    key data (decode/rng.py draws from them): serial `full` and the
    batched serving path draw the same numbers for the same window.
    per_row=False gives one (2,) key (beam search draws one stream a
    window)."""
    if not per_row:
        return np.array([np.uint32(seek), np.uint32(attempt)], np.uint32)
    keys = np.empty((n_cur, 2), np.uint32)
    keys[:, 0] = np.uint32(seek)
    keys[:, 1] = (np.uint32(attempt) << np.uint32(8)) + np.arange(
        n_cur, dtype=np.uint32)
    return keys


def _own_sampled_len(tokens, n_tokens: int, token_eot: int) -> int:
    """Length of one row's own sampled sequence inside the batch-global
    step budget `n_tokens` (trailing token_eot entries belong to other
    rows' longer decodes)."""
    toks = np.asarray(tokens[:n_tokens])
    nz = np.nonzero(toks != token_eot)[0]
    return int(nz[-1]) + 1 if nz.size else 0


def _sequence_score(plogs: np.ndarray, token_ids: np.ndarray,
                    length_penalty: float) -> tuple[float, float, float]:
    """whisper_sequence_score (reference: src/whisper.cpp:5433-5479).
    Returns (score, avg_logprobs, entropy-of-last-32-token-ids)."""
    n = len(plogs)
    if n == 0:
        return -math.inf, -math.inf, 0.0
    total = float(plogs.sum())
    avg = total / n
    if length_penalty > 0.0:
        penalty = ((5.0 + n) / 6.0) ** length_penalty
    else:
        penalty = float(n)
    score = total / penalty

    last = token_ids[max(0, n - 32):n]
    _, counts = np.unique(last, return_counts=True)
    ps = counts / counts.sum()
    entropy = float(-(ps * np.log(ps)).sum())
    return score, avg, entropy


def _rank_window_candidates(result, n_cur: int, params, last: bool,
                            token_eot: int, row0: int = 0):
    """Rank one window's n_cur candidate sequences and decide whether this
    temperature rung succeeded (reference: src/whisper.cpp:6169-6230).

    result: decode output dict; rows [row0, row0 + n_cur) are this
    window's candidates.  last: final temperature rung (always emits).
    Returns (best: dict | None, n_fail_h: int).
    """
    best_j, best_score = -1, -math.inf
    seqs = []
    n_fail_h = 0
    for jj in range(n_cur):
        j = row0 + jj
        failed = bool(result["failed"][j])
        rl = int(result["result_len"][j])
        plogs = np.asarray(result["plog"][j][:rl])
        score, avg_lp, entropy = _sequence_score(
            plogs, np.asarray(result["tokens"][j][:rl]),
            params.length_penalty)
        if not failed and rl > 32 and entropy < params.entropy_thold:
            failed = True
            n_fail_h += 1
        seqs.append((failed, rl, score, avg_lp))
        if not failed and score > best_score:
            best_score, best_j = score, jj

    no_speech_prob = float(result["no_speech_prob"][row0])
    if not last:
        if best_j < 0:
            return None, n_fail_h
        avg_lp = seqs[best_j][3]
        if (avg_lp < params.logprob_thold
                and no_speech_prob < params.no_speech_thold):
            return None, n_fail_h

    jj = max(best_j, 0)
    j = row0 + jj
    # a loop-failed candidate (possible at the final rung) keeps its own
    # sampled tail, not the batch-global step count
    n_emit = (_own_sampled_len(np.asarray(result["tokens"][j]),
                               int(result["n_tokens"]), token_eot)
              if bool(result["failed"][j]) else seqs[jj][1])
    best = {
        "tokens": np.asarray(result["tokens"][j]),
        "p": np.asarray(result["p"][j]),
        "plog": np.asarray(result["plog"][j]),
        "tid": np.asarray(result["tid"][j]),
        "pt": np.asarray(result["pt"][j]),
        "ptsum": np.asarray(result["ptsum"][j]),
        "result_len": seqs[jj][1],
        "n_emit": n_emit,
        "seek_delta": int(result["seek_delta"][j]),
        "avg_logprobs": seqs[jj][3],
        "no_speech_prob": no_speech_prob,
    }
    return best, n_fail_h
