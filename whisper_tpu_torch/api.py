"""Public API of the port: parameters, context and segment assembly
(port of the serving slice of whisper_tpu.api).

The dataclasses keep whisper_tpu's fields and defaults.  `WhisperContext`
carries only what the batched serving path needs: random-weight
construction, the bridge from a whisper_tpu context, the window-decode
function cache and host-side segment assembly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .audio.filters import mel_filterbank
from .audio.mel import full_f32_matmuls
from .constants import CHUNK_SIZE, TICKS_PER_SECOND
from .decode.filters import FilterConsts, FilterOptions
from .decode.loop import LoopConfig, make_decode_window
from .models.whisper import MODEL_DIMS, WhisperConfig
from .weights.convert import from_jax, random_params
from .weights.vocab import Vocab, synthetic_vocab

CROSS_MODES = ("einsum_q8",)   # cross-KV modes the port runs


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

    def full_n_segments(self): return len(self.result_all)
    def full_lang_id(self): return self.lang_id_state
    def full_get_segment_t0(self, i): return self.result_all[i].t0
    def full_get_segment_t1(self, i): return self.result_all[i].t1
    def full_get_segment_text(self, i): return self.result_all[i].text
    def full_n_tokens(self, i): return len(self.result_all[i].tokens)
    def full_get_token_id(self, i, j): return self.result_all[i].tokens[j].id


def _to_timestamp(t: int) -> str:
    """Ticks -> "HH:MM:SS.mmm" (whisper_tpu.outputs.to_timestamp)."""
    msec = t * 10
    hr, msec = divmod(msec, 1000 * 60 * 60)
    minute, msec = divmod(msec, 1000 * 60)
    sec, msec = divmod(msec, 1000)
    return f"{hr:02d}:{minute:02d}:{sec:02d}.{msec:03d}"


def _session_property(name):
    def get(self):
        return getattr(self._cur_state, name)

    def set_(self, value):
        setattr(self._cur_state, name, value)

    return property(get, set_)


class WhisperContext:
    """Model weights, vocab and filters on one torch device, plus the
    session state that segment assembly writes (whisper_context +
    whisper_state).  Build it with `from_random` or `from_jax`."""

    def __init__(self, *, config: WhisperConfig, vocab: Vocab,
                 filters: np.ndarray, params: dict, device,
                 compute_dtype: torch.dtype, cross_mode: str):
        if cross_mode not in CROSS_MODES:
            raise NotImplementedError(
                f"cross_mode {cross_mode!r} is not ported (have "
                f"{CROSS_MODES})")
        if torch.device(device).type == "cuda":
            full_f32_matmuls()
        self.config = config
        self.vocab = vocab
        self.filters = np.asarray(filters, np.float32)
        self.params = params
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.cross_mode = cross_mode
        self.n_loaded = sum(1 for _ in _leaves(params))
        self.dtw_token_timestamps = False
        self._default_state = WhisperState()
        self._cur_state = self._default_state
        self._fn_cache: dict = {}

    @classmethod
    def from_random(cls, size: str = "large-v3", seed: int = 0,
                    device="cpu", compute_dtype=torch.bfloat16,
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
    def from_jax(cls, jax_ctx, device="cpu") -> "WhisperContext":
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
        return cls(config=cfg, vocab=vocab, filters=jax_ctx.filters,
                   params=from_jax(params_np, device),
                   device=device, compute_dtype=dtype,
                   cross_mode=jax_ctx.cross_mode)

    def _decode_window_fn(self, B: int, P: int, opts: FilterOptions,
                          single_segment: bool, no_timestamps: bool,
                          max_tokens: int, strategy: str = "greedy",
                          extra_suppress: tuple = ()):
        key = ("dec", B, P, opts, single_segment, no_timestamps, max_tokens,
               strategy, extra_suppress)
        if key not in self._fn_cache:
            n_text_ctx = self.config.n_text_ctx
            cfg = LoopConfig(
                n_head=self.config.n_text_head,
                n_text_ctx=n_text_ctx,
                prompt_size=P,
                # max_tokens caps the loop at i >= max_tokens, so the
                # (B, N) buffers and the (..., C) cache shrink to match
                max_tokens_loop=(min(n_text_ctx // 2 - 4, max_tokens + 1)
                                 if max_tokens > 0 else n_text_ctx // 2 - 4),
                max_tokens_param=max_tokens,
                single_segment=single_segment,
                no_timestamps=no_timestamps,
                compute_dtype=self.compute_dtype,
                cross_mode=self.cross_mode,
            )
            self._fn_cache[key] = make_decode_window(
                consts=FilterConsts.from_vocab(self.vocab,
                                               self.config.n_audio_ctx),
                options=opts, cfg=cfg, strategy=strategy,
                extra_suppress=extra_suppress, device=self.device)
        return self._fn_cache[key]

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

    def _push_segment(self, t0, t1, text, tokens, speaker_turn_next, params):
        if params.print_realtime:
            if params.print_timestamps:
                print(f"[{_to_timestamp(int(t0))} --> "
                      f"{_to_timestamp(int(t1))}]  {text}", flush=True)
            else:
                print(text, end="", flush=True)
        self.result_all.append(Segment(
            t0=int(t0), t1=int(t1), text=text,
            no_speech_prob=self.no_speech_prob, tokens=list(tokens),
            speaker_turn_next=speaker_turn_next))
        if params.new_segment_callback:
            params.new_segment_callback(self, 1)


# session-state attribute proxies: WhisperContext.<field> reads/writes the
# state selected by use_state()
for _f in ("mel", "mel_n_len_org", "lang_id_state", "no_speech_prob",
           "result_all", "prompt_past", "energy", "t_beg", "t_last",
           "tid_last", "exp_n_audio_ctx"):
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


def window_rng(seek, attempt: int, n_cur: int, per_row: bool = True):
    """Sampling keys for one window decode, derived from (window seek,
    ladder attempt, candidate index), as whisper_tpu derives its threefry
    key data.  The port decodes greedily only: the sampler that draws
    from these keys (t > 0) is not ported yet."""
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
