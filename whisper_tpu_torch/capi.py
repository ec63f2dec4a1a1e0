"""C-style API surface: the whisper.h function names, 1:1 (port of
whisper_tpu.capi).

Every public function of the reference header (reference: include/whisper.h)
is exposed under its original name so code written against whisper.cpp's C
API ports mechanically:

    import whisper_tpu_torch.capi as whisper
    ctx = whisper.whisper_init_from_file_with_params("ggml-tiny.en.bin",
            whisper.whisper_context_default_params())
    params = whisper.whisper_full_default_params(whisper.WHISPER_SAMPLING_GREEDY)
    whisper.whisper_full(ctx, params, samples, len(samples))
    n = whisper.whisper_full_n_segments(ctx)

The "context" is a WhisperContext; whisper_init_state returns a
WhisperState sharing the context's weights, like the reference's
whisper_state.  Functions taking (ctx, state) route the call through the
given state.

The device: whisper_context_params.use_gpu=False puts a context on the
CPU; otherwise it runs on the device that the environment variable
WHISPER_TPU_TORCH_DEVICE names (e.g. "cpu", "cuda:1"), else on
cuda:<gpu_device>.  A CUDA device without a card raises; nothing falls
back to the CPU.

`library_path()` builds the C ABI library over this module (libwhisper_tpu.so
from whisper_tpu_torch/native/wtpu_capi.cpp and native/whisper_tpu.h).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import sysconfig
import time
from pathlib import Path

import numpy as np
import torch

from . import languages
from .api import (FullParams, SamplingStrategy, WhisperContext,
                  full_default_params)
from .outputs import ctx_system_info
from .utils import native_build
from .utils.device import resolve_device
from .utils.logging import log_set

WHISPER_SAMPLING_GREEDY = SamplingStrategy.GREEDY
WHISPER_SAMPLING_BEAM_SEARCH = SamplingStrategy.BEAM_SEARCH

# alignment-head presets (reference: whisper.h:83-103)
WHISPER_AHEADS_NONE = "none"
WHISPER_AHEADS_N_TOP_MOST = "n_top_most"
WHISPER_AHEADS_CUSTOM = "custom"
WHISPER_AHEADS_TINY_EN = "tiny.en"
WHISPER_AHEADS_TINY = "tiny"
WHISPER_AHEADS_BASE_EN = "base.en"
WHISPER_AHEADS_BASE = "base"
WHISPER_AHEADS_SMALL_EN = "small.en"
WHISPER_AHEADS_SMALL = "small"
WHISPER_AHEADS_MEDIUM_EN = "medium.en"
WHISPER_AHEADS_MEDIUM = "medium"
WHISPER_AHEADS_LARGE_V1 = "large-v1"
WHISPER_AHEADS_LARGE_V2 = "large-v2"
WHISPER_AHEADS_LARGE_V3 = "large-v3"
WHISPER_AHEADS_LARGE_V3_TURBO = "large-v3-turbo"

# names the device of contexts whose params say use_gpu (module docstring)
DEVICE_ENV = "WHISPER_TPU_TORCH_DEVICE"
# whisper_bench_ggml_mul_mat's square sizes
MUL_MAT_SIZES = (64, 128, 256, 512, 1024, 2048, 4096)

PKG_DIR = Path(__file__).resolve().parent
ROOT = PKG_DIR.parent
BUILD_DIR = ROOT / "build" / "whisper_tpu_torch"
LIB_DIR = BUILD_DIR / "capi"
SOURCE = PKG_DIR / "native" / "wtpu_capi.cpp"
HEADER = ROOT / "native" / "whisper_tpu.h"


@dataclasses.dataclass
class whisper_context_params:
    """reference: whisper.h:105-134.  use_gpu and gpu_device choose the
    device (module docstring)."""
    use_gpu: bool = True
    flash_attn: bool = False
    gpu_device: int = 0
    dtw_token_timestamps: bool = False
    dtw_aheads_preset: str = WHISPER_AHEADS_NONE
    dtw_n_top: int = -1
    dtw_aheads: list | None = None


def context_device(params: whisper_context_params) -> str:
    """The device a context of these params runs on."""
    if not params.use_gpu:
        return "cpu"
    return os.environ.get(DEVICE_ENV) or f"cuda:{params.gpu_device}"


def whisper_context_default_params() -> whisper_context_params:
    return whisper_context_params()


def whisper_context_default_params_by_ref() -> whisper_context_params:
    return whisper_context_params()


def whisper_full_default_params_by_ref(strategy: int):
    return full_default_params(strategy)


def whisper_ctx_init_openvino_encoder_with_state(ctx, state, model_path=None,
                                                 device=None,
                                                 cache_dir=None) -> int:
    """No-op: external-encoder offload is unnecessary — the encoder on the
    card IS the accelerated path (reference: whisper.h:243-254)."""
    return 0


def whisper_ctx_init_openvino_encoder(ctx, model_path=None, device=None,
                                      cache_dir=None) -> int:
    return whisper_ctx_init_openvino_encoder_with_state(
        ctx, None, model_path, device, cache_dir)


# ---- init family (reference: whisper.h:195-241) --------------------------

def _context_kwargs(params: whisper_context_params) -> dict:
    return dict(device=context_device(params),
                dtw_token_timestamps=params.dtw_token_timestamps,
                dtw_aheads_preset=params.dtw_aheads_preset,
                dtw_n_top=max(params.dtw_n_top, 0),
                dtw_aheads=params.dtw_aheads)


def whisper_init_from_file_with_params(path: str,
                                       params: whisper_context_params):
    return WhisperContext.from_file(path, **_context_kwargs(params))


def whisper_init_from_buffer_with_params(buf: bytes,
                                         params: whisper_context_params):
    return WhisperContext.from_buffer(buf, **_context_kwargs(params))


def _read_loader(loader) -> bytes:
    """Drain a whisper_model_loader-style object into bytes.

    The reference's loader is {context, read(buf, n), eof(), close()}
    (whisper.h:156-166).  Accepts any object with read()/eof() callables
    (or a plain file-like with read())."""
    if hasattr(loader, "eof") and callable(loader.eof):
        chunks = []
        while not loader.eof():
            chunk = loader.read(1 << 20)
            if not chunk:
                break
            chunks.append(bytes(chunk))
        if hasattr(loader, "close") and callable(loader.close):
            loader.close()
        return b"".join(chunks)
    return bytes(loader.read())


def whisper_init_with_params(loader, params: whisper_context_params):
    """Init from a whisper_model_loader (reference: whisper.h:197)."""
    return whisper_init_from_buffer_with_params(_read_loader(loader), params)


# -- no_state variants (reference: whisper.h:199-203, #523): the context is
# created without its internal state; the caller must whisper_init_state()
# and use the *_with_state API family.

def _drop_default_state(ctx):
    ctx._default_state = None
    ctx._cur_state = None
    return ctx


def whisper_init_from_file_with_params_no_state(
        path: str, params: whisper_context_params):
    return _drop_default_state(
        whisper_init_from_file_with_params(path, params))


def whisper_init_from_buffer_with_params_no_state(
        buf: bytes, params: whisper_context_params):
    return _drop_default_state(
        whisper_init_from_buffer_with_params(buf, params))


def whisper_init_with_params_no_state(loader,
                                      params: whisper_context_params):
    return _drop_default_state(whisper_init_with_params(loader, params))


def whisper_init_from_file(path: str):  # deprecated alias
    return whisper_init_from_file_with_params(
        path, whisper_context_default_params())


def whisper_init_from_buffer(buf: bytes):  # deprecated alias
    return whisper_init_from_buffer_with_params(
        buf, whisper_context_default_params())


def whisper_init(loader):  # deprecated alias
    return whisper_init_with_params(loader, whisper_context_default_params())


def whisper_init_from_file_no_state(path: str):  # deprecated alias
    return whisper_init_from_file_with_params_no_state(
        path, whisper_context_default_params())


def whisper_init_from_buffer_no_state(buf: bytes):  # deprecated alias
    return whisper_init_from_buffer_with_params_no_state(
        buf, whisper_context_default_params())


def whisper_init_no_state(loader):  # deprecated alias
    return whisper_init_with_params_no_state(
        loader, whisper_context_default_params())


def whisper_init_state(ctx):
    """A fresh decoding session sharing the context's weights."""
    return ctx.init_state()


def whisper_free(ctx) -> None:
    pass  # GC-managed


def whisper_free_state(state) -> None:
    pass


def whisper_free_params(params) -> None:
    pass


def whisper_free_context_params(params) -> None:
    pass


# ---- mel / encode / decode (reference: whisper.h:265-344) ----------------

def whisper_pcm_to_mel(ctx, samples, n_samples=None, n_threads: int = 4) -> int:
    ctx.pcm_to_mel(np.asarray(samples, np.float32)[:n_samples])
    return 0


def whisper_pcm_to_mel_with_state(ctx, state, samples, n_samples=None,
                                  n_threads: int = 4) -> int:
    with ctx.use_state(state):
        return whisper_pcm_to_mel(ctx, samples, n_samples, n_threads)


def whisper_set_mel(ctx, data, n_len: int, n_mel: int) -> int:
    try:
        ctx.set_mel(np.asarray(data, np.float32).reshape(n_mel, n_len).T)
        return 0
    except ValueError:
        return -1


def whisper_set_mel_with_state(ctx, state, data, n_len, n_mel) -> int:
    with ctx.use_state(state):
        return whisper_set_mel(ctx, data, n_len, n_mel)


def whisper_encode(ctx, offset: int, n_threads: int = 4) -> int:
    ctx._encoded = ctx.encode_window(offset)
    return 0


def whisper_encode_with_state(ctx, state, offset, n_threads=4) -> int:
    with ctx.use_state(state):
        return whisper_encode(ctx, offset, n_threads)


def whisper_decode(ctx, tokens, n_tokens: int, n_past: int,
                   n_threads: int = 4) -> int:
    """Legacy single-sequence decode; logits retrievable via
    whisper_get_logits.  n_past == 0 runs the causal prompt pass over the
    tokens and lays its self-KV into a (L, 1, H, Dh, n_text_ctx) cache;
    n_past > 0 runs one decode step a token on that cache."""
    if getattr(ctx, "_encoded", None) is None:
        return -1
    _, kc, vc = ctx._encoded
    toks = [int(t) for t in tokens[:n_tokens]]
    prompt_fn, step_fn = ctx._prompt_step_fns()
    dev, cd = ctx.device, ctx.compute_dtype
    if n_past == 0:
        logits, ks, vs = prompt_fn(
            ctx.params, torch.tensor([toks], dtype=torch.long, device=dev),
            kc, vc)
        C = ctx.hparams.n_text_ctx
        L, H, Dh = (ctx.config.n_text_layer, ctx.config.n_text_head,
                    ctx.config.head_dim_text)
        kv = {"k": torch.zeros((L, 1, H, Dh, C), dtype=cd, device=dev),
              "v": torch.zeros((L, 1, H, Dh, C), dtype=cd, device=dev)}
        # (L, 1, T, H, Dh) -> (L, 1, H, Dh, T): whisper_tpu's
        # transpose(0, 1, 3, 4, 2)
        kv["k"][..., :len(toks)] = ks.permute(0, 1, 3, 4, 2).to(cd)
        kv["v"][..., :len(toks)] = vs.permute(0, 1, 3, 4, 2).to(cd)
        ctx._capi_kv = kv
        # whisper.h: logits hold n_tokens rows x n_vocab cols
        ctx._capi_logits = logits[0].float().cpu().numpy()
    else:
        kv = getattr(ctx, "_capi_kv", None)
        if kv is None:
            return -2
        rows = []
        for i, t in enumerate(toks):
            pos = n_past + i
            lg, kv = step_fn(
                ctx.params, torch.tensor([t], dtype=torch.long, device=dev),
                torch.tensor([pos], dtype=torch.long, device=dev), pos, kv,
                kc, vc, pos + 1)
            rows.append(lg[0].float().cpu().numpy())
        ctx._capi_kv = kv
        ctx._capi_logits = np.stack(rows)
    return 0


def whisper_decode_with_state(ctx, state, tokens, n_tokens, n_past,
                              n_threads=4) -> int:
    with ctx.use_state(state):
        return whisper_decode(ctx, tokens, n_tokens, n_past, n_threads)


def whisper_get_logits(ctx) -> np.ndarray:
    """(n_tokens, n_vocab) rows from the last whisper_decode
    (reference: whisper.h:308-315)."""
    lg = getattr(ctx, "_capi_logits", None)
    if lg is None:
        return np.zeros((0, ctx.n_vocab()), np.float32)
    return lg


def whisper_get_logits_from_state(state) -> np.ndarray:
    # _capi_logits is a per-session field: decode_with_state stashed it on
    # the state itself
    lg = getattr(state, "_capi_logits", None)
    return lg if lg is not None else np.zeros((0, 0), np.float32)


def whisper_tokenize(ctx, text: str, tokens, n_max_tokens: int) -> int:
    ids = ctx.tokenize(text)
    if len(ids) > n_max_tokens:
        return -len(ids)
    tokens[:len(ids)] = ids
    return len(ids)


def whisper_token_count(ctx, text: str) -> int:
    return -whisper_tokenize(ctx, text, [0] * 0, 0)


# ---- language API (reference: whisper.h:347-378) -------------------------

def whisper_lang_max_id() -> int:
    return languages.lang_max_id()


def whisper_lang_id(lang: str) -> int:
    return languages.lang_id(lang)


def whisper_lang_str(lid: int):
    return languages.lang_str(lid)


def whisper_lang_str_full(lid: int):
    return languages.lang_str_full(lid)


def whisper_lang_auto_detect(ctx, offset_ms: int, n_threads: int = 4,
                             lang_probs=None) -> int:
    lid, probs = ctx.lang_auto_detect(offset_ms)
    if lang_probs is not None:
        lang_probs[:len(probs)] = probs
    return lid


def whisper_lang_auto_detect_with_state(ctx, state, offset_ms, n_threads=4,
                                        lang_probs=None) -> int:
    with ctx.use_state(state):
        return whisper_lang_auto_detect(ctx, offset_ms, n_threads, lang_probs)


# ---- introspection (reference: whisper.h:380-439) -------------------------

def whisper_n_len(ctx) -> int: return ctx.n_len_from_state()
def whisper_n_len_from_state(state) -> int: return state.mel_n_len_org
def whisper_n_vocab(ctx) -> int: return ctx.n_vocab()
def whisper_n_text_ctx(ctx) -> int: return ctx.n_text_ctx()
def whisper_n_audio_ctx(ctx) -> int: return ctx.n_audio_ctx()
def whisper_is_multilingual(ctx) -> int: return int(ctx.is_multilingual())
def whisper_model_n_vocab(ctx) -> int: return ctx.hparams.n_vocab
def whisper_model_n_audio_ctx(ctx) -> int: return ctx.hparams.n_audio_ctx
def whisper_model_n_audio_state(ctx) -> int: return ctx.hparams.n_audio_state
def whisper_model_n_audio_head(ctx) -> int: return ctx.hparams.n_audio_head
def whisper_model_n_audio_layer(ctx) -> int: return ctx.hparams.n_audio_layer
def whisper_model_n_text_ctx(ctx) -> int: return ctx.hparams.n_text_ctx
def whisper_model_n_text_state(ctx) -> int: return ctx.hparams.n_text_state
def whisper_model_n_text_head(ctx) -> int: return ctx.hparams.n_text_head
def whisper_model_n_text_layer(ctx) -> int: return ctx.hparams.n_text_layer
def whisper_model_n_mels(ctx) -> int: return ctx.hparams.n_mels
def whisper_model_ftype(ctx) -> int: return ctx.hparams.ftype
def whisper_model_type(ctx) -> int: return ctx.hparams.model_type
def whisper_model_type_readable(ctx) -> str: return ctx.hparams.model_type
def whisper_token_to_str(ctx, token: int) -> str: return ctx.token_to_str(token)
def whisper_token_eot(ctx) -> int: return ctx.token_eot()
def whisper_token_sot(ctx) -> int: return ctx.token_sot()
def whisper_token_solm(ctx) -> int: return ctx.vocab.token_solm
def whisper_token_prev(ctx) -> int: return ctx.token_prev()
def whisper_token_nosp(ctx) -> int: return ctx.token_nosp()
def whisper_token_not(ctx) -> int: return ctx.token_not()
def whisper_token_beg(ctx) -> int: return ctx.token_beg()
def whisper_token_lang(ctx, lang_id: int) -> int: return ctx.token_lang(lang_id)
def whisper_token_translate(ctx) -> int: return ctx.token_translate()
def whisper_token_transcribe(ctx) -> int: return ctx.token_transcribe()


# ---- timings / info -------------------------------------------------------

def whisper_get_timings(ctx):
    return ctx.timings.summary()


def whisper_print_timings(ctx) -> None:
    ctx.timings.print()


def whisper_reset_timings(ctx) -> None:
    ctx.timings.reset()


def whisper_print_system_info() -> str:
    return ctx_system_info()


whisper_log_set = log_set


# ---- full / segments (reference: whisper.h:584-670) -----------------------

def whisper_full_default_params(strategy: int) -> FullParams:
    return full_default_params(strategy)


def whisper_full(ctx, params: FullParams, samples, n_samples=None) -> int:
    pcm = np.asarray(samples, np.float32)
    if n_samples is not None:
        pcm = pcm[:n_samples]
    return ctx.full(params, pcm)


def whisper_full_with_state(ctx, state, params, samples, n_samples=None) -> int:
    pcm = np.asarray(samples, np.float32)
    if n_samples is not None:
        pcm = pcm[:n_samples]
    if state is ctx or state is None:
        return ctx.full(params, pcm)
    return ctx.full(params, pcm, state=state)


def whisper_full_parallel(ctx, params, samples, n_samples=None,
                          n_processors: int = 1) -> int:
    pcm = np.asarray(samples, np.float32)
    if n_samples is not None:
        pcm = pcm[:n_samples]
    return ctx.full_parallel(params, pcm, n_processors)


def whisper_full_n_segments(ctx) -> int: return ctx.full_n_segments()
def whisper_full_n_segments_from_state(state) -> int: return state.full_n_segments()
def whisper_full_lang_id(ctx) -> int: return ctx.full_lang_id()
def whisper_full_lang_id_from_state(state) -> int: return state.full_lang_id()
def whisper_full_get_segment_t0(ctx, i) -> int: return ctx.full_get_segment_t0(i)
def whisper_full_get_segment_t0_from_state(s, i) -> int: return s.full_get_segment_t0(i)
def whisper_full_get_segment_t1(ctx, i) -> int: return ctx.full_get_segment_t1(i)
def whisper_full_get_segment_t1_from_state(s, i) -> int: return s.full_get_segment_t1(i)
def whisper_full_get_segment_speaker_turn_next(ctx, i) -> bool:
    return ctx.full_get_segment_speaker_turn_next(i)
def whisper_full_get_segment_speaker_turn_next_from_state(s, i) -> bool:
    return s.full_get_segment_speaker_turn_next(i)
def whisper_full_get_segment_text(ctx, i) -> str: return ctx.full_get_segment_text(i)
def whisper_full_get_segment_text_from_state(s, i) -> str: return s.full_get_segment_text(i)
def whisper_full_n_tokens(ctx, i) -> int: return ctx.full_n_tokens(i)
def whisper_full_n_tokens_from_state(s, i) -> int: return s.full_n_tokens(i)
def whisper_full_get_token_text(ctx, i, j) -> str: return ctx.full_get_token_text(i, j)
def whisper_full_get_token_text_from_state(c, s, i, j) -> str:
    return c.token_to_str(s.full_get_token_id(i, j))
def whisper_full_get_token_id(ctx, i, j) -> int: return ctx.full_get_token_id(i, j)
def whisper_full_get_token_id_from_state(s, i, j) -> int:
    return s.full_get_token_id(i, j)
def whisper_full_get_token_data(ctx, i, j): return ctx.full_get_token_data(i, j)
def whisper_full_get_token_data_from_state(s, i, j):
    return s.full_get_token_data(i, j)
def whisper_full_get_token_p(ctx, i, j) -> float: return ctx.full_get_token_p(i, j)
def whisper_full_get_token_p_from_state(s, i, j) -> float:
    return s.full_get_token_p(i, j)
def whisper_full_get_segment_no_speech_prob(ctx, i) -> float:
    return ctx.full_get_segment_no_speech_prob(i)
def whisper_full_get_segment_no_speech_prob_from_state(s, i) -> float:
    return s.full_get_segment_no_speech_prob(i)


# ---- bench (reference: whisper.h:659-666) ---------------------------------

def whisper_bench_memcpy(n_threads: int = 1) -> int:
    print(whisper_bench_memcpy_str(n_threads), file=sys.stderr)
    return 0


def whisper_bench_memcpy_str(n_threads: int = 1) -> str:
    size = 1 << 28  # 256 MiB
    src = np.ones(size // 8, np.float64)
    t0 = time.perf_counter()
    n = 8
    for _ in range(n):
        dst = src.copy()
    dt = time.perf_counter() - t0
    del dst
    gbps = (2 * n * size / 1e9) / dt
    return f"memcpy: {gbps:7.2f} GB/s (heat-up + copy, host)"


def whisper_bench_ggml_mul_mat(n_threads: int = 1) -> int:
    print(whisper_bench_ggml_mul_mat_str(n_threads), file=sys.stderr)
    return 0


def whisper_bench_ggml_mul_mat_str(n_threads: int = 1) -> str:
    # on the device of a default params' context
    return mul_mat_lines(context_device(whisper_context_params()))


def mul_mat_lines(device) -> str:
    """whisper_bench_ggml_mul_mat's table on `device`: torch.matmul of two
    n x n matrices of ones in F32 and BF16 at each MUL_MAT_SIZES, repeated
    512 // max(n // 256, 1) times, the clock fenced by a synchronize."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    for n in MUL_MAT_SIZES:
        for dtype, name in ((torch.float32, "F32"), (torch.bfloat16, "BF16")):
            a = torch.ones((n, n), dtype=dtype, device=dev)
            b = torch.ones((n, n), dtype=dtype, device=dev)
            torch.matmul(a, b)
            sync()
            reps = max(1, 512 // max(n // 256, 1))
            t0 = time.perf_counter()
            for _ in range(reps):
                torch.matmul(a, b)
            sync()
            dt = time.perf_counter() - t0
            gflops = 2.0 * n * n * n * reps / dt / 1e9
            out.append(f"  {n:4d} x {n:4d}: {name}  {gflops:10.1f} GFLOPS")
    return "\n".join(out)


def whisper_grammar_from_c_rules(rules, i_start_rule: int):
    """C ABI grammar entry point (native/wtpu_capi.cpp params_to_py).

    `rules` is the whisper_full_params.grammar_rules array marshalled as
    nested [(type, value)] lists, each rule END-terminated exactly as in
    the C struct (reference: include/whisper.h:117-146, 546-551).
    Returns a grammar engine (native C++ when built, else Python) ready
    for FullParams.grammar_rules.
    """
    from .grammar import Element, Grammar, NativeGrammar

    el_rules = [[Element(int(t), int(v)) for t, v in rule]
                for rule in rules]
    if os.environ.get("WTPU_NO_NATIVE") != "1":
        try:
            return NativeGrammar(el_rules, int(i_start_rule))
        except RuntimeError:
            pass
    return Grammar(el_rules, int(i_start_rule))


# ---- the C ABI library ----------------------------------------------------

def _python_link() -> tuple[list[str], list[str]]:
    """(compile flags, link libraries) that embed the running interpreter:
    python3-config --includes and --ldflags --embed, from sysconfig."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise OSError(f"{sys.executable} has no shared libpython: the C ABI "
                      "library embeds the interpreter through it")
    paths = sysconfig.get_paths()
    includes = sorted({"-I" + paths["include"], "-I" + paths["platinclude"]})
    var = sysconfig.get_config_var
    libs = ["-L" + var("LIBDIR"),
            f"-lpython{var('VERSION')}{getattr(sys, 'abiflags', '')}",
            *(var("LIBS") or "").split(), *(var("SYSLIBS") or "").split()]
    return includes, libs


def library_path() -> Path:
    """Build (once per source, header and flag hash) the whisper.h C ABI
    library over this module and return build/whisper_tpu_torch/capi/
    libwhisper_tpu.so, a link to the hashed build: `cc ... -L<its dir>
    -lwhisper_tpu` links against it and LD_LIBRARY_PATH=<its dir> finds it
    at run time.  A failed build raises (OSError or SubprocessError): a C
    caller has no Python path to fall back on."""
    includes, libs = _python_link()
    flags = ["-O3", "-fPIC", "-std=c++17", "-Wall",
             "-I" + str(HEADER.parent), *includes]
    built = native_build.build("wtt_capi", BUILD_DIR, [(SOURCE, flags)],
                               ["-shared", "-pthread"], [HEADER],
                               libs=["-ldl", *libs])
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    link = LIB_DIR / "libwhisper_tpu.so"
    target = os.path.relpath(built, LIB_DIR)
    if not (link.is_symlink() and os.readlink(link) == target):
        tmp = LIB_DIR / f".libwhisper_tpu.so.{os.getpid()}"
        tmp.unlink(missing_ok=True)
        os.symlink(target, tmp)
        os.replace(tmp, link)
    return link
