"""The slice as a whole: whisper_tpu_torch's `from_file` + `full` emits the
same segments as whisper_tpu's on the same block-quantized ggml file
(micro dims, float32, greedy at t = 0, timestamps on), through each
cross mode: "pallas_q8" (K5), "pallas" (K4) and "einsum", with the decoder
weights packed (K3); and the batched serving path over a file.

whisper_tpu runs its Pallas kernels in interpret mode, with its decoder
kept packed (its own CPU gate would densify it), its numpy log-mel, and
its jitted functions compiled without excess precision, so that each
bf16 rounding its kernels state is made (see tests/test_torch_quant.py).
"""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from test_torch_ggml import MICRO, write_model  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu.models import whisper as jwm  # noqa: E402
from whisper_tpu.ops import cross_attention as _jxa  # noqa: E402,F401
from whisper_tpu.ops import quantized as _jq  # noqa: E402,F401
from whisper_tpu.weights import convert as jconvert  # noqa: E402
from whisper_tpu.weights.ggml_reader import read_ggml_file as jread  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.grammar import grammar_from_gbnf  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as txa  # noqa: E402
from whisper_tpu_torch.ops import quantized as tq  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

COLORS = open(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "grammars", "colors.gbnf")).read()

STRICT = {"xla_allow_excess_precision": False}

# name -> (file type, cross mode, FullParams overrides)
CASES = {
    "q5_0-pallas_q8": ("q5_0", "pallas_q8", {}),
    "q5_1-pallas": ("q5_1", "pallas", {"initial_prompt": " t5 t6 t7"}),
    "q8_0-einsum": ("q8_0", "einsum", {"offset_ms": 500,
                                       "duration_ms": 20000}),
    "q4_1-auto-language": ("q4_1", "einsum", {"language": "auto",
                                              "duration_ms": 30000}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("full")
    kinds = {kind for kind, _, _ in CASES.values()}
    return {kind: write_model(d / f"{kind}.bin", kind) for kind in kinds}


@pytest.fixture(scope="module")
def pcm():
    return (np.random.RandomState(0).randn(16000 * 35) * 0.1).astype(
        np.float32)


@pytest.fixture
def jax_strict(monkeypatch):
    """whisper_tpu as its Pallas tests run it, with every top-level jit
    compiled without excess precision (module docstring).  The modules
    whose functions are jitted at import time are imported above, before
    the patch: only a top-level jit may carry compiler options."""
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")
    orig = jax.jit

    def strict_jit(fun=None, **kw):
        kw.setdefault("compiler_options", STRICT)
        return orig(fun, **kw) if fun is not None else functools.partial(
            orig, **kw)

    monkeypatch.setattr(jax, "jit", strict_jit)

    # language detection calls decode_prompt outside any jit: its layer
    # scan would compile with the default options
    orig_dp = jwm.decode_prompt
    strict_dp = orig(orig_dp, static_argnames=("n_head", "compute_dtype"),
                     compiler_options=STRICT)

    def decode_prompt(*args, **kw):
        if any(isinstance(a, jax.core.Tracer)
               for a in jax.tree_util.tree_leaves((args, kw))):
            return orig_dp(*args, **kw)
        return strict_dp(*args, **kw)

    monkeypatch.setattr(jwm, "decode_prompt", decode_prompt)
    with pltpu.force_tpu_interpret_mode():
        yield


def jax_context(path, cross_mode):
    ctx = JaxContext.from_file(path, compute_dtype=jnp.float32,
                               cross_mode=cross_mode)
    ctx.params, _ = jconvert.params_from_ggml(
        jread(path), dtype=jnp.float32, keep_quantized=True)
    return ctx


def _params(factory, overrides):
    p = factory()
    p.print_progress = False
    p.temperature_inc = 0.0
    for k, v in overrides.items():
        setattr(p, k, v)
    return p


def _segments(segs):
    return [(s.t0, s.t1, s.text, tuple(t.id for t in s.tokens))
            for s in segs]


def _assert_same_segments(got, want):
    assert want, "the reference emitted no segments"
    assert _segments(got) == _segments(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose([t.p for t in b.tokens],
                                   [t.p for t in a.tokens], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(b.no_speech_prob, a.no_speech_prob,
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_full_segments_identical(files, pcm, jax_strict, case):
    kind, cross_mode, overrides = CASES[case]
    jctx = jax_context(files[kind], cross_mode)
    jp = _params(jax_params, overrides)
    assert jctx.full(jp, pcm) == 0

    tctx = WhisperContext.from_file(files[kind], compute_dtype=torch.float32,
                                    cross_mode=cross_mode, device="cpu")
    packed = tctx.params["decoder"]["blocks"]["mlp0_w"]
    assert isinstance(packed, dict) and packed["q"].dtype == torch.int8
    n = (tq.quantized_matmul.launches, txa.cross_attention_decode.launches,
         txa.cross_attention_decode_q8.launches)
    p = _params(full_default_params, overrides)
    assert tctx.full(p, pcm) == 0
    # on the CPU the wrappers run their plain versions and launch nothing
    assert n == (tq.quantized_matmul.launches,
                 txa.cross_attention_decode.launches,
                 txa.cross_attention_decode_q8.launches)

    _assert_same_segments(tctx.result_all, jctx.result_all)
    assert tctx.full_lang_id() == jctx.full_lang_id()
    assert tctx.timings.n_encode == jctx.timings.n_encode <= 2
    assert sum(len(s.tokens) for s in jctx.result_all) >= 10
    assert p.language == jp.language     # "auto" is resolved on both


def test_detect_language_only(files, pcm, jax_strict):
    """detect_language stops after detection, with the same language."""
    path = files["q4_1"]
    jp = _params(jax_params, {"detect_language": True})
    tp = _params(full_default_params, {"detect_language": True})
    jctx = jax_context(path, "einsum")
    tctx = WhisperContext.from_file(path, compute_dtype=torch.float32,
                                    device="cpu")
    assert jctx.full(jp, pcm) == 0 and tctx.full(tp, pcm) == 0
    assert tctx.full_lang_id() == jctx.full_lang_id()
    assert tp.language == jp.language
    assert tctx.full_n_segments() == 0 == jctx.full_n_segments()
    jlid, jprobs = jctx.lang_auto_detect()
    tlid, tprobs = tctx.lang_auto_detect()
    assert tlid == jlid
    np.testing.assert_allclose(tprobs, jprobs, rtol=1e-4, atol=1e-6)


def test_batch_transcriber_over_file(files, jax_strict):
    """The batched serving path (einsum_q8, device mel) over a q8_0 file
    with the packed decoder: segments identical to whisper_tpu's."""
    path = files["q8_0"]
    jctx = jax_context(path, "einsum_q8")
    tctx = WhisperContext.from_file(path, compute_dtype=torch.float32,
                                    cross_mode="einsum_q8", device="cpu")
    rng = np.random.RandomState(3)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (20, 33)]
    over = {"language": "en"}
    jres = JaxBatch(jctx, batch_size=2, params=_params(jax_params, over),
                    device_mel=True).transcribe(streams)
    tres = BatchTranscriber(tctx, batch_size=2,
                            params=_params(full_default_params, over),
                            device_mel=True).transcribe(streams)
    for want, got in zip(jres, tres):
        _assert_same_segments(got, want)
        assert sum(len(s.tokens) for s in want) >= 10


@pytest.mark.parametrize("field,value", [
    ("grammar_rules", []),
    ("logits_filter_callback", lambda *a: None),
    ("token_timestamps", True),
    ("suppress_regex", "t1.*"),
])
def test_full_refuses_unported_options(files, pcm, field, value):
    """full() refuses none of these now: a grammar (the [] stands for
    grammars/colors.gbnf) and a logits-filter callback decode on the host
    loop (held against whisper_tpu in tests/test_torch_grammar.py), token
    timestamps and suppress_regex in the window loop
    (tests/test_torch_timestamps.py, test_torch_regex.py)."""
    tctx = WhisperContext.from_file(files["q8_0"], device="cpu",
                                    compute_dtype=torch.float32)
    if field == "grammar_rules":
        value = grammar_from_gbnf(COLORS)
    p = _params(full_default_params, {field: value, "duration_ms": 3000})
    calls = []
    p.progress_callback = lambda *a: calls.append(a)
    assert tctx.full(p, pcm) == 0
    assert calls and tctx.mel is not None


def test_full_refuses_einsum_q8(files, pcm):
    """With cross mode einsum_q8, full() refuses neither the mode nor a
    grammar: the grammar's host loop reads the window's dense cross-KV,
    as whisper_tpu's does (tests/test_torch_cross_modes.py holds the
    mode's segments)."""
    tctx = WhisperContext.from_file(files["q8_0"], device="cpu",
                                    compute_dtype=torch.float32,
                                    cross_mode="einsum_q8")
    p = _params(full_default_params, {"grammar_rules": grammar_from_gbnf(
        COLORS), "duration_ms": 3000})
    assert tctx.full(p, pcm) == 0
    assert tctx.timings.n_grammar > 0 and tctx.mel is not None


def test_unported_context_options_refused(files):
    """DTW token timestamps are taken (tests/test_torch_dtw.py holds them);
    a cross mode outside the seven is rejected; each of the seven builds
    a context, and BatchTranscriber takes each."""
    from whisper_tpu_torch.decode.loop import CROSS_MODES
    ctx = WhisperContext.from_file(files["q8_0"], device="cpu",
                                   dtw_token_timestamps=True,
                                   dtw_aheads_preset="n_top_most",
                                   dtw_n_top=1)
    assert ctx.dtw_token_timestamps and ctx.dtw_n_top == 1
    with pytest.raises(ValueError, match="cross_mode"):
        WhisperContext.from_file(files["q8_0"], device="cpu",
                                 cross_mode="pallas_q4")
    assert len(CROSS_MODES) == 7
    for mode in CROSS_MODES:
        tctx = WhisperContext.from_file(files["q8_0"], device="cpu",
                                        cross_mode=mode)
        BatchTranscriber(tctx, batch_size=2, device_mel=True,
                         params=_params(full_default_params, {}))
