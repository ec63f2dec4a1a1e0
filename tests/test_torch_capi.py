"""whisper_tpu_torch.capi (the whisper.h surface) against whisper_tpu.capi
on the CPU at micro dims: the same names and signatures, introspection,
tokenize and language functions equal, whisper_full's segments and tokens
equal over a q5_0 file in float32, whisper_encode / whisper_decode logits
within 2e-3 of their scale (the packed-weight tolerance of
tests/test_torch_quant.py), and each session state's own cross-KV, self-KV
and logits.  whisper_tpu runs as in tests/test_torch_full.py: its Pallas
kernels in interpret mode, its jits without excess precision."""

import dataclasses
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import whisper_tpu.capi as jcapi  # noqa: E402
from test_torch_full import (_assert_same_segments, jax_context,  # noqa: E402,F401
                             jax_strict)
from test_torch_ggml import write_model  # noqa: E402
from test_torch_grammar import write_grammar_model  # noqa: E402
from whisper_tpu_torch import WhisperContext  # noqa: E402
from whisper_tpu_torch import capi as tcapi  # noqa: E402

# whisper_decode's logits: max |port - whisper_tpu| over max |whisper_tpu|
LOGITS_TOL = 2e-3


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("capi") / "q5_0.bin", "q5_0")


@pytest.fixture(scope="module")
def pieces_model(tmp_path_factory):
    """The q5_0 file with words in its vocab (" red", "green", " and ",
    ...): the synthetic " t<i>" tokens alone tokenize to nothing."""
    return write_grammar_model(
        tmp_path_factory.mktemp("capi") / "pieces.bin", "q5_0")


@pytest.fixture
def cpu_params():
    p = tcapi.whisper_context_default_params()
    p.use_gpu = False
    return p


@pytest.fixture
def f32_port(monkeypatch):
    """The port's contexts load at float32, as whisper_tpu's of
    jax_context."""
    orig = WhisperContext.__dict__["from_file"]
    monkeypatch.setattr(WhisperContext, "from_file", classmethod(
        lambda c, path, _f=orig.__func__, **kw:
        _f(c, path, compute_dtype=torch.float32, **kw)))


def _greedy(capi):
    p = capi.whisper_full_default_params(capi.WHISPER_SAMPLING_GREEDY)
    p.print_progress = False
    p.temperature_inc = 0.0
    return p


def _pcm(seconds, seed):
    return (np.random.RandomState(seed).randn(16000 * seconds) * 0.1).astype(
        np.float32)


def test_every_public_name_with_its_signature():
    names = [n for n in dir(jcapi) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(tcapi, n)]
    assert not missing, missing
    for n in (n for n in names if n.startswith(("whisper_", "WHISPER_"))):
        want = getattr(jcapi, n)
        if inspect.isfunction(want):
            assert (inspect.signature(getattr(tcapi, n))
                    == inspect.signature(want)), n
        elif isinstance(want, (int, str)):
            assert getattr(tcapi, n) == want, n
    assert ([(f.name, f.default)
             for f in dataclasses.fields(tcapi.whisper_context_params)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jcapi.whisper_context_params)])


def test_introspection_tokenize_and_language(pieces_model, cpu_params):
    j = jcapi.whisper_init_from_file_with_params(
        pieces_model, jcapi.whisper_context_default_params())
    t = tcapi.whisper_init_from_file_with_params(pieces_model, cpu_params)
    assert t.device.type == "cpu"
    for name in dir(jcapi):
        fn = getattr(jcapi, name)
        if (name.startswith(("whisper_model_", "whisper_token_"))
                and name not in ("whisper_token_to_str",
                                 "whisper_token_lang",
                                 "whisper_token_count")) or name in (
                "whisper_n_vocab", "whisper_n_text_ctx",
                "whisper_n_audio_ctx", "whisper_is_multilingual"):
            assert getattr(tcapi, name)(t) == fn(j), name
    for tid in (0, 1, 220, 1000, 50256, t.token_eot(), t.token_beg() + 3):
        assert (tcapi.whisper_token_to_str(t, tid)
                == jcapi.whisper_token_to_str(j, tid))
    for lid in range(jcapi.whisper_lang_max_id() + 1):
        assert tcapi.whisper_token_lang(t, lid) == \
            jcapi.whisper_token_lang(j, lid)
        assert tcapi.whisper_lang_str(lid) == jcapi.whisper_lang_str(lid)
        assert tcapi.whisper_lang_str_full(lid) == \
            jcapi.whisper_lang_str_full(lid)
        code = jcapi.whisper_lang_str(lid)
        assert tcapi.whisper_lang_id(code) == jcapi.whisper_lang_id(code)
    assert tcapi.whisper_lang_max_id() == jcapi.whisper_lang_max_id()
    counts = []
    for text in (" red green and blue", " yellow and red", "", "blue and "):
        tb, jb = [0] * 8, [0] * 8
        n = tcapi.whisper_tokenize(t, text, tb, 8)
        assert n == jcapi.whisper_tokenize(j, text, jb, 8)
        assert tb == jb
        assert tcapi.whisper_token_count(t, text) == \
            jcapi.whisper_token_count(j, text) == n
        counts.append(n)
    assert counts[0] > 2
    # too small a buffer: minus the count needed
    assert tcapi.whisper_tokenize(t, " red green and blue", [0], 1) == \
        jcapi.whisper_tokenize(j, " red green and blue", [0], 1) == \
        -counts[0]


def test_full_and_accessors_equal(model, jax_strict, f32_port, cpu_params):
    """whisper_full, whisper_full_with_state and whisper_full_parallel
    (one processor) over the q5_0 file in float32: every accessor equal to
    whisper_tpu's, probabilities within 1e-4."""
    pcm = _pcm(8, 0)
    j = jax_context(model, "einsum")
    assert jcapi.whisper_full(j, _greedy(jcapi), pcm, len(pcm)) == 0
    t = tcapi.whisper_init_from_file_with_params(model, cpu_params)
    assert t.compute_dtype == torch.float32 and t.device.type == "cpu"
    assert tcapi.whisper_full(t, _greedy(tcapi), pcm, len(pcm)) == 0
    _assert_same_segments(t.result_all, j.result_all)

    n = jcapi.whisper_full_n_segments(j)
    assert tcapi.whisper_full_n_segments(t) == n > 0
    assert tcapi.whisper_full_lang_id(t) == jcapi.whisper_full_lang_id(j)
    for i in range(n):
        for acc in ("t0", "t1", "text", "speaker_turn_next"):
            name = f"whisper_full_get_segment_{acc}"
            assert getattr(tcapi, name)(t, i) == getattr(jcapi, name)(j, i)
        np.testing.assert_allclose(
            tcapi.whisper_full_get_segment_no_speech_prob(t, i),
            jcapi.whisper_full_get_segment_no_speech_prob(j, i), rtol=1e-4)
        assert tcapi.whisper_full_n_tokens(t, i) == \
            jcapi.whisper_full_n_tokens(j, i)
        for k in range(jcapi.whisper_full_n_tokens(j, i)):
            assert tcapi.whisper_full_get_token_id(t, i, k) == \
                jcapi.whisper_full_get_token_id(j, i, k)
            assert tcapi.whisper_full_get_token_text(t, i, k) == \
                jcapi.whisper_full_get_token_text(j, i, k)
            np.testing.assert_allclose(
                tcapi.whisper_full_get_token_p(t, i, k),
                jcapi.whisper_full_get_token_p(j, i, k), rtol=1e-4,
                atol=1e-6)
            td = tcapi.whisper_full_get_token_data(t, i, k)
            jd = jcapi.whisper_full_get_token_data(j, i, k)
            assert (td.id, td.tid, td.t0, td.t1) == (jd.id, jd.tid, jd.t0,
                                                     jd.t1)
    want = [(s.t0, s.t1, s.text) for s in t.result_all]

    # a state of its own, and the parallel entry with one processor
    st = tcapi.whisper_init_state(t)
    assert tcapi.whisper_full_with_state(t, st, _greedy(tcapi), pcm) == 0
    assert [(tcapi.whisper_full_get_segment_t0_from_state(st, i),
             tcapi.whisper_full_get_segment_t1_from_state(st, i),
             tcapi.whisper_full_get_segment_text_from_state(st, i))
            for i in range(tcapi.whisper_full_n_segments_from_state(st))] \
        == want
    assert tcapi.whisper_full_parallel(t, _greedy(tcapi), pcm, len(pcm),
                                       1) == 0
    assert [(s.t0, s.t1, s.text) for s in t.result_all] == want
    assert tcapi.whisper_get_timings(t)["encode_ms"] >= 0


def _decode_rows(capi, ctx, pcm, prompt, steps):
    """mel, encode, the prompt pass, then one single-token decode a step:
    every logits row, stacked."""
    assert capi.whisper_pcm_to_mel(ctx, pcm, len(pcm)) == 0
    assert capi.whisper_encode(ctx, 0) == 0
    assert capi.whisper_decode(ctx, prompt, len(prompt), 0) == 0
    rows = [capi.whisper_get_logits(ctx)]
    for i, tok in enumerate(steps):
        assert capi.whisper_decode(ctx, [tok], 1, len(prompt) + i) == 0
        rows.append(capi.whisper_get_logits(ctx))
    return np.concatenate(rows)


def test_encode_decode_logits(model, jax_strict, f32_port, cpu_params):
    """A 4-token prompt and 3 single-token steps: each row within
    LOGITS_TOL of whisper_tpu's; a prompt of n tokens ends on the row of
    n - 1 tokens and one step (teacher forcing)."""
    pcm = _pcm(3, 1)
    j = jax_context(model, "einsum")
    t = tcapi.whisper_init_from_file_with_params(model, cpu_params)
    sot = t.token_sot()
    prompt = [sot, t.token_lang(0), t.token_transcribe(), t.token_beg()]
    steps = [440, 1234, 77]
    want = _decode_rows(jcapi, j, pcm, prompt, steps)
    got = _decode_rows(tcapi, t, pcm, prompt, steps)
    assert got.shape == want.shape == (len(prompt) + len(steps),
                                       t.n_vocab())
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= LOGITS_TOL, rel

    # teacher forcing: the prompt and steps at once give the rows of the
    # steps.  Within LOGITS_TOL, not exactly: K3 rounds its float32 x to
    # bf16, and x of the prompt pass and of a step differ in the last f32
    # bits (another summation order), which flips a rounding now and then
    full = prompt + steps
    assert tcapi.whisper_decode(t, full, len(full), 0) == 0
    forced = tcapi.whisper_get_logits(t)
    assert forced.shape == (len(full), t.n_vocab())
    rel = (np.abs(forced[len(prompt) - 1:] - got[len(prompt) - 1:]).max()
           / np.abs(got).max())
    assert rel <= LOGITS_TOL, rel

    # a step before any prompt pass, or a decode before encode, is refused
    fresh = tcapi.whisper_init_state(t)
    assert tcapi.whisper_decode_with_state(t, fresh, [sot], 1, 0) == -1
    assert tcapi.whisper_set_mel_with_state(
        t, fresh, np.zeros(80 * 100, np.float32), 100, 80) == 0
    assert tcapi.whisper_encode_with_state(t, fresh, 0) == 0
    assert tcapi.whisper_decode_with_state(t, fresh, [sot], 1, 3) == -2
    assert tcapi.whisper_get_logits_from_state(fresh).shape == (0, 0)


def test_states_keep_their_own_encode_and_logits(model, cpu_params):
    """Window A encoded on state 1 and window B on state 2, then the same
    prompt decoded on each: each state's logits are those it gives alone
    (the cross-KV, self-KV and logits live on the state, not the
    context)."""
    t = tcapi.whisper_init_from_file_with_params(model, cpu_params)
    pcm_a, pcm_b = _pcm(3, 2), _pcm(3, 3) * 3.0
    prompt = [t.token_sot(), t.token_lang(0), t.token_transcribe()]

    def alone(pcm):
        st = tcapi.whisper_init_state(t)
        assert tcapi.whisper_pcm_to_mel_with_state(t, st, pcm, len(pcm)) == 0
        assert tcapi.whisper_encode_with_state(t, st, 0) == 0
        assert tcapi.whisper_decode_with_state(t, st, prompt, 3, 0) == 0
        assert tcapi.whisper_decode_with_state(t, st, [500], 1, 3) == 0
        return tcapi.whisper_get_logits_from_state(st)

    want_a, want_b = alone(pcm_a), alone(pcm_b)
    assert np.abs(want_a - want_b).max() > 1e-3 * np.abs(want_a).max()

    s1, s2 = tcapi.whisper_init_state(t), tcapi.whisper_init_state(t)
    for st, pcm in ((s1, pcm_a), (s2, pcm_b)):
        assert tcapi.whisper_pcm_to_mel_with_state(t, st, pcm, len(pcm)) == 0
        assert tcapi.whisper_encode_with_state(t, st, 0) == 0
    for st in (s1, s2):
        assert tcapi.whisper_decode_with_state(t, st, prompt, 3, 0) == 0
    for st in (s1, s2):
        assert tcapi.whisper_decode_with_state(t, st, [500], 1, 3) == 0
    for st, want in ((s1, want_a), (s2, want_b)):
        got = tcapi.whisper_get_logits_from_state(st)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # the context's default state saw none of it
    assert tcapi.whisper_get_logits(t).shape == (0, t.n_vocab())
    assert t._default_state._encoded is None


def test_set_mel_validation(model, cpu_params):
    t = tcapi.whisper_init_from_file_with_params(model, cpu_params)
    j = jcapi.whisper_init_from_file_with_params(
        model, jcapi.whisper_context_default_params())
    bad = np.zeros((10, 10), np.float32)
    good = np.zeros((100, 80), np.float32)
    for capi, ctx in ((tcapi, t), (jcapi, j)):
        assert capi.whisper_set_mel(ctx, bad.T.ravel(), 10, 10) == -1
        assert capi.whisper_set_mel(ctx, good.T.ravel(), 100, 80) == 0
        assert capi.whisper_n_len(ctx) == 100
    np.testing.assert_array_equal(t.mel, j.mel)


def test_no_state_and_loader_init(model, cpu_params):
    c = tcapi.whisper_init_from_file_with_params_no_state(model, cpu_params)
    assert c._cur_state is None and c.device.type == "cpu"
    state = tcapi.whisper_init_state(c)
    mel = np.zeros(80 * 100, np.float32)
    assert tcapi.whisper_set_mel_with_state(c, state, mel, 100, 80) == 0
    assert tcapi.whisper_n_len_from_state(state) == 100

    data = open(model, "rb").read()

    class Loader:
        pos = 0

        def read(self, n):
            out = data[self.pos:self.pos + n]
            self.pos += len(out)
            return out

        def eof(self):
            return self.pos >= len(data)

        def close(self):
            pass

    c = tcapi.whisper_init_with_params(Loader(), cpu_params)
    assert tcapi.whisper_n_vocab(c) == c.hparams.n_vocab
    assert c.device.type == "cpu"
    b = tcapi.whisper_init_from_buffer_with_params_no_state(data, cpu_params)
    assert b._cur_state is None


def test_the_device_follows_the_params(model, monkeypatch):
    """use_gpu=False -> the CPU; else WHISPER_TPU_TORCH_DEVICE, else
    cuda:<gpu_device>; a CUDA device without a card raises (no
    fallback)."""
    monkeypatch.delenv(tcapi.DEVICE_ENV, raising=False)
    p = tcapi.whisper_context_default_params()
    assert p.use_gpu and tcapi.context_device(p) == "cuda:0"
    p.gpu_device = 1
    assert tcapi.context_device(p) == "cuda:1"
    p.use_gpu = False
    assert tcapi.context_device(p) == "cpu"
    if not torch.cuda.is_available():
        for call in (lambda: tcapi.whisper_init_from_file(model),
                     lambda: tcapi.whisper_init_from_buffer(
                         open(model, "rb").read()),
                     lambda: tcapi.whisper_bench_ggml_mul_mat_str(1)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")
    assert tcapi.whisper_init_from_file(model).device.type == "cpu"
    p.use_gpu = True
    assert tcapi.context_device(p) == "cpu"


def test_grammar_from_c_rules_and_bench_strings(monkeypatch):
    """The C ABI's grammar marshalling gives whisper_tpu's rules, on the
    native engine and with WTPU_NO_NATIVE=1 on the Python one; the bench
    strings keep whisper_tpu's formats."""
    from whisper_tpu_torch.grammar import Grammar

    # c_abi_ext.c's in-struct grammar: root ::= [a-z ]*
    rules = [[(3, 1), (0, 0)],
             [(4, 97), (5, 122), (6, 32), (3, 1), (1, 0), (0, 0)]]
    for native in ("0", "1"):
        monkeypatch.setenv("WTPU_NO_NATIVE", native)
        tg = tcapi.whisper_grammar_from_c_rules(rules, 0)
        jg = jcapi.whisper_grammar_from_c_rules(rules, 0)
        assert isinstance(tg, Grammar) == (native == "1")
        assert ([[(e.type, e.value) for e in r] for r in tg.rules]
                == [[(e.type, e.value) for e in r] for r in jg.rules])
    line = tcapi.whisper_bench_memcpy_str(1)
    assert line.startswith("memcpy: ") and line.endswith(
        " GB/s (heat-up + copy, host)")
    monkeypatch.setattr(tcapi, "MUL_MAT_SIZES", (64,))
    assert tcapi.mul_mat_lines("cpu").splitlines()[1].startswith(
        "    64 x   64: BF16 ")
