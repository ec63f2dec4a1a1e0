"""Energy token timestamps and `wrap_segment` in whisper_tpu_torch against
whisper_tpu: the helpers of timestamps.py, then `full` and
BatchTranscriber with token_timestamps on (and max_len > 0) over the same
f32 ggml file, TokenData t0 / t1 / vlen equal (tests/test_apps.py's
token-timestamp cases, held against the reference package)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
from whisper_tpu import timestamps as jts  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch import timestamps as tts  # noqa: E402
from whisper_tpu_torch.api import Segment, TokenData, WhisperState  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

# name -> FullParams overrides (token_timestamps is on in every case)
CASES = {
    "no_wrap": {},
    "max_len_12": {"max_len": 12},
    "max_len_8_split_on_word": {"max_len": 8, "split_on_word": True},
}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("ts") / "f32.bin", "f32")


@pytest.fixture(scope="module")
def contexts(path):
    return (JaxContext.from_file(path, compute_dtype=jnp.float32),
            WhisperContext.from_file(path, compute_dtype=torch.float32,
                                     device="cpu"))


@pytest.fixture(autouse=True)
def numpy_mel(monkeypatch):
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.RandomState(5)
    x = rng.randn(16000 * 33).astype(np.float32) * 0.1
    x[16000 * 4:16000 * 9] *= 0.05         # a quiet stretch for the VAD
    return x


def _params(factory, over):
    p = factory()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.token_timestamps = True
    for k, v in over.items():
        setattr(p, k, v)
    return p


def _tokens(segs):
    return [[(t.id, t.t0, t.t1, t.vlen) for t in s.tokens] for s in segs]


def _assert_same(got, want):
    assert [(s.t0, s.t1, s.text) for s in got] == \
        [(s.t0, s.t1, s.text) for s in want]
    assert _tokens(got) == _tokens(want)
    assert any(t.t0 >= 0 for s in got for t in s.tokens)


def test_helpers_match_whisper_tpu():
    rng = np.random.RandomState(0)
    for sig in (rng.randn(5000).astype(np.float32),
                (rng.randn(3000) * 9000).astype(np.int16),
                np.zeros(7, np.float32)):
        np.testing.assert_array_equal(tts.get_signal_energy(sig, 32),
                                      jts.get_signal_energy(sig, 32))
    for t, n in ((0, 100), (150, 16000 * 3), (10**6, 5000)):
        assert tts.timestamp_to_sample(t, n) == jts.timestamp_to_sample(t, n)
    for i in (0, 159, 16000 * 7 + 3):
        assert tts.sample_to_timestamp(i) == jts.sample_to_timestamp(i)
    for text in (" the", "3.14, ok!", "é?", ""):
        assert tts.voice_length(text) == jts.voice_length(text)


@pytest.mark.parametrize("case", list(CASES))
def test_full_token_timestamps_match_whisper_tpu(contexts, pcm, case):
    jctx, tctx = contexts
    assert jctx.full(_params(jax_params, CASES[case]), pcm) == 0
    calls = []
    p = _params(full_default_params, CASES[case])
    p.new_segment_callback = lambda ctx, n: calls.append(n)
    assert tctx.full(p, pcm) == 0
    _assert_same(tctx.result_all, jctx.result_all)
    # the callback hears of every segment, wrapped ones included
    assert sum(calls) == tctx.full_n_segments()
    for s in tctx.result_all:
        for t in s.tokens:
            assert t.t0 <= t.t1


@pytest.mark.parametrize("device_mel", [False, True], ids=["host", "device"])
def test_batch_token_timestamps_match_whisper_tpu(contexts, pcm, device_mel):
    jctx, tctx = contexts
    streams = [pcm, pcm[:16000 * 6]]
    if device_mel:
        streams = [(x * 32768).clip(-32768, 32767).astype(np.int16)
                   for x in streams]
    over = {"max_len": 12}
    want = JaxBatch(jctx, batch_size=2, device_mel=device_mel,
                    params=_params(jax_params, over)).transcribe(streams)
    bt = BatchTranscriber(tctx, batch_size=2, device_mel=device_mel,
                          params=_params(full_default_params, over))
    got = bt.transcribe(streams)
    for g, w in zip(got, want):
        _assert_same(g, w)
    # the energy is each stream's own, int16 taken over 32768 first
    np.testing.assert_array_equal(
        bt.last_states[1].energy,
        jts.get_signal_energy(np.asarray(streams[1], np.float32)
                              / (32768.0 if device_mel else 1.0), 32))


def test_full_wraps_to_max_len(contexts, pcm):
    """Every wrapped segment but its last token fits max_len bytes."""
    _, tctx = contexts
    assert tctx.full(_params(full_default_params, {"max_len": 12}),
                     pcm) == 0
    eot = tctx.vocab.token_eot
    for s in tctx.result_all:
        words = [tctx.vocab.token_str(t.id) for t in s.tokens if t.id < eot]
        assert s.text == "".join(words)
        assert len("".join(words[:-1]).encode()) <= 12


def test_wrap_segment_preserves_tokens(contexts):
    """A forced multi-way wrap keeps every token and the whole text; the
    trailing segment keeps speaker_turn_next."""
    _, tctx = contexts
    words = [" the", " quick", " brown", " fox", " jumps", " over"]
    toks = [TokenData(id=tctx.vocab.token_to_id[w.encode()]
                      if w.encode() in tctx.vocab.token_to_id
                      else 1000 + k, tid=0, p=1.0, plog=0.0, pt=0.0,
                      ptsum=0.0, t0=100 * k, t1=100 * k + 90)
            for k, w in enumerate(words)]
    full_text = "".join(tctx.vocab.token_str(t.id) for t in toks)
    seg = Segment(t0=0, t1=600, text=full_text, tokens=list(toks),
                  speaker_turn_next=True, no_speech_prob=0.25)
    st = WhisperState()
    with tctx.use_state(st):
        tctx.result_all.append(seg)
        n = tts.wrap_segment(tctx, max_len=10, split_on_word=True)
        segs = list(tctx.result_all)
    assert n == len(segs) and n >= 3
    assert sum(len(s.tokens) for s in segs) == len(toks)
    assert "".join(s.text for s in segs) == full_text
    assert all(s.t1 >= s.t0 for s in segs)
    assert segs[-1].speaker_turn_next is True
    assert all(not s.speaker_turn_next for s in segs[:-1])
    assert st.full_get_token_data(0, 0) is segs[0].tokens[0]
    assert st.full_get_segment_no_speech_prob(1) == 0.25
    assert st.full_get_segment_speaker_turn_next(n - 1)
