"""Batched language auto-detection in whisper_tpu_torch's BatchTranscriber
against whisper_tpu's, on the same f32 ggml file: the per-stream language
ids and probabilities of the [sot] pre-pass in the dense and the quantized
cross modes, and language "auto" / detect_language through transcribe."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
from test_torch_trace import traced  # noqa: E402,F401
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("lang") / "f32.bin", "f32",
                       seed=3)


@pytest.fixture(autouse=True)
def numpy_mel(monkeypatch):
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")


@pytest.fixture(scope="module")
def streams():
    rng = np.random.RandomState(11)
    return [(rng.randn(int(16000 * s)) * a).astype(np.float32)
            for s, a in ((3, 0.1), (35, 0.3), (8, 0.02))]


def _contexts(path, cross_mode):
    return (JaxContext.from_file(path, compute_dtype=jnp.float32,
                                 cross_mode=cross_mode),
            WhisperContext.from_file(path, compute_dtype=torch.float32,
                                     cross_mode=cross_mode, device="cpu"))


def _params(factory, **over):
    p = factory()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.language = "auto"
    for k, v in over.items():
        setattr(p, k, v)
    return p


@pytest.mark.parametrize("device_mel", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("cross_mode", ["einsum", "einsum_q8", "einsum_q4"])
def test_detect_languages_matches_whisper_tpu(path, streams, cross_mode,
                                              device_mel):
    """Detection reads each stream's first window, at offset 0 whatever
    offset_ms says, as the serial path does."""
    jctx, tctx = _contexts(path, cross_mode)
    out = []
    for bt in (JaxBatch(jctx, batch_size=4, device_mel=device_mel,
                        params=_params(jax_params, offset_ms=2000)),
               BatchTranscriber(tctx, batch_size=4, device_mel=device_mel,
                                params=_params(full_default_params,
                                               offset_ms=2000))):
        assert bt.auto_lang
        states = [bt._make_stream(pcm) for pcm in streams]
        assert all(st.prompt_init is None and st.seek == 200
                   for st in states)
        bt._detect_languages(states, list(range(len(states))))
        out.append(states)
    for want, got in zip(*out):
        assert got.lang_id_state == want.lang_id_state
        assert got.prompt_init == want.prompt_init
        assert got.lang_probs.dtype == np.float32
        assert got.lang_probs.shape == (100,)
        np.testing.assert_allclose(got.lang_probs, want.lang_probs,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.lang_probs.sum(), 1.0, atol=1e-5)


def test_auto_language_transcribe_matches_whisper_tpu(path, streams):
    """Three streams over a batch of two: the third is detected when it
    joins the second iteration."""
    jctx, tctx = _contexts(path, "einsum_q8")
    jbt = JaxBatch(jctx, batch_size=2, params=_params(jax_params))
    tbt = BatchTranscriber(tctx, batch_size=2,
                           params=_params(full_default_params))
    want, got = jbt.transcribe(streams), tbt.transcribe(streams)
    assert [[(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in x]
            for x in got] == [[(s.t0, s.t1, s.text, [t.id for t in s.tokens])
                               for s in x] for x in want]
    assert sum(len(x) for x in want) >= 3
    assert ([st.full_lang_id() for st in tbt.last_states]
            == [st.full_lang_id() for st in jbt.last_states])
    # each stream decodes with its own detected language token
    for st in tbt.last_states:
        assert st.prompt_init[1] == tctx.vocab.token_lang(st.lang_id_state)


def test_detect_language_stops(path, streams, traced):
    """detect_language resolves each stream's language and decodes
    nothing, in one iteration per batch."""
    jctx, tctx = _contexts(path, "einsum")
    jbt = JaxBatch(jctx, batch_size=4,
                   params=_params(jax_params, detect_language=True))
    tbt = BatchTranscriber(tctx, batch_size=4,
                           params=_params(full_default_params,
                                          detect_language=True))
    assert jbt.transcribe(streams) == [[], [], []]
    assert tbt.transcribe(streams) == [[], [], []]
    assert traced.summary()["iterate"]["count"] == 1 and tbt.n_windows == 0
    assert ([st.full_lang_id() for st in tbt.last_states]
            == [st.full_lang_id() for st in jbt.last_states])
    # the serial full() detects the same language for a stream
    p = _params(full_default_params, detect_language=True)
    assert tctx.full(p, streams[0]) == 0
    assert tctx.full_lang_id() == tbt.last_states[0].full_lang_id()
