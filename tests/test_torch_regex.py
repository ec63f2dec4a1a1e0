"""suppress_regex in whisper_tpu_torch against whisper_tpu, on the same f32
ggml file: the suppressed ids, `full`, and the batched beam, where both
packages suppress; and batched greedy decoding, where neither does
(whisper_tpu's `_decode_rows` passes no extra suppression, and the port
keeps that behaviour so that the two stay equal)."""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch import (SamplingStrategy, WhisperContext,  # noqa: E402
                               full_default_params)
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    path = write_model(tmp_path_factory.mktemp("re") / "f32.bin", "f32",
                       seed=1)
    return (JaxContext.from_file(path, compute_dtype=jnp.float32),
            WhisperContext.from_file(path, compute_dtype=torch.float32,
                                     device="cpu"))


@pytest.fixture(autouse=True)
def numpy_mel(monkeypatch):
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")


@pytest.fixture(scope="module")
def streams():
    rng = np.random.RandomState(9)
    return [(rng.randn(16000 * s) * 0.1).astype(np.float32) for s in (6, 33)]


def _params(factory, beam=False, regex=None):
    p = factory()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.suppress_regex = regex
    if beam:
        p.strategy = SamplingStrategy.BEAM_SEARCH
        p.beam_search.beam_size = 5
    return p


def _segs(result):
    return [(s.t0, s.t1, s.text, tuple(t.id for t in s.tokens))
            for s in result]


def _ids(result):
    return {t.id for s in result for t in s.tokens}


def _regex_for(ctx, result):
    """A pattern that matches exactly the most frequent text token of
    `result`, and the token's id."""
    ids = [t.id for s in result for t in s.tokens if t.id < ctx.token_eot()]
    tid = max(set(ids), key=ids.count)
    return re.escape(ctx.vocab.token_str(tid)), tid


def test_regex_suppress_ids_match_whisper_tpu(contexts):
    jctx, tctx = contexts
    for pat in (r" t1\d", r" t(5|77)\d*", r"\[.*\]", r"zzz", r" t2"):
        got = tctx._regex_suppress_ids(pat)
        assert got == jctx._regex_suppress_ids(pat)
        assert got == tuple(sorted(got))
    assert len(tctx._regex_suppress_ids(r" t1\d")) == 10
    assert tctx._regex_suppress_ids(r" t2") == (
        tctx.vocab.token_to_id[b" t2"],)


def test_full_suppress_regex_matches_whisper_tpu(contexts, streams):
    jctx, tctx = contexts
    pcm = streams[1]
    assert tctx.full(_params(full_default_params), pcm) == 0
    pat, tid = _regex_for(tctx, tctx.result_all)
    assert jctx.full(_params(jax_params, regex=pat), pcm) == 0
    assert tctx.full(_params(full_default_params, regex=pat), pcm) == 0
    assert _segs(tctx.result_all) == _segs(jctx.result_all)
    assert tid not in _ids(tctx.result_all)
    assert tctx.result_all


def test_batched_beam_suppress_regex_matches_whisper_tpu(contexts, streams):
    jctx, tctx = contexts
    plain = BatchTranscriber(tctx, batch_size=5, params=_params(
        full_default_params, beam=True)).transcribe(streams)
    pat, tid = _regex_for(tctx, plain[1])
    want = JaxBatch(jctx, batch_size=5, params=_params(
        jax_params, beam=True, regex=pat)).transcribe(streams)
    got = BatchTranscriber(tctx, batch_size=5, params=_params(
        full_default_params, beam=True, regex=pat)).transcribe(streams)
    assert [_segs(x) for x in got] == [_segs(x) for x in want]
    assert tid not in _ids(got[1])
    assert got[1]


def test_suppress_regex_not_applied_in_batched_greedy_either(contexts,
                                                             streams):
    """whisper_tpu's batched greedy rows pass no extra suppression, so a
    suppress_regex request that rides the batched engine keeps its
    matching tokens there; the port reproduces this (ROADMAP queue 3)."""
    jctx, tctx = contexts
    plain = BatchTranscriber(tctx, batch_size=2, params=_params(
        full_default_params)).transcribe(streams)
    pat, tid = _regex_for(tctx, plain[1])
    want = JaxBatch(jctx, batch_size=2, params=_params(
        jax_params, regex=pat)).transcribe(streams)
    got = BatchTranscriber(tctx, batch_size=2, params=_params(
        full_default_params, regex=pat)).transcribe(streams)
    assert [_segs(x) for x in got] == [_segs(x) for x in want]
    assert [_segs(x) for x in got] == [_segs(x) for x in plain]
    assert tid in _ids(got[1])
