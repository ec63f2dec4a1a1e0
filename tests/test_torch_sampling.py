"""Sampling at t > 0 and the temperature-fallback ladder: whisper_tpu_torch
against whisper_tpu on the same weights, inputs and keys (CPU, f32, micro
dims).

The window decode at t = 0.4 from one (2,) key and from (B, 2) per-row
keys; `full` with its default parameters (the ladder live, best_of 5) on a
packed q5_0 file, whose random weights fail every rung but the last, so
that the t > 0 rungs run; and BatchTranscriber with best_of 5 at batch 2
(best_of past the batch: the multi-pass rung) and at batch 10 (the tiled
rung, its cross-KV reused across rungs).

Every draw is recorded on the port's side: each test asserts that the
winner of every categorical draw led its runner-up (logits + Gumbel noise)
by more than GAP.  The two sides' f32 logits differ by ~1e-6 and their
Gumbel noise by an ulp (XLA's log is not torch's), so past GAP the draws
cannot part.  The seeds (weights: 7 for the slice's random context, 0
for the q5_0 file; PCM: 0 for `full`, 4 for the streams, 5 and 6 for the
windows' mel) keep every drawn position clear of a tie; a seed that did
not would fail here on the gap, not on luck.

The rungs' logprob_thold is -0.5 in the serving cases (the default is -1)
so that windows fail there too, and max_tokens 8-16 keeps the micro runs
short: whisper_tpu's side runs K3 interpreted.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_full import (_assert_same_segments, _params,  # noqa: E402
                             files, jax_context, jax_strict, pcm)
from test_torch_slice import (_first_divergence, _segments,  # noqa: E402
                              contexts)
from test_torch_trace import traced  # noqa: E402,F401
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.api import window_rng as jax_window_rng  # noqa: E402
from whisper_tpu.decode.filters import FilterOptions as JaxOptions  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.api import window_rng  # noqa: E402
from whisper_tpu_torch.decode import rng  # noqa: E402
from whisper_tpu_torch.decode.filters import FilterOptions  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

__all__ = ["contexts", "files", "jax_strict", "pcm"]

GAP = 1e-5


@pytest.fixture(scope="module")
def short_streams():
    """Two int16 streams of 20 and 25 s: a window each, then a tail."""
    rng_np = np.random.RandomState(4)
    return [(rng_np.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
            .astype(np.int16) for s in (20, 25)]


@pytest.fixture
def draw_gaps(monkeypatch):
    """Records, for every categorical draw the port makes, the smallest
    lead of a winner over its runner-up in logits + Gumbel noise."""
    gaps = []
    orig = rng.categorical

    def categorical(key, logits, shape=None):
        gaps.append(rng.categorical_margin(key, logits, shape))
        return orig(key, logits, shape)

    monkeypatch.setattr(rng, "categorical", categorical)
    return gaps


def _assert_draws_clear(gaps, at_least=1):
    assert len(gaps) >= at_least, f"only {len(gaps)} draws"
    assert min(gaps) > GAP, min(gaps)


def _window_inputs(jctx, tctx, B):
    """B windows of random mel through both encoders, a bare prompt."""
    n_ctx = jctx.hparams.n_audio_ctx
    mel = np.random.RandomState(5).randn(B, 2 * n_ctx, 80).astype(
        np.float32)
    _, jkc, jvc = jctx._encode_fn(n_ctx)(jctx.params, jnp.asarray(mel))
    _, tkc, tvc = tctx._encode_fn(torch.from_numpy(mel))
    P = 8
    prompt = [jctx.vocab.token_sot, jctx.vocab.token_lang(0),
              jctx.vocab.token_transcribe]
    buf = np.zeros((B, P), np.int32)
    buf[:, P - len(prompt):] = prompt
    pad = np.full((B,), P - len(prompt), np.int32)
    return (jkc, jvc), (tkc, tvc), buf, pad


@pytest.mark.parametrize("per_row", [False, True], ids=["one-key", "row-keys"])
def test_decode_window_sampled(contexts, draw_gaps, per_row):
    """One window at t = 0.4, four rows: the same tokens, probabilities
    and state, from one (2,) key (a joint draw over the rows) and from
    per-row keys."""
    jctx, tctx = contexts
    B, seek, end = 4, 0, 3000
    (jkc, jvc), (tkc, tvc), buf, pad = _window_inputs(jctx, tctx, B)
    jfn = jctx._decode_window_fn(B, 8, JaxOptions(), False, False, 0,
                                 per_row_rng=per_row)
    tfn = tctx._decode_window_fn(B, 8, FilterOptions(), False, False, 0)
    keys = (window_rng(seek, 2, B) if per_row
            else window_rng(seek, 2, B, per_row=False))
    np.testing.assert_array_equal(
        keys, jax_window_rng(seek, 2, B, per_row=per_row))
    live = np.ones((B,), bool)
    want = jfn(jctx.params, jkc, jvc, buf, pad, 0.4, seek, end, keys, live)
    got = tfn(tctx.params, tkc, tvc, buf, pad, 0.4, seek, end, keys, live)
    _assert_draws_clear(draw_gaps, at_least=4)
    n = int(want["n_tokens"])
    assert int(got["n_tokens"]) == n >= 4
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("result_len", "seek_delta", "completed", "failed", "tid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("p", "plog", "sum_logprobs_all", "no_speech_prob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    # the draws are the keys': another attempt draws other tokens
    other = tfn(tctx.params, tkc, tvc, buf, pad, 0.4, seek, end,
                window_rng(seek, 3, B) if per_row
                else window_rng(seek, 3, B, per_row=False), live)
    assert not np.array_equal(other["tokens"][:, :n], got["tokens"][:, :n])


def test_full_default_ladder(files, pcm, jax_strict, draw_gaps):
    """`full` with full_default_params (temperature_inc 0.2, best_of 5,
    greedy) on a packed q5_0 file (K3 as its plain version) in cross mode
    einsum, cut to 30 s and max_tokens 8 for time (whisper_tpu's side runs
    K3 interpreted): the same rungs fail on both sides, the t > 0 rungs
    draw best_of candidates, and the segments are equal."""
    jctx = jax_context(files["q5_0"], "einsum")
    tctx = WhisperContext.from_file(files["q5_0"], compute_dtype=torch.float32,
                                    cross_mode="einsum", device="cpu")
    for ctx, factory in ((jctx, jax_params), (tctx, full_default_params)):
        p = factory()
        assert p.temperature_inc == 0.2 and p.greedy.best_of == 5
        p.print_progress = False
        p.duration_ms = 30000
        p.max_tokens = 8
        assert ctx.full(p, pcm) == 0
    assert tctx.timings.n_fail_p == jctx.timings.n_fail_p > 0
    assert tctx.timings.n_fail_h == jctx.timings.n_fail_h
    _assert_draws_clear(draw_gaps, at_least=10)
    _assert_same_segments(tctx.result_all, jctx.result_all)


@pytest.mark.parametrize("batch", [2, 10], ids=["multipass", "tiled"])
def test_batch_best_of_ladder(contexts, short_streams, draw_gaps, batch,
                              traced):
    """BatchTranscriber with the ladder live and best_of 5: at batch 2 a
    stream's five candidates span three passes (merged before ranking), at
    batch 10 both streams' candidates share one pass and the later rungs
    reuse its cross-KV.  Segments equal whisper_tpu's, and windows were
    retried."""
    jctx, tctx = contexts
    over = {"temperature_inc": 0.2, "logprob_thold": -0.5, "max_tokens": 16}
    jb = JaxBatch(jctx, batch_size=batch, params=_params(jax_params, over),
                  device_mel=True)
    jres = jb.transcribe(short_streams)
    tb = BatchTranscriber(tctx, batch_size=batch,
                          params=_params(full_default_params, over),
                          device_mel=True)
    tres = tb.transcribe(short_streams)
    assert tb.n_windows == jb.n_windows
    assert tb.n_retried_windows == jb.n_retried_windows > 0
    assert _segments(tres) == _segments(jres), _first_divergence(jres, tres)
    assert all(_segments(jres))
    _assert_draws_clear(draw_gaps, at_least=10)
    spans = traced.summary()
    assert {"transcribe", "prep", "upload", "iterate", "encode", "decode",
            "step", "wait", "finish"} <= set(spans)
    assert spans["iterate"]["value"] == tb.n_windows
