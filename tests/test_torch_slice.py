"""The serving slice as a whole: whisper_tpu_torch's BatchTranscriber emits
the same segments as whisper_tpu's on the same random-weight model (micro
dims, float32, device mel, int8 cross-KV, greedy), token for token."""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.api import full_default_params as jax_params  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu_torch.api import WhisperContext  # noqa: E402
from whisper_tpu_torch.api import full_default_params  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402

# micro dims with a real-layout vocab (special ids need >= 50364);
# n_text_layer=3 as in __graft_entry__.py's dry run
MICRO = (51864, 32, 64, 4, 2, 48, 64, 4, 3, 80)

CASES = {
    "timestamps": {},
    "bench_settings": dict(no_timestamps=True, max_tokens=8,
                           n_max_text_ctx=64),
}


@pytest.fixture(scope="module")
def contexts():
    jctx = JaxContext.from_random(seed=7, compute_dtype=jnp.float32,
                                  dims=MICRO, cross_mode="einsum_q8")
    return jctx, WhisperContext.from_jax(jctx, "cpu")


@pytest.fixture(scope="module")
def streams():
    rng = np.random.RandomState(0)
    return [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
            .astype(np.int16) for s in (35, 62)]


def _params(factory, overrides):
    p = factory()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    for k, v in overrides.items():
        setattr(p, k, v)
    return p


def _segments(result):
    return [[(s.t0, s.t1, tuple(t.id for t in s.tokens)) for s in segs]
            for segs in result]


def _first_divergence(jres, tres):
    """Where the two runs first part, with each side's logprob of the
    token it chose there (a near-tie shows as a small gap)."""
    for si, (js, ts) in enumerate(zip(jres, tres)):
        jt = [t for s in js for t in s.tokens]
        tt = [t for s in ts for t in s.tokens]
        for i, (a, b) in enumerate(zip(jt, tt)):
            if a.id != b.id:
                return (f"stream {si} token {i}: jax id {a.id} "
                        f"plog {a.plog:.6g}, torch id {b.id} plog "
                        f"{b.plog:.6g}, gap {a.plog - b.plog:.3g}")
        if len(jt) != len(tt):
            return f"stream {si}: {len(jt)} vs {len(tt)} tokens"
    return "same tokens; timestamps differ"


@pytest.mark.parametrize("case", list(CASES))
def test_batch_segments_identical(contexts, streams, case):
    jctx, tctx = contexts
    overrides = CASES[case]
    jres = JaxBatch(jctx, batch_size=2, params=_params(jax_params, overrides),
                    device_mel=True).transcribe(streams)
    bt = BatchTranscriber(tctx, batch_size=2,
                          params=_params(full_default_params, overrides),
                          device_mel=True)
    tres = bt.transcribe(streams)
    want, got = _segments(jres), _segments(tres)
    assert all(want), want
    assert got == want, _first_divergence(jres, tres)
    assert set(bt.phase_times) == {"upload", "prep", "encode", "decode",
                                   "finish"}
    assert sum(b for b, _ in bt.window_times) == bt.n_windows
    # segment text and probabilities come along with the ids
    for js, ts in zip(jres, tres):
        for a, b in zip(js, ts):
            assert a.text == b.text
            np.testing.assert_allclose([t.p for t in b.tokens],
                                       [t.p for t in a.tokens], rtol=1e-4,
                                       atol=1e-6)
    if case == "bench_settings":
        # no timestamp token is sampled, so t0 comes from tid == 0 and lands
        # before the window start: the reference's arithmetic, kept as is
        assert any(s[0] < 0 for segs in got for s in segs)


@pytest.mark.parametrize("field,value", [
    ("language", "auto"),
    ("detect_language", True),
    ("token_timestamps", True),
    ("suppress_regex", "t1.*"),
])
def test_refused_options(contexts, field, value):
    _, tctx = contexts
    p = _params(full_default_params, {})
    setattr(p, field, value)
    with pytest.raises(NotImplementedError):
        BatchTranscriber(tctx, batch_size=2, params=p, device_mel=True)


def test_refused_paths(contexts):
    jctx, tctx = contexts
    p = _params(full_default_params, {})
    with pytest.raises(NotImplementedError):
        BatchTranscriber(tctx, batch_size=2, params=p, device_mel=False)
    with pytest.raises(NotImplementedError):
        BatchTranscriber(tctx, batch_size=2, params=p, mesh=object(),
                         device_mel=True)
    with pytest.raises(ValueError, match="cross_mode"):
        WhisperContext.from_random(dims=MICRO, cross_mode="einsum_q2",
                                   device="cpu")
    # every cross mode of whisper_tpu, "einsum" included, runs batched
    dense = WhisperContext.from_random(dims=MICRO, cross_mode="einsum",
                                       device="cpu")
    BatchTranscriber(dense, batch_size=2, params=p, device_mel=True)
    fields = ("config", "vocab", "filters", "params", "compute_dtype")
    other_mode = types.SimpleNamespace(
        cross_mode="pallas_q4", **{f: getattr(jctx, f) for f in fields})
    with pytest.raises(ValueError, match="cross_mode"):
        WhisperContext.from_jax(other_mode, "cpu")


def test_window_rng_matches_jax():
    """The sampling key data, bit for bit (decode/rng.py draws from it)."""
    from whisper_tpu import api as japi
    from whisper_tpu_torch import api as tapi
    for seek, attempt, n_cur in ((0, 0, 1), (4500, 2, 5), (2**31 + 7, 1, 3)):
        np.testing.assert_array_equal(tapi.window_rng(seek, attempt, n_cur),
                                      japi.window_rng(seek, attempt, n_cur))
        np.testing.assert_array_equal(
            tapi.window_rng(seek, attempt, n_cur, per_row=False),
            japi.window_rng(seek, attempt, n_cur, per_row=False))


@pytest.mark.parametrize("last", [False, True])
def test_rank_window_candidates_matches_jax(last):
    """Scores, the winner and its emission length on random candidates: a
    failed row, a repetitive (low-entropy) row and ordinary rows."""
    from whisper_tpu import api as japi
    from whisper_tpu_torch import api as tapi
    rng = np.random.RandomState(5)
    n_rows, N, eot = 5, 48, 50257
    result = {
        "tokens": rng.randint(0, 400, (n_rows, N)).astype(np.int32),
        "plog": -rng.rand(n_rows, N).astype(np.float32),
        "result_len": np.array([0, 40, 12, 40, 20], np.int32),
        "failed": np.array([True, False, False, False, True]),
        "no_speech_prob": rng.rand(n_rows).astype(np.float32),
        "seek_delta": rng.randint(0, 3000, n_rows).astype(np.int32),
        "n_tokens": np.int32(30),
    }
    for key in ("p", "tid", "pt", "ptsum"):
        result[key] = rng.rand(n_rows, N).astype(np.float32)
    result["tokens"][3, :] = 7                     # entropy 0: fails
    result["tokens"][4, 25:] = eot                 # own tail ends at 25
    for lp in (-1.0, 1.0):
        p = _params(full_default_params, {"length_penalty": lp})
        for n_cur, row0 in ((4, 1), (1, 4), (2, 3)):
            want = japi._rank_window_candidates(result, n_cur, p, last, eot,
                                                row0=row0)
            got = tapi._rank_window_candidates(result, n_cur, p, last, eot,
                                               row0=row0)
            assert got[1] == want[1]
            assert (got[0] is None) == (want[0] is None)
            if want[0] is not None:
                assert got[0].keys() == want[0].keys()
                for key, val in want[0].items():
                    np.testing.assert_array_equal(got[0][key], val,
                                                  err_msg=key)
    for n in (0, 5, 40):
        plogs = -rng.rand(n).astype(np.float32)
        ids = rng.randint(0, 50, n)
        assert (tapi._sequence_score(plogs, ids, 1.0)
                == japi._sequence_score(plogs, ids, 1.0))
        assert (tapi._own_sampled_len(result["tokens"][4], n, eot)
                == japi._own_sampled_len(result["tokens"][4], n, eot))


def test_from_random_micro_runs(streams):
    """A context built from torch's own generator runs the slice too."""
    ctx = WhisperContext.from_random(dims=MICRO, seed=1, device="cpu",
                                     compute_dtype=torch.float32)
    assert ctx.n_loaded > 0
    bt = BatchTranscriber(ctx, batch_size=2, params=_params(
        full_default_params, CASES["bench_settings"]), device_mel=True)
    bt.warmup(pcm_dtype=np.int16)
    res = bt.transcribe(streams)
    assert all(len(s) >= 1 for s in res)
