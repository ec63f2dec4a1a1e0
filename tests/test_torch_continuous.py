"""whisper_tpu_torch's ContinuousBatcher: against whisper_tpu's on the same
f32 ggml file (greedy, the best_of ladder and beam 5; host and device mel),
and the scheduling cases of tests/test_continuous.py re-run on the port
against its own serial `full`.

Both engines are gated by `iteration_hook` until every stream is queued,
so their batches hold the same streams in the same rows.  whisper_tpu's
host mel runs its numpy path (WTPU_NO_NATIVE=1)."""

import threading

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
from whisper_tpu.parallel.batch import ContinuousBatcher as JaxEngine  # noqa: E402
from whisper_tpu_torch import (SamplingStrategy, WhisperContext,  # noqa: E402
                               full_default_params)
from whisper_tpu_torch.parallel.batch import (BatchTranscriber,  # noqa: E402
                                              ContinuousBatcher)

# name -> (batch size, FullParams overrides)
CONFIGS = {
    "greedy": (2, dict(temperature_inc=0.0)),
    "best_of_ladder": (4, dict(greedy_best_of=2, temperature_inc=0.4,
                               logprob_thold=0.0)),
    "beam5": (5, dict(strategy=SamplingStrategy.BEAM_SEARCH,
                      beam_size=5, temperature_inc=0.0)),
}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("cont") / "f32.bin", "f32")


@pytest.fixture(scope="module")
def ctx(path):
    return WhisperContext.from_file(path, compute_dtype=torch.float32,
                                    device="cpu")


@pytest.fixture(scope="module")
def jctx(path):
    return JaxContext.from_file(path, compute_dtype=jnp.float32)


@pytest.fixture(autouse=True)
def numpy_mel(monkeypatch):
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")


def _params(factory, **over):
    p = factory()
    p.print_progress = False
    p.language = "en"
    for k, v in over.items():
        if k == "greedy_best_of":
            p.greedy.best_of = v
        elif k == "beam_size":
            p.beam_search.beam_size = v
        else:
            setattr(p, k, v)
    return p


def _noise(seconds, seed=0, int16=False):
    x = (np.random.RandomState(int(seed)).randn(int(16000 * seconds))
         .astype(np.float32) * 0.1)
    if int16:
        return (x * 32768).clip(-32768, 32767).astype(np.int16)
    return x


def _segs(segments):
    return [(s.t0, s.t1, s.text) for s in segments]


def _full_segs(segments):
    return [(s.t0, s.t1, s.text, tuple(t.id for t in s.tokens))
            for s in segments]


def _run_gated(engine, streams):
    """Submit every stream while the idle engine waits in its hook, so
    its first iteration admits them all."""
    parked, go = threading.Event(), threading.Event()

    def hook(n):
        parked.set()
        go.wait(timeout=120)

    engine.iteration_hook = hook
    assert parked.wait(timeout=60)
    jobs = [engine.submit_async(pcm) for pcm in streams]
    go.set()
    try:
        for j in jobs:
            assert j.done.wait(timeout=300)
            assert j.error is None, j.error
    finally:
        engine.iteration_hook = None
        engine.close()
    return jobs


@pytest.mark.parametrize("device_mel", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_matches_whisper_tpu(ctx, jctx, config, device_mel, traced):
    B, over = CONFIGS[config]
    streams = [_noise(s, seed=40 + s, int16=device_mel) for s in (4, 35, 62)]
    want = _run_gated(JaxEngine(jctx, batch_size=B, device_mel=device_mel,
                                params=_params(jax_params, **over)), streams)
    eng = ContinuousBatcher(ctx, batch_size=B, device_mel=device_mel,
                            params=_params(full_default_params, **over))
    got = _run_gated(eng, streams)
    for w, g in zip(want, got):
        assert _full_segs(g.st.result_all) == _full_segs(w.st.result_all)
        assert (g.iter_joined, g.iter_first, g.iter_done) == \
            (w.iter_joined, w.iter_first, w.iter_done)
        for a, b in zip(w.st.result_all, g.st.result_all):
            for key in ("p", "plog"):
                np.testing.assert_allclose(
                    [getattr(t, key) for t in b.tokens],
                    [getattr(t, key) for t in a.tokens], rtol=1e-4,
                    atol=1e-4, err_msg=key)
    assert sum(len(j.st.result_all) for j in want) >= 4
    spans = traced.summary()
    assert eng.bt.n_windows == spans["iterate"]["value"]
    if config == "best_of_ladder":
        assert eng.bt.n_retried_windows > 0     # the t > 0 rungs ran
    if device_mel:
        assert len(eng._pool_free) == eng.max_active


# -- tests/test_continuous.py's cases, on the port -------------------------

def _serving_params():
    # a window advances seek by 30 s, so the window count is
    # ceil(duration / 30 s); the ladder is off (its rungs are held above)
    return _params(full_default_params, single_segment=True, max_tokens=5,
                   temperature_inc=0.0)


def _serial(ctx, pcm, p=None):
    state = ctx.init_state()
    assert ctx.full(p or _serving_params(), pcm, state=state) == 0
    return _segs(state.result_all)


def test_continuous_matches_serial(ctx):
    streams = [_noise(d, seed=10 + d) for d in (2, 3, 4)]
    serial = [_serial(ctx, pcm) for pcm in streams]
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    try:
        jobs = [eng.submit_async(pcm) for pcm in streams]
        for j in jobs:
            assert j.done.wait(timeout=300) and j.error is None
        assert [_segs(j.st.result_all) for j in jobs] == serial
        for j in jobs:
            assert j.iter_joined is not None and j.iter_done is not None
            assert j.t_done is not None and j.t_first_segment is not None
    finally:
        eng.close()


def test_midflight_join_first_segment_within_one_iteration(ctx):
    """A request that arrives while a long stream is mid-decode joins the
    next iteration; the hook pins the join point."""
    long_pcm, short_pcm = _noise(235, seed=1), _noise(35, seed=2)
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    release, paused = threading.Event(), threading.Event()

    def hook(n):
        if n >= 2 and not release.is_set():
            paused.set()
            release.wait(timeout=120)

    eng.iteration_hook = hook
    try:
        a = eng.submit_async(long_pcm)
        assert paused.wait(timeout=300)
        assert not a.done.is_set()
        b = eng.submit_async(short_pcm)
        release.set()
        assert b.done.wait(timeout=300) and b.error is None
        assert b.iter_joined >= 2
        assert b.iter_done - b.iter_joined <= -(-35 * 100 // 3000) + 1
        assert b.iter_first <= b.iter_joined + 1
        assert a.done.wait(timeout=300) and a.error is None
        assert b.iter_done < a.iter_done
    finally:
        eng.iteration_hook = None
        release.set()
        eng.close()


def test_slot_refill_from_queue(ctx):
    """Three streams, two slots: the third takes the short stream's slot
    while the long one still decodes."""
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    try:
        ja, jb, jc = (eng.submit_async(_noise(d, seed=s))
                      for d, s in ((235, 3), (35, 4), (35, 5)))
        for j in (ja, jb, jc):
            assert j.done.wait(timeout=300) and j.error is None
        assert jb.iter_done < ja.iter_done
        assert jc.iter_done < ja.iter_done
        assert jc.iter_done >= jb.iter_done
    finally:
        eng.close()


def test_beam_strategy_rides_continuous_engine(ctx):
    p = _params(full_default_params, strategy=SamplingStrategy.BEAM_SEARCH,
                beam_size=2, temperature_inc=0.0)
    streams = [_noise(d, seed=20 + d) for d in (2, 3)]
    serial = [_serial(ctx, pcm, p) for pcm in streams]
    eng = ContinuousBatcher(ctx, batch_size=4, params=p)
    try:
        jobs = [eng.submit_async(pcm) for pcm in streams]
        for j in jobs:
            assert j.done.wait(timeout=300) and j.error is None
        assert [_segs(j.st.result_all) for j in jobs] == serial
    finally:
        eng.close()


def test_too_short_stream_resolves_immediately(ctx):
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    try:
        j = eng.submit_async(np.zeros(400, np.float32))
        assert j.done.wait(timeout=60)
        assert j.error is None and j.st.result_all == []
        assert eng.n_iterations == 0
    finally:
        eng.close()


def test_close_rejects_new_and_drains(ctx):
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    eng.close()
    assert not eng.thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_noise(2))


def test_on_segment_streams_progressively(ctx):
    pcm = _noise(65, seed=42)
    serial = _serial(ctx, pcm)
    assert len(serial) >= 2
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    try:
        got, done_at = [], []

        def on_segment(seg):
            got.append((seg.t0, seg.t1, seg.text))
            done_at.append(job.done.is_set())

        job = eng.submit_async(pcm, on_segment=on_segment)
        assert job.done.wait(timeout=300) and job.error is None
        assert got == serial == _segs(job.st.result_all)
        assert not any(done_at)            # every segment before the end
        job2 = eng.submit_async(pcm, on_segment=lambda s: 1 / 0)
        assert job2.done.wait(timeout=300) and job2.error is None
        assert _segs(job2.st.result_all) == serial
    finally:
        eng.close()


def test_first_window_priority_over_inflight(ctx):
    eng = ContinuousBatcher(ctx, batch_size=1, params=_serving_params())
    try:
        ja = eng.submit_async(_noise(95, seed=21))   # 4 windows
        jb = eng.submit_async(_noise(35, seed=22))   # 2 windows
        for j in (ja, jb):
            assert j.done.wait(timeout=300) and j.error is None
        assert jb.iter_first is not None
        assert jb.iter_first <= jb.iter_joined + 2
        assert jb.iter_done < ja.iter_done
        assert eng.n_iterations == 6
    finally:
        eng.close()


def test_resident_pcm_pool_matches_upload_path(ctx):
    """device_mel engines copy each admitted stream into a pool row once;
    every iteration reads the pool, the rows recycle, and the segments
    equal transcribe()'s."""
    streams = [_noise(d, seed=30 + d, int16=True) for d in (35, 65, 35, 95)]
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params(),
                            device_mel=True, max_active=4)
    pool_iters, rows = [], set()
    orig = eng.bt._iterate

    def spy(states, batch, pcm_dev=None):
        pool_iters.append(pcm_dev is not None)
        rows.update(states[i].pcm_row for i in batch)
        return orig(states, batch, pcm_dev)

    eng.bt._iterate = spy
    try:
        jobs = [eng.submit_async(pcm) for pcm in streams]
        for j in jobs:
            assert j.done.wait(timeout=300) and j.error is None
        cont = [_segs(j.st.result_all) for j in jobs]
        assert pool_iters and all(pool_iters)
        assert None not in rows
        assert len(eng._pool_free) == eng.max_active
        assert eng._pool.dtype == torch.int16
        assert tuple(eng._pool.shape) == (4, 2 * 16000 * 30 * 4)
    finally:
        eng.close()
    bt = BatchTranscriber(ctx, batch_size=2, params=_serving_params(),
                          device_mel=True)
    assert [_segs(s) for s in bt.transcribe(streams)] == cont


def test_iteration_failure_fails_jobs_and_engine_lives(ctx):
    """An iteration that raises gives every active job the error; the
    engine goes on serving."""
    eng = ContinuousBatcher(ctx, batch_size=2, params=_serving_params())
    orig = eng.bt._iterate
    eng.bt._iterate = lambda *a: (_ for _ in ()).throw(RuntimeError("boom"))
    try:
        j = eng.submit_async(_noise(4, seed=3))
        assert j.done.wait(timeout=60)
        assert "batch iteration failed: boom" in j.error
        eng.bt._iterate = orig
        assert _segs(eng.submit(_noise(4, seed=3))) == _serial(
            ctx, _noise(4, seed=3))
    finally:
        eng.close()


def test_concurrent_submitters_stress(ctx):
    """More submitting threads than cores, the interpreter switching
    threads every 10 us: every job finishes once, with its own stream's
    serial segments."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    streams = [_noise(2 + i % 3, seed=60 + i) for i in range(6)]
    serial = [_serial(ctx, pcm) for pcm in streams]
    eng = ContinuousBatcher(ctx, batch_size=3, params=_serving_params())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(eng.submit, streams[i % 6])
                    for i in range(24)]
            got = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert not eng.thread.is_alive()
    assert [_segs(g) for g in got] == [serial[i % 6] for i in range(24)]
    assert eng.active == [] and eng.queue.empty()
