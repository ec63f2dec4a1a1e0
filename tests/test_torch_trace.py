"""whisper_tpu_torch's tracer (utils/trace.py) on the CPU micro model: off,
it records nothing and changes no token; on, its spans nest, count what
BatchTranscriber, the token loop and the serving engine did, and carry
each request's id across threads."""

import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.parallel.batch import (BatchTranscriber,  # noqa: E402
                                              ContinuousBatcher)
from whisper_tpu_torch.utils.trace import TRACE, Tracer  # noqa: E402
from whisper_tpu_torch.models import whisper as wm  # noqa: E402
from whisper_tpu_torch.weights.convert import random_params  # noqa: E402

@pytest.fixture
def traced():
    """The tracer, on for the test and off and empty after it (the tests of
    other modules that read it import this fixture)."""
    TRACE.drain()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.disable()
        TRACE.drain()


# micro dims with a real-layout vocab, as tests/test_torch_slice.py's
MICRO = (51864, 32, 64, 4, 2, 48, 64, 4, 3, 80)


@pytest.fixture(scope="module")
def ctx():
    return WhisperContext.from_random(seed=7, device="cpu", dims=MICRO,
                                      compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def streams():
    rng = np.random.RandomState(0)
    return [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
            .astype(np.int16) for s in (35, 62)]


def _params(**over):
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    for k, v in over.items():
        setattr(p, k, v)
    return p


def _tokens(result):
    return [[tuple(t.id for t in s.tokens) for s in segs] for segs in result]


def test_off_records_nothing_and_changes_no_token(ctx, streams):
    TRACE.drain()
    assert not TRACE.on
    # off, every site shares one no-op context
    assert TRACE.span("a") is TRACE.span("b", 3, device=True)
    assert TRACE.request() is TRACE.span("c")
    assert TRACE.origin() == (None, None)
    bt = BatchTranscriber(ctx, batch_size=2, params=_params(),
                          device_mel=True)
    off = bt.transcribe(streams)
    assert TRACE.records == []
    TRACE.enable()
    try:
        on = bt.transcribe(streams)
    finally:
        TRACE.disable()
        recs = TRACE.drain()
    assert recs and all(off) and _tokens(on) == _tokens(off)


def _self_ns(recs):
    """Each record's duration less its children's, by id."""
    own = {r.id: r.t1 - r.t0 for r in recs}
    for r in recs:
        if r.parent in own:
            own[r.parent] -= r.t1 - r.t0
    return own


@pytest.mark.parametrize("device_mel", [False, True], ids=["host", "device"])
def test_spans_nest_and_count_the_work(ctx, streams, traced, device_mel):
    bt = BatchTranscriber(ctx, batch_size=2, params=_params(),
                          device_mel=device_mel)
    iterations = []
    orig = bt._iterate

    def counting(*args):
        iterations.append(len(args[1]))
        return orig(*args)

    bt._iterate = counting
    if not device_mel:
        streams = [x.astype(np.float32) / 32768.0 for x in streams]
    traced.drain()
    bt.transcribe(streams)
    recs = traced.drain()
    n = Counter(r.name for r in recs)
    by_id = {r.id: r for r in recs}

    assert n["transcribe"] == n["prep"] == 1
    assert n["upload"] == (1 if device_mel else 0)
    # the stack it builds and copies: 2 rows of int16, 62 s and its 30 s of
    # padding rounded up to 120 s
    assert [r.value for r in recs if r.name == "upload"] == \
        ([2 * 120 * 16000 * 2] if device_mel else [])
    assert n["iterate"] == len(iterations) == 3
    assert sorted(r.value for r in recs if r.name == "iterate") == \
        sorted(iterations)
    decodes = [r.value for r in recs if r.name == "decode"]
    assert len(decodes) == n["iterate"] and all(v >= 1 for v in decodes)
    assert n["step"] == sum(max(v - 1, 0) for v in decodes)
    assert n["wait"] == sum(v + 2 for v in decodes)
    assert n["encode"] == n["finish"] == n["iterate"]
    assert {r.value for r in recs if r.name == "encode"} == {2}

    # every span lies inside its parent, under the parent its layer has
    want_parent = {"prep": "transcribe", "upload": "transcribe",
                   "iterate": "transcribe", "encode": "iterate",
                   "decode": "iterate", "finish": "iterate",
                   "step": "decode", "wait": "decode"}
    for r in recs:
        if r.name == "transcribe":
            assert r.parent is None
            continue
        up = by_id[r.parent]
        assert up.name == want_parent[r.name], (r.name, up.name)
        assert up.t0 <= r.t0 <= r.t1 <= up.t1
        assert r.thread == up.thread and r.rid is None
    assert all(v >= 0 for v in _self_ns(recs).values())


def test_summary_reads_self_time_and_intervals(ctx, streams, traced):
    bt = BatchTranscriber(ctx, batch_size=2, params=_params(),
                          device_mel=True)
    traced.drain()
    t0 = time.time_ns()
    bt.transcribe(streams)
    t1 = time.time_ns()
    bt.transcribe(streams)
    one, both = traced.summary([(t0, t1)]), traced.summary()
    assert one["transcribe"]["count"] == 1
    assert both["transcribe"]["count"] == 2
    for name, s in one.items():
        assert 0.0 <= s["self_seconds"] <= s["seconds"] + 1e-9, name
    d = one["decode"]
    assert d["self_seconds"] == pytest.approx(
        d["seconds"] - one["step"]["seconds"] - one["wait"]["seconds"],
        abs=1e-6)
    assert one["iterate"]["value"] == 5       # rows: 2, 2, 1
    assert "stream_seconds" not in one["encode"]   # the CPU has no events


def test_nothing_is_built_inside_a_call_after_warmup(ctx, streams, traced):
    # max_tokens 7: a loop no other test of this module builds
    bt = BatchTranscriber(ctx, batch_size=2, params=_params(max_tokens=7),
                          device_mel=True)
    traced.drain()
    bt.warmup(pcm_dtype=np.int16)
    warm = traced.summary()
    assert warm["fn_built"]["value"] == 2     # the two prompt buckets
    assert warm["warmup"]["count"] == 1
    assert warm["encode"]["count"] == 1 and warm["decode"]["count"] == 2
    t0 = time.time_ns()
    bt.transcribe(streams)
    call = traced.summary([(t0, time.time_ns())])
    assert "fn_built" not in call and call["transcribe"]["count"] == 1


def test_engine_requests_carry_their_ids(ctx, traced):
    """Three threads submit to one ContinuousBatcher; each request's
    spans share its id, hang under the thread's span and keep order."""
    eng = ContinuousBatcher(ctx, batch_size=2,
                            params=_params(single_segment=True,
                                           max_tokens=5))
    got = {}

    def client(k):
        pcm = (np.random.RandomState(k).randn(16000 * (2 + k))
               .astype(np.float32) * 0.1)
        with traced.request() as rid, traced.span("client") as sp:
            got[k] = (rid, sp.id, eng.submit(pcm))

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.close()
    recs = traced.drain()
    assert len(got) == 3 and len({rid for rid, _, _ in got.values()}) == 3
    for rid, client_id, segs in got.values():
        assert segs
        mine = {r.name: r for r in recs if r.rid == rid}
        assert set(mine) == {"client", "request", "queued", "admit"}
        req, q, a = mine["request"], mine["queued"], mine["admit"]
        assert req.parent == client_id
        assert q.parent == a.parent == req.id
        assert req.t0 == q.t0 <= q.t1 == a.t0 <= a.t1 <= req.t1
        assert mine["client"].t0 <= req.t0 and req.t1 <= mine["client"].t1
    # the engine's own spans serve no one request
    assert all(r.rid is None for r in recs if r.name == "iterate")


def test_threads_lose_no_span():
    """Many threads record at once with a short switch interval: every
    span is kept, with its own thread's parent and request."""
    tr = Tracer()
    tr.enable()
    n_threads, n_spans = 12, 200

    def work():
        with tr.request():
            for _ in range(n_spans):
                with tr.span("outer"):
                    with tr.span("inner"):
                        tr.count("n", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = tr.drain()
    assert tr.records == []
    n = Counter(r.name for r in recs)
    assert n == {"outer": n_threads * n_spans, "inner": n_threads * n_spans,
                 "n": n_threads * n_spans}
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "outer":
            assert r.parent is None
        else:
            up = by_id[r.parent]
            assert up.thread == r.thread and up.rid == r.rid
            assert up.name == ("outer" if r.name == "inner" else "inner")
    assert len({r.rid for r in recs}) == n_threads


def test_decoder_fused_counts_the_fused_steps_layers(monkeypatch):
    """`decoder_fused` counts a decode step's layers once a step when the
    step runs fused (the card patched, bf16); nothing for the CPU's plain
    step, and nothing at all with the tracer off."""
    cfg = wm.WhisperConfig(128, 24, 64, 4, 2, 32, 64, 4, 3, 80)
    params = random_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    L, B, H, Dh, C = cfg.n_text_layer, 2, 4, 16, 8
    g = torch.Generator()
    g.manual_seed(0)
    kc, vc = (torch.randn(L, B, H, Dh, 24, generator=g).to(torch.bfloat16)
              for _ in range(2))

    def step():
        cache = {n: torch.zeros(L, B, H, Dh, C, dtype=torch.bfloat16)
                 for n in ("k", "v")}
        wm.decode_step(params, torch.tensor([5, 7]), torch.tensor([3, 4]),
                       4, cache, kc, vc, kv_len=5, n_head=H,
                       pad_len=torch.tensor([0, 2]))

    TRACE.drain()
    step()
    monkeypatch.setattr(wm, "_on_card", lambda x: True)
    step()
    assert TRACE.drain() == []
    monkeypatch.undo()
    TRACE.enable()
    try:
        step()
        monkeypatch.setattr(wm, "_on_card", lambda x: True)
        step()
        step()
    finally:
        TRACE.disable()
        recs = TRACE.drain()
    assert [r.value for r in recs if r.name == "decoder_fused"] == [L, L]
