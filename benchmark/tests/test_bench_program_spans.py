"""The readers of the program's own spans (metrics/*.py over the record's
"program" summaries, benchmark/program.py) on hand-made records: each
gives its value, and nothing where the program recorded no such span (a
program without the tracer)."""

from __future__ import annotations

import pytest

from benchmark import cells, program
from benchmark.tests.conftest import HERE


def _span(count, seconds, value, self_seconds=None, **extra):
    return dict(count=count, seconds=seconds, value=value,
                self_seconds=seconds if self_seconds is None
                else self_seconds, **extra)


WINDOW = {
    "prep": _span(2, 0.5, 512), "upload": _span(2, 0.25, 2e9),
    "decode": _span(8, 3.0, 500), "step": _span(492, 2.0, 492),
    "wait": _span(516, 0.5, 516),
    "encode": _span(8, 1.9, 2048, stream_seconds=2.048),
    "queued": _span(4, 2.0, 4), "admit": _span(4, 0.2, 4),
    "http": _span(4, 10.0, 4e6, self_seconds=0.4),
}
SETUP = {"warmup": _span(1, 9.5, 1), "fn_built": _span(3, 0.0, 3)}
RECORD = {"window_s": 10.0, "program": {"window": WINDOW, "setup": SETUP}}

# metric -> (its value on RECORD, the spans it reads)
WANT = {
    "prep_share.batch": (7.5, ("prep",)),
    "dispatch_ms.batch": (4.0, ("step", "decode")),
    "wait_ms.batch": (1.0, ("wait", "decode")),
    "encode_device_ms.batch": (1.0, ("encode",)),
    "warmup_s.batch": (9.5, ("warmup",)),
    "queue_ms.server": (500.0, ("queued",)),
    "admit_ms.server": (50.0, ("admit",)),
    "http_ms.server": (100.0, ("http",)),
}


def _reader(metric):
    return cells._module(HERE / "metrics" / f"{metric}.py")


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_reads_its_spans(metric):
    value, reads = WANT[metric]
    read = _reader(metric).read
    assert read(RECORD) == pytest.approx(value, rel=1e-12)
    for name in reads:
        part = "setup" if name in SETUP else "window"
        spans = {k: v for k, v in RECORD["program"][part].items()
                 if k != name}
        rec = dict(RECORD, program=dict(RECORD["program"], **{part: spans}))
        assert read(rec) is None, name
    # a program without the tracer: the record holds no "program"
    assert read({"window_s": 10.0}) is None
    assert read(None) is None


def test_encode_device_needs_device_time():
    """On the CPU the encode span has no CUDA events: no reading."""
    window = dict(WINDOW, encode=_span(8, 1.9, 2048))
    rec = dict(RECORD, program={"window": window, "setup": SETUP})
    assert _reader("encode_device_ms.batch").read(rec) is None


class _Spans:
    def __init__(self):
        self.records = []


class _Tracer:
    """The program tracer's reading side, over fixed records."""

    def __init__(self, recs):
        self.recs, self.on = recs, True

    def disable(self):
        self.on = False

    def summary(self, intervals):
        return {"n": sum(1 for r in self.recs
                         if any(a <= r[1] and r[2] <= b
                                for a, b in intervals))}

    def drain(self):
        from whisper_tpu_torch.utils.trace import Span
        return [Span(name, t0, t1, 1, None, None, 0, i)
                for i, (name, t0, t1) in enumerate(self.recs)]


def test_collect_splits_setup_and_window_and_feeds_the_gaps():
    tracer = _Tracer([("warmup", 1, 5), ("step", 10, 12), ("wait", 12, 13),
                      ("http", 10, 20), ("fn_built", 11, 11)])
    spans = _Spans()
    got = program.collect(tracer, spans, [(9, 30)], 8)
    assert not tracer.on
    assert got == {"window": {"n": 4}, "setup": {"n": 1}}
    # only the names the idle-gap attribution reads, prefixed
    assert spans.records == [("program.step", 10, 12, 1),
                             ("program.wait", 12, 13, 1)]
    assert program.collect(None, spans, [(0, 1)], 0) is None
