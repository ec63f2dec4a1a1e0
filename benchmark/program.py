"""The program's own spans (whisper_tpu_torch/utils/trace.py) for an
entry's traced run: `start()` before the program is built, so that its
warm-up is recorded, and `collect()` once the window has closed, its
result put in the record under "program", where the readers of
prep_share, dispatch_ms, wait_ms, encode_device_ms, warmup_s, queue_ms,
admit_ms and http_ms look.  A program without the tracer gives nothing,
and those readers report nothing.

Unused as yet: no entry calls start() or collect(), so no run records
the program's spans, and BENCHMARK.json lists none of those readers.
Wiring them in is an edit to benchmark/entries/transcribe.py and
server.py in their traced paths, and five per_layer entries."""

from __future__ import annotations

# the program's spans join the idle-gap attribution under these names,
# apart from the benchmark's wrappers of the same calls
PREFIX = "program."
GAPS = tuple(PREFIX + n for n in (
    "transcribe", "prep", "upload", "iterate", "encode", "decode", "step",
    "wait", "finish", "admit"))


def start():
    """The program's tracer, emptied and on; None when it has none."""
    try:
        from whisper_tpu_torch.utils.trace import TRACE
    except ImportError:
        return None
    TRACE.drain()
    TRACE.enable()
    return TRACE


def collect(tracer, spans, window: list, setup_end_ns: int) -> dict | None:
    """Turn the tracer off; -> {"window": its summary over the intervals
    `window` [(t0_ns, t1_ns), ...], "setup": over what ended before
    setup_end_ns}.  Its spans of the names in GAPS go into `spans` (the
    benchmark's records) for the idle-gap attribution."""
    if tracer is None:
        return None
    tracer.disable()
    out = {"window": tracer.summary(window),
           "setup": tracer.summary([(0, setup_end_ns)])}
    for r in tracer.drain():
        if PREFIX + r.name in GAPS:
            spans.records.append((PREFIX + r.name, r.t0, r.t1, r.value))
    return out
