"""queue_ms.server: milliseconds a request waited in the engine's queue,
from its submit to its admission (the program's `queued` spans), per
request done in the window up to the device trace.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    s = w and w.get("queued")
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["seconds"] / s["count"]
