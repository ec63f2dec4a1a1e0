"""http_ms.server: milliseconds of the `/inference` handler outside its
request's time in the engine (the program's `http` spans less their
child `request` spans: the body read, multipart parsing, the WAV round
trip through TMPDIR, the response's formatting and writing), per request
handled in the window up to the device trace.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    s = w and w.get("http")
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["self_seconds"] / s["count"]
