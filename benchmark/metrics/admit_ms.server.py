"""admit_ms.server: milliseconds of a request's admission on the engine
thread (the program's `admit` spans: its stream prep with the host mel,
and its copy into the resident PCM pool), per request done in the window
up to the device trace.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    s = w and w.get("admit")
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["seconds"] / s["count"]
