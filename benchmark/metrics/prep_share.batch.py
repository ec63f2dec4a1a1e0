"""prep_share.batch: percent of the untraced calls' wall in the program's
own `prep` (each stream's padding, or its host mel) and `upload` (the
streams' PCM stack built on the host and copied to the device) spans.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    if not w or "prep" not in w or rec["window_s"] <= 0:
        return None
    s = w["prep"]["seconds"] + w.get("upload", {"seconds": 0.0})["seconds"]
    return 100.0 * s / rec["window_s"]
