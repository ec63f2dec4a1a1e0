"""wait_ms.batch: milliseconds of the program's `wait` spans (the token
loop's host reads of the device: the stop flag once a token, the results
at the end of a window) per decode step, over the untraced calls.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    if not w or "wait" not in w or w.get("decode", {}).get("value", 0) <= 0:
        return None
    return 1e3 * w["wait"]["seconds"] / w["decode"]["value"]
