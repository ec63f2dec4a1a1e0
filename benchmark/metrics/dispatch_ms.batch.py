"""dispatch_ms.batch: milliseconds of the program's `step` spans (a decode
step's launches and the token's draw and bookkeeping, enqueued with no
wait for the device) per decode step, over the untraced calls.  Its
divisor is step_ms.batch's, the decode spans' tokens, so dispatch_ms and
wait_ms add up against it.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    if not w or "step" not in w or w.get("decode", {}).get("value", 0) <= 0:
        return None
    return 1e3 * w["step"]["seconds"] / w["decode"]["value"]
