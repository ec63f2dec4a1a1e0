"""warmup_s.batch: seconds of the program's `warmup` span
(BatchTranscriber.warmup: an encode and both prompt buckets' window
decodes, the kernels' first build inside it), before the window.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    s = rec and rec.get("program") and rec["program"]["setup"]
    if not s or "warmup" not in s:
        return None
    return s["warmup"]["seconds"]
