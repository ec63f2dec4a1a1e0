"""encode_device_ms.batch: stream milliseconds of the program's `encode`
spans per window slot, over the untraced calls.  A span's CUDA event pair
brackets each batched encode (the window cut, device mel, encoder and
cross-KV) on the stream: its kernels and any gap where the stream waited
for the host's launches, not the device's busy time alone.
Unused until an entry records the program's spans
(benchmark/program.py); BENCHMARK.json does not list it."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    e = w and w.get("encode")
    if not e or "stream_seconds" not in e or e["value"] <= 0:
        return None
    return 1e3 * e["stream_seconds"] / e["value"]
