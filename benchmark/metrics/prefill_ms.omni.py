"""prefill_ms.omni: milliseconds of the program's `llm_prefill` spans (the
language model over a window round's prompts) per window round, over the
untraced calls: their device time (the CUDA event pair a span records on
a card: the stream's time from its first launch to its last one's end),
not the host's, which returns once the launches are queued."""


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    s = w and w.get("llm_prefill")
    if not s or s["count"] <= 0 or not s.get("stream_seconds"):
        return None
    return 1e3 * s["stream_seconds"] / s["count"]
