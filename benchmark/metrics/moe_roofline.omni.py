"""moe_roofline.omni: the mixture of experts' least time at the H100's
HBM3 bandwidth over the device time of the program's `moe` spans (one a
layer call, prefill and steps), in percent, over the untraced calls.
Bytes: the expert weights read (the `moe_bytes` counter: the shared
experts and each routed expert that has a row, once a call), and each
routed row's input read in bf16 and output written in float32, once for
the shared experts and once for each routed expert it keeps
((moe_tokens + moe_routed) x d x 6).  A span's device time is its CUDA
event pair's: the stream's time from its first launch to its last one's
end, the host's wait for the kept sets included.  The prefill's calls are
bound by operations, not bytes, so they read low here."""

from benchmark import peaks


def read(rec):
    w = rec and rec.get("program") and rec["program"]["window"]
    moe = w and w.get("moe")
    if not moe or not moe.get("stream_seconds") or not all(
            k in w for k in ("moe_bytes", "moe_tokens", "moe_routed")):
        return None
    rows = w["moe_tokens"]["value"] + w["moe_routed"]["value"]
    nbytes = w["moe_bytes"]["value"] + rows * rec["d_model"] * 6
    return 100.0 * nbytes / peaks.PEAK_BYTES / moe["stream_seconds"]
