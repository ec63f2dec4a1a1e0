"""encode_ms.batch: milliseconds of the encoder span (device mel, encode
and cross_kv_q8, fenced) per 30 s window slot encoded, over the
window's untraced calls."""


def read(rec):
    s = rec and rec["spans"].get("encode")
    if not s or s["value"] <= 0:
        return None
    return 1e3 * s["seconds"] / s["value"]
