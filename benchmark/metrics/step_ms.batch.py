"""step_ms.batch: milliseconds of the window-decode span (prompt pass and
token loop) per decode step it took, over the
window's untraced calls."""


def read(rec):
    s = rec and rec["spans"].get("decode")
    if not s or s["value"] <= 0:
        return None
    return 1e3 * s["seconds"] / s["value"]
