"""host_share.batch: percent of the untraced calls' wall outside the
encoder and window-decode spans (the PCM upload, stream prep, prompts and
segment assembly)."""


def read(rec):
    if not rec or rec["window_s"] <= 0:
        return None
    inside = sum(rec["spans"].get(n, {"seconds": 0.0})["seconds"]
                 for n in ("encode", "decode"))
    return 100.0 * (rec["window_s"] - inside) / rec["window_s"]
