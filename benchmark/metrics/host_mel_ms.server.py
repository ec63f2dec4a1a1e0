"""host_mel_ms.server: milliseconds of the host log-mel (the engine's
stream prep, `log_mel_spectrogram`) per admitted request, over the
window up to the device trace."""


def read(rec):
    s = rec and rec["spans"].get("mel")
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["seconds"] / s["count"]
