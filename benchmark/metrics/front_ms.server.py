"""front_ms.server: milliseconds a request spent outside the batched
worker's submit (multipart parsing, the WAV written to TMPDIR and read
back, the response's formatting and the socket): the mean client
latency from send to last byte minus the mean submit span, over the
requests the record's interval holds."""


def read(rec):
    s = rec and rec["spans"].get("submit")
    client = rec and rec["client_s"]
    if not s or not client:
        return None
    return 1e3 * (sum(client) / len(client) - s["seconds"] / s["count"])
