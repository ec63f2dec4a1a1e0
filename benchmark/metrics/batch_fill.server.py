"""batch_fill.server: mean over the engine iterations (in the traced run,
those before the device trace) of the rows each decoded over the batch,
in percent."""


def read(rec):
    s = rec and rec["spans"].get("iterate")
    if not s or s["count"] <= 0:
        return None
    return 100.0 * s["value"] / (s["count"] * rec["batch"])
