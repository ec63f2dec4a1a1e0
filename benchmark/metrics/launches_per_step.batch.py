"""launches_per_step.batch: device operations that started inside the
window-decode spans of the traced call, per decode step."""


def read(rec):
    t = rec and rec.get("trace")
    d = t and t["inside"].get("decode")
    if not d or d["value"] <= 0:
        return None
    return d["events"] / d["value"]
