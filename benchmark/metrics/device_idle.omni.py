"""device_idle.omni: percent of the traced window round's wall in which
no operation ran on the device (torch.profiler's device activity, as a
union)."""


def read(rec):
    t = rec and rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
