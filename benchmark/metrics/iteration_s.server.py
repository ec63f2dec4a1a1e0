"""iteration_s.server: the window's wall over the engine iterations
counted in it by the engine's iteration_hook (in the traced run: up to
the start of the device trace)."""


def read(rec):
    if not rec or rec["iterations"] <= 0:
        return None
    return rec["window_s"] / rec["iterations"]
