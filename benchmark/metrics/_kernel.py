"""Shared arithmetic of the roofline readers."""

from __future__ import annotations


def roofline(rec: dict, name: str, module) -> float | None:
    """Percent of the least time the card could take for the kernel's
    traced calls (their shapes' bytes and operations at the data sheet's
    peaks) over the time its calls took in the device trace; None when
    the trace holds none of its calls or the launch record and the trace
    disagree on their number."""
    if not rec or not rec.get("trace"):
        return None
    launched = rec["kernels"].get(name)
    runs = [kv for kname, kv in rec["trace"]["kernels"].items()
            if module.KERNEL in kname]
    calls = sum(kv[0] for kv in runs)
    seconds = sum(kv[1] for kv in runs)
    if not launched or calls != launched["calls"] or seconds <= 0:
        return None
    return 100.0 * launched["bound_s"] / seconds
