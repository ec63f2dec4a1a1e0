"""Pieces every entry uses: the device's description, the launch-shape
record of the kernels whose rooflines are read, the judgement of the
compared numbers against their limits, and freeing the program's state
before the reference runs."""

from __future__ import annotations

import gc
import math

import torch

from . import peaks, tracing


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def fence(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The device's peak of allocated bytes so far in this process."""
    if not is_cuda(device):
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free_memory(device) -> None:
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def readings(gaps: dict, failed: int, failed_name: str) -> dict:
    """The numbers a run can compare: the sample's widest gaps and the
    count of answers that failed or never came."""
    def widest(a):
        return float(a.max()) if len(a) else None
    return {"max_logit_gap": widest(gaps["logit_gap"]),
            "max_logprob_gap": widest(gaps["logprob_gap"]),
            failed_name: float(failed)}


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}


class LaunchShapes:
    """Counts each roofline kernel's launches by shape while the device
    trace is on, by wrapping the kernel library's entry-point call."""

    def __init__(self, rooflines: dict, trace: tracing.DeviceTrace):
        self.rooflines = rooflines
        self.by_entry = {mod.ENTRY: name for name, mod in rooflines.items()}
        self.counts: dict = {}
        self.trace = trace
        self.lib = None

    def install(self) -> None:
        from whisper_tpu_torch.ops._build import library
        self.lib = library()
        call = self.lib.call
        rec = self

        def recording(entry, *args):
            name = rec.by_entry.get(entry)
            if name is not None and rec.trace.active:
                key = (name, rec.rooflines[name].shape(args))
                rec.counts[key] = rec.counts.get(key, 0) + 1
            return call(entry, *args)

        self.lib.call = recording

    def restore(self) -> None:
        if self.lib is not None:
            del self.lib.call

    def summary(self) -> dict:
        """{kernel: {"calls", "bound_s": the summed least time of its
        calls at the data sheet's peaks}}."""
        out: dict = {}
        for (name, shape), n in self.counts.items():
            mod = self.rooflines[name]
            nbytes, ops = mod.work(shape)
            s = out.setdefault(name, {"calls": 0, "bound_s": 0.0})
            s["calls"] += n
            s["bound_s"] += n * peaks.bound_s(nbytes, ops, mod.KIND)
        return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number the cell's limits file names, beside its limit; correct
    when none passes its limit (a missing or not-a-number reading
    fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and not math.isnan(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
