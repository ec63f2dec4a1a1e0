"""Spans around calls into the program, the device trace, and their
reduction to what the per-layer metrics read.

Spans come from the benchmark's own wrappers: a wrapper replaces a module
or instance attribute of the program for the traced run and records the
call's name, its start and end (time.time_ns(), the clock of the
profiler's events) and a number taken from its arguments or result.
The device trace is torch.profiler with device activity only, started and
stopped around whole iterations; its events are reduced in memory, and
no trace file is written.
"""

from __future__ import annotations

import bisect
import os
import threading
import time


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Spans:
    """Named intervals of host time, recorded by wrappers."""

    def __init__(self):
        self.records: list = []        # (name, t0_ns, t1_ns, value)
        self._undo: list = []
        self._lock = threading.Lock()
        self.fence = None              # called before a fenced span ends

    def wrap(self, obj, attr: str, name: str, value=None,
             fenced: bool = False) -> None:
        """Record every call of obj.attr as a span `name`; value(args,
        kwargs, result) gives the span's number.  fenced: wait for the
        device before the span ends, so the call's device work is its."""
        orig = getattr(obj, attr)
        spans = self

        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            out = orig(*args, **kwargs)
            if fenced and spans.fence is not None:
                spans.fence()
            t1 = time.time_ns()
            v = value(args, kwargs, out) if value is not None else 1
            with spans._lock:
                spans.records.append((name, t0, t1, v))
            return out

        had = attr in vars(obj) if hasattr(obj, "__dict__") else True
        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, orig, had))

    def restore(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def named(self, name: str, t0_ns: int | None = None,
              t1_ns: int | None = None) -> list:
        """The spans `name` that lie within [t0_ns, t1_ns]."""
        return [r for r in self.records if r[0] == name
                and (t0_ns is None or r[1] >= t0_ns)
                and (t1_ns is None or r[2] <= t1_ns)]

    def summary(self, intervals: list) -> dict:
        """Per name, over the spans that lie within one of the intervals
        [(t0_ns, t1_ns), ...]: count, seconds, the sum of their numbers."""
        out: dict = {}
        for name, a, b, v in self.records:
            if any(a >= t0 and b <= t1 for t0, t1 in intervals):
                s = out.setdefault(name, {"count": 0, "seconds": 0.0,
                                          "value": 0.0})
                s["count"] += 1
                s["seconds"] += (b - a) / 1e9
                s["value"] += v
        return out


class DeviceTrace:
    """torch.profiler over device activity, on from start() to stop()
    (host times kept), reduced by `reduce_trace`."""

    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        """End the trace; its events are read later (device_events), off
        the thread that runs the program."""
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1_ns is None

    @property
    def done(self) -> bool:
        return self.t1_ns is not None

    def device_events(self) -> list:
        """[(start_ns, end_ns, name)] of every device activity (kernels,
        copies, sets) inside the traced window, by start."""
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        out = [(e.start_ns(), e.end_ns(), e.name()) for e in events
               if e.device_type() == DeviceType.CUDA]
        return sorted(x for x in out
                      if x[1] > self.t0_ns and x[0] < self.t1_ns)


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class _Innermost:
    """For rising times t, the innermost of nested spans (name, t0, t1, v)
    that contains t."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.next = 0
        self.stack: list = []

    def at(self, t: int):
        while self.next < len(self.spans) and self.spans[self.next][1] <= t:
            s = self.spans[self.next]
            while self.stack and self.stack[-1][2] <= s[1]:
                self.stack.pop()
            self.stack.append(s)
            self.next += 1
        while self.stack and self.stack[-1][2] <= t:
            self.stack.pop()
        return self.stack[-1] if self.stack else None


def reduce_trace(trace: DeviceTrace, spans: Spans, gap_names: tuple,
                 count_in: tuple = ()) -> dict:
    """What the device did in the traced window, and what the host did
    while it idled.

    -> busy_s (the union of device activity), window_s, kernels {name:
    [count, seconds]} (copies and sets included), the idle seconds by the
    innermost span of `gap_names` that held the host at each gap's start
    ("outside spans" where none), and for each name of `count_in` the
    device activities that started inside its spans and the spans' sum
    of numbers in the window."""
    w0, w1 = trace.t0_ns, trace.t1_ns
    evs = trace.device_events()
    clipped = [(max(a, w0), min(b, w1)) for a, b, _ in evs]
    merged = _union(clipped)
    busy = sum(b - a for a, b in merged)
    kernels: dict = {}
    for a, b, name in evs:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e9
    host = _Innermost([r for r in spans.records if r[0] in gap_names
                       and r[2] > w0 and r[1] < w1])
    idle: dict = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        s = host.at(g0)
        key = s[0] if s is not None else "outside spans"
        idle[key] = idle.get(key, 0.0) + (g1 - g0) / 1e9
    starts = [a for a, _, _ in evs]
    inside = {}
    for name in count_in:
        n_ev, value, n = 0, 0.0, 0
        for _, a, b, v in spans.named(name, w0, w1):
            n_ev += bisect.bisect_left(starts, b) - bisect.bisect_left(starts,
                                                                       a)
            value += v
            n += 1
        inside[name] = {"spans": n, "events": n_ev, "value": value}
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": kernels, "idle_by_span": idle, "inside": inside}


def log_trace(red: dict) -> None:
    """One line on standard error about the traced window."""
    import sys
    n = sum(k[0] for k in red["kernels"].values())
    print(f"trace: {n} device operations, busy {red['busy_s']:.4f} s of "
          f"{red['window_s']:.4f} s; inside {red['inside']}", file=sys.stderr)


def breakdown(red: dict, top: int = 10) -> dict:
    """The traced window's ten costliest device operations and the host
    spans that held the ten largest shares of its idle time."""
    ops = sorted(((name, kv[1]) for name, kv in red["kernels"].items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(red["idle_by_span"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
