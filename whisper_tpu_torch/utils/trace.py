"""The port's in-process tracer: named spans and counters, off by default.

    from whisper_tpu_torch.utils.trace import TRACE
    TRACE.enable()
    bt.transcribe(streams)
    print(TRACE.summary())        # {name: {count, seconds, self_seconds,
    spans = TRACE.drain()         #         value[, stream_seconds]}}
    TRACE.disable()

A span is a `with TRACE.span(name, value)` block in the program; it records
a `Span` (name, start and end on `time.time_ns()`, the clock of
torch.profiler's device events, a number such as the rows or bytes it
handled, the span open on the same thread when it began, the request it
serves and the thread).  `TRACE.count(name, n)` records a counter as a span
of no length whose number is n.  A request id is made where a request
enters the program (`TRACE.request()`) and is carried on the thread; work
handed to another thread carries it with it (`TRACE.origin()`).

With `device=True` a span also records a pair of CUDA events on the
current stream.  Their interval is the stream's time from the block's
first launch to its last one's end: the kernels' time and any gap where
the stream waited for the host to launch, not the device's busy time.
It is read when the spans are read (`drain`, `summary`), after the
program's own readback, so the tracer adds no wait for the device.  Nothing is written to disk.

Off, a span site costs one attribute test and hands back one shared no-op
context: nothing is allocated and no event is recorded.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    """One recorded span (a counter: t0 == t1, its number in `value`)."""

    name: str
    t0: int                  # ns, time.time_ns()
    t1: int
    value: float
    parent: int | None       # id of the span open on the thread at t0
    rid: int | None          # request id
    thread: int
    id: int
    stream_s: object = None  # stream seconds (a CUDA event pair until read)


class _Null:
    """The shared context of every span site while tracing is off."""

    __slots__ = ()
    value = property(lambda self: 1, lambda self, v: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_OPEN = object()     # add()'s parent: the span open on the thread


class _Open:
    """One span while it is open; `value` may be set before it closes."""

    __slots__ = ("tracer", "name", "value", "device", "t0", "id", "parent",
                 "events")

    def __init__(self, tracer, name, value, device):
        self.tracer, self.name, self.value = tracer, name, value
        self.device = device

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        stack.append(self.id)
        self.events = None
        if self.device:
            import torch
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        tr = self.tracer
        tr._stack().pop()
        tr.records.append(Span(self.name, self.t0, t1, self.value,
                               self.parent, tr._rid(), threading.get_ident(),
                               self.id, self.events))
        return False


class _Request:
    """A fresh request id on this thread for the with-block."""

    __slots__ = ("tracer", "prev")

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        tls = self.tracer._tls
        self.prev = getattr(tls, "rid", None)
        tls.rid = next(self.tracer._rids)
        return tls.rid

    def __exit__(self, *exc):
        self.tracer._tls.rid = self.prev
        return False


class Tracer:
    """Spans and counters of every thread, in memory; `TRACE` is the
    program's one instance."""

    def __init__(self):
        self.on = False
        self.records: list[Span] = []
        self._ids = itertools.count(1)
        self._rids = itertools.count(1)
        self._tls = threading.local()
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    # -- recording ---------------------------------------------------------

    def span(self, name: str, value=1, device: bool = False):
        """A context that records the span `name` (its `value` may be set
        inside the block); device: also time the block's device work."""
        if not self.on:
            return _NULL
        return _Open(self, name, value, device)

    def count(self, name: str, n=1) -> None:
        """Add n to the counter `name` (a span of no length)."""
        if self.on:
            t = time.time_ns()
            self.add(name, t, t, n)

    def request(self):
        """A context under which this thread serves a new request."""
        if not self.on:
            return _NULL
        return _Request(self)

    def origin(self) -> tuple:
        """(request id, open span id) for work this thread hands to
        another: its request, or a new one; (None, None) when off."""
        if not self.on:
            return None, None
        stack = self._stack()
        return (self._rid() or next(self._rids),
                stack[-1] if stack else None)

    def add(self, name: str, t0: int, t1: int, value=1, parent=_OPEN,
            rid=None) -> int | None:
        """Record a span from its stamps (time.time_ns()), under `parent`
        (by default the span open on this thread); -> its id (None when
        off)."""
        if not self.on:
            return None
        if parent is _OPEN:
            stack = self._stack()
            parent = stack[-1] if stack else None
        sid = next(self._ids)
        self.records.append(Span(name, t0, t1, value, parent,
                                 rid if rid is not None else self._rid(),
                                 threading.get_ident(), sid))
        return sid

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _rid(self):
        return getattr(self._tls, "rid", None)

    # -- reading -----------------------------------------------------------

    def _read(self) -> list[Span]:
        """The records, each device span's event pair read into seconds."""
        with self._lock:
            recs = self.records
            for i, r in enumerate(recs):
                if isinstance(r.stream_s, tuple):
                    e0, e1 = r.stream_s
                    e1.synchronize()
                    recs[i] = r._replace(
                        stream_s=e0.elapsed_time(e1) / 1e3)
            return list(recs)

    def drain(self) -> list[Span]:
        """Every record so far, which the tracer then forgets."""
        recs = self._read()
        with self._lock:
            del self.records[:len(recs)]
        return recs

    def summary(self, intervals: list | None = None) -> dict:
        """Per name, over the records that lie within one of the intervals
        [(t0_ns, t1_ns), ...] (all of them when None): count, seconds,
        self_seconds (seconds less the time of their child spans), the sum
        of their values and, for device spans, stream_seconds (the CUDA
        events' intervals)."""
        recs = self._read()
        children: dict = {}
        for r in recs:
            if r.parent is not None:
                children[r.parent] = children.get(r.parent, 0) + r.t1 - r.t0
        out: dict = {}
        for r in recs:
            if intervals is not None and not any(
                    r.t0 >= a and r.t1 <= b for a, b in intervals):
                continue
            s = out.setdefault(r.name, {"count": 0, "seconds": 0.0,
                                        "self_seconds": 0.0, "value": 0.0})
            s["count"] += 1
            s["seconds"] += (r.t1 - r.t0) / 1e9
            s["self_seconds"] += (r.t1 - r.t0 - children.get(r.id, 0)) / 1e9
            s["value"] += r.value
            if r.stream_s is not None:
                s["stream_seconds"] = (s.get("stream_seconds", 0.0)
                                       + r.stream_s)
        return out


TRACE = Tracer()
