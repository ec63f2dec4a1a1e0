"""One thread a rank that runs every collective of the work done over a
tensor-parallel mesh (the context's `mesh` with n_data = n_slice = 1;
parallel/mesh.py): the scheduler of ContinuousBatcher over a mesh, and of
the server's engines and serial requests (server.py).

Every rank builds the same context, attaches the mesh, constructs the same
engines with the same arguments and starts its Conductor.  On rank 0 the
conductor thread takes, in its own order, each request (handed to an
engine, or run as a serial full()) and each busy engine's next iteration,
and before each piece of work broadcasts one plan naming it on the mesh's
host group; every other rank's conductor thread replays the plans in
order, so the model's collectives pair up and every rank's engines and
states move in lockstep:

  {"op": "engine", "params", "warmup"}  make the engine of a signature
  {"op": "iterate", "sig", "admit", "batch"}  one iteration of an engine
                                      (the PCM of the streams it admitted
                                      this cycle, the batch's indices)
  {"op": "full", "params", "pcm"}  a serial full()
  {"op": "idle"}  a wakeup with no work: one a IDLE_S, so no rank waits in
                  a collective for longer
  None  close: every rank's engines end; the threads return

Plans carry no callables: FullParams' callbacks are stripped, and a
streaming request's on_segment runs on rank 0 only.  Around each piece of
work every rank all-reduces a failure flag (an engine's, before and after
its iteration; after an engine's construction and a serial full()): a
failure on any rank fails that request, or that iteration's jobs, on every
rank alike, and the conductor goes on.  A rank lost, or raising, between
two of the model's collectives is not recovered.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
import traceback

import torch

from ..utils.logging import log_error

# FullParams' callbacks: a plan carries none of them (they run on rank 0)
_CALLBACKS = ("new_segment_callback", "progress_callback",
              "encoder_begin_callback", "abort_callback",
              "logits_filter_callback")
# ...and these change what the decode does, so the other ranks could not
# follow it: refused over a mesh
_STEERING = ("encoder_begin_callback", "abort_callback",
             "logits_filter_callback")


def plain(params):
    """A copy of `params` without its callbacks: what a plan carries."""
    return dataclasses.replace(params, **{f: None for f in _CALLBACKS})


def full_streaming(ctx, params, pcm, state=None, on_segment=None) -> int:
    """ctx.full(params, pcm, state=state), calling on_segment(Segment) for
    each segment as full() makes it (through params.new_segment_callback,
    cleared after) and for any left at the end -> full()'s return code."""
    if on_segment is None:
        return ctx.full(params, pcm, state=state)
    n_seen = 0

    def emit(st, n_new=0, _=None):
        nonlocal n_seen
        while n_seen < len(st.result_all):
            on_segment(st.result_all[n_seen])
            n_seen += 1

    params.new_segment_callback = emit
    try:
        rc = ctx.full(params, pcm, state=state)
    finally:
        params.new_segment_callback = None
    if rc == 0:
        emit(ctx._default_state if state is None else state)
    return rc


class _Request:
    """One request waiting on the conductor: `done` is set once it is
    answered (segments, lang_id or error) or handed to an engine (job)."""

    __slots__ = ("pcm", "params", "on_segment", "done", "job", "segments",
                 "lang_id", "error")

    def __init__(self, pcm, params, on_segment):
        self.pcm, self.params, self.on_segment = pcm, params, on_segment
        self.done = threading.Event()
        self.job = self.segments = self.error = None
        self.lang_id = 0


class Conductor:
    """The one thread a rank that runs every collective over the mesh of
    `ctx` (see the module).

    engines: signature -> ContinuousBatcher, the caller's dict; the
    conductor runs their iterations and adds the engines its "engine"
    plans make.  router: rank 0's routing and every rank's engine
    construction, or None (every request a serial full()):
    router.route(params, make) -> the engine that carries a request (made
    through make(params), an "engine" plan, when its signature has none
    and there is room) or None (a serial full()), and
    router.new_engine(params, warmup), which makes and registers the
    engine of a signature.  state: the WhisperState serial requests decode
    into, carried from request to request (the serial server's: the
    context's own, as its full() without a mesh), or None: a fresh one a
    request.  A request that fails on any rank leaves the carried prompt
    and language as it found them, on every rank alike.

    Construct it on every rank with the same arguments, then start() it.
    `n_plans` and `plan_digest` (a running hash of each plan's outcome) are
    equal on every rank that kept in step; `sync_s` holds rank 0's host
    seconds in plan broadcasts ("plan"), idle plans ("idle", n_idle of
    them) and failure flags ("flags": the wait for the slowest rank's work
    included).
    """

    IDLE_S = 0.25

    def __init__(self, ctx, engines: dict | None = None, router=None,
                 state=None):
        self.ctx, self.mesh, self.router, self.state = (ctx, ctx.mesh,
                                                        router, state)
        self.engines = {} if engines is None else engines
        self.leader = not any(self.mesh.coords.values())
        self.inbox: "queue.Queue[_Request | None]" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.n_plans = self.n_idle = 0
        self.plan_digest = ""
        # called as plan_hook(plan) on every rank before a plan runs (rank
        # 0: before it is sent): lets tests and metrics observe each plan
        self.plan_hook = None
        self.sync_s = {"plan": 0.0, "flags": 0.0, "idle": 0.0}
        # the current CUDA device is per thread, and the kernels launch on
        # it: the thread takes the context's (or its constructor's)
        dev = ctx.device
        self._cuda_index = None if dev.type != "cuda" else (
            torch.cuda.current_device() if dev.index is None else dev.index)
        self.thread: threading.Thread | None = None

    def start(self) -> None:
        """Start this rank's thread: rank 0 schedules, the others replay
        its plans."""
        self.thread = threading.Thread(
            target=self._main, daemon=True, name="conductor",
            args=(self._lead if self.leader else self._follow,))
        self.thread.start()

    # -- rank 0's requests -------------------------------------------------

    def submit(self, pcm, params, on_segment=None):
        """Blocks until the request is answered -> (segments, lang_id);
        on_segment(Segment) is called for each segment as it is made."""
        steer = [f for f in _STEERING if getattr(params, f) is not None]
        if steer:
            raise ValueError(f"{', '.join(steer)} over a mesh: the other "
                             "ranks cannot follow a decode that a callback "
                             "on rank 0 changes")
        if not self.leader:
            raise RuntimeError("requests enter the server on rank 0 of the "
                               "mesh; this rank replays its plans")
        req = _Request(pcm, params, on_segment)
        with self._lock:
            if self._closed:
                raise RuntimeError("the mesh's conductor is closed")
            self.inbox.put(req)
        req.done.wait()
        if req.job is not None:
            req.job.done.wait()
            if req.job.error is not None:
                raise RuntimeError(req.job.error)
            return list(req.job.st.result_all), req.job.st.full_lang_id()
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.segments, req.lang_id

    def wake(self) -> None:
        """Rank 0: a job was queued on an engine; schedule it now."""
        self.inbox.put(None)

    def close(self) -> None:
        """Rank 0: answer what is queued and running, then send the close
        plan (every rank's engines end) and end the thread.  The other
        ranks wait here for that plan."""
        with self._lock:
            self._closed = True
        if self.thread is None:
            return
        if self.leader:
            self.inbox.put(None)   # wake the thread
        self.thread.join()

    def follow(self) -> None:
        """A rank other than 0: block until rank 0's close plan ends the
        replay of its plans."""
        if self.leader:
            raise RuntimeError("rank 0 serves the requests; the other ranks "
                               "follow it")
        self.thread.join()

    # -- the thread --------------------------------------------------------

    def _main(self, body) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        with torch.no_grad():   # grad mode is thread-local
            body()

    def _hooks(self) -> None:
        """Each engine's iteration_hook(n_iterations): at the top of every
        cycle on rank 0, as each plan arrives elsewhere."""
        for eng in list(self.engines.values()):
            hook = eng.iteration_hook
            if hook is not None:
                hook(eng.n_iterations)

    def _lead(self) -> None:
        while True:
            self._hooks()
            # the waiting requests first, in order: each goes to an
            # engine's queue or runs here as a serial full()
            while True:
                try:
                    req = self.inbox.get_nowait()
                except queue.Empty:
                    break
                self._route(req)
            # then one iteration of each busy engine
            ran = False
            for sig, eng in list(self.engines.items()):
                plan = eng.schedule()
                if plan is not None:
                    self._run({"op": "iterate", "sig": sig, **plan})
                    ran = True
            if ran:
                continue
            if self._closed and self.inbox.empty():
                break
            try:
                req = self.inbox.get(timeout=self.IDLE_S)
            except queue.Empty:
                self._run({"op": "idle"})
                continue
            self._route(req)
        self._run(None)
        while True:   # anything queued after the close
            try:
                req = self.inbox.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = "the mesh's conductor is closed"
                req.done.set()

    def _follow(self) -> None:
        while True:
            plan = self.mesh.broadcast_object()
            if plan is not None:
                self._hooks()
            self._run(plan)
            if plan is None:
                return

    def _route(self, req: _Request | None) -> None:
        """Rank 0: hand `req` to an engine (made by a plan if need be),
        else run it as a serial full()."""
        if req is None:   # a wakeup
            return
        eng = None
        if self.router is not None:
            eng = self.router.route(req.params,
                                    lambda p: self._make_engine(p, req))
        if req.done.is_set():   # its engine failed on some rank
            return
        if eng is not None:
            req.job = eng.submit_async(req.pcm, on_segment=req.on_segment)
            req.done.set()
            return
        self._run({"op": "full", "params": plain(req.params),
                   "pcm": req.pcm}, req)

    def _make_engine(self, params, req: _Request):
        """Rank 0: the engine plan of params' signature -> the engine, or
        None if it failed on some rank (req answered)."""
        eng = self._run({"op": "engine", "params": plain(params),
                         "warmup": False}, req)
        return None if req.done.is_set() else eng

    # -- plans, on every rank ----------------------------------------------

    def _run(self, plan: dict | None, req: _Request | None = None):
        """Run one plan (on rank 0 send it first; `req` is the request it
        serves there) -> an engine plan's engine."""
        hook = self.plan_hook
        if hook is not None:
            hook(plan)
        if self.leader:
            t0 = time.perf_counter()
            self.mesh.broadcast_object(plan)
            idle = plan is not None and plan["op"] == "idle"
            self.sync_s["idle" if idle else "plan"] += time.perf_counter() - t0
        self.n_plans += 1
        eng = None
        if plan is None:
            outcome = ("close",)
            with self._lock:
                self._closed = True
            for e in self.engines.values():
                e._finish()
            self.engines.clear()
        elif plan["op"] == "idle":
            outcome = ("idle",)
            self.n_idle += 1
        elif plan["op"] == "iterate":
            e = self.engines[plan["sig"]]
            e.run(plan)
            outcome = ("iterate", plan["sig"], plan["batch"], e.plan_digest)
        elif plan["op"] == "engine":
            eng = self._new_engine(plan, req)
            outcome = ("engine", eng is not None)
        else:
            outcome = ("full", self._full(plan, req))
        h = hashlib.sha1(self.plan_digest.encode())
        h.update(repr(outcome).encode())
        self.plan_digest = h.hexdigest()
        return eng

    def any_rank(self, failed: bool) -> bool:
        """Whether any rank failed: a MAX all-reduce of the flag (its time
        in sync_s["flags"] on rank 0)."""
        t0 = time.perf_counter()
        failed = self.mesh.any_rank(failed)
        if self.leader:
            self.sync_s["flags"] += time.perf_counter() - t0
        return failed

    def _failed(self, error: str | None, req: _Request | None,
                what: str) -> bool:
        """any_rank(error is not None); on rank 0 a failure answers `req`
        with this rank's error, or `what` failed on another rank."""
        failed = self.any_rank(error is not None)
        if failed and req is not None:
            req.error = error or f"{what} failed on another rank"
            req.done.set()
        return failed

    def _new_engine(self, plan: dict, req: _Request | None):
        eng, error = None, None
        try:
            eng = self.router.new_engine(plan["params"], plan["warmup"])
        except Exception as e:  # noqa: BLE001 - fail the request only
            log_error("conductor: engine construction failed:\n"
                      + traceback.format_exc())
            error = f"engine construction failed: {e}"
        if self._failed(error, req, "engine construction"):
            for sig, e in list(self.engines.items()):
                if e is eng:
                    del self.engines[sig]
                    e._finish()
            return None
        return eng

    def _full(self, plan: dict, req: _Request | None):
        """A serial full(): on rank 0 with the request's own params (its
        callbacks), answering it; elsewhere with the plan's, the result
        discarded.  -> the segments' tokens, or None if it failed on any
        rank."""
        params = plan["params"] if req is None else req.params
        state = self.ctx.init_state() if self.state is None else self.state
        carried = (list(state.prompt_past), state.lang_id_state)
        error = None
        try:
            if full_streaming(self.ctx, params, plan["pcm"], state,
                              None if req is None else req.on_segment) != 0:
                error = "failed to process audio"
        except Exception as e:  # noqa: BLE001 - fail the request only
            log_error("conductor: full() failed:\n" + traceback.format_exc())
            error = str(e)
        if self._failed(error, req, "the request"):
            # where each rank stopped may differ: every rank takes the
            # carried context back to where the request found it
            state.prompt_past, state.lang_id_state = carried
            return None
        if req is not None:
            req.segments = list(state.result_all)
            req.lang_id = state.full_lang_id()
            req.done.set()
        return [(s.t0, s.t1, [t.id for t in s.tokens])
                for s in state.result_all]
