"""Rank bodies for tests/test_torch_mesh.py,
tests/test_torch_mesh_continuous.py and tests/test_torch_mesh_server.py.

Each rank is a process of its own, started by `spawn` (which imports this
module, not the test module: a rank imports torch and the port only).  It
builds its mesh over gloo on the CPU with a file:// rendezvous, runs one
job and pickles what the job returns, or the traceback, to out_dir.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, rdv: str, shape: tuple, job: str,
        kwargs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    from whisper_tpu_torch.parallel.mesh import make_mesh
    try:
        n_data, n_model, n_slice = shape
        mesh = make_mesh(n_data, n_model, n_slice, device="cpu",
                         init_method=f"file://{rdv}", world_size=world,
                         rank=rank)
        try:
            result = {"ok": JOBS[job](mesh, **kwargs),
                      "coords": mesh.coords}
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the test
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _params(overrides: dict):
    from whisper_tpu_torch.api import SamplingStrategy, full_default_params
    beam = overrides.pop("beam_size", 0)
    best_of = overrides.pop("best_of", 0)
    p = full_default_params(SamplingStrategy.BEAM_SEARCH if beam
                            else SamplingStrategy.GREEDY)
    if beam:
        p.beam_search.beam_size = beam
    if best_of:
        p.greedy.best_of = best_of
    p.print_progress = False
    for k, v in overrides.items():
        setattr(p, k, v)
    return p


def segments(result) -> list:
    """(t0, t1, token ids, t_dtw) of each segment of each stream."""
    return [[(s.t0, s.t1, tuple(t.id for t in s.tokens),
              tuple(t.t_dtw for t in s.tokens)) for s in segs]
            for segs in result]


def load(path: str, ctx_kwargs: dict, device="cpu"):
    from whisper_tpu_torch.api import WhisperContext
    return WhisperContext.from_file(path, compute_dtype=torch.float32,
                                    device=device, **ctx_kwargs)


def job_batch(mesh, path, streams, overrides, ctx_kwargs=None,
              batch_size=4, serial=True):
    """BatchTranscriber over the mesh, then a serial full() of stream 0
    on the mesh-attached context."""
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    ctx = load(path, ctx_kwargs or {})
    bt = BatchTranscriber(ctx, batch_size=batch_size,
                          params=_params(dict(overrides)), mesh=mesh)
    out = {"batch": segments(bt.transcribe(streams)),
           "heads": int(ctx.params["decoder"]["blocks"]["q_w"].shape[1])}
    if serial:
        assert ctx.full(_params(dict(overrides)), streams[0]) == 0
        out["serial"] = segments([ctx.result_all])[0]
    return out


def job_encode(mesh, path, mel, impls):
    """encode() of this rank's mel rows over sharded params, and the
    replicated encode of every row, in each attention impl."""
    from whisper_tpu_torch.models import whisper as wm
    from whisper_tpu_torch.parallel.mesh import row_slice, shard_params
    ctx = load(path, {})
    nh = ctx.config.n_audio_head
    sl = row_slice(mesh, len(mel)) or slice(None)
    whole = ctx.params
    sharded = shard_params(whole, mesh)
    out = {}
    with torch.no_grad():
        for impl in impls:
            ref = wm.encode(whole, torch.from_numpy(mel), nh,
                            torch.float32, attn_impl=impl).numpy()
            got = wm.encode(sharded, torch.from_numpy(mel[sl]), nh,
                            torch.float32, attn_impl=impl).numpy()
            out[impl] = float(np.abs(got - ref[sl]).max())
    return out


def job_dryrun(mesh):
    from whisper_tpu_torch.parallel.mesh import dryrun_multichip
    return dryrun_multichip(mesh)


def drive(cb, streams, late, after_idle, idle_s: float = 1.5,
          timeout: float = 180.0):
    """The continuous engine's scenario, on whisper_tpu's ContinuousBatcher
    or the port's (rank 0 of a mesh): `streams` queued together (the
    iteration hook holds the engine until they are), `late` submitted from
    the hook after the first iteration, while they decode; then, once
    every job has finished and the engine has idled for idle_s, `after_idle`
    alone.  -> ((t0, t1, token ids) of each segment of each job, and each
    job's (iter_joined, iter_done), in submit order: the late job last but
    one)."""
    parked, go = threading.Event(), threading.Event()
    late_job = []
    prev = cb.iteration_hook

    def hook(n):
        if prev is not None:
            prev(n)
        parked.set()
        go.wait(timeout)
        if n == 1 and not late_job:
            late_job.append(cb.submit_async(late))

    cb.iteration_hook = hook
    assert parked.wait(timeout), "the engine never reached its hook"
    jobs = [cb.submit_async(pcm) for pcm in streams]
    go.set()
    end = time.monotonic() + timeout
    while not late_job and time.monotonic() < end:
        time.sleep(0.01)
    jobs += late_job
    for j in jobs:
        assert j.done.wait(max(0.0, end - time.monotonic())), "a job hung"
    time.sleep(idle_s)
    jobs.append(cb.submit_async(after_idle))
    assert jobs[-1].done.wait(timeout), "the job after the idle gap hung"
    for j in jobs:
        assert j.error is None, j.error
    return ([[(s.t0, s.t1, tuple(t.id for t in s.tokens))
              for s in j.st.result_all] for j in jobs],
            [(j.iter_joined, j.iter_done) for j in jobs])


def job_engine(mesh, path, streams, late, after_idle, overrides,
               device_mel=False):
    """ContinuousBatcher over a tensor-parallel mesh: rank 0 drives the
    scenario (`drive`), a follower checks that it takes no request; every
    rank records its plan digest at each iteration and closes."""
    from whisper_tpu_torch.parallel.batch import (BatchTranscriber,
                                                  ContinuousBatcher)
    ctx = load(path, {})
    BatchTranscriber(ctx, batch_size=4, params=_params(dict(overrides)),
                     mesh=mesh)
    cb = ContinuousBatcher(ctx, batch_size=4, params=_params(dict(overrides)),
                           device_mel=device_mel)
    digests = []

    def record(n):   # the digest of iterations 0..n-1
        if n and (not digests or digests[-1][0] != n):
            digests.append((n, cb.plan_digest))

    cb.iteration_hook = record
    out = {"leader": cb.leader}
    try:
        if cb.leader:
            out["segments"], out["iters"] = drive(cb, streams, late,
                                                  after_idle)
            out["pool"] = cb._pool is not None
        else:
            for submit in (cb.submit, cb.submit_async):
                try:
                    submit(streams[0])
                except RuntimeError as e:
                    out.setdefault("refused", []).append(str(e))
    finally:
        cb.close()
    record(cb.n_iterations)
    out.update(digests=digests, iterations=cb.n_iterations,
               alive=cb.thread.is_alive(), n_idle=cb.conductor.n_idle,
               sync_s=cb.conductor.sync_s)
    return out


def job_engine_faults(mesh, path, pcm, overrides):
    """ContinuousBatcher over a tensor-parallel mesh whose follower ranks
    fail once to admit a stream, then once raise after an iteration (its
    collectives done): rank 0 submits three times; -> each submit's error
    (None for the last), on rank 0, and every rank's iteration count."""
    from whisper_tpu_torch.parallel.batch import (BatchTranscriber,
                                                  ContinuousBatcher)
    ctx = load(path, {})
    BatchTranscriber(ctx, batch_size=4, params=_params(dict(overrides)),
                     mesh=mesh)
    cb = ContinuousBatcher(ctx, batch_size=4, params=_params(dict(overrides)))
    faults = ["admit", "iterate"]
    make, iterate = cb.bt._make_stream, cb.bt._iterate

    def bad_make(pcm):
        if faults and faults[0] == "admit":
            faults.pop(0)
            raise MemoryError("no room")
        return make(pcm)

    def bad_iterate(*args):
        iterate(*args)
        if faults and faults[0] == "iterate":
            faults.pop(0)
            raise RuntimeError("late fault")

    if not cb.leader:
        cb.bt._make_stream, cb.bt._iterate = bad_make, bad_iterate
    errors = []
    try:
        if cb.leader:
            for _ in range(3):
                job = cb.submit_async(pcm)
                assert job.done.wait(180), "a job hung"
                errors.append(job.error)
    finally:
        cb.close()
    return {"errors": errors, "iterations": cb.n_iterations,
            "active": len(cb.active), "alive": cb.thread.is_alive()}


def job_engine_refused(mesh, path, overrides):
    """ContinuousBatcher over a data-parallel mesh: the constructor's
    NotImplementedError, on every rank."""
    from whisper_tpu_torch.parallel.batch import (BatchTranscriber,
                                                  ContinuousBatcher)
    ctx = load(path, {})
    BatchTranscriber(ctx, batch_size=4, params=_params(dict(overrides)),
                     mesh=mesh)
    try:
        ContinuousBatcher(ctx, batch_size=4, params=_params(dict(overrides)))
    except NotImplementedError as e:
        return str(e)
    raise AssertionError("ContinuousBatcher took a data-parallel mesh")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(port, path, body=None, headers=None, timeout=600):
    """-> (status, content type, body)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def multipart(wav: bytes, fields: dict) -> tuple[bytes, dict]:
    boundary = "meshboundary"
    parts = [(f"--{boundary}\r\nContent-Disposition: form-data; "
              f'name="file"; filename="a.wav"\r\n\r\n').encode() + wav]
    for k, v in fields.items():
        parts.append((f"--{boundary}\r\nContent-Disposition: form-data; "
                      f'name="{k}"\r\n\r\n{v}').encode())
    body = b"\r\n".join(parts) + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type":
                  f'multipart/form-data; boundary="{boundary}"'}


def run_steps(port, steps, wavs, control=None) -> dict:
    """A server scenario, on whisper_tpu's server or the port's: each step
    is a list of requests (name, path, form fields, WAV name) sent at once
    (a /load's fields are its JSON body), or ("control", arg), handed to
    control(arg) between requests.  -> {name: (status, type, body)}."""
    out = {}
    for step in steps:
        if step[0] == "control":
            if control is not None:
                control(step[1])
            continue

        def send(req):
            name, path, fields, wav = req
            if wav is None:
                return http(port, path, json.dumps(fields).encode())
            return http(port, path, *multipart(wavs[wav], fields))

        with ThreadPoolExecutor(len(step)) as pool:
            for req, res in zip(step, pool.map(send, step)):
                out[req[0]] = res
    return out


def job_server(mesh, path, mode, steps, wavs, fault_len):
    """The port's server over a tensor-parallel mesh: every rank attaches
    the mesh and calls server.install (serial, or --batch 2); rank 0 serves
    Handler on a free port and runs `steps` against it (run_steps), the
    other ranks check that their worker refuses a request, then follow()
    until rank 0 closes its worker or loads another model.  Rank 1 fails
    once the plan that carries PCM of fault_len samples: an engine's
    iteration after its collectives, or a serial full() partway, where
    the window's collectives are done and its prompt not yet carried on.
    Every rank logs each plan (op and engine number), the prompt carried
    into each serial full() and the names of the live threads, and
    reports its plan count and digest; a ("control", "past") step records
    rank 0's carried prompt."""
    from http.server import ThreadingHTTPServer

    import whisper_tpu_torch.server as srv
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    ctx = load(path, {})
    BatchTranscriber(ctx, batch_size=2, mesh=mesh)
    srv.install(ctx, path, batch=2 if mode == "batch2" else 0, warmup=False)
    worker = srv._worker()
    cond = worker if mode == "serial" else worker.conductor
    out = {"leader": cond.leader, "plans": [], "threads": set(),
           "engines": 0, "pasts": []}
    sigs: dict = {}
    armed = {"fault": mesh.coords["model"] == 1}

    def fail_once(obj, name, after):
        orig = getattr(obj, name)

        def bad(*args, **kwargs):
            delattr(obj, name)
            if after:
                orig(*args, **kwargs)
            raise RuntimeError("injected fault")
        setattr(obj, name, bad)

    def hook(plan):
        out["threads"].update(t.name for t in threading.enumerate())
        if plan is None:
            out["plans"].append(("close",))
            return
        op = plan["op"]
        sig = plan.get("sig") or (srv._BatchWorker._signature(plan["params"])
                                  if op == "engine" else None)
        out["plans"].append((op, sigs.setdefault(sig, len(sigs)))
                            if sig is not None else (op,))
        if op == "full":
            out["pasts"].append(list(ctx._default_state.prompt_past))
        if worker is not cond:
            out["engines"] = max(out["engines"], len(worker.engines))
            assert all(e.thread is None for e in worker.engines.values())
        if armed["fault"] and op == "iterate" and any(
                len(pcm) == fault_len for pcm in plan["admit"]):
            fail_once(worker.engines[plan["sig"]].bt, "_iterate", True)
            armed["fault"] = False
        elif (armed["fault"] and op == "full"
              and len(plan["pcm"]) == fault_len):
            fail_once(ctx, "_emit_segments", False)
            armed["fault"] = False

    cond.plan_hook = hook
    if cond.leader:
        port = free_port()
        httpd = ThreadingHTTPServer(("127.0.0.1", port), srv.Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def control(arg):
            if arg == "past":
                out["past"] = list(ctx._default_state.prompt_past)
            elif srv.STATE.batcher is not None:
                srv.STATE.batcher.MAX_ENGINES = arg

        try:
            out["responses"] = run_steps(port, steps, wavs, control)
            out["after_load"] = {
                "mesh": srv.STATE.ctx.mesh is not None,
                "dtype": str(srv.STATE.ctx.compute_dtype),
                "conductor": srv.STATE.conductor is not None or (
                    srv.STATE.batcher is not None
                    and srv.STATE.batcher.conductor is not None)}
        finally:
            httpd.shutdown()
            httpd.server_close()
            if srv._worker() is not None:
                srv._worker().close()
    else:
        from whisper_tpu_torch.api import full_default_params
        out["refused"] = []
        for call in (worker.submit, cond.submit):
            try:
                call(np.zeros(16000, np.float32), full_default_params())
            except RuntimeError as e:
                out["refused"].append(str(e))
        t0 = time.monotonic()
        srv.follow()
        out["followed_s"] = time.monotonic() - t0
    out.update(n_plans=cond.n_plans, digest=cond.plan_digest,
               n_idle=cond.n_idle, threads=sorted(out["threads"]),
               alive=cond.thread is not None and cond.thread.is_alive(),
               sync_s=cond.sync_s)
    return out


JOBS = {"batch": job_batch, "encode": job_encode, "dryrun": job_dryrun,
        "engine": job_engine, "engine_faults": job_engine_faults,
        "engine_refused": job_engine_refused, "server": job_server}
