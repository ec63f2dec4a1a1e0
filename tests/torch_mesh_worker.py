"""Rank bodies for tests/test_torch_mesh.py and
tests/test_torch_mesh_continuous.py.

Each rank is a process of its own, started by `spawn` (which imports this
module, not the test module: a rank imports torch and the port only).  It
builds its mesh over gloo on the CPU with a file:// rendezvous, runs one
job and pickles what the job returns, or the traceback, to out_dir.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import traceback

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
               alive=cb.thread.is_alive(), n_idle=cb.n_idle,
               sync_s=cb.sync_s)
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


JOBS = {"batch": job_batch, "encode": job_encode, "dryrun": job_dryrun,
        "engine": job_engine, "engine_faults": job_engine_faults,
        "engine_refused": job_engine_refused}
