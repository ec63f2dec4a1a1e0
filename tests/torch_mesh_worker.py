"""Rank bodies for tests/test_torch_mesh.py.

Each rank is a process of its own, started by `spawn` (which imports this
module, not the test module: a rank imports torch and the port only).  It
builds its mesh over gloo on the CPU with a file:// rendezvous, runs one
job and pickles what the job returns, or the traceback, to out_dir.
"""

from __future__ import annotations

import os
import pickle
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


JOBS = {"batch": job_batch, "encode": job_encode, "dryrun": job_dryrun}
