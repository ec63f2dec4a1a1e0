"""ContinuousBatcher over a mesh: the port's engine on spawned gloo ranks
against whisper_tpu's engine over its CPU mesh of the same shape.

Tensor parallel (n_data = 1): rank 0 schedules and broadcasts each
iteration's plan, the other ranks replay it.  On 1 x 2 (host mel) and 1 x 4
(device mel, the resident PCM pool on) rank 0's segments equal whisper_tpu's
engine's and the port's unsharded engine's, token for token at float32, in
one scenario (tests/torch_mesh_worker.py `drive`): four streams queued
together, a late stream joining while they decode, and a stream after an
idle gap.  Every rank reports the same iteration count and plan digests,
refuses requests off rank 0 and closes.  A failure on one rank, in
admission or after an iteration, fails the jobs on every rank alike.

Data parallel: whisper_tpu's engine fails every job (the window decode's
sharding does not match the engine's batch), so the port refuses such a
mesh; so does the port's batched server (tests/test_torch_mesh_server.py
runs it over a tensor-parallel one).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from test_torch_mesh import DIMS, OVERRIDES, _jax_params, _ranks  # noqa: E402
from test_torch_ggml import write_model  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.parallel import mesh as jmesh  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402
from whisper_tpu.parallel.batch import ContinuousBatcher as JaxEngine  # noqa: E402
from whisper_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from whisper_tpu_torch.parallel.batch import ContinuousBatcher  # noqa: E402

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("mesh_cont") / "f32.bin",
                       "f32", dims=DIMS, seed=3)


def _pcm(seconds, seed, int16):
    x = (np.random.RandomState(seed).randn(16000 * seconds) * 0.1) \
        .astype(np.float32)
    return (x * 32768).clip(-32768, 32767).astype(np.int16) if int16 else x


def _scenario(int16):
    """4 streams of 35 or 62 s (2 or 3 windows: a window's 5 tokens carry
    no timestamp, so it moves the seek by 30 s), the late stream, the
    stream after the idle gap."""
    return dict(streams=[_pcm(s, 10 + i, int16)
                         for i, s in enumerate((35, 62, 35, 62))],
                late=_pcm(2, 20, int16), after_idle=_pcm(2, 21, int16))


def _view(n_data, n_model):
    return tmesh.Mesh(("data", "model"), {"data": n_data, "model": n_model},
                      {"data": 0, "model": 0}, "cpu", "gloo", {}, None)


@needs8
@pytest.mark.parametrize("n_model,device_mel", [(2, False), (4, True)],
                         ids=["1x2-host-mel", "1x4-pool"])
def test_engine_on_tensor_parallel_mesh(model, tmp_path, n_model,
                                        device_mel):
    scen = _scenario(int16=device_mel)
    jctx = JaxContext.from_file(model, compute_dtype=jnp.float32)
    JaxBatch(jctx, batch_size=4, params=_jax_params(OVERRIDES),
             mesh=jmesh.make_mesh(n_data=1, n_model=n_model))
    eng = JaxEngine(jctx, batch_size=4, params=_jax_params(OVERRIDES),
                    device_mel=device_mel)
    try:
        want, want_iters = worker.drive(eng, **scen)
    finally:
        eng.close()
    assert all(want), want
    # the late stream joined while the first four decoded
    late_joined = want_iters[4][0]
    assert 0 < late_joined < max(done for _, done in want_iters[:4])

    eng = ContinuousBatcher(worker.load(model, {}), batch_size=4,
                            params=worker._params(dict(OVERRIDES)),
                            device_mel=device_mel)
    try:
        unsharded, iters = worker.drive(eng, **scen)
    finally:
        eng.close()
    assert (unsharded, iters) == (want, want_iters)

    ranks = [r["ok"] for r in _ranks(tmp_path, (1, n_model, 1), "engine",
                                      path=model, overrides=OVERRIDES,
                                      device_mel=device_mel, **scen)]
    lead = ranks[0]
    assert lead["leader"] and not any(r["leader"] for r in ranks[1:])
    assert (lead["segments"], lead["iters"]) == (want, want_iters)
    assert lead["pool"] == device_mel
    # the idle gap (1.5 s) went out as empty plans, one a 0.25 s wakeup
    assert lead["n_idle"] >= 4, lead["n_idle"]
    for r in ranks:
        assert not r["alive"]
        assert r["iterations"] == lead["iterations"] > 0
        assert r["digests"] == lead["digests"]
    for r in ranks[1:]:
        assert len(r["refused"]) == 2 and "rank 0" in r["refused"][0]


def test_engine_failures_stay_symmetric(model, tmp_path):
    """A stream the follower fails to admit, and an iteration the follower
    raises after: rank 0 fails the job too, every rank clears its active
    jobs, and the next job runs in lockstep."""
    ranks = [r["ok"] for r in _ranks(tmp_path, (1, 2, 1), "engine_faults",
                                      path=model, pcm=_pcm(2, 30, False),
                                      overrides=OVERRIDES)]
    assert ranks[0]["errors"] == [
        "stream prep failed on another rank",
        "batch iteration failed on another rank", None]
    for r in ranks:
        assert (r["iterations"], r["active"], r["alive"]) == (1, 0, False)


def test_engine_refuses_data_parallel_mesh(model, tmp_path):
    for msg in _ranks(tmp_path, (2, 1, 1), "engine_refused", path=model,
                      overrides=OVERRIDES):
        assert "data-parallel" in msg["ok"] and "fails every job" in \
            msg["ok"]


@needs8
def test_jax_engine_fails_every_job_on_data_parallel_mesh(model):
    """Why the port refuses: whisper_tpu's engine over a 2 x 2 CPU mesh
    fails each job's batch iteration."""
    jctx = JaxContext.from_file(model, compute_dtype=jnp.float32)
    JaxBatch(jctx, batch_size=4, params=_jax_params(OVERRIDES),
             mesh=jmesh.make_mesh(n_data=2, n_model=2))
    eng = JaxEngine(jctx, batch_size=4, params=_jax_params(OVERRIDES))
    try:
        jobs = [eng.submit_async(pcm) for pcm in _scenario(False)["streams"]]
        for j in jobs:
            assert j.done.wait(180)
    finally:
        eng.close()
    for j in jobs:
        assert j.error is not None and \
            j.error.startswith("batch iteration failed"), j.error


def test_refusals_in_process():
    """A data-parallel view refuses the engine, and the batched server,
    before any collective."""
    from whisper_tpu_torch.api import WhisperContext
    from whisper_tpu_torch.server import _BatchWorker
    ctx = WhisperContext.from_random(dims=DIMS, device="cpu")
    for view in (_view(2, 1), _view(2, 2)):
        ctx.mesh = view
        with pytest.raises(NotImplementedError, match="data-parallel"):
            ContinuousBatcher(ctx, batch_size=4)
    ctx.mesh = _view(2, 1)
    with pytest.raises(NotImplementedError, match="data-parallel"):
        _BatchWorker(ctx, batch_size=2, warmup=False)
