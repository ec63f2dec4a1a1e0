"""whisper_tpu_torch's server over a tensor-parallel mesh against
whisper_tpu's server over its CPU mesh of the same shape.

Two gloo ranks (spawned; tests/torch_mesh_worker.py `job_server`) load
tests/test_torch_mesh.py's model at float32, attach a 1 x 2 mesh and
install the server, serial (--batch 0) or with --batch 2; rank 0 serves
the port's Handler on a free port and runs one scenario of requests
(`run_steps`), rank 1 replays its conductor's plans in `follow()`.
whisper_tpu's Handler, over the same model on its 1 x 2 CPU mesh in this
process, answers the same scenario: the json, text and srt bodies are
byte-identical and the /stream events equal, for two signatures in flight
at once, a beam wider than the batch and a signature past MAX_ENGINES (set
to 1 on both servers' workers), both served by the serial full().  Both
ranks run the same plans (count, log and digest); no engine starts a
thread of its own; a follower's worker refuses a request; a fault on rank
1 in one piece of work (partway through the serial server's full(), where
the ranks' carried prompts part) gives a 500 on rank 0, and the next
request, its prompt carried, is answered as whisper_tpu answers it when
the failed request never came; /load ends follow() on rank 1 and rank 0
serves the new model with no mesh, as whisper_tpu does; closing rank 0's
worker ends every rank.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from test_torch_mesh import DIMS, _jax_params, _ranks  # noqa: E402
from test_torch_ggml import write_model  # noqa: E402
import whisper_tpu.server as jsrv  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.parallel import mesh as jmesh  # noqa: E402
from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch  # noqa: E402

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

FAULT_LEN = 16000 * 3 + 123   # samples of the request rank 1 fails


def _wav(seconds, seed, n=None) -> bytes:
    import io
    import wave
    n = n or 16000 * seconds
    pcm = (np.random.RandomState(seed).randn(n) * 3000).clip(
        -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("mesh_srv") / "f32.bin",
                       "f32", dims=DIMS, seed=3)


@pytest.fixture(scope="module")
def wavs():
    # 62 s: three windows (a window with no timestamp token moves 30 s)
    return {"long0": _wav(62, 40), "long1": _wav(62, 41),
            "mid": _wav(12, 42), "short": _wav(4, 43),
            "fault": _wav(0, 44, FAULT_LEN)}


def _steps(model):
    json_ = {"response_format": "json"}
    return [
        # two decode signatures at once (two engines under --batch 2)
        [("json", "/inference", json_, "long0"),
         ("srt_no_context", "/inference",
          {"response_format": "srt", "offset_n": "3", "no_context": "true"},
          "long1")],
        [("text", "/inference", {"response_format": "text"}, "mid")],
        [("stream", "/stream", {"max_len": "20"}, "mid")],
        # a beam wider than the batch: the serial full()
        [("beam3", "/inference", {"response_format": "json",
                                  "beam_size": "3"}, "short")],
        ("control", 1),   # MAX_ENGINES = 1
        [("past_max_engines", "/inference",
          {"response_format": "srt", "temperature_inc": "0"}, "mid")],
        [("fault", "/inference", json_, "fault")],
        ("control", "past"),   # the prompt carried into the next request
        [("after_fault", "/inference", json_, "short")],
        [("load", "/load", {"model": model}, None)],
        [("after_load", "/inference", json_, "short")],
    ]


def _jax_run(model, mode, steps, wavs):
    """The scenario on whisper_tpu's Handler over its 1 x 2 CPU mesh; its
    /load loads at float32, as the port's does from an f32 context."""
    from http.server import ThreadingHTTPServer
    import threading

    class F32Context:
        @staticmethod
        def from_file(path):
            return JaxContext.from_file(path, compute_dtype=jnp.float32)

    jctx = JaxContext.from_file(model, compute_dtype=jnp.float32)
    JaxBatch(jctx, batch_size=2, params=_jax_params({}),
             mesh=jmesh.make_mesh(n_data=1, n_model=2))
    saved = dict(vars(jsrv.STATE))
    jsrv.STATE.ctx, jsrv.STATE.model_path = jctx, model
    jsrv.STATE.batcher = (jsrv._BatchWorker(jctx, batch_size=2, warmup=False)
                          if mode == "batch2" else None)

    past = {}

    def control(n):
        if n == "past":
            past["past"] = list(jctx.prompt_past)
        elif jsrv.STATE.batcher is not None:
            jsrv.STATE.batcher.MAX_ENGINES = n

    port = worker.free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), jsrv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsrv, "WhisperContext", F32Context)
        try:
            return {**worker.run_steps(port, steps, wavs, control), **past}
        finally:
            httpd.shutdown()
            httpd.server_close()
            if jsrv.STATE.batcher is not None:
                jsrv.STATE.batcher.close()
            for k in ("ctx", "model_path", "batcher"):
                if k in saved:
                    setattr(jsrv.STATE, k, saved[k])
                elif k in vars(jsrv.STATE):
                    delattr(jsrv.STATE, k)


@pytest.fixture(scope="module", params=["serial", "batch2"])
def run(request, model, wavs, tmp_path_factory):
    """-> (mode, [rank 0's result, rank 1's], whisper_tpu's responses);
    whisper_tpu's scenario is the port's without the request that fails
    (a failed request leaves the carried context as it found it)."""
    mode = request.param
    os.environ["WTPU_NO_NATIVE"] = "1"
    try:
        steps = _steps(model)
        ranks = [r["ok"] for r in _ranks(
            tmp_path_factory.mktemp(f"srv_{mode}"), (1, 2, 1), "server",
            path=model, mode=mode, steps=steps, wavs=wavs,
            fault_len=FAULT_LEN)]
        want = _jax_run(model, mode, [s for s in steps
                                      if s[0][0] != "fault"], wavs)
    finally:
        os.environ.pop("WTPU_NO_NATIVE", None)
    return mode, ranks, want


COMPARED = ("json", "srt_no_context", "text", "beam3", "past_max_engines",
            "after_fault", "after_load")


@needs8
@pytest.mark.parametrize("name", COMPARED)
def test_bodies_byte_identical(run, name):
    _, (lead, _), want = run
    got = lead["responses"][name]
    assert want[name][0] == 200, want[name]
    assert got == want[name]
    assert len(got[2]) > 2
    if name == "srt_no_context":
        assert got[2].startswith(b"4\n")


@needs8
def test_stream_events_equal(run):
    _, (lead, _), want = run
    got = lead["responses"]["stream"]
    assert got[:2] == (200, "text/event-stream")
    assert got == want["stream"]
    events = got[2].decode().split("\n\n")
    assert events[-2:] == ["data: [DONE]", ""] and len(events) >= 3


@needs8
def test_two_signatures_in_flight(run):
    """Under --batch 2 the two long requests' engines iterate in turns;
    the serial server runs each request as one full() plan."""
    mode, (lead, _), _ = run
    plans = [p for p in lead["plans"] if p[0] != "idle"]
    if mode == "serial":
        assert plans[:2] == [("full",), ("full",)]
        assert not any(p[0] in ("engine", "iterate") for p in plans)
        return
    its = [p[1] for p in plans if p[0] == "iterate"]
    a, b = its[0], next(s for s in its if s != its[0])
    first_b = its.index(b)
    assert a in its[first_b + 1:], its      # a ran on after b started
    assert its[:first_b].count(a) < 3, its  # before a finished its windows


@needs8
def test_serial_fallbacks(run):
    """A beam of 3 over a batch of 2, and a signature past MAX_ENGINES,
    run as serial full() plans; under --batch 2 the other requests ride
    three engines."""
    mode, (lead, follower), _ = run
    ops = [p[0] for p in lead["plans"]]
    if mode == "serial":
        # every request up to the /load: 8 full() plans, no engine
        assert ops.count("full") == 8 and lead["engines"] == 0
    else:
        assert ops.count("full") == 2 and ops.count("engine") == 3
        assert lead["engines"] == follower["engines"] == 3
        # the two fallbacks' full() plans, after the three engines
        assert max(i for i, op in enumerate(ops) if op == "engine") < \
            ops.index("full")


@needs8
def test_ranks_in_step(run):
    """The same plans on both ranks (the logs from the hooks, set once
    install() has started the conductors, may miss a first idle plan);
    no thread but each rank's conductor (and rank 0's HTTP threads): no
    engine thread."""
    _, ranks, _ = run
    lead, follower = ranks
    assert lead["leader"] and not follower["leader"]
    assert lead["n_plans"] == follower["n_plans"] >= len(lead["plans"])
    busy = [[p for p in r["plans"] if p != ("idle",)] for r in ranks]
    assert busy[0] == busy[1] and len(busy[0]) >= 9   # 8 requests, close
    assert lead["digest"] == follower["digest"] != ""
    for r in ranks:
        assert "ContinuousBatcher" not in r["threads"], r["threads"]
        assert "conductor" in r["threads"], r["threads"]
        assert not r["alive"]


@needs8
def test_follower_refuses_requests(run):
    _, (_, follower), _ = run
    assert len(follower["refused"]) == 2
    assert all("rank 0" in e for e in follower["refused"])


@needs8
def test_fault_on_follower_fails_one_request(run):
    """Rank 1's fault gives rank 0 a 500; the next request (the serial
    server carries its prompt) is answered as if the failed one never
    came: every rank took its carried context back (rank 1 failed
    before carrying the request's prompt on, rank 0 after), so every
    serial full() started from the same prompt on both ranks, and the
    one after the fault from whisper_tpu's."""
    mode, (lead, follower), want = run
    status, _, body = lead["responses"]["fault"]
    assert status == 500
    what = "batch iteration" if mode == "batch2" else "the request"
    assert f"{what} failed on another rank".encode() in body, body
    assert "fault" not in want
    assert lead["responses"]["after_fault"] == want["after_fault"]
    assert lead["pasts"] == follower["pasts"]
    if mode == "serial":
        assert lead["past"] == want["past"] != []
        assert len(lead["pasts"]) == 8
        assert lead["pasts"][-1] == lead["pasts"][-2] == want["past"]


@needs8
def test_load_ends_follow(run):
    """/load: rank 0's close plan ends rank 1's follow(); the new model
    has no mesh and keeps the replaced one's dtype, as whisper_tpu's
    server serves after a load."""
    _, (lead, follower), want = run
    assert lead["responses"]["load"] == want["load"] == (
        200, "application/text", b"Load was successful!")
    assert lead["after_load"] == {"mesh": False, "dtype": "torch.float32",
                                  "conductor": False}
    assert lead["plans"][-1] == follower["plans"][-1] == ("close",)
    assert follower["followed_s"] > 0
    assert lead["responses"]["after_load"] == want["after_load"]


@pytest.mark.parametrize("mode", ["serial", "batch2"])
def test_close_ends_every_rank(model, wavs, tmp_path, mode):
    """One request, then rank 0 closes its worker: the close plan ends
    follow() on rank 1 and both ranks exit."""
    steps = [[("json", "/inference", {"response_format": "json"}, "short")]]
    lead, follower = (r["ok"] for r in _ranks(
        tmp_path, (1, 2, 1), "server", path=model, mode=mode, steps=steps,
        wavs=wavs, fault_len=0))
    status, ctype, body = lead["responses"]["json"]
    assert (status, ctype) == (200, "application/json") and len(body) > 2
    assert lead["after_load"]["mesh"] and lead["after_load"]["conductor"]
    assert lead["plans"][-1] == follower["plans"][-1] == ("close",)
    assert lead["n_plans"] == follower["n_plans"]
    assert lead["digest"] == follower["digest"]
    assert not lead["alive"] and follower["followed_s"] > 0


def test_worker_refusals_in_process():
    """follow() on a worker with no mesh, a rebind of the worker to a
    mesh-attached context, and over a mesh a request whose callbacks would
    change its decode on rank 0 alone, are refused."""
    from test_torch_mesh_continuous import _view
    from whisper_tpu_torch.api import WhisperContext, full_default_params
    from whisper_tpu_torch.parallel.conductor import Conductor
    from whisper_tpu_torch.server import _BatchWorker
    ctx = WhisperContext.from_random(dims=DIMS, device="cpu")
    w = _BatchWorker(ctx, batch_size=2, warmup=False)
    with pytest.raises(RuntimeError, match="ranks of a mesh"):
        w.follow()
    other = WhisperContext.from_random(dims=DIMS, device="cpu")
    other.mesh = _view(1, 2)
    with pytest.raises(NotImplementedError, match="mesh-attached"):
        w.rebind(other)
    assert w.ctx is ctx
    w.close()
    # rank 1's view of a 1 x 2 mesh, not started: no thread, no collective
    other.mesh.coords = {"data": 0, "model": 1}
    cond = Conductor(other)
    assert cond.thread is None and not cond.leader
    pcm = np.zeros(16000, np.float32)
    for cb in ("logits_filter_callback", "abort_callback",
               "encoder_begin_callback"):
        p = full_default_params()
        setattr(p, cb, lambda *a: None)
        with pytest.raises(ValueError, match=cb):
            cond.submit(pcm, p)
    with pytest.raises(RuntimeError, match="rank 0"):
        cond.submit(pcm, full_default_params())
