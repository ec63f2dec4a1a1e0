"""whisper_tpu_torch's server against whisper_tpu's: both `Handler`s serve in
this process on two ports, over the same f32 ggml file (contexts built at
float32 on the CPU) and the same WAV, serially and with --batch 2 (the
ContinuousBatcher path).  Bodies are byte-identical in json, text, srt
(with offset_n) and vtt; verbose_json is equal after json.loads, floats
within 1e-4; the /stream events are equal; /health, /load and a 404."""

import io
import json
import socket
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_ggml import write_model  # noqa: E402
import whisper_tpu.server as jsrv  # noqa: E402
import whisper_tpu_torch.server as tsrv  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu_torch import WhisperContext  # noqa: E402

FORMATS = {   # name -> form fields
    "json": {"response_format": "json"},
    "text": {"response_format": "text"},
    "srt_offset_n": {"response_format": "srt", "offset_n": "3"},
    "vtt": {"response_format": "vtt"},
    "json_no_context_t0": {"response_format": "json", "no_context": "true",
                           "temperature_inc": "0", "suppress_regex": " t1.*"},
}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("srv") / "f32.bin", "f32")


@pytest.fixture(scope="module")
def wav_bytes():
    pcm = (np.random.RandomState(6).randn(16000 * 12) * 3000).clip(
        -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=["serial", "batch2"])
def servers(request, model_path, tmp_path_factory):
    """{"jax": port, "torch": port} with both Handlers serving."""
    import os
    os.environ["WTPU_NO_NATIVE"] = "1"
    batch = request.param == "batch2"
    jctx = JaxContext.from_file(model_path, compute_dtype=jnp.float32)
    tctx = WhisperContext.from_file(model_path, compute_dtype=torch.float32,
                                    device="cpu")
    saved = {m: dict(vars(m.STATE)) for m in (jsrv, tsrv)}
    httpds, ports = [], {}
    for tag, mod, ctx in (("jax", jsrv, jctx), ("torch", tsrv, tctx)):
        mod.STATE.ctx, mod.STATE.model_path = ctx, model_path
        mod.STATE.batcher = (mod._BatchWorker(ctx, batch_size=2,
                                              warmup=False)
                             if batch else None)
        ports[tag] = _free_port()
        httpd = ThreadingHTTPServer(("127.0.0.1", ports[tag]), mod.Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        httpds.append(httpd)
    yield ports
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()
    for mod in (jsrv, tsrv):
        if mod.STATE.batcher is not None:
            mod.STATE.batcher.close()
        for k in ("ctx", "model_path", "batcher"):
            if k in saved[mod]:
                setattr(mod.STATE, k, saved[mod][k])
            elif k in vars(mod.STATE):
                delattr(mod.STATE, k)
    os.environ.pop("WTPU_NO_NATIVE", None)


def _request(port, path, body=None, headers=None, timeout=600):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _multipart(wav: bytes, fields: dict) -> tuple[bytes, dict]:
    boundary = "portboundary"
    parts = [(f"--{boundary}\r\nContent-Disposition: form-data; "
              f'name="file"; filename="a.wav"\r\n\r\n').encode() + wav]
    for k, v in fields.items():
        parts.append((f"--{boundary}\r\nContent-Disposition: form-data; "
                      f'name="{k}"\r\n\r\n{v}').encode())
    body = b"\r\n".join(parts) + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type":
                  f'multipart/form-data; boundary="{boundary}"'}


def _post_both(servers, path, wav, fields):
    body, headers = _multipart(wav, fields)
    return {tag: _request(port, path, body, headers)
            for tag, port in servers.items()}


def _assert_close(got, want, where="$"):
    """Equal structure and values; floats within 1e-4."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int,
                                                                   float}, \
        where
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-4, (where, got, want)
    else:
        assert got == want, where


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_inference_bodies_byte_identical(servers, wav_bytes, fmt):
    out = _post_both(servers, "/inference", wav_bytes, FORMATS[fmt])
    assert out["jax"][0] == 200, out["jax"][2]
    assert out["torch"][:2] == out["jax"][:2]
    assert out["torch"][2] == out["jax"][2]
    assert len(out["torch"][2]) > 2
    if fmt == "srt_offset_n":
        assert out["torch"][2].startswith(b"4\n")


@pytest.mark.parametrize("language", ["en", "auto"])
def test_verbose_json_equal(servers, wav_bytes, language):
    out = _post_both(servers, "/inference", wav_bytes,
                     {"response_format": "verbose_json",
                      "language": language})
    assert out["jax"][0] == 200, out["jax"][2]
    assert out["torch"][:2] == out["jax"][:2]
    want, got = (json.loads(out[t][2]) for t in ("jax", "torch"))
    _assert_close(got, want)
    words = [w for s in got["segments"] for w in s.get("words", [])]
    assert words and all(w["t_dtw"] == -1 for w in words)
    assert any(w["start"] != -0.01 for w in words)   # token timestamps set
    assert all(0.0 <= w["probability"] <= 1.0 for w in words)


def test_stream_events_equal(servers, wav_bytes):
    out = _post_both(servers, "/stream", wav_bytes, {"max_len": "20"})
    assert out["jax"][0] == 200
    assert out["torch"][:2] == out["jax"][:2] == (200, "text/event-stream")
    assert out["torch"][2] == out["jax"][2]
    events = out["torch"][2].decode().split("\n\n")
    assert events[-2] == "data: [DONE]" and events[-1] == ""
    assert len(events) >= 3 and "event: error" not in out["torch"][2].decode()
    for ev in events[:-2]:
        seg = json.loads(ev.removeprefix("data: "))
        assert set(seg) == {"start", "end", "text"}


def test_concurrent_requests(servers, wav_bytes):
    """Two requests at once on each server: both answered, each as it is
    alone."""
    body, headers = _multipart(wav_bytes, FORMATS["json"])
    alone = _request(servers["torch"], "/inference", body, headers)
    with ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(_request, port, "/inference", body, headers)
                for port in (servers["torch"], servers["torch"],
                             servers["jax"], servers["jax"])]
        res = [f.result() for f in futs]
    assert all(r == alone for r in res)


def test_concurrent_signatures_and_serial_fallback(servers, wav_bytes,
                                                  monkeypatch):
    """Two decode signatures (two engines under --batch) and a beam wider
    than the batch (the serial fallback) at once on the port's server:
    each body equals the same request's alone.  The engines and the
    fallback share one context, so each thread keeps its own current
    session state.  Segment emission is slowed so that one thread's
    emission overlaps the others' decodes."""
    import time
    emit = WhisperContext._emit_segments

    def slow_emit(self, *args, **kwargs):
        time.sleep(0.05)
        seek = emit(self, *args, **kwargs)
        time.sleep(0.05)
        return seek

    monkeypatch.setattr(WhisperContext, "_emit_segments", slow_emit)
    requests = [
        _multipart(wav_bytes, FORMATS["json"]),
        _multipart(wav_bytes, {"response_format": "verbose_json",
                               "language": "auto"}),
        _multipart(wav_bytes, {"response_format": "srt", "beam_size": "3"}),
    ]
    port = servers["torch"]
    alone = [_request(port, "/inference", *r) for r in requests]
    assert all(r[0] == 200 for r in alone), alone
    for _ in range(2):
        with ThreadPoolExecutor(len(requests)) as pool:
            res = list(pool.map(
                lambda r: _request(port, "/inference", *r), requests))
        assert res == alone


def test_health_404_and_load(servers, model_path, tmp_path):
    for tag, port in servers.items():
        assert _request(port, "/health") == (
            200, "application/json", b'{"status":"ok"}')
        assert _request(port, "/nope") == (
            404, "application/json", b'{"error": "not found"}')
        assert _request(port, "/nope", b"x")[0] == 404
        bad = _request(port, "/load", json.dumps(
            {"model": str(tmp_path / "missing.bin")}).encode())
        assert bad[0] == 400 and b"error" in bad[2]
        missing_file = _request(port, "/inference", *_multipart(b"", {}))
        assert missing_file[0] == 500
    mod_ctx = {}
    for tag, mod in (("jax", jsrv), ("torch", tsrv)):
        prev = mod.STATE.ctx
        assert _request(servers[tag], "/load", json.dumps(
            {"model": model_path}).encode()) == (
            200, "application/text", b"Load was successful!")
        mod_ctx[tag] = mod.STATE.ctx
        assert mod.STATE.ctx is not prev
        if mod.STATE.batcher is not None:
            assert mod.STATE.batcher.ctx is mod.STATE.ctx
            assert mod.STATE.batcher.engines == {}
        mod.STATE.ctx = prev
        if mod.STATE.batcher is not None:
            mod.STATE.batcher.rebind(prev)
    # the port loads onto the replaced context's device and dtype
    assert mod_ctx["torch"].device.type == "cpu"
    assert mod_ctx["torch"].compute_dtype == torch.float32


def test_main_serves_on_the_cpu(model_path, wav_bytes, tmp_path):
    """`python -m whisper_tpu_torch.server -m FILE --batch 2 --device cpu`
    answers /health and /inference; without a card, the default device
    (cuda) fails at start."""
    import os
    import subprocess
    import sys
    import time
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_tpu_torch.server", "-m", model_path,
         "--port", str(port), "--batch", "2", "--device", "cpu"],
        cwd=repo, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                health = _request(port, "/health", timeout=2)
                break
            except OSError:
                assert proc.poll() is None, (tmp_path / "server.log").read_text()
                time.sleep(0.3)
        assert health == (200, "application/json", b'{"status":"ok"}')
        status, ctype, body = _request(
            port, "/inference", *_multipart(wav_bytes, FORMATS["json"]))
        assert (status, ctype) == (200, "application/json"), body
        assert json.loads(body)["text"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "whisper_tpu_torch.server", "-m",
             model_path, "--port", str(_free_port())], cwd=repo,
            capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr
