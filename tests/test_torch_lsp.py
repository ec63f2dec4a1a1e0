"""whisper_tpu_torch.lsp against whisper_tpu.lsp: one scripted JSON-RPC
session through both `serve`s over in-memory pipes, on the same f32 ggml
file (the colors words in its vocab), each context loaded at float32 (the
port's on the CPU).  The responses are equal with "timestamp" removed:
echo, seek, an unknown method, a bad version, registerCommandset (and its
duplicate-token error -31000), guided over the commandset prompt (with and
without -ac), unguided with and without a prompt, pcm_base64 clamped to
its max length, and the vim clients' extension methods.  The guided pass's
softmax row is held within 1e-5; `main` runs on the card by default."""

import base64
import io
import json
import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_grammar import write_grammar_model  # noqa: E402
from whisper_tpu import lsp as jlsp  # noqa: E402
from whisper_tpu.api import WhisperContext as JaxContext  # noqa: E402
from whisper_tpu.models import whisper as jwm  # noqa: E402
from whisper_tpu_torch import WhisperContext  # noqa: E402
from whisper_tpu_torch import lsp as tlsp  # noqa: E402
from whisper_tpu_torch.models import whisper as twm  # noqa: E402

WORDS = ["red", "green", "blue", "yellow"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(model path, 3 s WAV path, 5 s of s16 PCM as base64)."""
    d = tmp_path_factory.mktemp("lsp")
    model = write_grammar_model(d / "f32.bin")
    rng = np.random.RandomState(9)
    pcm = (rng.randn(16000 * 3) * 2000).astype("<i2")
    wav = str(d / "a.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    long = (rng.randn(16000 * 5) * 2000).astype("<i2")
    return model, wav, base64.b64encode(long.tobytes()).decode()


@pytest.fixture(scope="module")
def contexts(files):
    return (JaxContext.from_file(files[0], compute_dtype=jnp.float32),
            WhisperContext.from_file(files[0], compute_dtype=torch.float32,
                                     device="cpu"))


def _rpc(method, params=None, id=1, version="2.0"):
    msg = {"jsonrpc": version, "id": id, "method": method}
    if params is not None:
        msg["params"] = params
    return msg


def _frame(requests) -> io.BytesIO:
    buf = io.BytesIO()
    for req in requests:
        data = json.dumps(req).encode()
        buf.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
        buf.write(data)
    buf.seek(0)
    return buf


def _responses(out: io.BytesIO) -> list:
    out.seek(0)
    responses = []
    while True:
        header = out.readline()
        if not header:
            return responses
        assert header.startswith(b"Content-Length: "), header
        length = int(header.split(b":")[1])
        assert out.readline() == b"\r\n"
        body = out.read(length)
        assert body.endswith(b"\n")      # counted in Content-Length
        responses.append(json.loads(body))


def run_lsp(serve, ctx, requests, **kw):
    out = io.BytesIO()
    assert serve(ctx, stdin=_frame(requests), stdout=out, **kw) == 0
    return _responses(out)


def _untimed(responses):
    for r in responses:
        if isinstance(r.get("result"), dict):
            r["result"].pop("timestamp", None)
    return responses


@pytest.fixture
def guided_rows(monkeypatch):
    """Each package's last-row logits of every guided prompt pass (a
    decode_prompt called from lsp._guided), as f32 numpy:
    {"jax": [...], "torch": [...]}."""
    rows = {"jax": [], "torch": []}
    inside = set()
    for tag, wm, lsp in (("jax", jwm, jlsp), ("torch", twm, tlsp)):
        def decode_prompt(*args, _orig=wm.decode_prompt, _tag=tag, **kw):
            out = _orig(*args, **kw)
            if _tag in inside:
                row = out[0][0, -1]
                rows[_tag].append(np.asarray(
                    row.float().cpu() if _tag == "torch" else row,
                    np.float32))
            return out

        def guided(*args, _orig=lsp._guided, _tag=tag, **kw):
            inside.add(_tag)
            try:
                return _orig(*args, **kw)
            finally:
                inside.discard(_tag)
        monkeypatch.setattr(wm, "decode_prompt", decode_prompt)
        monkeypatch.setattr(lsp, "_guided", guided)
    return rows


def _softmax(row):
    p = np.exp(row - row.max())
    return p / p.sum()


def _session(wav, b64):
    return [
        _rpc("echo", {"a": [1, "x"]}, id=1),
        _rpc("seek", {"t": 0}, id=2),
        _rpc("noSuchMethod", {}, id=3),
        _rpc("echo", {}, id=4, version="1.0"),
        _rpc("guided", {"file": wav}, id=5),          # none registered yet
        _rpc("registerCommandset", WORDS, id=6),
        _rpc("registerCommandset", ["red", "red"], id=7),
        _rpc("registerCommandset", WORDS[:2], id=8),
        _rpc("guided", {"file": wav}, id=9),
        _rpc("guided", {"file": wav, "commandset_index": 0}, id=10),
        _rpc("guided", {"pcm_base64": b64, "commandset_index": 0}, id=11),
        _rpc("unguided", {"file": wav}, id=12),
        _rpc("unguided", {"file": wav, "prompt": " green and blue"}, id=13),
        _rpc("unguided", {"pcm_base64": b64}, id=14),
        _rpc("initialize", {}, id=15),
        _rpc("transcribe", {"file": wav, "max_tokens": 4}, id=16),
        _rpc("guided", {"file": wav, "commands": ["red", "blue"],
                        "max_tokens": 4}, id=17),
        _rpc("shutdown", {}, id=18),
        _rpc("exit", {}, id=19),
        _rpc("echo", {"after": "exit"}, id=20),       # never answered
    ]


@pytest.mark.parametrize("audio_ctx", [0, 16], ids=["full-ctx", "ac16"])
def test_session_matches_whisper_tpu(files, contexts, guided_rows, audio_ctx):
    model, wav, b64 = files
    jctx, tctx = contexts
    requests = _session(wav, b64)
    want = _untimed(run_lsp(jlsp.serve, jctx, requests, audio_ctx=audio_ctx))
    got = _untimed(run_lsp(tlsp.serve, tctx, requests, audio_ctx=audio_ctx))
    assert got == want
    assert len(got) == 18                    # "exit" ends the session
    by_id = {r["id"]: r for r in got}
    assert by_id[2]["error"]["code"] == -32601
    assert by_id[3] == {"jsonrpc": "2.0", "id": 3, "result": None}
    assert by_id[4]["error"]["code"] == -3260
    assert by_id[5]["error"]["code"] == -32000
    assert by_id[6]["result"] == {"index": 0}
    assert by_id[7]["error"] == {"code": -31000, "message":
                                 "Duplicate token in token set: red"}
    assert by_id[8]["result"] == {"index": 1}
    assert by_id[9]["result"]["command_text"] in WORDS[:2]
    assert by_id[10]["result"]["command_text"] in WORDS
    assert by_id[11]["result"]["command_text"] in WORDS
    for i in (12, 13, 14):
        assert isinstance(by_id[i]["result"]["transcription"], str)
    # three guided prompt passes a side, each row within 1e-5 after the
    # softmax (whisper_tpu's ranking)
    assert len(guided_rows["torch"]) == len(guided_rows["jax"]) == 3
    for got_row, want_row in zip(guided_rows["torch"], guided_rows["jax"]):
        assert got_row.shape == want_row.shape == (tctx.n_vocab(),)
        np.testing.assert_allclose(_softmax(got_row), _softmax(want_row),
                                   rtol=0, atol=1e-5)


def test_guided_audio_ctx_too_large(files, contexts):
    """-ac past the model's n_audio_ctx: the same error on both sides."""
    model, wav, _ = files
    jctx, tctx = contexts
    requests = [_rpc("registerCommandset", WORDS, id=1),
                _rpc("guided", {"file": wav}, id=2)]
    want = run_lsp(jlsp.serve, jctx, requests, audio_ctx=1 << 12)
    got = run_lsp(tlsp.serve, tctx, requests, audio_ctx=1 << 12)
    assert got == want
    assert got[1]["error"]["message"] == ("audio_ctx is larger than the "
                                          "maximum allowed")


def test_main_runs_on_the_card_by_default(files, monkeypatch):
    """The parser defaults --device to cuda; with --device cpu, `main`
    serves stdin like whisper_tpu's (float32 on both sides here)."""
    assert tlsp.build_parser().parse_args(["-m", "x.bin"]).device == "cuda"
    model, wav, _ = files
    requests = [_rpc("registerCommandset", WORDS, id=1),
                _rpc("guided", {"file": wav}, id=2),
                _rpc("unguided", {"file": wav}, id=3)]
    outs = []
    for mod, dtype, extra in ((jlsp, jnp.float32, []),
                              (tlsp, torch.float32, ["--device", "cpu"])):
        cls = mod.WhisperContext
        orig = cls.__dict__["from_file"]
        monkeypatch.setattr(cls, "from_file", classmethod(
            lambda c, path, _f=orig.__func__, _d=dtype, **kw:
            _f(c, path, compute_dtype=_d, **kw)))
        stdin = _frame(requests)
        out = io.BytesIO()
        monkeypatch.setattr("sys.stdin", type("S", (), {"buffer": stdin}))
        monkeypatch.setattr("sys.stdout", type("S", (), {"buffer": out}))
        assert mod.main(["-m", model, *extra]) == 0
        outs.append(_untimed(_responses(out)))
    assert outs[1] == outs[0] and len(outs[0]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlsp.main(["-m", model])
