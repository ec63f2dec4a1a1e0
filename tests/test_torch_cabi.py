"""The port's C ABI library (libwhisper_tpu.so over whisper_tpu_torch.capi,
built by capi.library_path from whisper_tpu_torch/native/wtpu_capi.cpp):
C programs written against whisper.h run over it, here on the CPU
(WHISPER_TPU_TORCH_DEVICE=cpu), and print what the port computes in
process.

  * examples/c_demo.c: its SEG| lines equal the port's `full` on the same
    file, PCM and params (temperature_inc = 0)
  * tests/c_abi_ext.c: raw mel / encode / decode and logits, states,
    timings, the log callback, the five whisper_full_params callbacks and
    the in-struct grammar, whose segments equal the Python GBNF path's
  * every whisper.h function is an exported symbol
  * the perl XS client (bindings/perl) over the library, by
    LD_LIBRARY_PATH
  * a build that fails raises
The subprocesses run bf16 on the CPU, as the in-process contexts do, with
two threads each."""

import os
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_ggml import write_model  # noqa: E402
from test_torch_grammar import write_grammar_model  # noqa: E402
from whisper_tpu_torch import capi  # noqa: E402
from whisper_tpu_torch.grammar import grammar_from_gbnf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER_DIR = os.path.join(ROOT, "native")

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="no C compiler")


@pytest.fixture(scope="module")
def lib():
    return str(capi.library_path())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cabi")
    return {"q5_0": write_model(d / "q5_0.bin", "q5_0"),
            "pieces": write_grammar_model(d / "pieces.bin", "q5_1")}


def _env(lib, root=True, **extra):
    """The C programs' environment: the library's directory, the CPU as
    the device, and this interpreter's sys.path (an embedded interpreter
    does not see a venv's site-packages by itself)."""
    path = [p for p in sys.path if p]
    if not root:
        # without WHISPER_TPU_ROOT and the repository on the path, the
        # library finds the root from its own place under build/
        path = [p for p in path
                if os.path.abspath(p) != ROOT]
    env = dict(os.environ, LD_LIBRARY_PATH=os.path.dirname(lib),
               WHISPER_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(path), **extra)
    env.pop("WHISPER_TPU_ROOT", None)
    if root:
        env["WHISPER_TPU_ROOT"] = ROOT
    return env


def _compile(src, lib, tmp_path):
    exe = str(tmp_path / os.path.basename(src)[:-2])
    subprocess.run(["gcc", src, "-I" + HEADER_DIR,
                    "-L" + os.path.dirname(lib), "-lwhisper_tpu", "-o", exe],
                   check=True)
    return exe


def _cpu_context(path):
    p = capi.whisper_context_default_params()
    p.use_gpu = False
    return capi.whisper_init_from_file_with_params(path, p)


def _greedy():
    p = capi.whisper_full_default_params(capi.WHISPER_SAMPLING_GREEDY)
    p.print_progress = False
    p.temperature_inc = 0.0
    return p


def test_library_is_the_ports(lib):
    """build/whisper_tpu_torch/capi/libwhisper_tpu.so, a link to the hashed
    build of the port's source; it names whisper_tpu_torch.capi and never
    whisper_tpu.capi."""
    assert lib == str(capi.LIB_DIR / "libwhisper_tpu.so")
    assert os.path.islink(lib)
    real = os.path.realpath(lib)
    assert os.path.dirname(real) == str(capi.BUILD_DIR)
    blob = open(real, "rb").read()
    assert b"whisper_tpu_torch.capi" in blob
    assert b"whisper_tpu.capi\0" not in blob
    assert capi.library_path() == capi.LIB_DIR / "libwhisper_tpu.so"


def test_exports_cover_whisper_h(lib):
    want = set(open(os.path.join(
        ROOT, "tests", "golden", "whisper_h_functions.txt")).read().split())
    out = subprocess.run(["nm", "-D", "--defined-only", lib],
                         capture_output=True, text=True, check=True).stdout
    have = {line.split()[-1] for line in out.splitlines() if line.strip()}
    missing = sorted(want - have)
    assert not missing, f"missing C ABI symbols: {missing}"


@pytest.mark.parametrize("root", [True, False], ids=["root_env", "root_found"])
def test_c_demo_matches_full(lib, files, tmp_path, root):
    exe = _compile(os.path.join(ROOT, "examples", "c_demo.c"), lib, tmp_path)
    pcm = (np.random.RandomState(0).randn(16000 * 10) * 0.1).astype(
        np.float32)
    raw = str(tmp_path / "pcm.f32")
    pcm.tofile(raw)
    out = subprocess.run([exe, files["q5_0"], raw], env=_env(lib, root),
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    c_segs = [line.split("|")[1:4] for line in out.splitlines()
              if line.startswith("SEG|")]
    assert c_segs, out
    assert "tokenize ' and so' -> " in out
    assert "callback_segments=" in out
    assert "backend cpu" in out            # whisper_print_system_info

    ctx = _cpu_context(files["q5_0"])
    assert capi.whisper_full(ctx, _greedy(), pcm, len(pcm)) == 0
    assert c_segs == [[str(s.t0), str(s.t1), s.text]
                      for s in ctx.result_all]


def _c_lcg_noise(n):
    """fill_noise() of c_abi_ext.c (LCG, seed 12345)."""
    s = np.uint64(12345)
    a, c, m = np.uint64(1664525), np.uint64(1013904223), np.uint64(1 << 32)
    out = np.empty(n, np.float32)
    for i in range(n):
        s = (s * a + c) % m
        out[i] = (float(s >> np.uint64(8)) / float(1 << 24) - 0.5) * 0.2
    return out


def test_c_abi_extended_surface(lib, files, tmp_path):
    """tests/c_abi_ext.c over the port, checked as tests/test_cabi.py
    checks it over whisper_tpu's library (the model lines from the port in
    process)."""
    exe = _compile(os.path.join(ROOT, "tests", "c_abi_ext.c"), lib, tmp_path)
    out = subprocess.run([exe, files["pieces"]], env=_env(lib),
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    assert "DONE" in out, out
    lines = dict(line.split("|", 1) for line in out.splitlines()
                 if "|" in line and not line.startswith("GSEG|"))
    ctx = _cpu_context(files["pieces"])
    hp = ctx.hparams
    assert lines["MODEL"] == (f"{hp.n_vocab}|{hp.n_audio_layer}|"
                              f"{hp.n_text_layer}|{hp.n_mels}|"
                              f"{hp.model_type}")
    assert lines["LANG"] == "99|en|english"
    assert lines["NLEN"] == "99" and lines["NLEN_ST"] == "99"
    assert lines["LOGITS"] == f"{hp.n_vocab}|ok"
    assert lines["LOGITS_ST"] == "ok"
    assert lines["TIMINGS"] == "ok"
    assert lines["LOGS"] == "captured"

    n_base = int(lines["BASE_SEGS"])
    assert n_base > 0
    n_abort_calls, n_abort_segs = map(int, lines["ABORT"].split("|"))
    assert n_abort_calls == 1 and n_abort_segs == 0   # aborted before work
    n_encb_calls, n_encb_segs, encb_state_segs = map(
        int, lines["ENCB"].split("|"))
    assert n_encb_calls == 1 and n_encb_segs == 0     # veto gates encode
    assert encb_state_segs >= 0                       # a live state pointer
    n_lfilt, lfilt_ok = lines["LFILT"].split("|")
    assert int(n_lfilt) > 0 and lfilt_ok == "ok"      # forced-token filter
    gram_ok, n_gram_chars = lines["GRAMMAR"].split("|")
    assert gram_ok == "ok" and int(n_gram_chars) > 0

    # the in-struct C grammar gives the Python GBNF path's segments
    c_gsegs = [line[len("GSEG|"):] for line in out.splitlines()
               if line.startswith("GSEG|")]
    p = _greedy()
    p.greedy.best_of = 1
    p.grammar_rules = grammar_from_gbnf("root ::= [a-z ]*")
    p.grammar_penalty = 100.0
    pcm = _c_lcg_noise(16000 * 8)
    assert capi.whisper_full(ctx, p, pcm, len(pcm)) == 0
    assert c_gsegs == [s.text for s in ctx.result_all]


@pytest.mark.skipif(shutil.which("perl") is None, reason="no perl")
@pytest.mark.skipif(shutil.which("xsubpp") is None, reason="no xsubpp")
def test_perl_client_over_the_port(lib, files, tmp_path):
    """bindings/perl's XS client, built here against the port's library
    (bindings/perl/build.sh's steps), transcribes as the port does in
    process (transcribe.pl's params: language en, temperature_inc 0)."""
    src = os.path.join(ROOT, "bindings", "perl")
    work = tmp_path / "perl"
    work.mkdir()
    for name in ("WhisperTPU.xs", "WhisperTPU.pm", "transcribe.pl"):
        shutil.copy(os.path.join(src, name), work / name)

    def perl_config(key):
        return subprocess.run(
            ["perl", "-MConfig", "-e", f"print $Config{{{key}}}"],
            capture_output=True, text=True, check=True).stdout

    typemap = os.path.join(perl_config("privlib"), "ExtUtils", "typemap")
    xs_c = subprocess.run(["xsubpp", "-typemap", typemap, "WhisperTPU.xs"],
                          cwd=work, capture_output=True, text=True,
                          check=True).stdout
    (work / "WhisperTPU.c").write_text(xs_c)
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared",
                    *perl_config("ccflags").split(),
                    "-I" + os.path.join(perl_config("archlib"), "CORE"),
                    "-I" + HEADER_DIR, "WhisperTPU.c", "-o", "WhisperTPU.so",
                    "-L" + os.path.dirname(lib), "-lwhisper_tpu"],
                   cwd=work, check=True)

    pcm16 = (np.random.RandomState(4).randn(16000 * 5) * 3000).clip(
        -32768, 32767).astype(np.int16)
    wav = str(tmp_path / "a.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm16.tobytes())
    out = subprocess.run(
        ["perl", "-I", str(work), str(work / "transcribe.pl"),
         files["q5_0"], wav], env=_env(lib), capture_output=True, text=True,
        timeout=300, check=True).stdout
    perl_lines = [line for line in out.splitlines() if line.strip()]
    assert perl_lines, out

    ctx = _cpu_context(files["q5_0"])
    p = _greedy()
    p.language = "en"
    pcm = pcm16.astype(np.float32) / 32768.0
    assert capi.whisper_full(ctx, p, pcm, len(pcm)) == 0
    assert perl_lines == [f"[{s.t0 / 100:.2f}s -> {s.t1 / 100:.2f}s]{s.text}"
                          for s in ctx.result_all]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises from library_path (no warning
    and None: a C caller has no Python path to fall back on), and no
    library link is left behind."""
    bad = tmp_path / "wtpu_capi.cpp"
    bad.write_text(capi.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(capi, "SOURCE", bad)
    monkeypatch.setattr(capi, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(capi, "LIB_DIR", tmp_path / "build" / "capi")
    with pytest.raises(OSError, match="failed"):
        capi.library_path()
    assert not (tmp_path / "build" / "capi").exists()
