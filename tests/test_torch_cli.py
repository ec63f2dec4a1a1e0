"""whisper_tpu_torch.cli against whisper_tpu.cli: both `main`s run in this
process on the same f32 ggml file (each module's WhisperContext.from_file
patched to float32; the port's with --device cpu) and the same WAV.
Standard output is equal, and every -otxt/-ovtt/-osrt/-ocsv/-olrc/-owts
file byte-equal; the JSON is equal after json.loads with floats within
1e-4 (its systeminfo names each package's framework), and so is the -ls
score file, whose token probabilities are printed in full.  Greedy, the CLI's
defaults (beam 5 + ladder), DTW, grammars (speculative greedy and host
beam), -p 2 batched and serial; the exit codes 1, 3 and 4; and without a
card `main` raises unless --device cpu is given."""

import contextlib
import io
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_grammar import write_grammar_model  # noqa: E402
import whisper_tpu.cli as jcli  # noqa: E402
import whisper_tpu_torch.cli as tcli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLORS = os.path.join(REPO, "grammars", "colors.gbnf")
TEXT_EXT = (".txt", ".vtt", ".srt", ".csv", ".lrc", ".wts", ".score.txt")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(model path, 20 s WAV path)."""
    d = tmp_path_factory.mktemp("cli")
    model = write_grammar_model(d / "f32.bin")
    pcm = (np.random.RandomState(6).randn(16000 * 20) * 3000).clip(
        -32768, 32767).astype(np.int16)
    wav = str(d / "a.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return model, wav


@pytest.fixture(scope="module", autouse=True)
def f32_contexts():
    """Both CLIs load their context at float32."""
    saved = []
    for mod, dtype in ((jcli, jnp.float32), (tcli, torch.float32)):
        cls = mod.WhisperContext
        orig = cls.__dict__["from_file"]
        saved.append((cls, orig))
        cls.from_file = classmethod(
            lambda c, path, _f=orig.__func__, _d=dtype, **kw:
            _f(c, path, compute_dtype=_d, **kw))
    yield
    for cls, orig in saved:
        cls.from_file = orig


def _run(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


def _close(got, want, where="$"):
    """Equal structure and values; floats within 1e-4."""
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-4, (where, got, want)
    else:
        assert got == want, (where, got, want)


CASES = {
    "greedy_all_outputs": ["-nf", "-bs", "1", "-otxt", "-ovtt", "-osrt",
                           "-ocsv", "-olrc", "-ojf", "-owts", "-ls"],
    "defaults": ["-oj", "-d", "9000"],
    "dtw_top2": ["-dtw", "top2", "-bs", "1", "-nf", "-ojf", "-pc"],
    "grammar_speculative": ["--grammar", COLORS, "--grammar-rule", "root",
                            "-bs", "1", "-nf", "-oj", "-d", "9000"],
    "grammar_beam5": ["--grammar", COLORS, "--grammar-rule", "root",
                      "-bs", "5", "-nf", "-otxt", "-d", "5000"],
    "p2_batched": ["-p", "2", "-bs", "1", "-nf", "-osrt", "-oj", "-kvq"],
    "p2_serial_dtw": ["-p", "2", "-bs", "1", "-nf", "-dtw", "top1", "-ojf",
                      "-ml", "12"],
    "p2_auto_language": ["-p", "2", "-bs", "1", "-nf", "-l", "auto", "-oj"],
}


# -p 2 takes the batched route unless the params need the serial `full`
BATCHED = {"p2_batched", "p2_auto_language"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches(files, tmp_path, monkeypatch, case):
    model, wav = files
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    batched = []
    orig = BatchTranscriber.transcribe
    monkeypatch.setattr(BatchTranscriber, "transcribe",
                        lambda self, streams: batched.append(len(streams))
                        or orig(self, streams))
    outs = {}
    for tag, mod, extra in (("jax", jcli, []),
                            ("torch", tcli, ["--device", "cpu"])):
        base = str(tmp_path / tag)
        rc, stdout = _run(mod, ["-m", model, "-f", wav, "-of", base,
                                "-fp", model, *CASES[case], *extra])
        assert rc == 0, tag
        outs[tag] = (base, stdout)
    (jbase, jout), (tbase, tout) = outs["jax"], outs["torch"]
    assert batched == ([2] if case in BATCHED else [])
    assert tout == jout
    assert tout.count("-->") >= 1
    written = 0
    for ext in TEXT_EXT + (".json",):
        if not os.path.exists(jbase + ext):
            assert not os.path.exists(tbase + ext), ext
            continue
        written += 1
        if ext == ".json":
            with open(jbase + ext) as f:
                want = json.load(f)
            with open(tbase + ext) as f:
                got = json.load(f)
            assert got.pop("systeminfo").startswith("PyTorch")
            want.pop("systeminfo")
            _close(got, want)
            if "-ojf" in CASES[case] and "-dtw" in CASES[case]:
                stamps = [t["t_dtw"] for s in got["transcription"]
                          for t in s["tokens"] if not t["text"].startswith(
                              "[_")]
                assert stamps and all(t >= 0 for t in stamps)
        elif ext == ".score.txt":
            # "token\tp" lines: p printed in full, so within 1e-4
            with open(jbase + ext) as f:
                want = [line.split("\t") for line in f.read().splitlines()]
            with open(tbase + ext) as f:
                got = [line.split("\t") for line in f.read().splitlines()]
            assert [t for t, _ in got] == [t for t, _ in want]
            _close([float(p) for _, p in got], [float(p) for _, p in want])
        else:
            with open(jbase + ext, "rb") as f:
                want = f.read()
            with open(tbase + ext, "rb") as f:
                assert f.read() == want, ext
    assert written == sum(
        flag in CASES[case] for flag in ("-otxt", "-ovtt", "-osrt", "-ocsv",
                                         "-olrc", "-owts", "-ls")) + any(
        flag in CASES[case] for flag in ("-oj", "-ojf"))


@pytest.mark.parametrize("argv,code", [
    ([], 1),
    (["-l", "xx"], 1),
    (["-dtw", "bogus.model"], 3),
    (["--grammar", 'root ::= ("red"'], 4),
])
def test_cli_exit_codes_match(files, argv, code):
    model, wav = files
    argv = ["-m", model] + (["-f", wav] if argv else []) + argv
    assert _run(jcli, argv)[0] == code
    assert _run(tcli, argv + ["--device", "cpu"])[0] == code


def test_cli_runs_on_the_card_by_default(files):
    """Without --device the CLI asks for the card; without one it raises
    rather than run on the CPU."""
    assert tcli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    model, wav = files
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(tcli, ["-m", model, "-f", wav, "-bs", "1", "-nf"])


def test_cli_no_gpu_runs_on_the_cpu(files, monkeypatch):
    """-ng (whisper.cpp's "no GPU") alone selects the CPU; an explicit
    --device wins over it.  The output is the CLI case's as without -ng."""
    model, wav = files
    devices = []
    cls = tcli.WhisperContext
    orig = cls.__dict__["from_file"]
    monkeypatch.setattr(cls, "from_file", classmethod(
        lambda c, path, _f=orig.__func__, **kw:
        devices.append(kw["device"]) or _f(c, path, **kw)))
    argv = ["-m", model, "-f", wav, *CASES["greedy_all_outputs"][:3]]
    want = _run(jcli, argv)
    assert _run(tcli, argv + ["-ng"]) == want
    assert _run(tcli, argv + ["--device", "cpu"]) == want
    assert devices == ["cpu", "cpu"]
    assert tcli.build_parser().parse_args(["-ng"]).no_gpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run(tcli, argv + ["-ng", "--device", "cuda"])
        assert devices[-1] == "cuda"


def test_cli_module_entry_point(files):
    """python -m whisper_tpu_torch.cli, as a user runs it (bf16 on the
    CPU: only the form of its output is checked)."""
    model, wav = files
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.cli", "-m", model, "-f",
         wav, "-bs", "1", "-nf", "-d", "4000", "--device", "cpu", "-np"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines and all(line.startswith("[00:00:0") and "-->" in line
                         for line in lines), proc.stdout
