"""whisper_tpu_torch imports neither JAX nor whisper_tpu, directly or not:
the card it runs on has no JAX."""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import whisper_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            whisper_tpu_torch.__path__, "whisper_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith(("jax.", "jaxlib"))
                     or k == "whisper_tpu" or k.startswith("whisper_tpu."))
        print(len(names), bad)
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 59, proc.stdout


def test_port_has_the_whisper_full_modules():
    """The modules whisper_full over a ggml file needs are the port's own
    copies, importable without JAX (checked above)."""
    import importlib
    for name in ("weights.quant", "weights.ggml_reader", "weights.ggml_writer",
                 "ops.quantized", "tokenizer", "utils.timings",
                 "utils.logging"):
        mod = importlib.import_module(f"whisper_tpu_torch.{name}")
        assert mod.__name__ == f"whisper_tpu_torch.{name}"


def test_port_has_the_serving_modules():
    """The server's path: its own copies of the JAX-free modules it needs
    (outputs, timestamps, the audio loaders and decoders)."""
    import importlib
    for name in ("server", "outputs", "timestamps", "audio.io",
                 "audio.resample", "audio.flac", "audio.mp3",
                 "audio._mp3_tables", "audio.ogg", "audio.vorbis"):
        mod = importlib.import_module(f"whisper_tpu_torch.{name}")
        assert mod.__name__ == f"whisper_tpu_torch.{name}"
    from whisper_tpu_torch.parallel.batch import ContinuousBatcher
    from whisper_tpu_torch.server import _BatchWorker
    assert _BatchWorker.MAX_ENGINES == 4
    assert ContinuousBatcher.POOL_BYTES == 1 << 30


def test_port_has_the_cli_modules():
    """The CLI's path: its own copies of whisper_tpu's dtw, grammar,
    host filter chain and host decode loops, and the CLI itself."""
    import importlib
    for name in ("cli", "dtw", "grammar", "decode.host_filters",
                 "decode.grammar_loop", "decode.host_beam"):
        mod = importlib.import_module(f"whisper_tpu_torch.{name}")
        assert mod.__name__ == f"whisper_tpu_torch.{name}"
    from whisper_tpu_torch.api import WhisperContext
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    assert callable(WhisperContext.full_parallel)
    assert BatchTranscriber.DTW_QK_ROWS == 8


def test_port_has_the_app_modules():
    """whisper-stream, whisper-command, whisper-lsp, the native audio
    front end, VAD, the chessboard, quantize and the HF rename table: the
    port's own copies (importable without JAX, checked above); the three
    applications' parsers default --device to cuda."""
    import importlib
    for name in ("audio.native", "audio.vad", "stream", "command", "lsp",
                 "chessboard", "quantize", "weights.hf",
                 "utils.native_build"):
        mod = importlib.import_module(f"whisper_tpu_torch.{name}")
        assert mod.__name__ == f"whisper_tpu_torch.{name}"
    from whisper_tpu_torch import command, lsp, stream
    for mod in (stream, command, lsp):
        assert mod.build_parser().parse_args(["-m", "x.bin"]).device == \
            "cuda", mod.__name__


def test_port_has_the_whisper_h_modules():
    """whisper.h's surface and whisper-bench: the port's own capi (with its
    C ABI source beside it) and bench_tool, importable with neither JAX
    nor whisper_tpu loaded; the C source imports the port's module."""
    code = textwrap.dedent("""
        import sys
        from whisper_tpu_torch import bench_tool, capi
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith(("jax.", "jaxlib"))
                     or k == "whisper_tpu" or k.startswith("whisper_tpu."))
        assert not bad, bad
        src = capi.SOURCE.read_text()
        assert 'PyImport_ImportModule("whisper_tpu_torch.capi")' in src
        assert '"whisper_tpu.capi"' not in src
        assert capi.HEADER.name == "whisper_tpu.h"
        print(capi.__name__, bench_tool.__name__)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["whisper_tpu_torch.capi",
                                   "whisper_tpu_torch.bench_tool"]


def test_entry_points_default_to_the_card():
    """Every entry point takes device="cuda" by default.  Without a card
    such a call raises instead of running on the CPU, so each CPU test
    here that reaches one asks for "cpu" itself."""
    import inspect

    from whisper_tpu_torch.api import WhisperContext
    from whisper_tpu_torch.decode import filters, loop
    from whisper_tpu_torch.models.whisper import WhisperConfig
    from whisper_tpu_torch.weights import convert
    from whisper_tpu_torch.bench_tool import bench_latency
    from whisper_tpu_torch.server import _arg_parser
    assert _arg_parser().parse_args(["-m", "x.bin"]).device == "cuda"
    fns = (WhisperContext.__init__, WhisperContext.from_random,
           WhisperContext.from_jax, convert.params_from_ggml,
           convert.zero_params, convert.random_params, convert.from_jax,
           loop.make_decode_window, filters.make_process_logits,
           bench_latency)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    # from_file and from_buffer forward their keywords to __init__
    for fn in (WhisperContext.from_file, WhisperContext.from_buffer):
        assert "device" not in inspect.signature(fn).parameters
    if torch.cuda.is_available():
        return
    dims = (128, 32, 64, 4, 2, 32, 64, 4, 2, 80)
    cfg = WhisperConfig(*dims)
    for call in (lambda: convert.random_params(cfg),
                 lambda: convert.zero_params(cfg),
                 lambda: WhisperContext.from_random(dims=dims)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
