"""whisper_tpu_torch.bench_tool (whisper-bench) on the CPU at micro dims:
-w 0's four figures, -w 1's and -w 2's lines in whisper_tpu's formats,
-w 3's step at one iteration, and the card as the default device.  Only
the plumbing is checked here: a time taken on the CPU says nothing of the
card."""

import contextlib
import io
import re

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import whisper_tpu.capi as jcapi  # noqa: E402
from test_torch_ggml import write_model  # noqa: E402
from whisper_tpu_torch import bench_tool, capi  # noqa: E402
from whisper_tpu_torch.models.whisper import (MODEL_DIMS,  # noqa: E402
                                               WhisperConfig)
from whisper_tpu_torch.weights.convert import random_params  # noqa: E402

# narrow widths at the released n_text_ctx: PP decodes 256 positions
DIMS = (51865, 32, 128, 4, 2, 448, 128, 4, 3, 80)
MUL_MAT_LINE = re.compile(r"^ +\d+ x +\d+: (F32|BF16) +\d+\.\d GFLOPS$")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_tool.main(argv)
    return rc, out.getvalue()


def test_bench_full_fast():
    cfg = WhisperConfig(*DIMS)
    params = random_params(cfg, seed=0, device="cpu")
    r = bench_tool.bench_full(params, cfg, fast=True)
    assert sorted(r) == ["bch5_ms", "dec_ms", "enc_ms", "pp_ms_per_tok"]
    assert all(np.isfinite(v) and v > 0 for v in r.values()), r


def test_model_file_table(tmp_path):
    """-w 0 over a q5_0 file (its decoder packed: K3's plain version on
    the CPU): the reference's table with the device column."""
    path = write_model(tmp_path / "q5_0.bin", "q5_0", dims=DIMS)
    rc, out = _run(["-m", path, "--device", "cpu"])
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[0] == "| model | device | Enc. | Dec. | Bch5 | PP |"
    cells = [c.strip() for c in lines[2].strip("|").split("|")]
    assert cells[:2] == ["unknown", "cpu"]
    assert all(float(c) > 0 for c in cells[2:])


def test_memcpy_and_mul_mat_lines(monkeypatch):
    """-w 1 and -w 2 print whisper_tpu's line formats (-w 2 at two sizes
    here: the full sweep is the card's)."""
    rc, out = _run(["-w", "1"])
    want = jcapi.whisper_bench_memcpy_str(1)
    assert rc == 0
    assert re.sub(r"[\d.]+ GB/s", "X", out.strip()) == \
        re.sub(r"[\d.]+ GB/s", "X", want)
    monkeypatch.setattr(capi, "MUL_MAT_SIZES", (64, 128))
    rc, out = _run(["-w", "2", "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 4
    assert all(MUL_MAT_LINE.match(line) for line in lines), lines
    assert [line.split(":")[0] for line in lines] == \
        ["    64 x   64"] * 2 + ["   128 x  128"] * 2
    assert [line.split()[3] for line in lines] == ["F32", "BF16"] * 2


def test_latency_step(monkeypatch):
    """-w 3's step (mel, encode at a shrunk audio_ctx, cross-KV, greedy
    steps through the filter chain) at B = 1 and 2, one iteration, on
    random weights at micro dims (a --size of their own)."""
    monkeypatch.setitem(MODEL_DIMS, "micro", DIMS)
    lat = bench_tool.bench_latency("micro", Bs=(1, 2), audio_ctx=16,
                                   n_tokens=3, iters=1, device="cpu")
    assert sorted(lat) == ["b1_step_ms", "b2_step_ms"]
    assert all(v > 0 for v in lat.values())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(["-w", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(["--size", "tiny"])
