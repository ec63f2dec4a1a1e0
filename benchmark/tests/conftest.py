"""A micro benchmark for the CPU: the benchmark's folder copied into a
temporary directory with a micro configuration (large-v3's vocabulary,
window and mel, 2 + 2 layers of width 128), micro traffic of both
entries and their limits, and a BENCHMARK.json naming its two cells.
The harness then runs on the CPU through `run.run_cell(..., "cpu")`,
which skips the look for a card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]          # benchmark/
REPO = HERE.parent

# the micro model: large-v3's vocabulary, window, context and mel bands,
# two layers of width 128; init_std 0.1 so that its tokens follow the
# audio (at 0.02 and this depth a window decodes one token over and over)
MICRO = {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_attention_heads": 2,
         "encoder_ffn_dim": 512, "decoder_ffn_dim": 512, "init_std": 0.1}
# the micro cells' limits, between what bf16 on the CPU reads at seed 2
# and what the float8 control reads there (test_bench_runs)
MICRO_LIMITS = {"max_logit_gap": 0.08, "max_logprob_gap": 0.1}


SERVER_METRICS = (("device_idle.server", "%", "device"),
                  ("host_mel_ms.server", "ms", "host mel"),
                  ("iteration_s.server", "s", "scheduler"),
                  ("batch_fill.server", "%", "scheduler"),
                  ("front_ms.server", "ms", "whisper-server"))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture()
def micro(tmp_path) -> Path:
    """-> the micro BENCHMARK.json; its folder is tmp_path / "bm"."""
    return make_micro(tmp_path)


def make_micro(tmp_path: Path) -> Path:
    bm = tmp_path / "bm"
    shutil.copytree(HERE, bm, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.loads((HERE / "configs" / "large-v3.json").read_text())
    cfg.update(MICRO)
    (bm / "configs" / "micro.json").write_text(json.dumps(cfg))
    batch = json.loads((HERE / "traffic" / "batch-90s.json").read_text())
    batch.update(batch=4, streams=4, stream_s=40, input_sets=1,
                 sample_streams=4, trace_call=0)
    batch["params"]["max_tokens"] = 8
    (bm / "traffic" / "micro-batch.json").write_text(json.dumps(batch))
    clips = json.loads((HERE / "traffic" / "clips-8s-4.8rps.json").read_text())
    clips.update(batch=2, rate_per_s=2.0, sample_requests=10,
                 trace_iterations=[0, 1])
    clips["clip_s"].update(median=2.0, max=5.0)
    (bm / "traffic" / "micro-clips.json").write_text(json.dumps(clips))
    (bm / "limits" / "micro.batch.json").write_text(json.dumps(
        dict(MICRO_LIMITS, streams_failed=0)))
    (bm / "limits" / "micro.server.json").write_text(json.dumps(
        dict(MICRO_LIMITS, requests_failed=0)))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "micro", "source": "micro",
                         "file": "bm/configs/micro.json", "reduced": [],
                         "why": "CPU tests"}]
    cells = {"batch": "micro.batch", "server": "micro.server"}
    bench["workloads"] = [
        {"name": "micro.batch", "config": "micro", "traffic": "micro-batch",
         "chips": 1, "why": "CPU tests"},
        {"name": "micro.server", "config": "micro",
         "traffic": "micro-clips", "chips": 1, "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cells["batch"]]
    # the server entry's metrics (their readers are in metrics/)
    server = [cells["server"]]
    bench["end_to_end"].append(
        {"name": "request_p95_s", "unit": "s", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": server})
    for name, unit, layer in SERVER_METRICS:
        bench["per_layer"].append(
            {"name": name, "unit": unit, "better": "lower",
             "source": "program_span", "layer": layer,
             "moves": "request_p95_s", "workloads": server})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run_micro(bench: Path, cell: str, trace: bool = False, seed: int = 2,
              seconds: float = 1.0) -> dict:
    from benchmark.run import run_cell
    return run_cell(bench, cell, seed, seconds, trace, "cpu",
                    bench.parent / "bm")
