"""The audio-LLM cell (entries/audio_llm.py, configs/uni-moe-2.0-omni.json)
at micro dims on the CPU: the benchmark's folder copied into a temporary
directory with a micro configuration (the published keys at width 64, 4/2
heads, 2 layers, the 4 routed + 2 shared + 1 null experts at widths 96 and
32, a vocabulary of 512, the audio tower at width 64 over large-v3's mel
bands and window), micro traffic and limits, and a BENCHMARK.json naming
the one cell; then the harness through `run.run_cell(..., "cpu")`.  Also
the reference's two copies, the operation count against the reference's
products, and the readers on hand-made records."""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, flops_omni, model_omni
from benchmark.reference import uni_moe_omni as ref
from benchmark.tests.conftest import HERE, REPO

CELL = "micro-omni.batch"
# width 64 throughout; init 0.1 so that the router's probabilities spread
# (at 0.02 and this width they sit near uniform); a route_delta above what
# bf16 moves the micro router's probabilities by on the CPU (0.0024-0.0028
# at seeds 2, 5 and 9; the control's 0.05-0.06)
MICRO = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "num_hidden_layers": 2, "vocab_size": 512,
         "dynamic_intermediate_size": 96, "intermediate_size": 96,
         "shared_intermediate_size": 32, "whisper_hidden_size": 64,
         "whisper_query_tokens_size": 20, "init_std": 0.1,
         "prompt_head": [11, 12, 13], "prompt_tail": [14, 15],
         "eos_token_id": 512, "route_delta": 0.01}
MICRO_ENCODER = {"d_model": 64, "encoder_layers": 2,
                 "encoder_attention_heads": 2, "encoder_ffn_dim": 256}
# between what bf16 on the CPU reads at seeds 2, 5 and 9 (logit gap
# <= 0.0084, logprob gap <= 0.0204, router probabilities <= 0.0028 apart)
# and what the float8 control reads there (0.0 / 0.1704 / 0.1638; 0.1764
# and up; 0.05-0.06): test_control_fails
MICRO_LIMITS = {"max_logit_gap": 0.05, "max_logprob_gap": 0.08,
                "streams_failed": 0, "routes_handed": 1.0,
                "routes_wide_disagree": 0, "routes_rule_broken": 0,
                "route_prob_gap": 0.02}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def micro_config() -> dict:
    cfg = json.loads((HERE / "configs" / "uni-moe-2.0-omni.json").read_text())
    cfg.update(MICRO)
    cfg["whisper_encoder"] = dict(cfg["whisper_encoder"], **MICRO_ENCODER)
    return cfg


@pytest.fixture()
def micro(tmp_path) -> Path:
    """-> the micro BENCHMARK.json; its folder is tmp_path / "bm"."""
    bm = tmp_path / "bm"
    shutil.copytree(HERE, bm, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (bm / "configs" / "micro-omni.json").write_text(
        json.dumps(micro_config()))
    spec = json.loads((HERE / "traffic" / "llm-batch-90s.json").read_text())
    spec.update(batch=3, streams=4, stream_s=40, input_sets=1,
                sample_streams=3, trace_call=1)
    spec["params"]["max_tokens"] = 6
    (bm / "traffic" / "micro-llm.json").write_text(json.dumps(spec))
    (bm / "limits" / f"{CELL}.json").write_text(json.dumps(MICRO_LIMITS))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "micro-omni", "source": "micro",
                         "file": "bm/configs/micro-omni.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"] = [{"name": CELL, "config": "micro-omni",
                           "traffic": "micro-llm", "chips": 1,
                           "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ([CELL] if "uni-moe-2.0-omni.batch"
                              in m["workloads"] else [])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run_micro(bench: Path, trace: bool = False, seed: int = 2,
              seconds: float = 0.5) -> dict:
    from benchmark.run import run_cell
    return run_cell(bench, CELL, seed, seconds, trace, "cpu",
                    bench.parent / "bm")


OMNI_METRICS = {"mfu.omni", "device_idle.omni", "prefill_ms.omni",
                "step_ms.omni", "experts_per_token.omni",
                "moe_roofline.omni"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(micro, trace):
    line = run_micro(micro, trace)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 4
    c = cells.load(micro, CELL, micro.parent / "bm")
    assert {m["name"] for m in c.per_layer} == OMNI_METRICS
    if trace:
        # no device trace and no device time of a span on the CPU:
        # device_idle, the MoE's roofline and the language model's
        # prefill and step times read nothing there
        assert set(line["metrics"]) == OMNI_METRICS - {
            "device_idle.omni", "moe_roofline.omni", "prefill_ms.omni",
            "step_ms.omni"}
        assert 1.0 <= line["metrics"]["experts_per_token.omni"]["value"] <= 2
    else:
        assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    for m in c.per_layer + c.end_to_end:
        if m["name"] in line["metrics"]:
            got = line["metrics"][m["name"]]
            assert got["unit"] == m["unit"] and np.isfinite(got["value"])
    assert set(line["checks"]) == set(MICRO_LIMITS)
    assert line["checks"]["routes_wide_disagree"]["value"] == 0


def test_control_fails(micro):
    """The reference in float8, in the program's place, reads past a limit
    that the program (bf16) keeps."""
    c = cells.load(micro, CELL, micro.parent / "bm")
    out = c.entry().run(c, 2, 0.5, False, "cpu", control=True)
    assert out["correct"] is True, out["checks"]
    over = [name for name in ("logit_gap", "logprob_gap")
            if out["control_gaps"][name].max() > MICRO_LIMITS[f"max_{name}"]]
    assert over or out["control_gaps"]["routes_wide_disagree"].sum() > 0
    assert out["control_gaps"]["route_prob_gap"].max() > \
        MICRO_LIMITS["route_prob_gap"]
    assert out["gaps"]["routes_rule_broken"].sum() == 0
    for name in ("logit_gap", "logprob_gap"):
        assert out["gaps"][name].max() <= MICRO_LIMITS[f"max_{name}"]


def _no_shared(monkeypatch):
    from whisper_tpu_torch.models import uni_moe_omni as omni
    monkeypatch.setattr(omni, "_shared", lambda a, blk, cfg: torch.zeros(
        a.shape, dtype=torch.float32))


def _threshold(monkeypatch):
    from whisper_tpu_torch.models import uni_moe_omni as omni
    orig = omni.route
    monkeypatch.setattr(omni, "route", lambda p, top_p, top_k: orig(
        p, 0.6, top_k))


def _rope_theta(monkeypatch):
    from whisper_tpu_torch.models import uni_moe_omni as omni
    orig = omni.rope_tables
    monkeypatch.setattr(omni, "rope_tables", lambda pos, dh, theta: orig(
        pos, dh, 1e4))


def _renormalised(monkeypatch):
    from whisper_tpu_torch.models import uni_moe_omni as omni
    orig = omni.route

    def route(p, top_p, top_k):
        kept, weight = orig(p, top_p, top_k)
        w = torch.where(kept >= 0, weight, 0.0)
        return kept, weight / w.sum(-1, keepdim=True)
    monkeypatch.setattr(omni, "route", route)


FAULTS = {"shared_dropped": _no_shared, "threshold_0.6": _threshold,
          "rope_theta_1e4": _rope_theta, "renormalised": _renormalised}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(micro, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line = run_micro(micro)
    assert line["correct"] is False, line["checks"]


def test_threshold_fault_is_caught_by_the_rule_alone(micro, monkeypatch):
    """Handed every set (a routing margin wider than any probability), the
    reference cannot see a wrong threshold in the logits: the program's
    sets against the rule on its own probabilities still do."""
    cfg = json.loads((micro.parent / "bm" / "configs" / "micro-omni.json")
                     .read_text())
    cfg["route_delta"] = 2.0
    (micro.parent / "bm" / "configs" / "micro-omni.json").write_text(
        json.dumps(cfg))
    _threshold(monkeypatch)
    line = run_micro(micro)
    assert line["checks"]["routes_rule_broken"]["value"] > 0
    assert line["checks"]["routes_wide_disagree"]["value"] == 0
    assert line["correct"] is False


def _tests_copy():
    path = REPO / "tests" / "uni_moe_omni_reference.py"
    spec = importlib.util.spec_from_file_location("tests_omni_reference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def micro_params():
    cfg = micro_config()
    cfg["compute_dtype"] = "float32"
    cfg["name"] = "micro-omni"
    return cfg, model_omni.make_params(cfg, 7, "cpu")


def test_reference_copies_agree_bit_for_bit(micro_params):
    cfg, params = micro_params
    other = _tests_copy()
    mel = torch.randn(3000, 128, generator=torch.Generator().manual_seed(1))
    outs = []
    for mod in (ref, other):
        ar = mod.Arith("f32")
        enc = mod.encode(params["encoder"], mel, 2, ar)
        audio = mod.connect(params["connector"], enc, 20, ar)
        outs.append((enc, mod.forward(params, cfg, [audio], [[14, 15, 3, 9]],
                                      [22], ar)))
    (e0, a), (e1, b) = outs
    assert torch.equal(e0, e1)
    assert torch.equal(a["logits"][0], b["logits"][0])
    assert torch.equal(a["kept"][0], b["kept"][0])


def test_flops_count_the_references_products(micro_params):
    """flops_omni at micro dims equals the products the reference computes:
    an encoder pass, the connector, a language-model pass over t positions
    with logits over the last n, and the routed experts it ran."""
    cfg, params = micro_params
    ar = ref.Arith("f32")
    mel = torch.randn(3000, 128, generator=torch.Generator().manual_seed(2))
    with FlopCounterMode(display=False) as fc:
        enc = ref.encode(params["encoder"], mel, 2, ar)
    assert fc.get_total_flops() == flops_omni.encoder_window(cfg)
    with FlopCounterMode(display=False) as fc:
        audio = ref.connect(params["connector"], enc, 20, ar)
    assert fc.get_total_flops() == flops_omni.connector(cfg)
    for n_text, first in ((1, 24), (9, 24), (40, 60)):
        ids = [14, 15] + list(range(n_text))
        t = 3 + 20 + len(ids)
        with FlopCounterMode(display=False) as fc:
            out = ref.forward(params, cfg, [audio], [ids], [first], ar)
        assert out["routed"] > 0
        assert fc.get_total_flops() == flops_omni.llm_pass(
            cfg, t, t - first) + flops_omni.routed(cfg, out["routed"])


def _reader(metric):
    return cells._module(HERE / "metrics" / f"{metric}.py")


def _span(count, seconds, value, **extra):
    return dict(count=count, seconds=seconds, self_seconds=seconds,
                value=value, **extra)


# the language model's spans read their device time, not the host's
WINDOW = {"llm_prefill": _span(4, 0.4, 256, stream_seconds=2.0),
          "llm_step": _span(380, 1.0, 380, stream_seconds=7.6),
          "moe": _span(10752, 9.0, 1e6, stream_seconds=8.0),
          "moe_tokens": _span(10752, 0.0, 1000.0),
          "moe_routed": _span(10752, 0.0, 1600.0),
          "moe_bytes": _span(10752, 0.0, 2.0e12)}
RECORD = {"window_s": 10.0, "flops": 4.945e15, "d_model": 3584,
          "trace": {"busy_s": 7.5, "window_s": 10.0},
          "program": {"window": WINDOW, "setup": {}}}
WANT = {"mfu.omni": (50.0, ()), "device_idle.omni": (25.0, ()),
        "prefill_ms.omni": (500.0, ("llm_prefill",)),
        "step_ms.omni": (20.0, ("llm_step",)),
        "experts_per_token.omni": (1.6, ("moe_tokens", "moe_routed")),
        "moe_roofline.omni": (100.0 * (2.0e12 + 2600 * 3584 * 6) / 3.35e12
                              / 8.0, ("moe", "moe_bytes", "moe_tokens",
                                      "moe_routed"))}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_its_record(metric):
    value, reads = WANT[metric]
    read = _reader(metric).read
    assert read(RECORD) == pytest.approx(value, rel=1e-12)
    for name in reads:
        spans = {k: v for k, v in WINDOW.items() if k != name}
        rec = dict(RECORD, program={"window": spans, "setup": {}})
        assert read(rec) is None, name
    # a program without the audio-LLM path or its tracer records nothing
    assert read({"window_s": 10.0, "program": None, "trace": None,
                 "flops": None}) is None
