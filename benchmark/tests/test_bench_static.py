"""The benchmark's yardsticks and plumbing, without running the model:
the frozen roofline arithmetic, the model-operation count, the traffic's
determinism, finding files by name, BENCHMARK.json's form, the import
check and the command's refusal without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, flops, model, peaks, traffic
from benchmark.reference import whisper as ref
from benchmark.rooflines import k1, k2
from benchmark.run import forbidden_modules
from benchmark.tests.conftest import HERE, MICRO, REPO


@pytest.mark.parametrize("shape", [(256, 1500, 20, 64), (64, 1500, 20, 64),
                                   (1, 1500, 20, 64), (4, 750, 10, 64)])
def test_k1_roofline_is_chip_smokes(shape):
    import chip_smoke
    nbytes, ops, kind = chip_smoke.work("K1", shape)
    assert k1.work(shape) == (nbytes, ops) and k1.KIND == kind
    assert peaks.bound_s(nbytes, ops, kind) * 1e3 == pytest.approx(
        chip_smoke.bound("K1", shape)[0], rel=1e-12)


@pytest.mark.parametrize("shape", [(256, 20, 64, 1500, 1), (64, 20, 64, 1500, 1),
                                   (4, 20, 64, 1500, 5), (2, 10, 64, 750, 1)])
def test_k2_roofline_is_chip_smokes(shape):
    import chip_smoke
    key, theirs = ("K2", shape[:4]) if shape[4] == 1 else ("K2G", shape)
    nbytes, ops, kind = chip_smoke.work(key, theirs)
    assert k2.work(shape) == (nbytes, ops) and k2.KIND == kind
    assert peaks.PEAK_BYTES == chip_smoke.PEAK_BYTES
    assert peaks.PEAK_OPS == chip_smoke.PEAK_OPS


def test_roofline_shapes_read_the_entry_arguments():
    """The shape each roofline takes from a C entry point's arguments, as
    the port's wrappers pass them (pointers first)."""
    assert k1.shape((1, 2, 3, 4, 8, 1500, 20, 64, 9)) == (8, 1500, 20, 64)
    assert k2.shape((1, 2, 3, 4, 5, 6, 8, 20, 1, 64, 1500, 7, 9)) == \
        (8, 20, 64, 1500, 1)


def _micro_cfg():
    cfg = json.loads((HERE / "configs" / "large-v3.json").read_text())
    cfg.update(MICRO, compute_dtype="float32", name="micro")
    return cfg


def test_flops_count_the_references_products():
    """flops.py at micro dims equals the products the reference computes:
    an encoder pass, the cross K/V, a decoder pass over t positions."""
    cfg = _micro_cfg()
    params = model.make_params(cfg, 5, "cpu")
    ar = ref.Arith("f32")
    mel = torch.randn(3000, cfg["num_mel_bins"])
    with FlopCounterMode(display=False) as fc:
        enc = ref.encode(params, mel, cfg["encoder_attention_heads"], ar)
    assert fc.get_total_flops() == flops.encoder_window(cfg)
    with FlopCounterMode(display=False) as fc:
        kv = ref.cross_kv(params, enc, cfg["decoder_attention_heads"], ar)
    assert fc.get_total_flops() == flops.cross_kv(cfg)
    for t in (1, 13, 70):
        with FlopCounterMode(display=False) as fc:
            ref.decode(params, list(range(t)), kv,
                       cfg["decoder_attention_heads"], ar)
        assert fc.get_total_flops() == flops.decoder_pass(cfg, t)


SPEC = json.loads((HERE / "traffic" / "clips-8s-4.8rps.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, -3])
def test_traffic_is_the_seeds(seed):
    """The same seed gives the same requests and audio; every seed the
    same multiset of clip lengths and gaps, in its own order."""
    a = traffic.schedule(SPEC, seed, 45.0)
    assert a == traffic.schedule(SPEC, seed, 45.0)
    b = traffic.schedule(SPEC, seed + 1, 45.0)
    assert sorted(n for _, n in a) == sorted(n for _, n in b)
    gaps = np.diff([0.0] + [t for t, _ in a])
    gaps_b = np.diff([0.0] + [t for t, _ in b])
    assert np.allclose(np.sort(gaps), np.sort(gaps_b))
    assert [n for _, n in a] != [n for _, n in b]
    assert a[-1][0] <= 45.0 and len(a) > 45.0 * SPEC["rate_per_s"] / 2
    pcm = traffic.clip_pcm(SPEC, seed, 3, 16000)
    assert pcm.dtype == np.int16 and len(pcm) == 16000
    assert np.array_equal(pcm, traffic.clip_pcm(SPEC, seed, 3, 16000))
    assert not np.array_equal(pcm, traffic.clip_pcm(SPEC, seed, 4, 16000))


def test_stream_sets_are_the_seeds():
    spec = json.loads((HERE / "traffic" / "batch-90s.json").read_text())
    spec.update(streams=3, stream_s=2, input_sets=2)
    a = traffic.stream_sets(spec, 2**31 + 5, "cpu")
    b = traffic.stream_sets(spec, 2**31 + 5, "cpu")
    c = traffic.stream_sets(spec, 2**31 + 6, "cpu")
    assert len(a) == 2 and len(a[0]) == 3 and a[0][0].dtype == np.int16
    assert all(np.array_equal(x, y) for s, t in zip(a, b)
               for x, y in zip(s, t))
    assert not np.array_equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][0], a[1][0])


def test_weights_are_the_seeds():
    cfg = _micro_cfg()
    a = model.make_params(cfg, 2**31 + 9, "cpu")
    b = model.make_params(cfg, 2**31 + 9, "cpu")
    c = model.make_params(cfg, 2**31 + 10, "cpu")
    qa, qb = a["decoder"]["blocks"]["q_w"], b["decoder"]["blocks"]["q_w"]
    assert torch.equal(qa, qb)
    assert not torch.equal(qa, c["decoder"]["blocks"]["q_w"])
    assert qa.shape == (2, 128, 128)
    ln = a["encoder"]["blocks"]["attn_ln_w"]
    assert abs(float(ln.mean()) - 1.0) < 0.05


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a cell are added by dropping
    their files and naming them in BENCHMARK.json."""
    bm = tmp_path / "bm"
    shutil.copytree(HERE, bm, ignore=shutil.ignore_patterns("tests"))
    cfg = json.loads((HERE / "configs" / "large-v3.json").read_text())
    cfg["decoder_layers"] = 2
    (bm / "configs" / "new-model.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "clips-8s-4.8rps.json").read_text())
    mix["rate_per_s"] = 1.5
    (bm / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (bm / "limits" / "new-model.new-mix.json").write_text(
        json.dumps({"max_logit_gap": 0.5, "requests_failed": 0}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "bm/configs/new-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-model.new-mix",
                               "config": "new-model", "traffic": "new-mix",
                               "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load(tmp_path / "BENCHMARK.json", "new-model.new-mix", bm)
    assert cell.config["decoder_layers"] == 2
    assert cell.config["name"] == "new-model"
    assert cell.traffic["rate_per_s"] == 1.5
    assert cell.limits["max_logit_gap"] == 0.5
    assert cell.entry().__name__.endswith("server")
    assert set(cell.rooflines()) >= {"k1", "k2"}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_is_whole():
    """Every cell of BENCHMARK.json has its files, every per-layer metric
    a reader, and the names and units keep to their alphabets."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        cell = cells.load(REPO / "BENCHMARK.json", w["name"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
            assert callable(cell.reader(m["name"]).read)
        assert callable(cell.entry().run)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("whisper_tpu", "whisper_tpu.api", "jaxlib.xla",
                 "whisper_tpu_torch_extra", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, fake)
    found = forbidden_modules()
    assert "whisper_tpu" in found and "whisper_tpu.api" in found
    assert "jaxlib.xla" in found
    assert "whisper_tpu_torch_extra" not in found and "jaxtyping" not in found
    assert not any(n.split(".")[0] == "whisper_tpu_torch" for n in found)


def test_the_harness_imports_no_jax():
    """Every module of the benchmark and what its entries import, in a
    fresh interpreter: no module named jax, jaxlib, flax or whisper_tpu
    (compared whole) is loaded."""
    code = (
        "import pkgutil, importlib, benchmark\n"
        "from benchmark import cells\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "import whisper_tpu_torch.server, whisper_tpu_torch.parallel.batch\n"
        "from benchmark.run import ROOT, forbidden_modules\n"
        "for w in ('large-v3.batch',):\n"
        "    c = cells.load(ROOT / 'BENCHMARK.json', w)\n"
        "    c.entry(); c.rooflines(); [c.reader(m['name']) for m in c.per_layer]\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    """No card (this CPU sandbox): no result line, a nonzero exit."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "large-v3.batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_reference_tables_are_the_ports():
    """The reference works its tables out again; they equal the port's."""
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.decode.filters import (FilterConsts,
                                                  FilterOptions,
                                                  _static_suppress_mask)
    from whisper_tpu_torch.weights.vocab import (special_token_ids,
                                                 synthetic_vocab)
    for n_mels in (80, 128):
        assert np.allclose(ref.mel_filterbank(n_mels), mel_filterbank(n_mels),
                           rtol=1e-5, atol=1e-8)
    for n_vocab in (51864, 51865, 51866):
        tok = ref.special_tokens(n_vocab)
        port = special_token_ids(n_vocab)
        assert {k: tok[k[6:]] for k in port} == port
    vocab = synthetic_vocab(51866)
    consts = FilterConsts.from_vocab(vocab, 1500)
    port_mask = np.isinf(_static_suppress_mask(
        consts, FilterOptions(no_timestamps=True)))
    mine = ref.suppressed(ref.special_tokens(51866), 51866, True, False)
    assert np.array_equal(port_mask, mine.numpy())
    initial = ref.suppressed(ref.special_tokens(51866), 51866, True, True)
    assert set(np.flatnonzero(initial.numpy() & ~mine.numpy())) == {
        consts.token_eot, consts.token_space}
