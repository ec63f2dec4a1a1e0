"""Whole runs of the harness at micro dims on the CPU (the look for a card
skipped): the result line's form, the control failing the comparison,
and the comparison catching the faults a cell can have when the timed
path is broken underneath."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import cells
from benchmark.tests.conftest import MICRO_LIMITS, run_micro

CELLS = ("micro.batch", "micro.server")
SECONDS = {"micro.batch": 1.0, "micro.server": 3.0}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(micro, cell, trace):
    line = run_micro(micro, cell, trace, seconds=SECONDS[cell])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    c = cells.load(micro, cell, micro.parent / "bm")
    want = c.per_layer if trace else c.end_to_end
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in want:
        if m["name"] in line["metrics"]:
            got = line["metrics"][m["name"]]
            assert got["unit"] == m["unit"] and np.isfinite(got["value"])
    assert line["device"]["count"] == 1
    assert set(line["checks"]) == set(c.limits)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(micro, cell):
    """The reference in float8 with int4 K/V, in the program's place, reads
    gaps past the limits that the program (bf16, int8 K/V) keeps."""
    c = cells.load(micro, cell, micro.parent / "bm")
    out = c.entry().run(c, 2, SECONDS[cell], False, "cpu", control=True)
    for name, limit in MICRO_LIMITS.items():
        key = name.removeprefix("max_")
        assert out["gaps"][key].max() <= limit < out["control_gaps"][key].max()


def _stale_step(monkeypatch):
    """decode_step returns its cache unchanged (the new column unwritten)."""
    from whisper_tpu_torch.models import whisper as wm
    orig = wm.decode_step

    def step(params, tokens, pos_ids, cache_index, kv_self, *a, **k):
        copy = {key: t.clone() for key, t in kv_self.items()}
        logits, _ = orig(params, tokens, pos_ids, cache_index, copy, *a, **k)
        return logits, kv_self
    monkeypatch.setattr(wm, "decode_step", step)


def _half_batch(monkeypatch):
    """The second half of the batch left out of the encoder: its rows take
    the first half's cross-K/V."""
    from whisper_tpu_torch.parallel.batch import BatchTranscriber
    orig = BatchTranscriber._encode_batch

    def encode(self, windows):
        out = orig(self, windows)
        h = windows.shape[0] // 2
        for kv in out:
            for t in kv:
                t[:, h:2 * h] = t[:, :h]
        return out
    monkeypatch.setattr(BatchTranscriber, "_encode_batch", encode)


def _altered_token(monkeypatch):
    """Every fifth token of the first row is changed where it is drawn."""
    from whisper_tpu_torch.decode import loop
    orig = loop.draw_or_argmax
    calls = [0]

    def draw(*a, **k):
        tok, keys = orig(*a, **k)
        calls[0] += 1
        if calls[0] % 5 == 2:
            tok = tok.clone()
            tok[0] = (tok[0] + 7919) % 50257
        return tok, keys
    monkeypatch.setattr(loop, "draw_or_argmax", draw)


FAULTS = {"stale_step": _stale_step, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(micro, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    line = run_micro(micro, cell, seconds=SECONDS[cell])
    assert line["correct"] is False, line["checks"]
