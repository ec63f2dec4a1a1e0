"""On the card: the micro cells through the whole harness, traced, with
the device trace read.  Run there with

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests/test_bench_gpu.py
"""

from __future__ import annotations

import pytest
import torch



@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["micro.batch", "micro.server"])
def test_micro_cell_on_the_card(micro, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.run import run_cell
    line = run_cell(micro, cell, 3, 3.0, True, "cuda", micro.parent / "bm")
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "checks" and "breakdown" in line
