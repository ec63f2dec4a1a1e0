"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json beside this folder).  Without
a CUDA card, or with fewer than the cell asks for, it prints no result
and exits 2; if JAX or the JAX package was loaded in this process it
exits 3 once the window has closed.  The last lines on standard error are
the numbers compared, each beside its limit; the last line on standard
output is the result: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device (and
with --trace 1 busy_s, window_s and the breakdown), then the checks.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (whisper_tpu_torch is the port, and allowed)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def _finite(x):
    """The structure with every non-finite float as None (JSON has none)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def run_cell(bench_file: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", root: Path = HERE) -> dict:
    """Drive the cell and -> its result line (a dict).  Tests call it with
    device="cpu"; the command checks the card first."""
    from benchmark import cells
    cell = cells.load(bench_file, workload, root)
    out = cell.entry().run(cell, seed, seconds, trace, device)
    metrics = {}
    if trace:
        rec = out["record"]
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    dev = dict(out["device"])
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["record"] and out["record"]["trace"]:
        dev["busy_s"] = out["record"]["trace"]["busy_s"]
        dev["window_s"] = out["record"]["trace"]["window_s"]
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return _finite(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import cells
    chips = cells.load(ROOT / "BENCHMARK.json", args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no result)", file=sys.stderr)
        return 2
    line = run_cell(ROOT / "BENCHMARK.json", args.workload, args.seed,
                    args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package loaded: {bad} (no result)",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
