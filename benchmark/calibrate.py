"""The readings a cell's limits are set from, on the card:

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ...

For each seed, one run of the cell's entry at its own size with a short
window (`--seconds`), then the reference's gaps of the tokens it served
and the control's gaps (the reference in the precision below the
configuration's, benchmark/reference/whisper.py) on the same sample.
One JSON line a seed on standard output, and at the end the largest
program reading and the smallest control reading.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import cells
from benchmark.run import ROOT, _finite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    cell = cells.load(ROOT / "BENCHMARK.json", args.workload)
    entry = cell.entry()
    program: dict = {}
    control: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = entry.run(cell, seed, args.seconds, False, "cuda",
                        control=True)
        rec = {"workload": args.workload, "seed": seed}
        for key in out["gaps"]:
            gp, gc = out["gaps"][key], out["control_gaps"][key]
            program.setdefault(key, []).append(float(gp.max()))
            control.setdefault(key, []).append(float(gc.max()))
            rec[key] = {"program": program[key][-1],
                        "control": control[key][-1],
                        "program_windows": [float(x) for x in gp],
                        "control_windows": [float(x) for x in gc]}
        rec.update(attempted=out["attempted"], failed=out["failed"],
                   end_to_end=out["end_to_end"], checks=out["checks"],
                   seconds=time.perf_counter() - t0)
        print(json.dumps(_finite(rec)), flush=True)
    for key in program:
        print(json.dumps({"workload": args.workload, "number": key,
                          "program_largest": max(program[key]),
                          "control_smallest": min(control[key]),
                          "ratio": min(control[key])
                          / max(max(program[key]), 1e-30)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
