"""Find the highest request rate a server cell sustains, on the card:

    python -m benchmark.sweep --workload <cell> --rates 3 4 5 --seconds 45

One server for all rates (set up once, as a run of the cell would be),
then one window at each rate of the cell's traffic.  For each: requests
sent and completed, the latency's median, 95th percentile and maximum,
the mean latency of the arrivals in each third of the window (a backlog
that grows shows as a rising third), the requests still open when the
window closed, and the engine iterations.  The cell's traffic file then
states 0.8 of the highest sustained rate as a number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark import cells
from benchmark.run import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = cells.load(ROOT / "BENCHMARK.json", args.workload)
    entry = cell.entry()
    served = entry.Served(cell, args.seed, "cuda")
    try:
        for rate in args.rates:
            spec = dict(cell.traffic, rate_per_s=rate)
            n0 = served.engine.n_iterations
            reqs = served.window(spec, args.seed, args.seconds)
            lat = np.asarray([r["done"] - r["due"] for r in reqs])
            due = np.asarray([r["due"] for r in reqs])
            thirds = [float(lat[(due >= args.seconds * k / 3)
                                & (due < args.seconds * (k + 1) / 3)].mean())
                      for k in range(3)]
            print(json.dumps({
                "rate_per_s": rate, "sent": len(reqs),
                "failed": sum(r["status"] != 200 for r in reqs),
                "p50_s": float(np.percentile(lat, 50)),
                "p95_s": entry.p95(reqs), "max_s": float(lat.max()),
                "mean_by_third_s": thirds,
                "open_at_close": int(sum(r["done"] > args.seconds
                                         for r in reqs)),
                "last_done_s": float(max(r["done"] for r in reqs)),
                "iterations": served.engine.n_iterations - n0}), flush=True)
    finally:
        served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
