"""A cell as BENCHMARK.json names it, and everything found by name under
the benchmark's folder: the configuration file, the traffic file
(traffic/<name>.json), the limits of its comparison (limits/<cell>.json),
the entry that drives the program (entries/<entry>.py), the reader of
each per-layer metric (metrics/<metric>.py) and each kernel's roofline
arithmetic (rooflines/<kernel>.py).  Adding a configuration, a traffic
mix, a cell or a metric adds files and entries; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _module(path: Path):
    """Import a file of the benchmark by path (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    name = f"benchmark.found.{path.parent.name}.{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict             # the configuration file, plus its "name"
    traffic: dict            # the traffic file, plus its "name"
    limits: dict             # the comparison's limits
    end_to_end: list         # BENCHMARK.json metrics this cell reports
    per_layer: list
    root: Path               # the benchmark's folder

    def reader(self, metric: str):
        return _module(self.root / "metrics" / f"{metric}.py")

    def entry(self):
        return _module(self.root / "entries" / f"{self.traffic['entry']}.py")

    def rooflines(self) -> dict:
        """{kernel short name: module} of every roofline file."""
        return {p.stem: _module(p)
                for p in sorted((self.root / "rooflines").glob("*.py"))
                if p.stem != "__init__"}


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(bench_file: Path, workload: str, root: Path = HERE) -> Cell:
    """The cell `workload` of BENCHMARK.json at `bench_file`, its files
    under `root` (the configuration's file path is relative to the
    directory that holds BENCHMARK.json)."""
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file} (have "
                       f"{sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((Path(bench_file).parent / conf["file"]).read_text())
    config["name"] = conf["name"]
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    traffic["name"] = w["traffic"]
    limits = json.loads((root / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e,
                per_layer, Path(root))
