"""Reads `BENCHMARK.json` and finds a cell's files by name: its
configuration (`configs[].file`), its traffic mix
(`bench/traffic/<traffic>.json`), the runner of the mix's `entry`
(`bench/runners/<entry>.py`) and a reader module for each of its
metrics (`bench/metrics/<metric>.py`).  Nothing here names a cell, a
configuration, a mix or a metric: a new one is new files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
METRICS_DIR = BENCH / "metrics"
RUNNERS_DIR = BENCH / "runners"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(root: Path, name: str) -> Cell:
    """The cell `name` of root's BENCHMARK.json with its files read.
    Raises KeyError for a cell the file does not list."""
    spec = load(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["chips"], config, traffic, e2e, layer)


def _module(path: Path, prefix: str):
    name = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"{prefix}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(run)` function of `bench/metrics/<metric>.py`."""
    return _module(METRICS_DIR / f"{metric}.py", "bench_metric").read


def runner(entry: str):
    """The `Runner` class of `bench/runners/<entry>.py`."""
    return _module(RUNNERS_DIR / f"{entry}.py", "bench_runner").Runner
