"""A cell, found by name: its configuration, traffic mix and metrics.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, named after it, so that a new
cell needs new files and entries only:

* ``BENCHMARK.json`` ``configs[].file``: the configuration's file;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters;
* ``benchmark/metrics/<name>.py``: a per-layer metric's reader, a module
  with ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list    # the manifest's entries this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = load_manifest(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(has {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``benchmark/metrics/<name>.py``'s ``read`` function."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
