"""Tiny cells for the CPU tests: the real cells' files, cut to a corpus
and a load that a test run holds."""

from __future__ import annotations

import copy
import json

from harness.cell import ROOT, Cell, find_cell, load_manifest


def _cell(workload: str) -> Cell:
    """The manifest's cell, or for a mix kept for a cell to come
    (``<config>.<traffic>``, not in the manifest) one made from its files
    with the metrics that every cell reports."""
    try:
        return find_cell(workload)
    except SystemExit:
        conf, mix = workload.split(".", 1)
        manifest = load_manifest()
        entry = {c["name"]: c for c in manifest["configs"]}[conf]
        every = lambda ms: [m for m in ms if "workloads" not in m]  # noqa: E731
        return Cell(
            workload, json.loads((ROOT / entry["file"]).read_text()),
            json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json")
                       .read_text()),
            1, every(manifest["end_to_end"]), every(manifest["per_layer"]))


def tiny_cell(workload: str, genome_len: int = 20_000, coverage: float = 10.0,
              samples: int | None = None) -> Cell:
    base = _cell(workload)
    cfg = copy.deepcopy(base.config)
    cfg["name"] += "-tiny"
    cfg["corpus"].update(genome_len=genome_len, coverage=coverage)
    if samples is not None:
        cfg["corpus"]["num_samples"] = samples
    cfg["serve"]["batch_size"] = 512
    traffic = dict(base.traffic, clients=3, kmers_per_request=64,
                   pool_kmers=2048, check_every=2, ramp_s=0.2)
    return Cell(base.name, cfg, traffic, 1, base.end_to_end, base.per_layer)
