"""The benchmark's definition, found by name: BENCHMARK.json and its files.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
`BENCHMARK.json` gives it:

    configs/<config>.json      a deployment of the counting service
    traffic/<traffic>.json     the parameters the one generator reads
    metrics/<metric>.py        a reader: read(ctx) -> float or None

so a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FOLDER = BENCH_DIR.name


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries
    chips: int


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, its configuration and
    traffic files read from the benchmark's folder under `root`."""
    root = pathlib.Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / FOLDER / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def load_reader(metric: str, root: pathlib.Path = ROOT):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = pathlib.Path(root) / FOLDER / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
