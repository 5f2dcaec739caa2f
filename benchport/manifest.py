"""What a cell is made of, found by name from BENCHMARK.json.

  * a configuration: BENCHMARK.json's `configs` entry and the JSON file it
    names (base, field size, mode, the fields the check samples);
  * a traffic mix: benchport/traffic/<traffic>.json, the parameters of the
    one generator (traffic.py);
  * a metric, end-to-end or per-layer: benchport/metrics/<name>.py, a reader
    `read(run)` that returns its value, or None where it finds nothing to
    read, beside its LAYER, UNIT, SOURCE and MOVES;
  * a group of kernel names: benchport/kernels/<group>/*.json, one file a
    kernel symbol, each with the program's launch counter that counts it.

A new configuration, mix, metric or kernel name is a new file and an entry
in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = "BENCHMARK.json"


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, MANIFEST)) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in {MANIFEST}")


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in a cell: its `workloads`, or every
    cell where it has none."""
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One workload of the manifest with its configuration, mix and
    metrics, read from the files under `root`."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.manifest = load(root)
        self.workload = _by_name(self.manifest["workloads"], name, "workload")
        self.name = name
        entry = _by_name(self.manifest["configs"], self.workload["config"],
                         "config")
        self.config = _read_json(os.path.join(root, entry["file"]))
        self.mix = _read_json(os.path.join(
            root, "benchport", "traffic", self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        """The end-to-end metrics of the cell, or its per-layer ones."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[kind] if applies(m, self.name)]

    def reader(self, metric: str) -> ModuleType:
        return load_reader(metric, self.root)


def load_reader(metric: str, root: str = ROOT) -> ModuleType:
    path = os.path.join(root, "benchport", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchport.metrics." + metric.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_names(group: str, root: str = ROOT) -> list[dict]:
    """[{"kernel": symbol, "launches": counter}] of a group, by file name."""
    d = os.path.join(root, "benchport", "kernels", group)
    return [_read_json(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".json")]
