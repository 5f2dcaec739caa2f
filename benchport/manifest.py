"""What a cell is made of, found by name from BENCHMARK.json.

  * a configuration: BENCHMARK.json's `configs` entry and the JSON file it
    names (base, field size, mode, the fields the check samples, the plain
    reference), the file of its `reference` key (a path from the root that
    stays inside it) and
    benchport/modes/<mode>.py, which provides MODE_CONTRACT: the warm-up,
    the per-field stats, the comparison and the control (see
    modes/detailed.py);
  * a traffic mix: benchport/traffic/<traffic>.json, the parameters of the
    one generator (traffic.py);
  * a metric, end-to-end or per-layer: benchport/metrics/<name>.py, a reader
    `read(run)` that returns its value, or None where it finds nothing to
    read, beside its LAYER, UNIT, SOURCE and MOVES;
  * a group of kernel names: benchport/kernels/<group>/*.json, one file a
    kernel symbol, each with the program's launch counter that counts it.

A new configuration, mode, mix, metric or kernel name is a new file and an
entry in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = "BENCHMARK.json"
MODE_CONTRACT = ("LIMITS", "warm", "stats", "pick", "readings", "control")


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
        self.mode = load_mode(self.config["mode"], root)
        self.reference = _load_file(
            _inside(root, self.config["reference"]),
            "benchport.reference_of." + entry["name"].replace(".", "_"))
        self.mix = _read_json(os.path.join(
            root, "benchport", "traffic", self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        """The end-to-end metrics of the cell, or its per-layer ones."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[kind] if applies(m, self.name)]

    def reader(self, metric: str) -> ModuleType:
        return load_reader(metric, self.root)


def _inside(top: str, rel: str) -> str:
    """`rel` joined to `top`, refused where it resolves outside `top`."""
    path = os.path.join(top, rel)
    real_top = os.path.realpath(top)
    if os.path.commonpath([os.path.realpath(path), real_top]) != real_top:
        raise ValueError(f"{path} lies outside {top}")
    return path


def _load_file(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if not os.path.isfile(path) or spec is None or spec.loader is None:
        raise FileNotFoundError(f"no such file: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: str = ROOT) -> ModuleType:
    path = os.path.join(root, "benchport", "metrics", metric + ".py")
    return _load_file(path, "benchport.metrics." + metric.replace(".", "_"))


def load_mode(mode: str, root: str = ROOT) -> ModuleType:
    """benchport/modes/<mode>.py, checked to provide MODE_CONTRACT."""
    path = _inside(os.path.join(root, "benchport", "modes"), mode + ".py")
    module = _load_file(path, "benchport.modes." + mode.replace(".", "_"))
    missing = [k for k in MODE_CONTRACT if not hasattr(module, k)]
    if missing:
        raise AttributeError(f"{path} lacks {', '.join(missing)} of the "
                             f"mode contract")
    return module


def kernel_names(group: str, root: str = ROOT) -> list[dict]:
    """[{"kernel": symbol, "launches": counter}] of a group, by file name."""
    d = os.path.join(root, "benchport", "kernels", group)
    return [_read_json(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".json")]
