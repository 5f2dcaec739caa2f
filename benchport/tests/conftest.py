"""Fixtures of the benchmark's CPU tests: a root that holds a manifest of
tiny cells beside copies of the harness's traffic, metric, kernel and mode
files and of its plain reference."""

import json
import os
import shutil

import pytest

from benchport import manifest

REFERENCE = "benchport/reference.py"
TINY = {
    "tiny-b10": {"base": 10, "mode": "detailed", "field_size": 8,
                 "check_fields": 6, "warm_index": 2, "profile_seconds": 0.3,
                 "reference": REFERENCE},
    "tiny-b40": {"base": 40, "mode": "detailed", "field_size": 4096,
                 "check_fields": 2, "warm_index": 0, "profile_seconds": 0.3,
                 "reference": REFERENCE},
}
# Plain versions on the CPU, in small batches.
CPU_ARGV = ("--device", "cpu", "--batch-size", "256")


def make_root(path, extra_configs=None, extra_cells=()):
    """A root with BENCHMARK.json's metrics, cells t10.thin and t40.thin
    over TINY, and the harness's data files."""
    m = manifest.load()
    configs = dict(TINY, **(extra_configs or {}))
    os.makedirs(path / "benchport" / "configs")
    for sub in ("traffic", "metrics", "kernels", "modes"):
        shutil.copytree(os.path.join(manifest.HERE, sub),
                        path / "benchport" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, REFERENCE), path / REFERENCE)
    for name, cfg in configs.items():
        with open(path / "benchport" / "configs" / f"{name}.json", "w") as f:
            json.dump(cfg, f)
    m["configs"] = [{"name": n, "source": "https://example.org", "reduced": [],
                     "file": f"benchport/configs/{n}.json", "why": "test"}
                    for n in configs]
    m["workloads"] = [
        {"name": "t10.thin", "config": "tiny-b10", "traffic": "thin",
         "chips": 1, "why": "test"},
        {"name": "t40.thin", "config": "tiny-b40", "traffic": "thin",
         "chips": 1, "why": "test"},
        *extra_cells]
    for metric in m["end_to_end"] + m["per_layer"]:
        metric.pop("workloads", None)
    with open(path / "BENCHMARK.json", "w") as f:
        json.dump(m, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
