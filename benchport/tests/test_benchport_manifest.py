"""BENCHMARK.json against the files the harness finds by name, and a new
configuration, mix and metric added as files alone."""

import itertools
import json
import os
import re

import pytest

from benchport import manifest, run, traffic

from conftest import CPU_ARGV, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    m = manifest.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchport"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_finds_its_files():
    m = manifest.load()
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"])
        assert cell.config["base"] in (40, 80)
        assert next(traffic.fields(cell.config, cell.mix, 1))
        traffic.warm_field(cell.config)
        for trace in (False, True):
            assert cell.metrics(trace)


def test_metric_files_agree_with_the_manifest():
    m = manifest.load()
    kinds = {"end_to_end": m["end_to_end"], "per_layer": m["per_layer"]}
    for kind, metrics in kinds.items():
        for entry in metrics:
            reader = manifest.load_reader(entry["name"])
            assert reader.UNIT == entry["unit"]
            assert reader.SOURCE == entry["source"]
            if kind == "per_layer":
                assert reader.LAYER == entry["layer"]
                assert reader.MOVES == entry["moves"]
                moved = next(e for e in m["end_to_end"]
                             if e["name"] == entry["moves"])
                for w in entry.get("workloads", []):
                    assert manifest.applies(moved, w)


def test_config_files_state_their_source():
    for entry in manifest.load()["configs"]:
        with open(os.path.join(manifest.ROOT, entry["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"] == []
        assert cfg["field_size"] == 10**9


NEW_METRIC = '''"""fields_per_window: the fields the window completed."""

LAYER = "client"
UNIT = "fields"
SOURCE = "program_counter"
MOVES = "numbers_per_s"


def read(run):
    return float(len(run.fields))
'''


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    new_cfg = {"tiny-b12": {"base": 12, "mode": "detailed", "field_size": 64,
                            "check_fields": 3, "warm_index": 1,
                            "reference": "benchport/reference.py"}}
    cell = {"name": "t12.every", "config": "tiny-b12", "traffic": "every",
            "chips": 1, "why": "test"}
    root = make_root(tmp_path, extra_configs=new_cfg, extra_cells=[cell])
    with open(os.path.join(root, "benchport", "traffic", "every.json"),
              "w") as f:
        json.dump({"order": "sequential", "start_fields": 1}, f)
    with open(os.path.join(root, "benchport", "metrics",
                           "fields_per_window.py"), "w") as f:
        f.write(NEW_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["per_layer"].append({"name": "fields_per_window", "unit": "fields",
                           "better": "higher", "source": "program_counter",
                           "layer": "client", "moves": "numbers_per_s",
                           "workloads": ["t12.every"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)

    c = manifest.Cell("t12.every", root=root)
    assert c.config["base"] == 12 and c.mix["order"] == "sequential"
    assert "fields_per_window" in [x["name"] for x in c.metrics(True)]
    assert "fields_per_window" not in [
        x["name"] for x in manifest.Cell("t10.thin", root=root).metrics(True)]
    r = run.drive(c, 5, 1, True, client_argv=CPU_ARGV)
    got = run.read_metrics(c, r, True)
    assert got["fields_per_window"]["value"] == len(r.fields) > 0
    assert got["fields_per_window"]["unit"] == "fields"
    expected = itertools.islice(traffic.fields(c.config, c.mix, 5), 3)
    assert [f.start for f in r.fields[:3]] == [s for s, _ in expected]


def test_unknown_names_raise(tiny_root):
    with pytest.raises(KeyError):
        manifest.Cell("nope", root=tiny_root)
