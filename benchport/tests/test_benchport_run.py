"""Whole runs of the harness on the CPU (the kernels' plain versions, tiny
fields), the look for a card left out: correct when the program is sound,
and not correct with the timed path broken underneath in each way a cell
of one card can break it."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchport import manifest, reference, run
from nice_tpu_torch.core.types import (
    FieldResults,
    FieldSize,
    NiceNumberSimple,
    UniquesDistributionSimple,
)
from nice_tpu_torch.ops import engine

from conftest import CPU_ARGV

SEED = 2**31 + 12345


def whole_run(root, workload="t10.thin", seconds=1, trace=False):
    cell = manifest.Cell(workload, root=root)
    r = run.drive(cell, SEED, seconds, trace, client_argv=CPU_ARGV)
    return run.result_line(r, cell, SEED, trace, {"platform": "cpu"}, "cpu")


@pytest.mark.parametrize("workload", ["t10.thin", "t40.thin"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_is_correct(tiny_root, workload, trace):
    line = whole_run(tiny_root, workload, trace=trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert all(v["value"] == 0 == v["limit"] for v in line["checks"].values())
    names = {m["name"] for m in manifest.Cell(workload, root=tiny_root)
             .metrics(trace)}
    if not trace:
        assert set(line["metrics"]) == names
    else:
        assert set(line["metrics"]) <= names


def _broken(monkeypatch, alter):
    real = engine.process_range_detailed
    last = {}

    def process(range_, base, **kw):
        res = alter(real, range_, base, kw, last)
        last["res"] = res
        return res

    monkeypatch.setattr(engine, "process_range_detailed", process)


def stale(real, range_, base, kw, last):
    """A step that returns its state unchanged: the last field's answer."""
    return last.get("res") or real(range_, base, **kw)


def half(real, range_, base, kw, last):
    """Half of the field left out, the histogram of the rest doubled."""
    mid = range_.start() + range_.size() // 2
    res = real(FieldSize(range_.start(), mid), base, **kw)
    dist = tuple(dataclasses.replace(d, count=2 * d.count)
                 for d in res.distribution)
    return FieldResults(dist, res.nice_numbers)


def moved_count(real, range_, base, kw, last):
    """An answer altered where it is produced: one number counted a bin up."""
    res = real(range_, base, **kw)
    dist = list(res.distribution)
    i = next(i for i, d in enumerate(dist) if d.count)
    dist[i] = dataclasses.replace(dist[i], count=dist[i].count - 1)
    dist[i + 1] = dataclasses.replace(dist[i + 1], count=dist[i + 1].count + 1)
    return FieldResults(tuple(dist), res.nice_numbers)


def dropped_near_miss(real, range_, base, kw, last):
    """An answer altered where it is produced: the near misses dropped."""
    res = real(range_, base, **kw)
    return FieldResults(res.distribution, ())


def altered_near_miss(real, range_, base, kw, last):
    """An answer altered where it is produced: a near miss's number."""
    res = real(range_, base, **kw)
    return FieldResults(res.distribution, tuple(
        NiceNumberSimple(n.number + 1, n.num_uniques)
        for n in res.nice_numbers))


@pytest.mark.parametrize("fault", [stale, half, moved_count,
                                   dropped_near_miss, altered_near_miss])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    line = whole_run(tiny_root)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


def test_control_in_the_programs_place_is_not_correct(tiny_root, monkeypatch):
    """The control (the reference in float64) put in the program's place."""
    def control(real, range_, base, kw, last):
        bins, near = reference.field_result(base, range_.start(),
                                            range_.end(),
                                            arithmetic="float64")
        return FieldResults(
            tuple(UniquesDistributionSimple(u, c) for u, c in
                  enumerate(bins, 1)),
            tuple(NiceNumberSimple(n, u) for n, u in near))

    _broken(monkeypatch, control)
    line = whole_run(tiny_root, "t40.thin")
    assert line["correct"] is False
    assert line["checks"]["hist_gap"]["value"] > 0


def test_a_field_that_raises_is_not_correct(tiny_root, monkeypatch):
    def boom(real, range_, base, kw, last):
        if "res" in last:  # the warm field passes; the window's first raises
            raise RuntimeError("kernel failed")
        return real(range_, base, **kw)

    _broken(monkeypatch, boom)
    line = whole_run(tiny_root)
    assert line["correct"] is False and line["failed"] >= 1


def test_answers_the_server_would_refuse_read_wrong():
    detailed = manifest.load_mode("detailed")
    fields = [run.Field(47, 55, 0.0, 0.0, {}, detailed.answer([0] * 10, []))]
    got, bad = detailed.readings({"base": 10}, reference, fields, [], "cpu")
    assert got["bins_sum_gap"] == 8 and bad == 1


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "b40.thin", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_harness_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and benchport/."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "benchport",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = subprocess.run(
        [sys.executable, "-m", "benchport.run", "--workload", "b40.thin",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert p.stdout == ""


def test_the_import_check_compares_whole_top_level_names():
    code = ("import sys, types\n"
            "import nice_tpu_torch.client.main, benchport.run\n"
            "from benchport.run import loaded_forbidden\n"
            "print(loaded_forbidden())\n"
            "sys.modules['nice_tpu.ops'] = types.ModuleType('nice_tpu.ops')\n"
            "print(loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr
    assert p.stdout.splitlines() == ["[]", "['nice_tpu']"]


def test_a_run_imports_neither_jax_nor_the_jax_package(tiny_root):
    code = ("import sys\n"
            "sys.path.insert(0, 'benchport/tests')\n"
            "from test_benchport_run import whole_run\n"
            f"whole_run({tiny_root!r}, 't10.thin')\n"
            "from benchport.run import loaded_forbidden\n"
            "print(loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr
    assert p.stdout.splitlines()[-1] == "[]"


def test_harness_sources_import_nothing_of_the_program():
    """The yardstick (the reference, the comparison, the traffic, the
    counts, the peaks, the trace reading, the metric readers, the modes and
    the reference each configuration names) imports nothing of JAX, the JAX package or the port: a mode reaches the
    program only through the run's session."""
    import ast

    files = [os.path.join(manifest.HERE, f) for f in
             ("reference.py", "compare.py", "traffic.py", "opcount.py",
              "peaks.py", "devtrace.py", "manifest.py")]
    for sub in ("metrics", "modes"):
        d = os.path.join(manifest.HERE, sub)
        files += [os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".py")]
    assert any(f.endswith(os.path.join("modes", "detailed.py"))
               for f in files)
    m = manifest.load()
    for entry in m["configs"]:  # each configuration's own reference
        with open(os.path.join(manifest.ROOT, entry["file"])) as f:
            files.append(os.path.join(manifest.ROOT,
                                      json.load(f)["reference"]))
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "nice_tpu", "nice_tpu_torch"), (
                    path, n)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["b40.thin", "b80.thin", "b40.next"])
def test_each_cell_runs_correct_on_the_card(workload, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells drive the CUDA kernels")
    assert run.main(["--workload", workload, "--seed", "77",
                     "--seconds", "2", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
