"""A configuration's mode is a file: every mode under benchport/modes/
provides the contract, a mode the harness has never seen arrives as one new
file in a root and runs there, the configuration's `reference` is the one
compared, and a mode that is unknown or short of the contract stops the run
with no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchport import compare, manifest, run

from conftest import CPU_ARGV, REFERENCE, TINY, make_root

SEED = 2**31 + 424242

# A niceonly mode written for these tests alone: the program's nice numbers
# against the configuration's reference, on every field.
NICEONLY_MODE = '''"""niceonly: a field answers with its nice numbers."""

from benchport import compare

LIMITS = {"nice_gap": 0}


def warm(session, config, field):
    session.engine.warm_niceonly(int(config["base"]),
                                 int(config["field_size"]),
                                 device=session.args.device,
                                 field_start=field[0])


def stats(session):
    engine = session.engine
    return lambda: dict(engine.LAST_NICEONLY_STATS)


def pick(config, n_fields, seed):
    return compare.sample(n_fields, int(config["check_fields"]), seed)


def readings(config, reference, fields, picked, device):
    base, gap, bad = int(config["base"]), 0, 0
    for i in picked:
        f = fields[i]
        got = {n.number for n in f.results.nice_numbers}
        miss = len(got ^ set(reference.nice(base, f.start, f.end)))
        gap += miss
        bad += miss > 0
    return {"nice_gap": gap}, bad


class Nice:
    def __init__(self, number):
        self.number = number


class Answer:
    def __init__(self, numbers):
        self.distribution = ()
        self.nice_numbers = tuple(Nice(n) for n in numbers)


def control(config, reference, field, device):
    return Answer(reference.nice(int(config["base"]), field.start,
                                 field.end, float64=True))
'''

NICE_REFERENCE = '''"""The nice numbers of a field, on Python ints (float64: the control)."""


def nice(base, start, end, float64=False):
    out = []
    for n in range(start, end):
        x = float(n) if float64 else n
        seen = set()
        for v in (x * x, x * x * x):
            v = int(v)
            while v:
                v, d = divmod(v, base)
                seen.add(d)
        if len(seen) == base:
            out.append(n)
    return out
'''

# The same, with 69 left out: a reference that has to fail the program.
DROPS_69 = NICE_REFERENCE.replace("    return out",
                                  "    return [n for n in out if n != 69]")

TINY_N10 = {"base": 10, "mode": "niceonly", "field_size": 53,
            "check_fields": 2, "warm_index": 0, "profile_seconds": 0.3,
            "reference": "benchport/nice_reference.py"}
N10_CELL = {"name": "n10.thin", "config": "tiny-n10", "traffic": "thin",
            "chips": 1, "why": "test"}


def _write(root, rel, text):
    with open(os.path.join(root, rel), "w") as f:
        f.write(text)


def _result(root, workload, client_argv):
    cell = manifest.Cell(workload, root=root)
    r = run.drive(cell, SEED, 1, False, client_argv=client_argv)
    line = run.result_line(r, cell, SEED, False, {"platform": "cpu"}, "cpu")
    return cell, r, line


def test_every_mode_file_provides_the_contract():
    d = os.path.join(manifest.HERE, "modes")
    modes = sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py"))
    assert "detailed" in modes
    configured = {manifest.Cell(w["name"]).config["mode"]
                  for w in manifest.load()["workloads"]}
    assert configured <= set(modes)
    for mode in modes:
        module = manifest.load_mode(mode)
        assert all(callable(getattr(module, k))
                   for k in manifest.MODE_CONTRACT if k != "LIMITS")
        assert module.LIMITS and all(
            isinstance(v, (int, float)) for v in module.LIMITS.values())


@pytest.mark.parametrize("reference,correct", [(NICE_REFERENCE, True),
                                               (DROPS_69, False)])
def test_a_niceonly_mode_arrives_as_one_new_file(tmp_path, reference,
                                                 correct):
    """One mode file, one configuration and one cell, in this root alone:
    the client finds 69 in [47, 100) on the CPU, each field keeps its own
    copy of LAST_NICEONLY_STATS, and a reference that leaves 69 out reads
    the same answers incorrect."""
    root = make_root(tmp_path, extra_configs={"tiny-n10": TINY_N10},
                     extra_cells=[N10_CELL])
    _write(root, "benchport/modes/niceonly.py", NICEONLY_MODE)
    _write(root, "benchport/nice_reference.py", reference)
    assert not os.path.exists(os.path.join(manifest.HERE, "modes",
                                           "niceonly.py"))

    cell, r, line = _result(root, "n10.thin", ("--device", "cpu"))
    assert cell.mode.__file__.startswith(root)
    assert r.fields and all((f.start, f.end) == (47, 100) for f in r.fields)
    assert all([n.number for n in f.results.nice_numbers] == [69]
               for f in r.fields)
    assert all(f.stats and "route" in f.stats for f in r.fields)
    assert len({id(f.stats) for f in r.fields}) == len(r.fields)
    assert line["correct"] is correct
    assert line["checks"] == {"nice_gap": {"value": 0 if correct else 2,
                                           "limit": 0}}
    assert line["failed"] == (0 if correct else 2)
    got, _, checked = compare.check(cell, r.fields, SEED, "cpu",
                                    control=True)
    assert checked == 2 and set(got) == {"nice_gap"}
    assert run.loaded_forbidden() == []


WRONG_REFERENCE = '''
_exact = field_result


def field_result(base, start, end, *args, **kw):
    """The reference with one number counted a bin down."""
    bins, near = _exact(base, start, end, *args, **kw)
    i = next(i for i in range(1, len(bins)) if bins[i])
    bins[i] -= 1
    bins[i - 1] += 1
    return bins, near
'''


def test_the_configurations_reference_is_the_one_compared(tmp_path):
    """A detailed configuration whose `reference` names a planted wrong
    file reads the sound program incorrect."""
    wrong = dict(TINY["tiny-b10"], reference="benchport/wrong_reference.py")
    cell = dict(N10_CELL, name="w10.thin", config="tiny-w10")
    root = make_root(tmp_path, extra_configs={"tiny-w10": wrong},
                     extra_cells=[cell])
    with open(os.path.join(root, REFERENCE)) as f:
        _write(root, "benchport/wrong_reference.py",
               f.read() + WRONG_REFERENCE)
    _, _, line = _result(root, "t10.thin", CPU_ARGV)
    assert line["correct"] is True
    _, _, line = _result(root, "w10.thin", CPU_ARGV)
    assert line["correct"] is False
    assert line["checks"]["hist_gap"]["value"] > 0
    assert line["checks"]["bins_sum_gap"]["value"] == 0


LACKS_READINGS = '''LIMITS = {"gap": 0}


def warm(session, config, field):
    pass


def stats(session):
    return dict


def pick(config, n_fields, seed):
    return []


def control(config, reference, field, device):
    return None
'''


@pytest.mark.parametrize("mode,text", [("nosuch", None),
                                       ("short", LACKS_READINGS)])
def test_an_unknown_or_short_mode_gives_no_result(tmp_path, mode, text):
    """A run in a checkout whose configuration names a mode with no file, or
    one short of the contract, exits with no result and names the file."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "benchport",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    cfg_path = tmp_path / "benchport" / "configs" / "detailed-b40.json"
    cfg = json.loads(cfg_path.read_text())
    cfg_path.write_text(json.dumps(dict(cfg, mode=mode)))
    if text is not None:
        (tmp_path / "benchport" / "modes" / f"{mode}.py").write_text(text)
    with pytest.raises((FileNotFoundError, AttributeError),
                       match=f"modes/{mode}.py"):
        manifest.Cell("b40.thin", root=str(tmp_path))
    p = subprocess.run(
        [sys.executable, "-m", "benchport.run", "--workload", "b40.thin",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    assert p.returncode != 0
    assert p.stdout == ""
    assert f"modes/{mode}.py" in p.stderr


@pytest.mark.parametrize("key,value", [
    ("reference", "../outside_reference.py"),
    ("reference", "/outside_reference.py"),
    ("mode", "../reference"),
])
def test_a_file_outside_its_place_is_refused(tmp_path, key, value):
    """A configuration's reference lies inside the checkout, and its mode
    under benchport/modes/."""
    cfg = dict(TINY["tiny-b10"], **{key: value})
    cell = dict(N10_CELL, name="o10.thin", config="tiny-o10")
    root = make_root(tmp_path / "root", extra_configs={"tiny-o10": cfg},
                     extra_cells=[cell])
    (tmp_path / "outside_reference.py").write_text(
        (tmp_path / "root" / REFERENCE).read_text())
    manifest.Cell("t10.thin", root=root)
    with pytest.raises(ValueError, match="lies outside"):
        manifest.Cell("o10.thin", root=root)


LOADS_A_FORBIDDEN_MODULE = '''
import sys as _sys
import types as _types

_exact = field_result


def field_result(base, start, end, *args, **kw):
    """The reference, which loads a forbidden module as it runs."""
    _sys.modules.setdefault("forbidden_pkg", _types.ModuleType("forbidden_pkg"))
    return _exact(base, start, end, *args, **kw)
'''


def test_a_comparison_that_loads_a_forbidden_module_gives_no_result(
        tmp_path, monkeypatch, capsys):
    """The process is checked again after the comparison: a reference (or a
    mode) that imports JAX while it runs leaves the run with no result."""
    monkeypatch.setattr(run, "FORBIDDEN", ("forbidden_pkg",))
    loads = dict(TINY["tiny-b10"], reference="benchport/loads_reference.py")
    cell_entry = dict(N10_CELL, name="f10.thin", config="tiny-f10")
    root = make_root(tmp_path, extra_configs={"tiny-f10": loads},
                     extra_cells=[cell_entry])
    with open(os.path.join(root, REFERENCE)) as f:
        _write(root, "benchport/loads_reference.py",
               f.read() + LOADS_A_FORBIDDEN_MODULE)
    try:
        for workload, rc in (("t10.thin", 0), ("f10.thin", 3)):
            cell = manifest.Cell(workload, root=root)
            r = run.drive(cell, SEED, 1, False, client_argv=CPU_ARGV)
            assert run.report(r, cell, SEED, False, {"platform": "cpu"},
                              "cpu") == rc
            out, err = capsys.readouterr()
            if rc:
                assert out == "" and "forbidden_pkg" in err
            else:
                assert json.loads(out.splitlines()[-1])["correct"] is True
    finally:
        sys.modules.pop("forbidden_pkg", None)
