"""The port's nicelint (nice_tpu_torch/analysis/, scripts/nicelint.py): each
rule on a fixture mini-project it flags and on a clean twin, the rules the
reference also has (A1, M1, K1's environment reads) against the JAX
package's rules on the same fixture text, the ratchet through the command
line, and the port's own tree clean under --strict.
"""

import json
import os
import subprocess
import sys

import pytest

from nice_tpu.analysis import core as jcore
from nice_tpu_torch.analysis import core
from nice_tpu_torch.scripts import nicelint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root, files: dict) -> core.Project:
    for rel, text in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return core.Project(str(root))


def _keys(project, rule):
    kept, _, _ = core.run_rules_tracked(project, only=[rule])
    return sorted(v.key for v in kept)


A1_BAD = '''\
import os

def save(path, data):
    with open(path, "w") as f:
        f.write(data)

def append(path):
    return open(path, mode="a")
'''
A1_GOOD = '''\
from nice_tpu_torch.utils import fsio

def save(path, data):
    fsio.atomic_write_text(path, data)

def load(path):
    with open(path) as f:
        return f.read()

def sink(path):
    # nicelint: allow A1 (streaming append-only sink)
    return open(path, "a")
'''

D1_BAD = '''\
import torch

def collect(counts, hist, ev):
    ev.synchronize()
    total = counts.sum().item()
    return hist.cpu().numpy(), counts.tolist(), total
'''
D1_GOOD = '''\
import numpy as np
import torch

def collect(counts, hist, ev, flat):
    ev.synchronize()  # nicelint: fence (the one wait)
    # nicelint: fence (counts landed at the event)
    total = counts.sum().item()
    hits = np.nonzero(flat)[0].tolist()  # host data
    return total, hits
'''

K1_BAD = '''\
import os
from os import getenv

def depth():
    return int(os.environ.get("NICE_TPU_FEED_DEPTH", "2"))

def mxu():
    return os.getenv("NICE_TPU_MXU")

def home():
    return os.environ["NICE_TPU_FEED_DEPTH"], dict(os.environ)
'''
# What the reference's K1 (a) reads: literal NICE_TPU_* names it declares.
K1_REF = '''\
import os

def depth():
    return int(os.environ.get("NICE_TPU_FEED_DEPTH", "2"))

def mxu():
    return os.getenv("NICE_TPU_MXU")

def again():
    return os.environ["NICE_TPU_FEED_DEPTH"]
'''
K1_GOOD = '''\
def depth(feed_depth: int = 2):
    return feed_depth
'''

M1_SERIES_REF = '''\
from . import metrics

DISPATCHES = metrics.counter(
    "nice_engine_dispatches_total", "Dispatches.", labelnames=("mode",))
'''
M1_SERIES = M1_SERIES_REF + 'SERVER_SERIES = ("nice_api_requests_total",)\n'
M1_BAD = '''\
from nice_tpu_torch.obs import metrics

ROGUE = metrics.counter("nice_rogue_total", "Declared at its use.")
NAMES = ("a",)
COMPUTED = metrics.gauge("nice_computed", "h", labelnames=tuple(NAMES))

def read(scrape):
    return scrape["nice_undeclared_total"], scrape["nice_engine_dispatches_total"]
'''
M1_GOOD = '''\
def read(scrape):
    return (scrape["nice_engine_dispatches_total"],
            scrape["nice_engine_"],  # a prefix of declared series
            scrape["nice_api_requests_total"])
'''


@pytest.mark.parametrize("rule,files,want", [
    ("A1", {"nice_tpu_torch/ops/x.py": A1_BAD},
     ["A1|nice_tpu_torch/ops/x.py|append:a", "A1|nice_tpu_torch/ops/x.py|save:w"]),
    ("A1", {"nice_tpu_torch/ops/x.py": A1_GOOD,
            "chip_smoke.py": A1_BAD}, []),  # A1 keeps to the package
    ("D1", {"nice_tpu_torch/ops/engine.py": D1_BAD},
     ["D1|nice_tpu_torch/ops/engine.py|collect->cpu",
      "D1|nice_tpu_torch/ops/engine.py|collect->item",
      "D1|nice_tpu_torch/ops/engine.py|collect->numpy",
      "D1|nice_tpu_torch/ops/engine.py|collect->synchronize",
      "D1|nice_tpu_torch/ops/engine.py|collect->tolist"]),
    ("D1", {"nice_tpu_torch/ops/engine.py": D1_GOOD,
            "nice_tpu_torch/ops/other.py": D1_BAD}, []),  # scope: engine, mesh
    ("K1", {"chip_smoke.py": K1_BAD},
     ["K1|chip_smoke.py|direct-read:NICE_TPU_FEED_DEPTH",
      "K1|chip_smoke.py|direct-read:NICE_TPU_MXU",
      "K1|chip_smoke.py|env-read:<module>:getenv",
      "K1|chip_smoke.py|env-read:home:environ"]),
    ("K1", {"nice_tpu_torch/ops/x.py": K1_GOOD}, []),
    ("M1", {"nice_tpu_torch/obs/series.py": M1_SERIES,
            "nice_tpu_torch/ops/x.py": M1_BAD},
     ["M1|nice_tpu_torch/ops/x.py|global-decl:nice_computed",
      "M1|nice_tpu_torch/ops/x.py|global-decl:nice_rogue_total",
      "M1|nice_tpu_torch/ops/x.py|labels:nice_computed",
      "M1|nice_tpu_torch/ops/x.py|undeclared:nice_undeclared_total"]),
    ("M1", {"nice_tpu_torch/obs/series.py": M1_SERIES,
            "nice_tpu_torch/ops/x.py": M1_GOOD}, []),
])
def test_rule_flags_fixture_and_passes_clean_twin(tmp_path, rule, files, want):
    assert _keys(_tree(tmp_path, files), rule) == want


def test_m1_skips_the_c_entry_points(tmp_path):
    # A nice_* C function of the port's sources is a symbol, not a series.
    project = _tree(tmp_path, {
        "nice_tpu_torch/obs/series.py": M1_SERIES,
        "nice_tpu_torch/csrc/k.cu": 'extern "C" {\nint nice_k_entry(int a) {'
                                     " return a; }\n}\n",
        "nice_tpu_torch/ops/x.py": 'NAME = "nice_k_entry"\n'})
    assert _keys(project, "M1") == []


@pytest.mark.parametrize("rule,text,jax_rel", [
    ("A1", A1_BAD, "ops/x.py"),
    ("K1", K1_REF, "ops/x.py"),
    ("M1", M1_BAD, "ops/x.py"),
])
def test_rule_keys_equal_the_reference_rule(tmp_path, rule, text, jax_rel):
    # The same fixture text under each package's tree: the JAX rule and the
    # port's give the same keys, the package prefix aside.
    series = {"obs/series.py": M1_SERIES_REF} if rule == "M1" else {}
    files = {jax_rel: text, **series}
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jproject = jcore.Project(str(jroot))
    for rel, body in files.items():
        path = jroot / "nice_tpu" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body.replace("nice_tpu_torch.", "nice_tpu."))
    port = _tree(proot, {f"nice_tpu_torch/{k}": v for k, v in files.items()})
    want = sorted({v.key for v in jcore.run_rules(jproject, only=[rule])})
    got = [k.replace("nice_tpu_torch/", "nice_tpu/") for k in _keys(port, rule)]
    assert want and got == want


def test_s1_flags_a_dead_allow_and_keeps_a_live_one(tmp_path):
    project = _tree(tmp_path, {"nice_tpu_torch/ops/x.py": '''\
def live(path):
    return open(path, "w")  # nicelint: allow A1 (a report)

def dead(path):
    return path  # nicelint: allow A1 (nothing writes here)
'''})
    kept, allowed, used = core.run_rules_tracked(project, only=["A1"])
    assert kept == [] and len(allowed) == 1
    dead = core.dead_suppressions(project, {"A1"}, used)
    assert [v.key for v in dead] == ["S1|nice_tpu_torch/ops/x.py|dead:A1:dead"]
    # A marker naming a rule that did not run is not judged.
    assert core.dead_suppressions(project, {"D1"}, used) == []


def _baseline(root):
    with open(os.path.join(str(root), core.BASELINE_RELPATH)) as f:
        return json.load(f)["entries"]


def test_ratchet_new_finding_fails_and_stale_entry_fails_strict(tmp_path):
    _tree(tmp_path, {"nice_tpu_torch/ops/x.py": A1_BAD,
                     "nice_tpu_torch/analysis/baseline.json": json.dumps({
                         "entries": {"C2|nice_tpu_torch/ops/e.py|x": "kept"}})})
    root = str(tmp_path)
    assert nicelint.main(["--root", root]) == 1  # new findings
    assert nicelint.main(["--root", root, "--update-baseline"]) == 0
    entries = _baseline(root)
    # The other family's key survives the rewrite.
    assert entries["C2|nice_tpu_torch/ops/e.py|x"] == "kept"
    assert "A1|nice_tpu_torch/ops/x.py|save:w" in entries
    assert nicelint.main(["--root", root, "--strict"]) == 0
    (tmp_path / "nice_tpu_torch/ops/x.py").write_text(A1_GOOD)
    assert nicelint.main(["--root", root]) == 0  # fixed: stale entries only
    assert nicelint.main(["--root", root, "--strict"]) == 1
    assert nicelint.main(["--root", root, "--rules", "Z9"]) == 2


def test_port_tree_is_nicelint_clean_strict():
    # python -m nice_tpu_torch.scripts.nicelint --strict, on the repository,
    # with the committed (empty) baseline.
    proc = subprocess.run(
        [sys.executable, "-m", "nice_tpu_torch.scripts.nicelint", "--strict"],
        cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert core.load_baseline(REPO) == {}
