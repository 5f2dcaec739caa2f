"""The port's client (nice_tpu_torch/client) on the CPU: the offline benchmark
summaries, claim -> process -> submit rounds (detailed and niceonly) against
the JAX package's coordination server, and the import rules of the port (no
jax, nothing of nice_tpu) checked in a clean subprocess and by an AST scan.
"""

import ast
import json
import os
import subprocess
import sys
import threading

import pytest

from nice_tpu.client import main as jclient
from nice_tpu.core.types import DataToClient as JDataToClient
from nice_tpu.core.types import SearchMode as JSearchMode
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
import nice_tpu_torch
from nice_tpu_torch.client import main as client
from nice_tpu_torch.ops import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files() -> list[str]:
    """The port's Python sources: everything under nice_tpu_torch/ but
    _build/, which holds what the port builds at run time (and may hold an
    unpacked copy of the whole repository), and chip_smoke.py."""
    out = []
    for root, dirs, files in os.walk(os.path.dirname(nice_tpu_torch.__file__)):
        dirs[:] = [d for d in dirs if d != "_build"]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out + [os.path.join(REPO, "chip_smoke.py")]


PORT_FILES = _port_files()


def _run_port(*argv, code=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable] + (["-c", code] if code else
                              ["-m", "nice_tpu_torch.client", *argv])
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_benchmark_base_ten_prints_summary():
    proc = _run_port("--benchmark", "base-ten", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["benchmark"] == "base-ten"
    assert summary["nice_count"] == 1
    assert summary["near_misses"] == 1
    assert summary["range_size"] == 53
    assert summary["device"] == "cpu"


def test_niceonly_benchmark_runs_on_cpu():
    proc = _run_port("niceonly", "--benchmark", "base-ten", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["mode"] == "niceonly"
    assert summary["nice_count"] == 1 and summary["near_misses"] == 1
    assert summary["range_size"] == 53 and summary["device"] == "cpu"


def _serve(tmp_path, base: int, field_size: int):
    db_path = str(tmp_path / "nice.db")
    db = Db(db_path)
    db.seed_base(base, field_size=field_size)
    db.close()
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0, prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", db_path


@pytest.fixture
def server(tmp_path):
    httpd, api, db_path = _serve(tmp_path, 17, 4_000)
    yield api, db_path
    httpd.shutdown()


def test_niceonly_round_matches_jax_client(tmp_path):
    # b10's one field, [47, 100), holds 69.
    httpd, api, db_path = _serve(tmp_path, 10, 1_000)
    try:
        args = client.build_parser().parse_args(
            ["niceonly", "--api-base", api, "--username", "torch-test",
             "--device", "cpu"])
        data, sub, resp = client.run_single_iteration(args)
    finally:
        httpd.shutdown()
    assert resp.get("status") == "OK" and not resp.get("duplicate")
    assert (data.base, data.range_start, data.range_end) == (10, 47, 100)

    # The JAX package's client on the same field: the same payload, byte
    # for byte (one client version, so one submit_id).
    jdata = JDataToClient.from_json(data.to_json())
    jres, _ = jclient.process_field(jdata, JSearchMode.NICEONLY, "scalar", None)
    jsub = jclient.compile_results(jdata, jres, JSearchMode.NICEONLY,
                                   "torch-test").to_json()
    # The fleet snapshot rides on the submit after submit_id is stamped, as
    # the JAX client attaches it after compile_results.
    mine = sub.to_json()
    assert mine.pop("telemetry")["v"] == 1
    assert mine == jsub
    assert jsub["unique_distribution"] is None
    assert jsub["nice_numbers"] == [{"number": 69, "num_uniques": 10}]


def test_single_shot_round_matches_jax_client(server, monkeypatch):
    api, db_path = server
    # Small batches keep the plain rare-path re-scan short on the CPU.
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 512)
    args = client.build_parser().parse_args(
        ["detailed", "--api-base", api, "--username", "torch-test",
         "--device", "cpu"])
    data, sub, resp = client.run_single_iteration(args)
    assert resp.get("status") == "OK" and not resp.get("duplicate")
    assert data.base == 17 and data.range_size <= 4_000

    # The JAX package's client on the same field.
    jdata = JDataToClient.from_json(data.to_json())
    jres, _ = jclient.process_field(jdata, JSearchMode.DETAILED, "jnp", 512)
    jsub = jclient.compile_results(jdata, jres, JSearchMode.DETAILED,
                                   "torch-test").to_json()
    mine = sub.to_json()
    assert mine["unique_distribution"] == jsub["unique_distribution"]
    assert mine["nice_numbers"] == jsub["nice_numbers"]
    assert mine["nice_numbers"], "field without near misses: test is vacuous"

    # The server holds exactly this submission for the claimed field.
    db = Db(db_path)
    try:
        subs = db.get_detailed_submissions_by_field(
            db.get_claim_by_id(data.claim_id).field_id)
    finally:
        db.close()
    assert len(subs) == 1 and subs[0].claim_id == data.claim_id
    assert sorted((n.number, n.num_uniques) for n in subs[0].numbers) == [
        (n["number"], n["num_uniques"]) for n in mine["nice_numbers"]]


def test_port_imports_neither_jax_nor_nice_tpu():
    # tests/conftest.py imports jax into every test process, so the check
    # runs in a fresh interpreter that imports every module of the port.
    # It imports every module, then runs niceonly fields (the host
    # library's build, the strided pipeline at b10, the dense loop at b98)
    # and a detailed one (also on a mesh of two slices), and the host
    # engines: the native backend, the niceonly host route and the scalar
    # oracle's chunked checkpoints.
    code = (
        "import importlib, pkgutil, sys\n"
        "import nice_tpu_torch\n"
        "for m in pkgutil.walk_packages(nice_tpu_torch.__path__, 'nice_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from nice_tpu_torch.core.types import FieldSize\n"
        "from nice_tpu_torch.ops import engine\n"
        "r = engine.process_range_niceonly(FieldSize(47, 100), 10, device='cpu')\n"
        "assert [n.number for n in r.nice_numbers] == [69]\n"
        "lo = 413428759798923141071530212209627033363\n"
        "engine.process_range_niceonly(FieldSize(lo, lo + 5000), 98, device='cpu')\n"
        "assert engine.LAST_NICEONLY_STATS['runs'] > 0\n"
        "engine.process_range_detailed(FieldSize(47, 100), 10, device='cpu')\n"
        "engine.process_range_detailed(FieldSize(47, 100), 10, device='cpu',\n"
        "                              devices=['cpu'] * 2, batch_size=16)\n"
        "assert engine.LAST_FEED_STATS['n_dev_start'] == 2\n"
        "engine.process_range_detailed(FieldSize(47, 100), 10, backend='native')\n"
        "engine.process_range_niceonly(FieldSize(47, 100), 10, device='cpu',\n"
        "                              host_niceonly_max=1 << 25)\n"
        "assert engine.LAST_NICEONLY_STATS['route'] == 'host'\n"
        "engine.process_range_niceonly(FieldSize(47, 100), 10, backend='scalar',\n"
        "                              checkpoint_cb=lambda st: None)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'nice_tpu'))\n"
        "mods = sorted(k for k in sys.modules if k.startswith('nice_tpu_torch'))\n"
        "print(len(mods), bad, ','.join(mods))\n"
    )
    proc = _run_port(code=code)
    assert proc.returncode == 0, proc.stderr
    count, bad, mods = proc.stdout.split(" ", 2)
    assert bad.strip() == "[]"
    assert int(count) >= 21  # the walk really imported the package
    for name in ("native", "ops.adaptive_floor", "ops.lsd_filter",
                 "ops.msd_filter", "ops.residue_filter", "ops.stride_filter",
                 "ckpt.manager", "ckpt.snapshot", "faults.spool",
                 "daemon.main", "utils.fsio", "utils.resources",
                 "scripts.bench", "scripts.tune_kernels", "parallel.mesh",
                 "scripts.multichip_scaling"):
        assert f"nice_tpu_torch.{name}" in mods.strip().split(",")


def test_port_sources_have_no_jax_or_nice_tpu_import():
    assert len(PORT_FILES) >= 15
    for path in PORT_FILES:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "nice_tpu"), (path, name)


def test_port_reads_no_environment_variables():
    # Knobs are arguments: no module of the port, and not chip_smoke.py,
    # reads os.environ or os.getenv.
    for path in PORT_FILES:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv", "environb"), \
                    (path, node.lineno)
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                assert not {a.name for a in node.names} & {"environ", "getenv"}, \
                    (path, node.lineno)
