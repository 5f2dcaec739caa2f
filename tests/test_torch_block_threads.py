"""The block size as a tuning axis on the CPU: block_threads (the port's
counterpart of the JAX package's block_rows) through resolve_tuning, the
winners table, the wrappers, the plain versions, the tuning harness's
--sweep-threads, blocks and stride-blocks kinds, autotune.sweep and a
scheduler page. The kernels themselves run only on the card
(tests/test_torch_cuda.py); here every wrapper takes its plain version.
"""

import json

import numpy as np
import pytest
import torch

from nice_tpu.ops import limbs as jlimbs
from nice_tpu.ops import pallas_engine as pe
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor, autotune, engine
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs
from nice_tpu_torch.scripts import tune_kernels

BAD = (0, 16, 48, 288, 512)
DEFAULT = ce.DEFAULT_BLOCK_THREADS
SEED = 20261018


@pytest.fixture(autouse=True)
def _isolated_table(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "WINNERS_PATH", str(tmp_path / "winners.json"))
    autotune.reset_for_tests()
    autotune.reset_events()
    yield
    autotune.reset_for_tests()
    adaptive_floor.reset_for_tests()


def _start(plan, x):
    return ve.start_limbs_tensor(x, plan, "cpu")


def _seeded_start(base: int, lanes: int, seed: int = SEED) -> int:
    plan = get_plan(base)
    rng = np.random.default_rng(seed + base)
    span = plan.range_end - plan.range_start - lanes
    return plan.range_start + int.from_bytes(rng.bytes(32), "little") % span


# -- the rule -----------------------------------------------------------------

def test_admissible_set_is_whole_warps_to_256():
    assert ce.admissible_block_threads() == tuple(range(32, 257, 32))
    assert ce.admissible_block_threads(1) == tuple(range(64, 257, 32))
    assert DEFAULT == ce.BLOCK_THREADS_MAX == 256
    assert ce.STRIDED_BLOCK_THREADS == DEFAULT
    for t in range(-64, 600):
        assert ce.block_threads_ok(t) == (t in ce.admissible_block_threads())
        assert ce.block_threads_ok(t, 1) == (t in ce.admissible_block_threads(1))


@pytest.mark.parametrize("bad", [*BAD, 256.0, True, "256"])
def test_check_refuses_what_the_rule_refuses(bad):
    with pytest.raises(ValueError, match="block_threads"):
        ce.check_block_threads(bad)


# -- resolve_tuning -----------------------------------------------------------

def test_resolve_tuning_precedence_argument_winner_default():
    assert engine.resolve_tuning("detailed", 40, "cpu")[3] == DEFAULT
    assert autotune.EVENTS["miss"] == 4
    autotune.record("detailed", 40, "cpu", {"block_threads": 128})
    assert engine.resolve_tuning("detailed", 40, "cpu")[3] == 128
    assert engine.resolve_tuning("detailed", 40, "cpu",
                                 block_threads=64)[3] == 64
    # Another mode or base keeps the default; the scalar backend has no knob.
    assert engine.resolve_tuning("niceonly", 40, "cpu")[3] == DEFAULT
    assert engine.resolve_tuning("detailed", 17, "cpu")[3] == DEFAULT
    assert engine.resolve_tuning("detailed", 40, "cpu",
                                 backend="scalar")[3] == DEFAULT


@pytest.mark.parametrize("bad", BAD)
def test_resolve_tuning_raises_on_a_bad_argument(bad):
    with pytest.raises(ValueError, match="block_threads"):
        engine.resolve_tuning("detailed", 40, "cpu", block_threads=bad)


@pytest.mark.parametrize("bad", BAD)
def test_resolve_tuning_raises_on_a_stale_winner(bad):
    """Nothing clamps a winner: one the kernel does not take raises."""
    autotune.record("niceonly", 98, "cpu", {"block_threads": bad})
    with pytest.raises(ValueError, match="block_threads"):
        engine.resolve_tuning("niceonly", 98, "cpu")


def test_k5_needs_two_warps():
    """K5's least block is 64: a 32 that K1 takes raises once use_mxu
    resolves to 1, from an argument or a winner."""
    assert engine.resolve_tuning("detailed", 40, "cpu", use_mxu=0,
                                 block_threads=32)[3] == 32
    with pytest.raises(ValueError, match="K5"):
        engine.resolve_tuning("detailed", 40, "cpu", use_mxu=1,
                              block_threads=32)
    autotune.record("detailed", 40, "cpu", {"use_mxu": 1, "block_threads": 32})
    with pytest.raises(ValueError, match="K5"):
        engine.resolve_tuning("detailed", 40, "cpu")
    assert engine.resolve_tuning("detailed", 40, "cpu", use_mxu=0)[2:] == (0, 32)


# -- the wrappers and the plain versions --------------------------------------

def _k1(plan, threads, use_mxu=0, plain=False, batch=256, n_iters=2):
    start = _seeded_start(plan.base, batch * n_iters)
    acc = torch.zeros(plan.base + 2, dtype=torch.int32)
    fn = ve.detailed_accum_megaloop if plain else ce.detailed_accum_megaloop
    kw = {"block_threads": threads}
    h, nm = fn(plan, batch, n_iters, acc, _start(plan, start),
               batch * n_iters - 7, use_mxu, **kw)
    return h.tolist() + [int(nm)]


def _k3(plan, threads, plain=False):
    table_mod, res = 6, torch.tensor([1, 5], dtype=torch.int64)
    lo = _seeded_start(plan.base, 1 << 12)
    desc = np.zeros((4, ce.DESC_WIDTH), dtype=np.int64)
    for row in range(4):
        n0 = lo // table_mod * table_mod + row * 64 * table_mod
        for k, x in enumerate((n0, lo, lo + 200 * table_mod)):
            desc[row, 4 * k:4 * k + 4] = int_to_limbs(x, 4)
    min_u = (5 * plan.base + 7) // 8
    fn = ve.niceonly_strided_counts if plain else ce.strided_niceonly_batch
    return fn(plan, table_mod, res, 64, torch.from_numpy(desc), 3, min_u,
              block_threads=threads).tolist()


def _k4(plan, threads, use_mxu=0, plain=False):
    classes = ce.niceonly_classes(plan, True, "cpu")
    start = _seeded_start(plan.base, 1 << 12)
    min_u = (5 * plan.base + 7) // 8
    fn = ve.niceonly_dense_megaloop if plain else ce.niceonly_dense_megaloop
    return fn(plan, 1 << 11, 2, classes, _start(plan, start), 4000, min_u,
              use_mxu, block_threads=threads).tolist()


CASES = {"k1": (_k1, 40, 0), "k5": (_k1, 40, 1), "k3": (_k3, 40, None),
         "k4": (_k4, 98, 0), "k5_dense": (_k4, 98, 1)}


def _call(case, threads, plain=False):
    fn, base, mxu = CASES[case]
    plan = get_plan(base)
    if mxu is None:
        return fn(plan, threads, plain=plain)
    return fn(plan, threads, mxu, plain=plain)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_admissible_size_gives_the_default_result(case):
    """The bins and counts are integer sums over the blocks: no size moves
    them, through the wrapper or the plain version."""
    mxu = CASES[case][2] or 0
    want = _call(case, DEFAULT)
    assert any(want), "a check that counts nothing proves nothing"
    for threads in ce.admissible_block_threads(mxu):
        assert _call(case, threads) == want
        assert _call(case, threads, plain=True) == want


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_and_plain_versions_refuse_a_bad_size(case, plain):
    mxu = CASES[case][2] or 0
    for bad in BAD + ((32,) if mxu else ()):
        with pytest.raises(ValueError, match="block_threads"):
            _call(case, bad, plain=plain)


def test_launch_shape_refuses_a_bad_size_before_loading_the_library(
        monkeypatch):
    def no_build():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr("nice_tpu_torch.ops.cuda_build.load", no_build)
    for kernel in ("detailed_megaloop", "niceonly_dense", "strided_niceonly"):
        for bad in BAD:
            with pytest.raises(ValueError, match="block_threads"):
                ce.launch_shape(kernel, get_plan(40), 1 << 10, 4,
                                block_threads=bad)
    with pytest.raises(ValueError, match="K5"):
        ce.launch_shape("detailed_megaloop_mma", get_plan(40), 1 << 10,
                        block_threads=32)


@pytest.mark.parametrize("block_rows", [8, 16])
def test_plain_k1_at_two_sizes_equals_the_pallas_kernel(block_rows):
    """One numpy-seeded b40 batch of 2048 lanes through the JAX package's
    Pallas stats kernel (interpret mode) at a block_rows, and through the
    port's plain K1 at the least and the default block_threads."""
    base, batch, valid = 40, 2048, 2000
    start = _seeded_start(base, batch)
    hist_j, nm_j = pe.detailed_batch(
        jlimbs.get_plan(base), batch,
        np.asarray(jlimbs.int_to_limbs(start, jlimbs.get_plan(base).limbs_n),
                   dtype=np.uint32),
        np.int32(valid), block_rows=block_rows)
    want = np.asarray(hist_j)[: base + 2].tolist() + [int(np.asarray(nm_j))]
    plan = get_plan(base)
    for threads in (32, DEFAULT):
        acc = torch.zeros(base + 2, dtype=torch.int32)
        h, nm = ve.detailed_accum_megaloop(plan, batch, 1, acc,
                                           _start(plan, start), valid,
                                           block_threads=threads)
        assert h.tolist() + [int(nm)] == want


# -- the engine, the winners table, the scheduler ------------------------------

def test_fields_run_at_the_resolved_size_and_record_it(monkeypatch):
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 1 << 12)
    plan = get_plan(40)
    rng = FieldSize(plan.range_start, plan.range_start + 50_000)
    want = engine.process_range_detailed(rng, 40, device="cpu")
    assert engine.LAST_FEED_STATS["block_threads"] == DEFAULT
    got = engine.process_range_detailed(rng, 40, device="cpu",
                                        block_threads=96)
    assert engine.LAST_FEED_STATS["block_threads"] == 96
    assert got == want
    autotune.record("detailed", 40, "cpu", {"block_threads": 160})
    assert engine.process_range_detailed(rng, 40, device="cpu") == want
    assert engine.LAST_FEED_STATS["block_threads"] == 160
    with pytest.raises(ValueError, match="block_threads"):
        engine.process_range_detailed(rng, 40, device="cpu", block_threads=48)


def test_dense_loop_records_its_size_and_the_strided_path_refuses_one(
        monkeypatch):
    adaptive_floor.reset_for_tests(pinned=1 << 14)
    start = 413428759798923141071530212209627033363
    rng = FieldSize(start, start + 200_000)
    want = engine.process_range_niceonly(rng, 98, device="cpu")
    assert engine.LAST_NICEONLY_STATS["block_threads"] == DEFAULT
    got = engine.process_range_niceonly(rng, 98, device="cpu",
                                        block_threads=64)
    assert got == want and engine.LAST_NICEONLY_STATS["block_threads"] == 64
    plan = get_plan(40)
    small = FieldSize(plan.range_start, plan.range_start + 10_000)
    with pytest.raises(ValueError, match="block_threads"):
        engine.process_range_niceonly(small, 40, device="cpu",
                                      block_threads=64)


def test_winners_table_round_trip_and_tenant_report():
    autotune.record("detailed", 40, "cpu",
                    {"batch_size": 4096, "megaloop": 4, "block_threads": 96})
    autotune.reset_for_tests()
    assert autotune.params("detailed", 40, "cpu")["block_threads"] == 96
    assert autotune.choose("detailed", 40, "cpu", "block_threads", 1) == 96
    rows = autotune.tenant_report([("canon", "detailed", 40, "device"),
                                   ("nice", "niceonly", 98, "device")],
                                  device="cpu")
    assert rows[0]["block_threads"] == 96 and rows[0]["tuned"]
    assert rows[1]["block_threads"] == DEFAULT and not rows[1]["tuned"]
    assert "block_rows" not in rows[0]
    assert "block_threads" in autotune.PARAMS


def test_sweep_passes_the_thread_axis_and_records_its_winner():
    won = autotune.sweep("detailed", "cpu", bench_mode="default",
                         batch_shifts=[10], segments=[2], mxu="off",
                         threads=[64, 128], slice_size=10_000, timeout=300)
    assert won["block_threads"] in (64, 128)
    entry = autotune._load()["detailed|b40|cpu"]
    assert sorted(r["block_threads"] for r in entry["swept"]) == [64, 128]
    assert [r["block_threads"] for r in autotune.LAST_SWEEP] == [64, 128]
    assert engine.resolve_tuning("detailed", 40, "cpu")[3] == won["block_threads"]


def test_scheduler_page_with_a_non_default_winner_equals_solo():
    """A detailed tenant whose winner pins 64 threads, interleaved page by
    page with a niceonly tenant (a preemption at every page boundary), runs
    each page at 64 and assembles the field a solo run at the default size
    gives (tests/test_torch_sched.py's shape: b17, batch 256, segment 2)."""
    from nice_tpu_torch import sched

    base, batch, seg = 17, 256, 2
    autotune.record("detailed", base, "cpu", {"batch_size": batch,
                                              "megaloop": seg})
    want = engine.process_range_detailed(FieldSize(5541, 9541), base,
                                         device="cpu")
    assert engine.LAST_FEED_STATS["block_threads"] == DEFAULT
    for mode in ("detailed", "niceonly"):
        autotune.record(mode, base, "cpu", {"batch_size": batch,
                                            "megaloop": seg,
                                            "block_threads": 64})
    specs = [sched.TenantSpec(name=n, mode=m, base=base, priority=p,
                              slo_page_secs=0.0, batch_size=batch)
             for n, m, p in (("det", "detailed", 2), ("nice", "niceonly", 1))]
    source = sched.StaticSource({"det": [("det/f0", base, 5541, 9541)],
                                 "nice": [("nice/f0", base, 9541, 13541)]})
    scheduler = sched.MultiTenantScheduler(
        sched.TenantRegistry(specs), source, device="cpu", policy="rr",
        page_batches=1, quantum_secs=1e-9)
    sizes = []
    real = scheduler._execute_page

    def execute(spec, page):
        out = real(spec, page)
        if spec.mode == "detailed":
            sizes.append(engine.LAST_FEED_STATS["block_threads"])
        return out

    scheduler._execute_page = execute
    stats = scheduler.run()
    assert source.results["det"]["det/f0"] == want
    assert stats["tenants"]["det"]["preemptions"] > 0
    assert sizes and set(sizes) == {64}
    assert [r["block_threads"] for r in autotune.tenant_report(
        [("det", "detailed", base, "device")], device="cpu")] == [64]


# -- the tuning harness -------------------------------------------------------

def _records(capsys, argv) -> tuple[int, list]:
    rc = tune_kernels.main(argv + ["--device", "cpu", "--json"])
    out = capsys.readouterr().out
    return rc, [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_harness_sweep_threads_axis(capsys):
    rc, recs = _records(capsys, ["detailed", "--mode", "default", "--slice",
                                 "4096", "--batches", "10", "--segments", "1",
                                 "--mxu", "off", "--sweep-threads", "32,256"])
    assert rc == 0
    assert [r["block_threads"] for r in recs] == [32, 256]
    assert all(r["launch_threads"] is None for r in recs)  # no card here
    assert all(r["numbers_per_sec"] > 0 for r in recs)


def test_harness_blocks_kind_on_the_plain_versions(capsys):
    rc, recs = _records(capsys, ["blocks", "--mode", "default",
                                 "--block-batch", "10", "--mxu", "auto"])
    assert rc == 0
    got = {(r["kernel"], r["block_threads"]) for r in recs}
    assert got == ({("detailed_megaloop", t) for t in (32, 64, 128, 256)}
                   | {("detailed_megaloop_mma", t) for t in (64, 128, 256)})
    assert all(r["plain"] and r["timing"] == "wall" and r["equal_to_default"]
               for r in recs)
    assert all(r["lanes"] == 1024 for r in recs)


def test_harness_blocks_kind_at_a_dense_base(capsys):
    start = 413428759798923141071530212209627033363
    rc, recs = _records(capsys, ["blocks", "--field", f"98:{start}:1000000",
                                 "--block-lanes", "3000", "--mxu", "off",
                                 "--min-uniques", "62", "--threads", "64,256"])
    assert rc == 0
    assert [(r["kernel"], r["block_threads"]) for r in recs] == [
        ("niceonly_dense", 64), ("niceonly_dense", 256)]


def test_harness_stride_blocks_kind(capsys):
    adaptive_floor.reset_for_tests(pinned=4096)
    plan = get_plan(17)
    rc, recs = _records(capsys, ["stride-blocks", "--field",
                                 f"17:{plan.range_start}:1000000",
                                 "--threads", "32,128,256",
                                 "--min-uniques", "11"])
    assert rc == 0
    assert [r["block_threads"] for r in recs] == [32, 128, 256]
    s = engine.strided_setup(17, 1_000_000)
    assert all(r["lanes"] == tune_kernels.STRIDE_GROUP * s.periods
               * s.table.num_residues and r["equal_to_default"]
               for r in recs)


def test_stride_group_rows_are_the_reference_harness_rows():
    """scripts/tune_kernels.py sweep_stride_blocks: row i from the start
    rounded down to the modulus plus i spans, each bounded by [start,
    start + 1024 spans)."""
    adaptive_floor.reset_for_tests(pinned=4096)
    plan = get_plan(17)
    s, desc = tune_kernels.stride_group(17, plan.range_start + 1000, 10**6)
    span = s.periods * s.table.modulus
    lo = plan.range_start + 1000
    for i in (0, 1, 1023):
        n0 = (lo // s.table.modulus) * s.table.modulus + i * span
        assert desc[i, 0:4].tolist() == int_to_limbs(n0, 4).tolist()
        assert desc[i, 4:8].tolist() == int_to_limbs(lo, 4).tolist()
        assert desc[i, 8:12].tolist() == int_to_limbs(lo + 1024 * span,
                                                      4).tolist()
