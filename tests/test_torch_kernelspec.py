"""The port's kernel-spec twin (nice_tpu_torch/analysis/kernelspec.py,
cudarules/, scripts/cudalint.py): C6 on a copy of the sources with one
drift seeded, C2 with a spec's budget or domain widened, the registry's
contract constants and tier predicates against the JAX package's
kernelspec, the witnesses at the limb boundaries (the plain versions
against the JAX package's jnp functions at b40 and b80 and against its
scalar oracle at b98, b100 and b510), the flush cadence at a lowered
ACC_LIMIT, and the batch-size finding both packages share.
"""

import dataclasses
import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_tpu.analysis import kernelspec as jks
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import limbs as jlimbs
from nice_tpu.ops import mxu as jmxu
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import vector_engine as jve
from nice_tpu_torch.analysis import core, cudarules, kernelspec as ks
from nice_tpu_torch.analysis.cudarules import c2_headroom, c6_kernelspec
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine, stride_filter
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs, plan_from_reference
from nice_tpu_torch.scripts import cudalint, spec_witness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# What C6 and C2 read of the tree: a copy of it takes seeded drift.
TREE = ("nice_tpu_torch/csrc", "nice_tpu_torch/ops/cuda_engine.py",
        "nice_tpu_torch/ops/cuda_build.py", "nice_tpu_torch/ops/mxu.py",
        "nice_tpu_torch/ops/engine.py", "nice_tpu_torch/analysis/baseline.json")


def _copy(tmp_path) -> str:
    for rel in TREE:
        src, dst = os.path.join(REPO, rel), tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        if os.path.isdir(src):
            shutil.copytree(src, dst)
        else:
            shutil.copy(src, dst)
    return str(tmp_path)


def _c6_keys(root: str) -> set:
    ctx = cudarules.Context(bases=())
    return {v.key.split("|", 2)[2]
            for v in c6_kernelspec.check(core.Project(root), ctx)}


def test_copied_tree_is_clean(tmp_path):
    root = _copy(tmp_path)
    assert _c6_keys(root) == set()
    assert cudalint.main(["--root", root, "--bases", "none", "--strict"]) == 0


@pytest.mark.parametrize("rel,old,new,finding", [
    ("nice_tpu_torch/csrc/nice_kernels.cuh", "kPlanTierLimbs = 4;",
     "kPlanTierLimbs = 5;", "constant-drift:PLAN_TIER_LIMBS:cuda"),
    ("nice_tpu_torch/csrc/plan_kernels.cu", "kDescWidth = 12;",
     "kDescWidth = 16;", "constant-drift:DESC_WIDTH:cuda"),
    ("nice_tpu_torch/ops/cuda_build.py",
     '"nice_uniques": [words, c_void_p, c_longlong, c_void_p, c_void_p],',
     '"nice_uniques": [words, c_void_p, c_longlong, c_void_p],',
     "abi-drift:nice_uniques"),
    ("nice_tpu_torch/csrc/nice_kernels.cuh",
     "typedef Lane<2, 4, 6, 2, true> SmallTier;",
     "typedef Lane<2, 4, 7, 2, true> SmallTier;", "tier-drift:SmallTier"),
    ("nice_tpu_torch/ops/cuda_engine.py", "PLAN_TIER_LIMBS = 4",
     "PLAN_TIER_LIMBS = 3", "constant-drift:PLAN_TIER_LIMBS:py"),
    ("nice_tpu_torch/csrc/nice_kernels.cu",
     "int nice_uniques(const uint64_t* plan_words, const void* start,",
     "int nice_uniques(const uint64_t* plan_words, const void* start, int x,",
     "abi-drift:nice_uniques"),
    ("nice_tpu_torch/ops/cuda_engine.py", "launch = lib.nice_plan_uniques",
     "launch = lib.nice_plan_uniques_v2",
     "unspecced-entry:nice_plan_uniques_v2"),
    # The block size: a Python admissible set that disagrees with the CUDA
    # source's (half warps, or K5 from one warp), the CUDA rule moved
    # alone, and a C entry that stops refusing a size outside it.
    ("nice_tpu_torch/ops/cuda_engine.py",
     "            and block_threads % WARP == 0)",
     "            and block_threads % (WARP // 2) == 0)",
     "block-rule-drift:py:mma0"),
    ("nice_tpu_torch/ops/cuda_engine.py", "MMA_BLOCK_THREADS_MIN = 64",
     "MMA_BLOCK_THREADS_MIN = 32", "block-rule-drift:py:mma1"),
    ("nice_tpu_torch/csrc/nice_grid.cuh", "constexpr int kMmaMinThreads = 64;",
     "constexpr int kMmaMinThreads = 32;", "block-rule-drift:cuda:mma1"),
    ("nice_tpu_torch/csrc/plan_kernels.cu",
     "  if (!block_threads_ok(block_threads, kWarp)) return kBadThreads;\n"
     "  const int64_t lanes", "  const int64_t lanes",
     "block-check-missing:nice_plan_strided_niceonly"),
    # K1's per-base entry: its block-size check, its ctypes binding, and a
    # wrapper that loads another name.
    ("nice_tpu_torch/csrc/plan_kernels.cu",
     "  if (!block_threads_ok(block_threads, kWarp)) return kBadThreads;\n"
     "  launch_k1<PlanTier>", "  launch_k1<PlanTier>",
     "block-check-missing:nice_plan_detailed_megaloop"),
    ("nice_tpu_torch/ops/cuda_build.py",
     """                                        c_longlong, c_void_p, c_void_p, c_int,
                                        c_void_p],""",
     """                                        c_longlong, c_void_p, c_void_p,
                                        c_void_p],""",
     "abi-drift:nice_plan_detailed_megaloop"),
    ("nice_tpu_torch/ops/cuda_engine.py",
     "launch, mma = lib.nice_plan_detailed_megaloop, ()",
     "launch, mma = lib.nice_plan_detailed_megaloop_v2, ()",
     "unspecced-entry:nice_plan_detailed_megaloop_v2"),
])
def test_c6_flags_seeded_drift(tmp_path, rel, old, new, finding):
    root = _copy(tmp_path)
    path = tmp_path / rel
    text = path.read_text()
    assert text.count(old) == 1
    path.write_text(text.replace(old, new))
    assert finding in _c6_keys(root)
    assert cudalint.main(["--root", root, "--bases", "none", "--strict"]) == 1


def _c2_keys() -> set:
    return {v.key.split("|", 2)[2] for v in c2_headroom.check(
        core.Project(REPO), cudarules.Context(bases=()))}


def test_c2_discharges_every_obligation_but_the_queue_3_domain():
    ctx = cudarules.Context(bases=())
    found = c2_headroom.check(core.Project(REPO), ctx)
    report = ctx.report["c2"]["obligations"]
    assert set(report) == {"k1_flush_budget", "k5_accum", "k5_lanes",
                           "k5_smem", "k3_counts", "k4_counts",
                           "scalar_types", "entry_domain"}
    assert {k: n for k, n in report.items() if n} == {"entry_domain": 3}
    # Each entry-domain finding is allowed inline, naming ROADMAP queue 3.
    kept, allowed, _ = core.filter_allowed(core.Project(REPO), found)
    assert kept == [] and len(allowed) == 3
    assert {v.detail for v in allowed} == {
        "entry_domain:page_quantum", "entry_domain:_detailed_shape",
        "entry_domain:_niceonly_dense"}


def test_an_upper_batch_check_clears_the_finding_and_kills_its_allow(tmp_path):
    # Bounding batch_size from above in _detailed_shape (the detailed
    # entry's tuning) discharges its entry_domain finding; the inline allow
    # left behind is then dead, which S1 fails under the full run.
    root = _copy(tmp_path)
    path = tmp_path / "nice_tpu_torch/ops/engine.py"
    old = ('        raise ValueError(f"batch_size must be positive, got '
           '{batch_size}")\n')
    text = path.read_text()
    assert text.count(old) == 1
    path.write_text(text.replace(old, old + "    if batch_size > 1 << 26:\n"
                                 "        raise ValueError(batch_size)\n"))
    found = c2_headroom.check(core.Project(root), cudarules.Context(()))
    assert "entry_domain:_detailed_shape" not in {v.detail for v in found}
    assert cudalint.main(["--root", root, "--bases", "none"]) == 1


def test_c2_fails_when_the_spec_acc_limit_is_raised(monkeypatch):
    monkeypatch.setattr(ks, "ACC_LIMIT", 1 << 32)
    assert "k1_flush_budget:acc-limit" in _c2_keys()
    assert cudalint.main(["--rules", "C2", "--strict"]) == 1


@pytest.mark.parametrize("var,hi", [("batch_size", 1 << 31), ("n_dev", 64)])
def test_c2_fails_when_the_domain_is_widened_past_the_clamp(monkeypatch, var,
                                                             hi):
    monkeypatch.setitem(ks.DOMAIN, var, (1, hi))
    assert "k1_flush_budget:lanes" in _c2_keys()
    assert cudalint.main(["--rules", "C2"]) == 1


def test_registry_covers_every_loaded_entry_and_kernel():
    assert c6_kernelspec.check_coverage(core.Project(REPO)) == []
    loads = set().union(*(e for _, e in cudarules.sources.wrapper_loads(
        core.Project(REPO), c6_kernelspec.CE_PATH).values()))
    assert loads - set(ks.HELPERS) == set(ks.all_specs())
    assert {k for s in ks.all_specs().values() for k in s.kernels} == {
        "K1", "K2", "K3", "K4", "K5"}


@pytest.mark.parametrize("base", sorted(set(ks.PROBE_BASES + ks.SWEEP_BASES)))
def test_k1_runs_on_the_plan_tier_exactly_where_the_tier_takes(base):
    """K1 at b10-b97 on the per-base entry and the plan tier, above it on the
    main library's generic tier, and past the histogram's bins nowhere; no
    plan is taken by both entries, and the per-base one runs no K5."""
    shape = ks.plan_shape(base)
    plan_k1, main_k1 = (next(s for s in ks.all_specs().values()
                             if "K1" in s.kernels and s.library == lib)
                        for lib in ("plan", "main"))
    if not ks.supports_base(shape):
        want = None
    elif shape.limbs_n <= ks.PLAN_TIER_LIMBS:
        want = "plan"
    else:
        want = "generic"
    assert ks.predicted_tier("detailed_megaloop", shape) == want
    assert plan_k1.tier(shape, 0) == ("plan" if want == "plan" else None)
    assert main_k1.tier(shape, 0) == ("generic" if want == "generic" else None)
    assert plan_k1.tier(shape, 1) is None
    assert ce.plan_tier_takes(get_plan(base)) == (want == "plan")


def test_contract_constants_equal_jax_kernelspec():
    assert ks.MAX_HIST_ROWS == jks.MAX_HIST_ROWS
    assert ks.MAX_HIST_BINS == jks.MAX_HIST_ROWS * 128 == ce.MAX_HIST_BINS
    assert ks.HIST_ACC_BOUND == jks.HIST_ACC_BOUND
    assert ks.ACC_LIMIT == engine.ACC_LIMIT
    assert engine.ACC_LIMIT // 2 <= jks.HIST_ACC_BOUND[1]
    # The probe sweep: each cap's predicate in both registries.
    for base in ks.PROBE_BASES + ks.SWEEP_BASES:
        jplan, shape = jlimbs.get_plan(base), ks.plan_shape(base)
        assert ks.supports_base(shape) == jks._pe_supports(jplan), base
        strided = jks.SPECS["pallas_engine.niceonly_strided_batch"].applies
        k3 = next(s for s in ks.all_specs().values() if s.kernels == ("K3",))
        assert (k3.tier(shape, 0) is not None) == strided(jplan), base
        assert ks.reference_takes(shape) == jmxu.supports_plan(jplan), base
        assert ks.k5_takes(shape) == (jmxu.supports_plan(jplan)
                                      and ks.k5_smem_bytes(
                                          shape, ks.k5_front(shape))
                                      <= ks.SMEM_LIMIT), base


def _plan(base):
    return plan_from_reference(dataclasses.asdict(jlimbs.get_plan(base)))


def _jstart(base, x):
    return jlimbs.int_to_limbs(x, jlimbs.get_plan(base).limbs_n)


@pytest.mark.parametrize("base", [40, 80])
def test_witnesses_equal_the_jax_jnp_functions(base):
    # K2's plain version at every witness window against the JAX package's
    # jnp uniques batch, and K1's (padding in bin 0, near misses) against
    # the same lanes' histogram; at b40 K1 and K5 also against the JAX jnp
    # megaloop itself (its b80 graph takes seconds more to compile).
    plan, shape = _plan(base), ks.plan_shape(base)
    rng = np.random.default_rng(base)
    batch, n_iters = 64, 2
    lanes = batch * n_iters
    starts = ks.witness_starts(shape, lanes, limit=6)
    assert len(starts) >= 4 and any(
        s < e <= s + lanes for s in starts for e in ks.limb_edges(shape))
    for start in starts:
        st = ve.start_limbs_tensor(start, plan, "cpu")
        u_j = np.asarray(jve.uniques_batch(jlimbs.get_plan(base), lanes,
                                           _jstart(base, start)))
        assert ce.uniques_batch(plan, lanes, st).tolist() == u_j.tolist()
        valid = lanes - int(rng.integers(1, batch))
        acc0 = rng.integers(0, 1000, base + 2, dtype=np.int32)
        want = acc0 + np.bincount(u_j[:valid], minlength=base + 2)[: base + 2]
        want[0] += lanes - valid
        for mma in (0, 1):
            h_t, nm_t = ce.detailed_accum_megaloop(
                plan, batch, n_iters, torch.from_numpy(acc0.copy()), st,
                valid, use_mxu=mma)
            assert h_t.tolist() == want.tolist(), (start, mma)
            assert int(nm_t) == int((u_j[:valid] > plan.near_miss_cutoff).sum())
            if base == 40:
                h_j, nm_j = jve.detailed_accum_megaloop(
                    jlimbs.get_plan(base), batch, n_iters, jnp.asarray(acc0),
                    _jstart(base, start), np.int32(valid), use_mxu=bool(mma))
                assert np.asarray(h_j).tolist() == want.tolist()
                assert int(np.asarray(nm_j)) == int(nm_t)


@pytest.mark.parametrize("base", [40, 80])
def test_k3_witness_rows_equal_the_oracle(base):
    # Descriptors across each limb edge of the range, at the nice test and
    # about the median of num_uniques, against the JAX package's oracle.
    plan = _plan(base)
    table = stride_filter.get_stride_table(base, 1)
    periods = 2
    rows = spec_witness.strided_rows(ks.plan_shape(base), table.modulus,
                                     periods)
    desc = np.zeros((len(rows), 12), dtype=np.int64)
    for i, (n0, lo, hi) in enumerate(rows):
        for k, x in enumerate((n0, lo, hi)):
            desc[i, 4 * k:4 * k + 4] = int_to_limbs(x, 4)
    res = torch.from_numpy(table.residues_u32.astype(np.int64))
    valid = set(table.valid_residues)
    for min_u in (base, spec_witness.check_min_uniques(base)):
        got = ce.strided_niceonly_batch(plan, table.modulus, res, periods,
                                        torch.from_numpy(desc), len(rows),
                                        min_u).tolist()
        want = [sum(1 for n in range(max(lo, n0), min(hi, n0 + periods
                                                      * table.modulus))
                    if (n - n0) % table.modulus in valid and min_u <=
                    jscalar.get_num_unique_digits(n, base) <= base)
                for n0, lo, hi in rows]
        assert got == want, min_u
    assert sum(want) > 0


def _oracle_uniques(base, start, lanes):
    return [jscalar.get_num_unique_digits(start + i, base)
            for i in range(lanes)]


@pytest.mark.parametrize("base", [98, 100])
def test_k4_witnesses_equal_the_oracle(base):
    plan, shape = _plan(base), ks.plan_shape(base)
    classes = ce.niceonly_classes(plan, True, "cpu")
    kept = set(classes.tolist())
    batch, n_iters = 128, 2
    for start in ks.witness_starts(shape, batch * n_iters, limit=3):
        st = ve.start_limbs_tensor(start, plan, "cpu")
        valid = batch * n_iters - 5
        u = _oracle_uniques(base, start, valid)
        keep = [(start + i) % (base - 1) in kept for i in range(valid)]
        for min_u in (base, spec_witness.check_min_uniques(base)):
            got = ce.niceonly_dense_megaloop(plan, batch, n_iters, classes, st,
                                             valid, min_u).tolist()
            assert got == [sum(k and min_u <= x <= base
                               for k, x in zip(keep, u)),
                           valid - sum(keep)], (start, min_u)
        if base == 98:  # K5's dense mode on the same run
            got5 = ce.niceonly_dense_megaloop(
                plan, batch, n_iters, classes, st, valid,
                spec_witness.check_min_uniques(base), use_mxu=1)
            assert got5.tolist() == got


def test_b510_witnesses_equal_the_oracle():
    # The 29-limb plan: K1, K5 and K2's plain versions at a window across
    # the range's first limb edge and at its start, against Python ints.
    base = 510
    plan, shape = _plan(base), ks.plan_shape(base)
    lanes = 16
    edge = ks.limb_edges(shape)[0]
    for start in (edge - lanes // 2, plan.range_start):
        st = ve.start_limbs_tensor(start, plan, "cpu")
        u = _oracle_uniques(base, start, lanes - 3)
        want = np.bincount(u, minlength=base + 2)[: base + 2].tolist()
        want[0] += 3
        for mma in (0, 1):
            h, nm = ce.detailed_accum_megaloop(
                plan, lanes, 1, torch.zeros(base + 2, dtype=torch.int32), st,
                lanes - 3, use_mxu=mma)
            assert h.tolist() == want and int(nm) == sum(
                x > plan.near_miss_cutoff for x in u), (start, mma)
        assert ce.uniques_batch(plan, lanes, st).tolist()[: lanes - 3] == u


def _pairs(results):
    return ([(d.num_uniques, d.count) for d in results.distribution],
            sorted((n.number, n.num_uniques) for n in results.nice_numbers))


CADENCE_BATCH = 256


@functools.lru_cache(maxsize=None)
def _cadence_field():
    plan = jlimbs.get_plan(40)
    s = plan.range_start + 1_000_000
    return s, s + 24_000


@functools.lru_cache(maxsize=None)
def _cadence_reference():
    s, e = _cadence_field()
    return _pairs(jengine.process_range_detailed(
        JFieldSize(s, e), 40, backend="jnp", batch_size=CADENCE_BATCH))


@pytest.mark.parametrize("devices", [None, ["cpu"] * 2])
def test_cadence_witness_at_a_lowered_acc_limit(monkeypatch, devices):
    # With ACC_LIMIT lowered so that clamp_segment cuts the segment from 8
    # to 4 (2 on two slices) and _flush_every hands the accumulator over
    # after every dispatch, the field equals its unpatched run and the JAX
    # package's.
    s, e = _cadence_field()
    field = FieldSize(s, e)
    n_dev = len(devices or ["cpu"])

    def run():
        r = engine.process_range_detailed(field, 40, device="cpu",
                                          devices=devices,
                                          batch_size=CADENCE_BATCH, segment=8)
        return _pairs(r), dict(engine.LAST_FEED_STATS)

    plain, stats0 = run()
    limit = 2 * CADENCE_BATCH * 4  # a 4-batch segment on one slice
    monkeypatch.setattr(engine, "ACC_LIMIT", limit)
    assert engine.clamp_segment(8, CADENCE_BATCH, n_dev) == 4 // n_dev
    assert engine._flush_every(CADENCE_BATCH * 4) == 1
    patched, stats = run()
    assert patched == plain == _cadence_reference()
    assert stats["dispatches"] > stats0["dispatches"]


def test_batch_budget_gap_is_the_references():
    # ROADMAP queue 3: both packages bound batch_size from below only. Past
    # the spec's domain (batch_size * n_dev > ACC_LIMIT // 2) both clamps
    # give a segment of 1 and the budget no longer holds, and both entry
    # points take such a batch size (here on a field outside the base's
    # range, which the oracle scans: no kernel sees the batch).
    half = ks.ACC_LIMIT // 2
    for seg, batch, n_dev in [(8, 1 << 18, 1), (8, 1 << 26, 8),
                              (8, 1 << 28, 4), (3, 1 << 31, 1),
                              (8, half + 1, 1)]:
        port = engine.clamp_segment(seg, batch, n_dev)
        assert port == jengine._clamp_segment(seg, batch, n_dev)
        within = batch * n_dev <= half
        assert (batch * port * n_dev <= half) == within
    big = 1 << 31
    plan = get_plan(10)
    s, e = plan.range_end + 5, plan.range_end + 500
    got = engine.process_range_detailed(FieldSize(s, e), 10, device="cpu",
                                        batch_size=big)
    want = jengine.process_range_detailed(JFieldSize(s, e), 10,
                                          backend="jnp", batch_size=big)
    assert _pairs(got) == _pairs(want)
