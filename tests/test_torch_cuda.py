"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs (exact: every output is an integer), and the
engine on the card against the engine on the CPU.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They
import neither jax nor nice_tpu, so a machine with only PyTorch runs them
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nice_tpu_torch.analysis import kernelspec
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine, stride_filter
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("base", [10, 17, 40, 50, 80, 97, 98, 100, 510])
def test_kernels_equal_plain_versions_on_card(card, base):
    plan = get_plan(base)
    rng = np.random.default_rng(base)
    batch = 128
    # From range_start, and across a 2^32 limb carry (wrapping past the
    # top limb where the range is narrower than 2^32).
    carry = ((plan.range_start >> 32) + 1) << 32
    starts = [plan.range_start,
              (carry - batch // 2) % (1 << (32 * plan.limbs_n))]
    for start in starts:
        st = ve.start_limbs_tensor(start, plan, card)
        for n_iters in (1, 3):
            valid = batch * n_iters - int(rng.integers(1, batch))
            acc = torch.from_numpy(
                rng.integers(0, 1000, base + 2, dtype=np.int32)).to(card)
            before = ce.LAUNCHES["detailed_megaloop"]
            h_k, nm_k = ce.detailed_accum_megaloop(plan, batch, n_iters,
                                                   acc.clone(), st, valid)
            assert ce.LAUNCHES["detailed_megaloop"] == before + 1
            h_p, nm_p = ve.detailed_accum_megaloop(plan, batch, n_iters,
                                                   acc.clone(), st, valid)
            assert torch.equal(h_k, h_p)
            assert int(nm_k) == int(nm_p)
        assert torch.equal(ce.uniques_batch(plan, batch, st),
                           ve.uniques_batch(plan, batch, st))
        thresh = plan.near_miss_cutoff - 3
        for got, want in zip(ce.survivors_batch(plan, batch, thresh, 8, st, 100),
                             ve.survivors_batch(plan, batch, thresh, 8, st, 100)):
            assert torch.equal(got, want)
    torch.cuda.synchronize()


def test_engine_on_card_equals_cpu(card):
    plan = get_plan(17)
    rng = FieldSize(plan.range_start - 100, plan.range_end + 100)
    ce.reset_launches()
    on_card = engine.process_range_detailed(rng, 17, device=card,
                                            batch_size=1024, segment=2)
    assert ce.LAUNCHES["detailed_megaloop"] > 0
    assert ce.LAUNCHES["uniques"] > 0  # b17 has near misses
    on_cpu = engine.process_range_detailed(rng, 17, device="cpu",
                                           batch_size=1024, segment=2)
    assert on_card == on_cpu


def _desc(rows, n_pad, rng, device):
    desc = np.zeros((len(rows) + n_pad, 12), dtype=np.int64)
    for i, (n0, lo, hi) in enumerate(rows):
        desc[i, 0:4] = int_to_limbs(n0, 4)
        desc[i, 4:8] = int_to_limbs(lo, 4)
        desc[i, 8:12] = int_to_limbs(hi, 4)
    desc[len(rows):] = rng.integers(0, 1 << 32, size=(n_pad, 12))
    return torch.from_numpy(desc).to(device)


@pytest.mark.parametrize("base", [10, 17, 40, 50, 80])
def test_strided_kernel_equals_plain_version_on_card(card, base):
    s = engine.strided_setup(base, 10**9)
    plan, m = s.plan, s.table.modulus
    span = s.periods * m
    rng = np.random.default_rng(base)
    if base == 10:
        rows = [(0, 47, 100)] * 5  # 69, five times
    else:
        lo = plan.range_start + 3
        rows = [(n0, lo, lo + 2 * span + 7)
                for n0 in range(lo // m * m, lo + 2 * span + 7, span)]
        n_ragged = len(rows)
        for width in (32, 64, 96):  # across a multiple of 2^width
            b = ((plan.range_start >> width) + 1) << width
            if plan.range_start < b < plan.range_end - span:
                n0 = (b - span // 2) // m * m
                rows.append((n0, n0, n0 + span))
    desc = _desc(rows, 3, rng, card)
    res = engine._device_residues(base, s.k, str(card))
    # The nice test (only b10 holds a nice number here), then one at about
    # the median of num_uniques, where every real row counts many lanes: a
    # lost carry or a wrong range mask changes those counts.
    for min_u in (base, (5 * base + 7) // 8):
        before = ce.LAUNCHES["strided_niceonly"]
        got = ce.strided_niceonly_batch(plan, m, res, s.periods, desc,
                                        len(rows), min_u)
        assert ce.LAUNCHES["strided_niceonly"] == before + 1
        want = ve.niceonly_strided_counts(plan, m, res, s.periods, desc,
                                          len(rows), min_u)
        assert torch.equal(got, want)
        assert got[len(rows):].tolist() == [0, 0, 0]
        if min_u == base and base == 10:
            assert got[:5].tolist() == [1] * 5
        if min_u < base and base != 10:
            assert int(got[:n_ragged].sum()) > 0
            assert bool((got[n_ragged:len(rows)] > 0).all())  # each carry row
    torch.cuda.synchronize()


def _carry_start(plan, lanes: int) -> int:
    """A start whose lanes cross the largest limb carry inside the range."""
    for w in range(32 * (plan.limbs_n - 1), 0, -32):
        b = ((plan.range_start >> w) + 1) << w
        if plan.range_start + lanes < b < plan.range_end - lanes:
            return b - lanes // 2
    raise AssertionError(f"b{plan.base}: no limb carry inside the range")


@pytest.mark.parametrize("base", [40, 98, 100, 510])
def test_dense_kernel_equals_plain_version_on_card(card, base):
    plan = get_plan(base)
    batch = 256 if base == 510 else 1024
    valid = 3 * batch - 29
    min_u = (5 * base + 7) // 8  # about the median of num_uniques
    for where in ("range_start", "carry"):
        start = plan.range_start if where == "range_start" else \
            _carry_start(plan, 3 * batch)
        st = ve.start_limbs_tensor(start, plan, card)
        for fused in (True, False):
            classes = ce.niceonly_classes(plan, fused, str(card))
            for mu in (base, min_u):
                before = ce.LAUNCHES["niceonly_dense"]
                got = ce.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                 valid, mu)
                assert ce.LAUNCHES["niceonly_dense"] == before + 1
                want = ve.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                  valid, mu)
                assert torch.equal(got, want)
                count, pruned = got.tolist()
                assert (pruned > 0) == fused and pruned < valid
                # Unfused, across the carry, the median threshold counts
                # many lanes (at a range's start num_uniques sits lower).
                if mu == min_u and not fused and where == "carry":
                    assert count > 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("base", [98, 100, 510])
def test_dense_small_runs_equal_plain_version_on_card(card, base):
    """K4 on runs with fewer kept lanes than 132 x 32 and lane counts that
    are no multiple of a block, which take blocks of 64 threads (b98 and
    b100 in the dense register tier, b510 in the generic one), and (fused,
    below b510) on a full 2^21-lane run in blocks of 256."""
    plan = get_plan(base)
    st = ve.start_limbs_tensor(_carry_start(plan, 1 << 21), plan, card)
    want_tier = "generic" if base == 510 else "dense"
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for fused in (True, False):
        classes = ce.niceonly_classes(plan, fused, str(card))
        num_cls = classes.shape[0]
        full = [1 << 21] if fused and base < 510 else []
        for valid in [1, 97, 4999, 100_003] + full:
            shape = ce.launch_shape("niceonly_dense", plan, num_cls, valid)
            lanes = num_cls * -(-valid // (base - 1))
            assert shape["tier"] == want_tier
            assert shape["threads"] == (64 if lanes < sms * 256 else 256)
            assert shape["grid"] <= shape["blocks_per_sm"] * shape["sms"]
            for mu in (base, (5 * base + 7) // 8):
                got = ce.niceonly_dense_megaloop(plan, 1 << 21, 1, classes,
                                                 st, valid, mu)
                want = ve.niceonly_dense_megaloop(plan, 1 << 21, 1, classes,
                                                  st, valid, mu)
                assert torch.equal(got, want), (fused, valid, mu)
    torch.cuda.synchronize()


def _mid_rows(plan, m, span, rng):
    """Rows mid-range (near a range's start the squares lead with zeros and
    num_uniques sits lower): a ragged run cut into spans, then one span
    across each multiple of 2^32, 2^64 and 2^96 above the middle that lies
    inside the range; the index where the carry rows start."""
    mid = (plan.range_start + plan.range_end) // 2
    lo = mid + int(rng.integers(1, m))
    hi = lo + 2 * span + 7
    rows = [(n0, lo, hi) for n0 in range(lo // m * m, hi, span)]
    n_ragged = len(rows)
    for width in (32, 64, 96):
        b = ((mid >> width) + 1) << width
        if b < plan.range_end - span:
            n0 = (b - span // 2) // m * m
            rows.append((n0, n0, n0 + span))
    return rows, n_ragged


def test_plan_tier_strided_kernel_at_b97_equals_plain_version_on_card(card):
    """K3 at the plan tier's widest base (4/9/12 limbs), at both of its
    stride depths that fit a descriptor, across 2^32, 2^64 and 2^96."""
    plan = get_plan(97)
    rng = np.random.default_rng(97)
    for k in (1, 2):
        table = stride_filter.get_stride_table(97, k)
        m = table.modulus
        periods = max(1, min(32, (1 << 20) // table.num_residues))
        rows, n_ragged = _mid_rows(plan, m, periods * m, rng)
        assert len(rows) == n_ragged + 3
        desc = _desc(rows, 2, rng, card)
        res = engine._device_residues(97, k, str(card))
        assert ce.launch_shape("strided_niceonly", plan,
                               periods * table.num_residues,
                               len(rows))["tier"] == "plan"
        for min_u in (97, (5 * 97 + 7) // 8):
            before = ce.LAUNCHES["strided_niceonly"]
            got = ce.strided_niceonly_batch(plan, m, res, periods, desc,
                                            len(rows), min_u)
            assert ce.LAUNCHES["strided_niceonly"] == before + 1
            want = ve.niceonly_strided_counts(plan, m, res, periods, desc,
                                              len(rows), min_u)
            assert torch.equal(got, want), (k, min_u)
            assert got[len(rows):].tolist() == [0, 0]
            if min_u < 97:
                assert bool((got[:len(rows)] > 0).all()), (k, got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("base", [80, 97])
def test_plan_tier_uniques_equals_plain_version_on_card(card, base):
    """K2 on the plan tier at the main path's rare-scan sub-batch (2^18
    lanes) and at a ragged one, mid-range and across a 2^64 carry."""
    plan = get_plan(base)
    mid = (plan.range_start + plan.range_end) // 2
    starts = [mid, (((mid >> 64) + 1) << 64) - 1000]
    for lanes in (1 << 18, 1000):
        assert ce.launch_shape("uniques", plan, lanes)["tier"] == "plan"
        for start in starts:
            st = ve.start_limbs_tensor(start, plan, card)
            before = ce.LAUNCHES["uniques"]
            got = ce.uniques_batch(plan, lanes, st)
            assert ce.LAUNCHES["uniques"] == before + 1
            assert torch.equal(got, ve.uniques_batch(plan, lanes, st))
    assert ce.launch_shape("uniques", get_plan(98), 1 << 18)["tier"] == "generic"
    torch.cuda.synchronize()


def test_plan_tier_build_is_reused_on_card(card, monkeypatch):
    """One nvcc a base and key: a second call at the same base in this
    process loads nothing new, and a fresh load finds the library on
    disk."""
    from nice_tpu_torch.ops import cuda_build

    plan = get_plan(80)
    st = ve.start_limbs_tensor(plan.range_start, plan, card)
    ce.uniques_batch(plan, 256, st)  # built here or earlier
    runs = []
    real_run = cuda_build.subprocess.run

    def counting_run(cmd, *args, **kwargs):
        runs.append(cmd[0])
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(cuda_build.subprocess, "run", counting_run)
    ce.uniques_batch(plan, 256, st)
    ce.plan_library.cache_clear()
    assert torch.equal(ce.uniques_batch(plan, 256, st),
                       ve.uniques_batch(plan, 256, st))
    assert runs == []
    assert cuda_build.PLAN_BUILDS[ce.plan_header(plan)]["seconds"] == 0.0


def test_plan_tier_failures_raise_on_card(card, monkeypatch):
    """A per-base build that fails raises, and so does a library asked for
    another base's plan, for K1, K2, K3 and K5's detailed mode; neither
    launches anything else (K1 and K5 do not give way to the main
    library)."""
    from nice_tpu_torch.ops import cuda_build

    plan = get_plan(97)
    st = ve.start_limbs_tensor(plan.range_start, plan, card)
    table = stride_filter.get_stride_table(97, 1)
    res = engine._device_residues(97, 1, str(card))
    desc = _desc([(plan.range_start, plan.range_start, plan.range_start + 99)],
                 0, np.random.default_rng(0), card)
    acc = torch.zeros(plan.base + 2, dtype=torch.int32, device=card)
    before = dict(ce.LAUNCHES)
    ce.plan_library.cache_clear()
    with monkeypatch.context() as mp:
        mp.setattr(cuda_build, "NVCC_FLAGS",
                   cuda_build.NVCC_FLAGS + ("--no-such-nvcc-flag",))
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ce.uniques_batch(plan, 256, st)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ce.strided_niceonly_batch(plan, table.modulus, res, 1, desc, 1)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ce.detailed_accum_megaloop(plan, 64, 1, acc, st, 64, use_mxu=1)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ce.detailed_accum_megaloop(plan, 64, 1, acc, st, 64)
    wrong = ce.plan_library(get_plan(80))
    monkeypatch.setattr(ce, "plan_library", lambda p: wrong)
    with pytest.raises(RuntimeError, match="another plan"):
        ce.uniques_batch(plan, 256, st)
    with pytest.raises(RuntimeError, match="another plan"):
        ce.strided_niceonly_batch(plan, table.modulus, res, 1, desc, 1)
    with pytest.raises(RuntimeError, match="another plan"):
        ce.detailed_accum_megaloop(plan, 64, 1, acc, st, 64, use_mxu=1)
    with pytest.raises(RuntimeError, match="another plan"):
        ce.detailed_accum_megaloop(plan, 64, 1, acc, st, 64)
    torch.cuda.synchronize()
    assert ce.LAUNCHES == before


def test_k1_launch_is_one_resident_wave_on_card(card):
    """K1's grid is the blocks each SM holds at once times the SMs for a
    main-path segment (2^18 x 8 lanes), and one block per 256 lanes for a
    small one."""
    plan = get_plan(40)
    big = ce.launch_shape("detailed_megaloop", plan, 1 << 21)
    assert big["tier"] == "plan" and big["threads"] == 256
    assert big["grid"] == big["blocks_per_sm"] * big["sms"]
    small = ce.launch_shape("detailed_megaloop", plan, 1000)
    assert small["grid"] == 4
    # K5's dense mode takes K4's register tier and, for a small run, K4's
    # small blocks; its detailed mode takes the plan tier to b97.
    k5d = ce.launch_shape("niceonly_dense_mma", get_plan(98), 2, 10_000)
    k4 = ce.launch_shape("niceonly_dense", get_plan(98), 2, 10_000)
    assert k5d["tier"] == k4["tier"] == "dense"
    assert k5d["threads"] == k4["threads"] == 64
    assert ce.launch_shape("detailed_megaloop_mma", plan, 1 << 21)["tier"] == "plan"


def test_dense_engine_on_card_equals_cpu(card):
    adaptive_floor.reset_for_tests(pinned=4096)
    start = 413428759798923141071530212209627033363  # a b98 field, > 2^128
    field = FieldSize(start, start + 200_000)
    ce.reset_launches()
    on_card = engine.process_range_niceonly(field, 98, device=card)
    runs = engine.LAST_NICEONLY_STATS["runs"]
    assert ce.LAUNCHES["niceonly_dense"] == runs > 0
    assert on_card == engine.process_range_niceonly(field, 98, device="cpu")
    adaptive_floor.reset_for_tests()
    found = []
    engine._niceonly_dense(FieldSize(47, 100), 10, card, found)
    assert [n.number for n in found] == [69]  # K4's count, then K2


def test_niceonly_engine_on_card_equals_cpu(card):
    for base, s, e, floor in [(10, 40, 130, None),
                              (40, 3621949012977, 3621949612977, 4096)]:
        adaptive_floor.reset_for_tests(pinned=floor)
        ce.reset_launches()
        # host_niceonly_max=0 holds these small fields on K3 whatever the
        # host route's default limit.
        on_card = engine.process_range_niceonly(FieldSize(s, e), base,
                                                device=card,
                                                host_niceonly_max=0)
        assert ce.LAUNCHES["strided_niceonly"] > 0
        assert on_card == engine.process_range_niceonly(
            FieldSize(s, e), base, device="cpu")
    adaptive_floor.reset_for_tests()
    assert [n.number for n in engine.process_range_niceonly(
        FieldSize(47, 100), 10, device=card).nice_numbers] == [69]


@pytest.mark.parametrize("base", [10, 17, 40, 80, 98, 510])
def test_k5_equals_plain_versions_and_k1_on_card(card, base):
    """K5 in the detailed mode: against its plain version (the plain K1 with
    use_mxu=1) and against K1 on the card, bins and near misses, from
    range_start and across a 2^32 carry (wrapping past the top limb where the
    range is narrower than 2^32: those lanes take K1's products)."""
    plan = get_plan(base)
    rng = np.random.default_rng(base)
    batch = 128
    carry = ((plan.range_start >> 32) + 1) << 32
    for start in (plan.range_start,
                  (carry - batch // 2) % (1 << (32 * plan.limbs_n))):
        st = ve.start_limbs_tensor(start, plan, card)
        for n_iters in (1, 3):
            valid = batch * n_iters - int(rng.integers(1, batch))
            acc = torch.from_numpy(
                rng.integers(0, 1000, base + 2, dtype=np.int32)).to(card)
            before = dict(ce.LAUNCHES)
            h5, nm5 = ce.detailed_accum_megaloop(plan, batch, n_iters,
                                                 acc.clone(), st, valid, 1)
            assert ce.LAUNCHES["detailed_megaloop_mma"] == \
                before["detailed_megaloop_mma"] + 1
            assert ce.LAUNCHES["detailed_megaloop"] == before["detailed_megaloop"]
            hp, nmp = ve.detailed_accum_megaloop(plan, batch, n_iters,
                                                 acc.clone(), st, valid, 1)
            h1, nm1 = ce.detailed_accum_megaloop(plan, batch, n_iters,
                                                 acc.clone(), st, valid)
            assert torch.equal(h5, hp) and torch.equal(h5, h1)
            assert int(nm5) == int(nmp) == int(nm1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("base", [10, 40, 98, 100, 510])
def test_k5_dense_equals_plain_version_and_k4_on_card(card, base):
    """K5 in the dense mode, both TPU modes, at the nice test and the
    median: against its plain version and against K4 on the card."""
    plan = get_plan(base)
    batch = 256 if base == 510 else 1024
    valid = 3 * batch - 29
    starts = [47] if base == 10 else [plan.range_start,
                                      _carry_start(plan, 3 * batch)]
    for start in starts:
        st = ve.start_limbs_tensor(start, plan, card)
        for fused in (True, False):
            classes = ce.niceonly_classes(plan, fused, str(card))
            for mu in (base, (5 * base + 7) // 8):
                before = ce.LAUNCHES["niceonly_dense_mma"]
                got = ce.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                 valid, mu, use_mxu=1)
                assert ce.LAUNCHES["niceonly_dense_mma"] == before + 1
                want = ve.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                  valid, mu, use_mxu=1)
                k4 = ce.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                valid, mu)
                assert torch.equal(got, want) and torch.equal(got, k4)
                if base == 10 and mu == base:
                    # 69, and past the range's end (100) what the
                    # fixed-width digits count there.
                    assert got.tolist()[0] >= 1
    torch.cuda.synchronize()


def test_engine_with_k5_on_card_equals_k1_k4(card):
    """Whole fields with use_mxu=1 on the card equal the use_mxu=0 runs:
    detailed b17 (near misses, so K2 re-scans where K5 counts) and dense
    niceonly b98."""
    plan = get_plan(17)
    rng = FieldSize(plan.range_start - 100, plan.range_end + 100)
    ce.reset_launches()
    k5 = engine.process_range_detailed(rng, 17, device=card, batch_size=1024,
                                       segment=2, use_mxu=1)
    assert ce.LAUNCHES["detailed_megaloop_mma"] > 0
    assert ce.LAUNCHES["detailed_megaloop"] == 0 and ce.LAUNCHES["uniques"] > 0
    assert k5 == engine.process_range_detailed(rng, 17, device=card,
                                               batch_size=1024, segment=2,
                                               use_mxu=0)
    adaptive_floor.reset_for_tests(pinned=4096)
    start = 413428759798923141071530212209627033363
    field = FieldSize(start, start + 200_000)
    ce.reset_launches()
    k5 = engine.process_range_niceonly(field, 98, device=card, use_mxu=1)
    assert ce.LAUNCHES["niceonly_dense_mma"] == engine.LAST_NICEONLY_STATS["runs"] > 0
    assert ce.LAUNCHES["niceonly_dense"] == 0
    assert k5 == engine.process_range_niceonly(field, 98, device=card, use_mxu=0)
    adaptive_floor.reset_for_tests()


def _k5_detailed_case(card, plan, start, batch, n_iters, valid, rng):
    """K5's detailed mode against its plain version and K1 on one call."""
    st = ve.start_limbs_tensor(start, plan, card)
    acc = torch.from_numpy(
        rng.integers(0, 1000, plan.base + 2, dtype=np.int32)).to(card)
    before = dict(ce.LAUNCHES)
    h5, nm5 = ce.detailed_accum_megaloop(plan, batch, n_iters, acc.clone(),
                                         st, valid, 1)
    assert ce.LAUNCHES["detailed_megaloop_mma"] == \
        before["detailed_megaloop_mma"] + 1
    hp, nmp = ve.detailed_accum_megaloop(plan, batch, n_iters, acc.clone(),
                                         st, valid, 1)
    h1, nm1 = ce.detailed_accum_megaloop(plan, batch, n_iters, acc.clone(),
                                         st, valid)
    assert torch.equal(h5, hp) and torch.equal(h5, h1), (plan.base, start)
    assert int(nm5) == int(nmp) == int(nm1)


@pytest.mark.parametrize("base,tier", [(10, "plan"), (17, "plan"),
                                       (40, "plan"), (50, "plan"),
                                       (80, "plan"), (97, "plan"),
                                       (105, "generic"), (1024, "generic")])
def test_k5_detailed_tiers_on_card(card, base, tier):
    """K5's detailed mode in each tier it runs in (the plan tier at a base
    of each limb count to b97, the generic tier above, to b1024, the top of
    its admitted range), exact against its
    plain version and K1: from range_start, mid-range, across the largest
    limb carry inside the range and across a 2^32 carry (past the range
    where it is narrower: the schoolbook branch), with ragged last warps."""
    plan = get_plan(base)
    rng = np.random.default_rng(base + 1)
    batch = 96
    assert ce.launch_shape("detailed_megaloop_mma", plan, 1 << 21)["tier"] == tier
    carry = ((plan.range_start >> 32) + 1) << 32
    starts = [plan.range_start, (plan.range_start + plan.range_end) // 2,
              (carry - batch // 2) % (1 << (32 * plan.limbs_n))]
    if plan.limbs_n > 1:
        starts.append(_carry_start(plan, 3 * batch))
    for start in starts:
        for n_iters, valid in ((1, batch - 19), (3, 3 * batch - 45)):
            _k5_detailed_case(card, plan, start, batch, n_iters, valid, rng)
    torch.cuda.synchronize()


@pytest.mark.parametrize("base", [10, 17, 40, 55, 80, 97])
def test_k1_plan_tier_equals_plain_version_and_k5_on_card(card, base):
    """K1 on the plan tier (its per-base library, b10-b97) against its plain
    version and against K5, every bin and the near-miss count: from
    range_start and across the largest limb carry inside the range, with a
    ragged valid_total (so a nonzero pad into bin 0), at block sizes 32, 64,
    128 and 256; each launch counted under detailed_megaloop and
    detailed_megaloop_plan."""
    plan = get_plan(base)
    rng = np.random.default_rng(base + 2)
    batch, n_iters = 256, 3
    assert ce.launch_shape("detailed_megaloop", plan, 1 << 21)["tier"] == "plan"
    starts = [plan.range_start]
    if plan.limbs_n > 1:
        starts.append(_carry_start(plan, n_iters * batch))
    for start in starts:
        st = ve.start_limbs_tensor(start, plan, card)
        valid = n_iters * batch - int(rng.integers(1, batch))
        acc = torch.from_numpy(
            rng.integers(0, 1000, base + 2, dtype=np.int32)).to(card)
        hp, nmp = ve.detailed_accum_megaloop(plan, batch, n_iters, acc.clone(),
                                             st, valid)
        h5, nm5 = ce.detailed_accum_megaloop(plan, batch, n_iters, acc.clone(),
                                             st, valid, 1)
        assert torch.equal(h5, hp) and int(nm5) == int(nmp), start
        for threads in (32, 64, 128, 256):
            before = dict(ce.LAUNCHES)
            h1, nm1 = ce.detailed_accum_megaloop(plan, batch, n_iters,
                                                 acc.clone(), st, valid,
                                                 block_threads=threads)
            assert torch.equal(h1, hp) and int(nm1) == int(nmp), (start,
                                                                  threads)
            for k in ("detailed_megaloop", "detailed_megaloop_plan"):
                assert ce.LAUNCHES[k] == before[k] + 1, k
    torch.cuda.synchronize()


def test_main_library_leaves_plan_tier_k1_to_the_per_base_one_on_card(card):
    """The main library answers kPlanTierOnly for K1 and K5 at every plan
    the plan tier takes, before launching anything."""
    from nice_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    for base in (10, 40, 55, 80, 97):
        plan = get_plan(base)
        st = ve.start_limbs_tensor(plan.range_start, plan, card)
        acc = torch.zeros(base + 2, dtype=torch.int32, device=card)
        nm = torch.zeros((), dtype=torch.int32, device=card)
        for mma in (0, 1):
            rc = lib.nice_detailed_megaloop(
                ce.plan_words(plan), st.data_ptr(), 64, 0, acc.data_ptr(),
                nm.data_ptr(), mma, ce.DEFAULT_BLOCK_THREADS,
                ce._stream(st.device))
            assert rc == kernelspec.RETURN_CODES["kPlanTierOnly"], (base, mma)
        torch.cuda.synchronize()
        assert int(acc.abs().sum()) == 0 and int(nm) == 0


def test_k1_plan_tier_launches_over_fields_on_card(card):
    """LAUNCHES["detailed_megaloop_plan"] counts every K1 launch of a 1e9
    field at b40 and b80 (477 at the default shape) and none at b98 and
    b510, whose K1 runs in the main library."""
    for base, size, want in ((40, 10**9, 477), (80, 10**9, 477),
                             (98, 1 << 24, None), (510, 1 << 22, None)):
        plan = get_plan(base)
        start = (plan.range_start + plan.range_end) // 2
        ce.reset_launches()
        engine.process_range_detailed(
            FieldSize(start, start + size), base, device=card,
            batch_size=engine.DEFAULT_BATCH_SIZE,
            segment=engine.MEGALOOP_SEGMENT_DEFAULT, use_mxu=0)
        torch.cuda.synchronize()
        k1, on_plan = (ce.LAUNCHES[k] for k in ("detailed_megaloop",
                                                  "detailed_megaloop_plan"))
        if want:
            assert k1 == on_plan == want, (base, k1, on_plan)
        else:
            assert k1 > 0 and on_plan == 0, (base, k1, on_plan)
    ce.reset_launches()


@pytest.mark.parametrize("base,tier", [(40, "small"), (98, "dense"),
                                       (104, "dense"), (105, "generic")])
def test_k5_dense_tiers_on_card(card, base, tier):
    """K5's dense mode in each tier it runs in (K4's: the small tier, the
    dense register tier b97-b104, the generic tier from b105), both TPU
    modes at the nice test and the median, exact against its plain version
    and K4, from range_start and across the largest limb carry, with a
    ragged last warp and K4's small blocks."""
    plan = get_plan(base)
    batch = 512
    valid = 3 * batch - 77
    for fused in (True, False):
        classes = ce.niceonly_classes(plan, fused, str(card))
        shape = ce.launch_shape("niceonly_dense_mma", plan, classes.shape[0],
                                valid)
        assert shape["tier"] == tier and shape["threads"] == 64
        for start in (plan.range_start, _carry_start(plan, 3 * batch)):
            st = ve.start_limbs_tensor(start, plan, card)
            for mu in (base, (5 * base + 7) // 8):
                before = ce.LAUNCHES["niceonly_dense_mma"]
                got = ce.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                 valid, mu, use_mxu=1)
                assert ce.LAUNCHES["niceonly_dense_mma"] == before + 1
                want = ve.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                  valid, mu, use_mxu=1)
                k4 = ce.niceonly_dense_megaloop(plan, batch, 3, classes, st,
                                                valid, mu)
                assert torch.equal(got, want) and torch.equal(got, k4), \
                    (base, fused, start, mu)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# The pipelined host loop on the card: pinned uploads, event readbacks
# --------------------------------------------------------------------------

B40_NEAR_MISS = 3621949312977


def _with_launches(run):
    ce.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, dict(ce.LAUNCHES)


@pytest.mark.parametrize("use_mxu", [0, 1])
def test_pipelined_detailed_equals_synchronous_on_card(card, use_mxu):
    # Feed depth 0 (items made inline) and 2 (the feed thread): the same
    # results, launches and checkpoint states, near misses included.
    field = FieldSize(B40_NEAR_MISS - (1 << 24), B40_NEAR_MISS + (1 << 24))
    runs, states = {}, {0: [], 2: []}
    for depth in (0, 2):
        runs[depth] = _with_launches(lambda: engine.process_range_detailed(
            field, 40, device=card, batch_size=1 << 16, segment=4,
            use_mxu=use_mxu, feed_depth=depth,
            checkpoint_cb=states[depth].append, checkpoint_batches=8))
        assert engine.LAST_FEED_STATS["feed_depth"] == depth
    assert runs[0] == runs[2]
    assert runs[0][0].nice_numbers and runs[0][1]["uniques"] > 0
    assert len(states[0]) == len(states[2]) == 128 // 8
    for a, b in zip(states[0], states[2]):
        assert a["remaining"] == b["remaining"]
        assert np.array_equal(a["hist"], b["hist"])
        assert a["nice_numbers"] == b["nice_numbers"]


def test_pipelined_dense_equals_synchronous_on_card(card):
    start = 413428759798923141071530212209627033363  # a b98 field, > 2^128
    field = FieldSize(start, start + 200_000)
    runs = {}
    for depth in (0, 2):
        adaptive_floor.reset_for_tests(pinned=4096)
        runs[depth] = _with_launches(lambda: engine.process_range_niceonly(
            field, 98, device=card, feed_depth=depth))
    adaptive_floor.reset_for_tests()
    assert runs[0] == runs[2] and runs[0][1]["niceonly_dense"] > 0


def test_start_ring_waits_for_its_copy_on_card(card, monkeypatch):
    # A ring of one pinned block of start limbs in front of a device that
    # lags: 0.8 ms segments, so the dispatcher runs a window ahead of the
    # device and each block's upload comes back to the one slot while the
    # copy before is still queued behind kernels. (A slow collector alone
    # would let the device catch up.) The feed must wait for that copy's
    # event, ring_waits counts the waits, and a block written early would
    # send wrong starts and change the histogram.
    field = FieldSize(B40_NEAR_MISS - (1 << 30), B40_NEAR_MISS + (1 << 30))
    kw = dict(device=card, batch_size=1 << 18, segment=64)
    want = engine.process_range_detailed(field, 40, feed_depth=0, **kw)
    monkeypatch.setattr(engine, "FEED_RING_SLOTS", 1)
    got = engine.process_range_detailed(field, 40, feed_depth=2, **kw)
    assert got == want
    assert engine.LAST_FEED_STATS["dispatches"] == 128
    assert engine.LAST_FEED_STATS["ring_waits"] > 0


def _torch_calls_on_thread(target, name="nice-prefetch"):
    """target() on a thread of that name, profiled: the torch functions it
    called (Python frames in the torch package, C functions of its
    modules)."""
    import sys
    import threading

    root = torch.__file__.rsplit("/", 1)[0]
    calls = []

    def prof(frame, event, arg):
        if event == "call" and frame.f_code.co_filename.startswith(root):
            calls.append(frame.f_code.co_name)
        elif event == "c_call" and (getattr(arg, "__module__", None)
                                    or "").startswith("torch"):
            calls.append(arg.__name__)

    def run():
        sys.setprofile(prof)
        try:
            target()
        finally:
            sys.setprofile(None)

    t = threading.Thread(target=run, name=name)
    t.start()
    t.join(600)
    return calls


def test_warm_builds_the_field_libraries_without_torch_on_card(card):
    # b23 is used by no other test: its per-base library is built by the
    # warm, on the prefetch thread, with no torch call and no launch; the
    # field's K2 then loads nothing new.
    from nice_tpu_torch.ops import cuda_build

    plan = get_plan(23)
    header = ce.plan_header(plan)
    ce.plan_library.cache_clear()
    ce.reset_launches()
    calls = _torch_calls_on_thread(lambda: engine.warm_detailed(23))
    assert calls == [] and sum(ce.LAUNCHES.values()) == 0
    assert header in cuda_build.PLAN_BUILDS
    builds = dict(cuda_build.PLAN_BUILDS)
    start = ve.start_limbs_tensor(plan.range_start, plan, card)
    ce.uniques_batch(plan, 1024, start)
    torch.cuda.synchronize()
    assert cuda_build.PLAN_BUILDS == builds and ce.LAUNCHES["uniques"] == 1
    calls = _torch_calls_on_thread(
        lambda: engine.warm_niceonly(98, 1 << 20) or engine.warm_niceonly(
            23, 1 << 20))
    assert calls == []


def test_block_iteration_on_card(card, tmp_path):
    # The JAX package's server in a process of its own (this file imports
    # nothing of nice_tpu), seeded with b40 fields of 1e9; one block of 3
    # through the port's client on the card, each member accepted and
    # equal to the engine's run of its field.
    import json
    import os
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from nice_tpu_torch.client import api_client
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.types import SearchMode

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with open(tmp_path / "server.log", "wb") as log_f:
        server = subprocess.Popen(
            [sys.executable, "-m", "nice_tpu.server", "--db",
             str(tmp_path / "nice.db"), "--init-base", "40", "--field-size",
             "1000000000", "--host", "127.0.0.1", "--port", str(port)],
            cwd=repo, stdout=log_f, stderr=subprocess.STDOUT)
    api = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(api + "/status", timeout=5) as r:
                    json.loads(r.read())
                break
            except OSError:
                assert server.poll() is None and time.monotonic() < deadline
                time.sleep(0.5)
        args = client.build_parser().parse_args(
            ["detailed", "--api-base", api, "--claim-block", "3",
             "--renew-secs", "1", "--max-retries", "2"])
        api_obj = api_client.AsyncApi(api, "card", max_retries=2)
        claimed, sent = [], []
        real_claim, real_submit = (api_obj.claim_block_async,
                                   api_obj.submit_block_async)
        api_obj.claim_block_async = lambda *a: claimed.append(
            real_claim(*a)) or claimed[-1]
        api_obj.submit_block_async = lambda b, subs: sent.append(
            (subs, real_submit(b, subs))) or sent[-1][1]
        try:
            assert client.run_block_iteration(args, api_obj,
                                              SearchMode.DETAILED)
        finally:
            api_obj.shutdown()
            api_client.close_connections()
        _, fields = claimed[0].result()
        subs, fut = sent[0]
        assert fut.result()["accepted"] == len(fields) == len(subs) >= 1
        assert api_client.last_seen_epoch() >= 1
        for data, sub in zip(fields, subs):
            want = engine.process_range_detailed(data.to_field_size(), 40,
                                                 device=card)
            assert sub.claim_id == data.claim_id
            assert sub.unique_distribution == list(want.distribution)
            assert sub.nice_numbers == list(want.nice_numbers)
            assert sum(d.count for d in want.distribution) == data.range_size
    finally:
        server.terminate()
        server.wait(timeout=30)


def test_small_b50_field_takes_the_default_route_on_card(card):
    # A b50 field of 2^20 from the msd-ineffective cell's start: with the
    # default limit it takes the host route (no K3 launch) when
    # HOST_NICEONLY_MAX admits it, and equals the K3 path.
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field

    start = get_benchmark_field(BenchmarkMode.MSD_INEFFECTIVE).range_start
    field = FieldSize(start, start + (1 << 20))
    ce.reset_launches()
    k3 = engine.process_range_niceonly(field, 50, device=card,
                                       host_niceonly_max=0)
    assert engine.LAST_NICEONLY_STATS["route"] == "device"
    assert ce.LAUNCHES["strided_niceonly"] >= 1
    ce.reset_launches()
    default = engine.process_range_niceonly(field, 50, device=card)
    routed = engine.HOST_NICEONLY_MAX >= field.size()
    assert engine.LAST_NICEONLY_STATS["route"] == ("host" if routed
                                                   else "device")
    assert (ce.LAUNCHES["strided_niceonly"] == 0) == routed
    assert default == k3
    ce.reset_launches()
    assert engine.process_range_niceonly(field, 50, device=card,
                                         host_niceonly_max=1 << 27) == k3
    assert ce.LAUNCHES["strided_niceonly"] == 0


def test_native_fields_equal_the_card(card):
    lo = get_plan(40).range_start
    field = FieldSize(lo, lo + 2_000_000)
    assert engine.process_range_detailed(field, 40, backend="native") == \
        engine.process_range_detailed(field, 40, device=card)
    mid = 3621949012977
    field = FieldSize(mid, mid + 600_000)
    adaptive_floor.reset_for_tests(pinned=4096)
    try:
        assert engine.process_range_niceonly(field, 40, backend="native",
                                             threads=4) == \
            engine.process_range_niceonly(field, 40, device=card,
                                          host_niceonly_max=0)
    finally:
        adaptive_floor.reset_for_tests()


def test_two_tenants_interleaved_on_card_equal_solo_runs(card):
    # A detailed tenant (b40, a stretch with a near miss: K1 and K2) and a
    # niceonly tenant (b40 strided: K3) interleaved at every page boundary
    # on the card; each assembled field equals its solo run there, and
    # every page launched on the card.
    from nice_tpu_torch import sched

    near_miss = 3621949312977  # num_uniques 37 at b40
    det_rng = (near_miss - (5 << 20), near_miss + (3 << 20))
    nice_rng = (det_rng[1], det_rng[1] + (8 << 20))
    reg = sched.TenantRegistry([
        sched.TenantSpec(name="det", mode="detailed", base=40, priority=2,
                         batch_size=1 << 18),
        sched.TenantSpec(name="nice", mode="niceonly", base=40, priority=1)])
    source = sched.StaticSource({
        "det": [("det/f0", 40, *det_rng)], "nice": [("nice/f0", 40, *nice_rng)]})
    scheduler = sched.MultiTenantScheduler(reg, source, page_batches=1,
                                           quantum_secs=1e-9)
    ce.reset_launches()
    stats = scheduler.run()
    assert stats["tenants"]["det"]["pages"] == 4  # 8 Mi numbers / 2^21
    assert stats["tenants"]["det"]["preemptions"] > 0
    assert ce.LAUNCHES["detailed_megaloop"] >= 4
    assert ce.LAUNCHES["uniques"] > 0 and ce.LAUNCHES["strided_niceonly"] > 0
    want_det = engine.process_range_detailed(FieldSize(*det_rng), 40,
                                             batch_size=1 << 18)
    want_nice = engine.process_range_niceonly(FieldSize(*nice_rng), 40)
    assert source.results["det"]["det/f0"] == want_det
    assert source.results["nice"]["nice/f0"] == want_nice
    assert near_miss in [n.number for n in want_det.nice_numbers]
    assert scheduler.table.check_invariants() == []


# --- the mesh of logical slices (parallel/mesh.py) ---------------------------

NEAR_MISS_B40 = 3621949312977  # num_uniques 37 at b40
B98_SURVIVING = 413428759798923141071530212209627033363


@pytest.mark.parametrize("k", [2, 4])
def test_detailed_on_logical_slices_equals_one_device_on_card(card, k):
    # k slices of the one card, each on its own stream: K1 a slice, the
    # fold across the streams, K2 on the slice that holds the near miss.
    field = FieldSize(NEAR_MISS_B40 - (6 << 20), NEAR_MISS_B40 + (5 << 20))
    want = engine.process_range_detailed(field, 40, batch_size=1 << 16,
                                         segment=2)
    ce.reset_launches()
    got = engine.process_range_detailed(field, 40, devices=["cuda:0"] * k,
                                        batch_size=1 << 16, segment=2)
    assert got == want
    assert NEAR_MISS_B40 in [n.number for n in got.nice_numbers]
    stats = engine.LAST_FEED_STATS
    assert stats["n_dev_start"] == stats["n_dev_end"] == k
    assert ce.LAUNCHES["detailed_megaloop"] >= field.size() >> 17
    assert ce.LAUNCHES["uniques"] > 0


@pytest.mark.parametrize("k", [2, 4])
def test_strided_groups_on_logical_slices_equal_one_device_on_card(
        card, monkeypatch, k):
    # Groups of 8 descriptors a slice: every group spans the slices.
    lo, hi = get_plan(40).range_start, get_plan(40).range_end
    field = FieldSize((lo + hi) // 2, (lo + hi) // 2 + 4_000_000)
    try:
        adaptive_floor.reset_for_tests(pinned=4096)
        want = engine.process_range_niceonly(field, 40, host_niceonly_max=0)
        monkeypatch.setattr(ce, "STRIDED_DESC_MAX", 8)
        ce.reset_launches()
        got = engine.process_range_niceonly(field, 40, host_niceonly_max=0,
                                            devices=["cuda:0"] * k)
        stats = engine.LAST_NICEONLY_STATS
        assert got == want and stats["n_dev"] == k
        assert stats["descriptors"] > 8 * k
        # Every group but the last spans every slice: one launch a slice.
        assert ce.LAUNCHES["strided_niceonly"] >= (stats["groups"] - 1) * k + 1
    finally:
        adaptive_floor.reset_for_tests()


@pytest.mark.parametrize("k", [2, 4])
def test_dense_runs_on_logical_slices_equal_one_device_on_card(card, k):
    field = FieldSize(B98_SURVIVING, B98_SURVIVING + 400_000)
    try:
        adaptive_floor.reset_for_tests(pinned=4096)
        want = engine.process_range_niceonly(field, 98, batch_size=1024,
                                             segment=2)
        runs = engine.LAST_NICEONLY_STATS["runs"]
        ce.reset_launches()
        got = engine.process_range_niceonly(field, 98, batch_size=1024,
                                            segment=2, devices=["cuda:0"] * k)
        mesh_runs = engine.LAST_NICEONLY_STATS["runs"]
        assert got == want and runs > k
        # The slices' queues may cut a filtered range once more apiece.
        assert runs <= mesh_runs <= runs + k - 1
        assert ce.LAUNCHES["niceonly_dense"] == mesh_runs
    finally:
        adaptive_floor.reset_for_tests()


def test_downshift_on_logical_slices_on_card(card):
    # A slice lost mid-field: the rows fold across the streams at the
    # downshift, and the survivors finish the field.
    from nice_tpu_torch.faults import injector as faults
    from nice_tpu_torch.parallel import mesh as pmesh

    field = FieldSize(NEAR_MISS_B40 - (6 << 20), NEAR_MISS_B40 + (5 << 20))
    want = engine.process_range_detailed(field, 40, batch_size=1 << 16,
                                         segment=2)
    try:
        faults.configure("mesh.dispatch:dead:1@5")
        got = engine.process_range_detailed(field, 40, devices=["cuda:0"] * 4,
                                            batch_size=1 << 16, segment=2)
    finally:
        faults.reset()
        pmesh.heal_devices()
    assert got == want
    stats = engine.LAST_FEED_STATS
    assert (stats["reshards"], stats["n_dev_end"]) == (1, 3)


# The kernel-spec registry's claims on the card
# (nice_tpu_torch/scripts/spec_witness.py, chip_smoke.py's kernelspec phase).

# The registry's entries that launch a kernel (the shape queries aside).
LAUNCH_SPECS = sorted(name for name, spec in kernelspec.all_specs().items()
                      if spec.kind == "launch")


@pytest.mark.parametrize("name", LAUNCH_SPECS)
def test_spec_witnesses_equal_plain_versions_on_card(card, name):
    from nice_tpu_torch.scripts import spec_witness

    got = spec_witness.witnesses(card, names=[name])[name]
    assert got and all(c["max_abs_diff"] == 0 and c["cases"] > 0
                       for c in got.values()), got


def test_clamp_edge_launch_equals_default_segments(card):
    from nice_tpu_torch.scripts import spec_witness

    edge = spec_witness.clamp_edge(card)
    assert edge["lanes"] <= kernelspec.ACC_LIMIT // 2 < edge["lanes"] + edge["batch"]
    assert edge["bins_sum"] == edge["lanes"] and edge["equal_to_segments"], edge


def test_spec_error_paths_raise_on_card(card):
    from nice_tpu_torch.scripts import spec_witness

    errors = spec_witness.error_paths(card)
    assert all(errors.values()), errors
    assert "below 2^31" in errors["k5_past_2^31_lanes"]
    assert "per-base build" in errors["main_k5_on_plan_tier"]
    assert "per-base build" in errors["main_k1_on_plan_tier"]
    assert "another plan" in errors["other_plan"]
    assert "another plan" in errors["other_plan_k1"]
    assert "shared memory" in errors["k5_smem"]
    assert "2048 bins" in errors["base_past_2048_bins"]


def test_launch_shape_tiers_equal_the_spec_on_card(card):
    from nice_tpu_torch.scripts import spec_witness

    tiers = spec_witness.shape_tiers((40, 80, 97))
    drift = {k: {b: t for b, t in v.items() if t[0] != t[1]}
             for k, v in tiers.items()}
    assert not any(drift.values()), drift


# -- the block size (block_threads) --------------------------------------------

def _k3_inputs(card, base):
    """A ragged b40/b80 descriptor table at its depth-1 stride table."""
    plan = get_plan(base)
    table = stride_filter.get_stride_table(base, 1)
    res = torch.from_numpy(table.residues_u32.astype(np.int64)).to(card)
    periods, m = 16, table.modulus
    lo = plan.range_start + 12345
    desc = np.zeros((8, kernelspec.DESC_WIDTH), dtype=np.int64)
    for row in range(6):
        n0 = lo // m * m + row * periods * m
        for k, x in enumerate((n0, lo + row, lo + 5 * periods * m)):
            desc[row, 4 * k:4 * k + 4] = int_to_limbs(x, 4)
    return plan, m, res, periods, torch.from_numpy(desc).to(card)


BLOCK_CASES = [("k1", 40), ("k1", 80), ("k1", 510), ("k5", 40), ("k5", 510),
               ("k3", 40), ("k3", 80), ("k4", 98), ("k5_dense", 98)]


@pytest.mark.parametrize("kernel,base", BLOCK_CASES)
def test_every_block_size_equals_the_plain_version_on_card(card, kernel, base):
    """Each kernel at every admissible block size (K5 from 64) against its
    plain version, exact, at a check threshold where K3 and K4 count."""
    plan = get_plan(base)
    mxu = int(kernel.startswith("k5"))
    min_u = (5 * base + 7) // 8
    rng = np.random.default_rng(base)
    if kernel in ("k1", "k5"):
        batch, n_iters = 512, 3
        valid = batch * n_iters - int(rng.integers(1, batch))
        st = ve.start_limbs_tensor(plan.range_start + 777, plan, card)
        want = ve.detailed_accum_megaloop(
            plan, batch, n_iters, torch.zeros(base + 2, dtype=torch.int32,
                                              device=card), st, valid, mxu)
    elif kernel == "k3":
        plan, m, res, periods, desc = _k3_inputs(card, base)
        want = ve.niceonly_strided_counts(plan, m, res, periods, desc, 6,
                                          min_u)
        assert int(want.sum()) > 0
    else:
        classes = ce.niceonly_classes(plan, True, str(card))
        st = ve.start_limbs_tensor(plan.range_start + 999, plan, card)
        want = ve.niceonly_dense_megaloop(plan, 1 << 12, 4, classes, st,
                                          (1 << 14) - 33, min_u, mxu)
    for threads in ce.admissible_block_threads(mxu):
        if kernel in ("k1", "k5"):
            got = ce.detailed_accum_megaloop(
                plan, batch, n_iters, torch.zeros(base + 2, dtype=torch.int32,
                                                  device=card), st, valid,
                mxu, block_threads=threads)
            assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        elif kernel == "k3":
            got = ce.strided_niceonly_batch(plan, m, res, periods, desc, 6,
                                            min_u, block_threads=threads)
            assert torch.equal(got, want), threads
        else:
            got = ce.niceonly_dense_megaloop(plan, 1 << 12, 4, classes, st,
                                             (1 << 14) - 33, min_u, mxu,
                                             block_threads=threads)
            assert torch.equal(got, want), threads


def test_launch_shape_takes_the_block_size_on_card(card):
    """launch_shape reports the block size asked for (K2 keeps 256; K4 and
    K5's dense mode take 64 on a run smaller than the SMs' blocks of it),
    and at 256 the parent's shape: one resident wave of 256-thread blocks."""
    p40, p98 = get_plan(40), get_plan(98)
    seg = 1 << 21
    for threads in ce.admissible_block_threads():
        k1 = ce.launch_shape("detailed_megaloop", p40, seg,
                             block_threads=threads)
        assert k1["threads"] == threads
        assert k1["grid"] == k1["blocks_per_sm"] * k1["sms"]
        k3 = ce.launch_shape("strided_niceonly", p40, 17408, 1024,
                             block_threads=threads)
        assert k3["threads"] == threads
        assert k3["grid"] == -(-17408 // threads) * 1024
        assert ce.launch_shape("uniques", p40, 1 << 18,
                               block_threads=threads)["threads"] == 256
        full = ce.launch_shape("niceonly_dense", p98, 2, seg,
                               block_threads=threads)
        assert full["threads"] == threads
        small = ce.launch_shape("niceonly_dense", p98, 2, 10_000,
                                block_threads=threads)
        lanes = 2 * -(-10_000 // 97)
        assert small["threads"] == (
            64 if threads > 64 and lanes < small["sms"] * threads else threads)
    for threads in ce.admissible_block_threads(1):
        assert ce.launch_shape("detailed_megaloop_mma", p40, seg,
                               block_threads=threads)["threads"] == threads
        assert ce.launch_shape("niceonly_dense_mma", p98, 2, seg,
                               block_threads=threads)["threads"] == threads
    default = ce.launch_shape("detailed_megaloop", p40, seg)
    assert default == ce.launch_shape("detailed_megaloop", p40, seg,
                                      block_threads=256)
    assert default["threads"] == 256


def test_bad_block_sizes_raise_at_the_c_entries_on_card(card):
    from nice_tpu_torch.scripts import spec_witness

    errors = spec_witness.bad_block_threads(card)
    assert errors and all(errors.values()), errors
    assert all("admissible set" in v for k, v in errors.items()
               if k.startswith("nice_")), errors


def test_engine_at_a_tuned_block_size_equals_the_default_on_card(card):
    plan = get_plan(40)
    rng = FieldSize(plan.range_start, plan.range_start + 5_000_000)
    want = engine.process_range_detailed(rng, 40, device=card)
    for threads in (32, 128):
        got = engine.process_range_detailed(rng, 40, device=card,
                                            block_threads=threads)
        assert got == want
        assert engine.LAST_FEED_STATS["block_threads"] == threads
    adaptive_floor.reset_for_tests(pinned=4096)
    try:
        start = 413428759798923141071530212209627033363
        dense = FieldSize(start, start + 2_000_000)
        want = engine.process_range_niceonly(dense, 98, device=card)
        got = engine.process_range_niceonly(dense, 98, device=card,
                                            block_threads=64)
        assert got == want
        assert engine.LAST_NICEONLY_STATS["block_threads"] == 64
    finally:
        adaptive_floor.reset_for_tests()
