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

from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("base", [10, 17, 40, 50, 80, 97, 510])
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


@pytest.mark.parametrize("base", [40, 98, 510])
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
        on_card = engine.process_range_niceonly(FieldSize(s, e), base,
                                                device=card)
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
