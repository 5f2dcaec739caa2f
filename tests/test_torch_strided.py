"""The port's plain strided niceonly kernel (K3's CPU twin,
nice_tpu_torch/ops/vector_engine.py niceonly_strided_counts) held against the
JAX package's stride-descriptor Pallas kernel (pallas_engine.
niceonly_strided_batch, run in interpret mode as tests/test_pallas_engine.py
runs it), per descriptor, exactly: ragged lo/hi, padded rows past n_real,
b10's 69, and candidates that cross a multiple of 2^32 (b40) and of 2^64
(b80). Inputs come from a seeded numpy generator; both kernels get the same
descriptor table.
"""

import numpy as np
import pytest
import torch

from nice_tpu.ops import pallas_engine as pe
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import stride_filter as jstride
from nice_tpu.ops.limbs import get_plan as jget_plan
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import stride_filter
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

PERIODS = 4  # the Pallas tests' stride periods: keeps interpret mode short


def _desc_rows(base: int, rng) -> list[tuple[int, int, int]]:
    """(n0, lo, hi) rows of the cases at one base."""
    plan = get_plan(base)
    table = stride_filter.get_stride_table(base, 1)
    m = table.modulus
    span = PERIODS * m
    start = plan.range_start
    rows = []
    if base == 10:
        # The whole range [47, 100) holds 69; then an empty descriptor.
        rows.append(((47 // m) * m, 47, 100))
        rows.append((0, 0, 0))
        return rows
    # Ragged lo/hi: a run that starts and ends mid-period, cut into spans.
    lo = start + int(rng.integers(1, m))
    hi = lo + 2 * span + int(rng.integers(1, span))
    n0 = (lo // m) * m
    while n0 < hi:
        rows.append((n0, lo, hi))
        n0 += span
    # Candidates across a multiple of 2^32 (b40) or 2^64 (b80) inside the
    # base's range.
    width = {40: 32, 80: 64}.get(base)
    if width is not None:
        boundary = ((start >> width) + 1) << width
        assert start < boundary < plan.range_end
        n0 = ((boundary - span // 2) // m) * m
        rows.append((n0, n0 + int(rng.integers(0, m)), n0 + span))
    return rows


def _case(base: int):
    rng = np.random.default_rng(base)
    rows = _desc_rows(base, rng)
    n_real = len(rows)
    desc = np.zeros((n_real + 2, 12), dtype=np.uint32)  # two padding rows
    for i, (n0, lo, hi) in enumerate(rows):
        desc[i, 0:4] = int_to_limbs(n0, 4)
        desc[i, 4:8] = int_to_limbs(lo, 4)
        desc[i, 8:12] = int_to_limbs(hi, 4)
    # Padding rows hold junk the kernels must not count.
    desc[n_real:, :] = rng.integers(0, 1 << 32, size=(2, 12), dtype=np.uint32)
    return rows, desc, n_real


def _plain_counts(base: int, desc: np.ndarray, n_real: int,
                  min_uniques: int | None = None):
    plan = get_plan(base)
    table = stride_filter.get_stride_table(base, 1)
    residues = torch.from_numpy(table.residues_u32.astype(np.int64))
    return ce.strided_niceonly_batch(
        plan, table.modulus, residues, PERIODS,
        torch.from_numpy(desc.astype(np.int64)), n_real, min_uniques)


@pytest.mark.parametrize("base", [10, 20, 40, 80])
def test_plain_k3_equals_pallas_kernel(base):
    rows, desc, n_real = _case(base)
    jt = jstride.get_stride_table(base, 1)
    spec = pe.StrideSpec(jt.modulus, tuple(jt.valid_residues))
    want = np.asarray(pe.niceonly_strided_batch(
        jget_plan(base), spec, desc, periods=PERIODS, n_real=n_real)
    ).reshape(-1)[: desc.shape[0]]
    got = _plain_counts(base, desc, n_real)
    assert got.dtype == torch.int32 and got.shape == (desc.shape[0],)
    assert got.tolist() == want.tolist()
    assert got[n_real:].tolist() == [0] * (desc.shape[0] - n_real)
    if base == 10:
        assert got.tolist()[:2] == [1, 0]  # 69


def test_plain_k3_counts_each_candidate_once():
    # Per descriptor, the count is that of the stride candidates in its span
    # clipped to [lo, hi), each through num_uniques: b10's range (69) and
    # spans past it.
    base = 10
    table = stride_filter.get_stride_table(base, 1)
    span = PERIODS * table.modulus
    rows = [(0, 47, 100)] + [(n0, max(n0, 100), n0 + span)
                             for n0 in range(90, 3000, span)]
    desc = np.zeros((len(rows), 12), dtype=np.uint32)
    for i, (n0, lo, hi) in enumerate(rows):
        desc[i, 0:4] = int_to_limbs(n0, 4)
        desc[i, 4:8] = int_to_limbs(lo, 4)
        desc[i, 8:12] = int_to_limbs(hi, 4)
    got = _plain_counts(base, desc, len(rows)).tolist()
    plan = get_plan(base)
    want = []
    for n0, lo, hi in rows:
        n = torch.tensor([c for c in range(lo, hi)
                          if (c - n0) % table.modulus in table.valid_residues],
                         dtype=torch.int64)
        u = ve.num_uniques_lanes(
            plan, [(n >> (32 * i)) & 0xFFFFFFFF for i in range(plan.limbs_n)])
        want.append(int((u == base).sum()))
    assert got == want
    assert want[0] == 1


@pytest.mark.parametrize("base", [20, 40, 80])
def test_plain_k3_threshold_counts_equal_bigint(base):
    # No number of these rows is nice, so at min_uniques = base every count
    # is 0 and would hide a lost carry or a wrong range mask. About the
    # median of num_uniques every row counts many lanes, each held to the
    # JAX package's Python big-int num_uniques: the ragged rows, and the
    # rows across 2^32 (b40) and 2^64 (b80).
    rows, desc, n_real = _case(base)
    min_u = (5 * base + 7) // 8
    got = _plain_counts(base, desc, n_real, min_u).tolist()
    m = stride_filter.get_stride_table(base, 1).modulus
    valid = stride_filter.get_stride_table(base, 1).valid_residues
    want = []
    for n0, lo, hi in rows:
        want.append(sum(
            1 for c in range(max(lo, n0), min(hi, n0 + PERIODS * m))
            if (c - n0) % m in valid
            and min_u <= jscalar.get_num_unique_digits(c, base) <= base))
    assert got[:n_real] == want
    assert got[n_real:] == [0] * (len(got) - n_real)
    assert sum(want[:-1]) > 0 and all(w > 0 for w in want[-1:])
    assert _plain_counts(base, desc, n_real).tolist() == [0] * len(got)


def test_plain_k3_is_chunk_invariant(monkeypatch):
    rows, desc, n_real = _case(40)
    whole = _plain_counts(40, desc, n_real)
    monkeypatch.setattr(ve, "STRIDED_CHUNK_LANES", 1)  # one descriptor a chunk
    assert torch.equal(_plain_counts(40, desc, n_real), whole)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = get_plan(40)
    table = stride_filter.get_stride_table(40, 1)
    res = torch.from_numpy(table.residues_u32.astype(np.int64))
    desc = torch.zeros((4, 12), dtype=torch.int64)
    with pytest.raises(ValueError):  # n_real past the rows
        ce.strided_niceonly_batch(plan, table.modulus, res, 4, desc, 5)
    with pytest.raises(ValueError):  # periods * M leaves u32
        ce.strided_niceonly_batch(plan, table.modulus, res, 1 << 22, desc, 1)
    with pytest.raises(ValueError):  # u32 carriers are int64 tensors
        ce.strided_niceonly_batch(plan, table.modulus, res, 4,
                                  desc.to(torch.int32), 1)
    with pytest.raises(ValueError):  # more than 4 limbs
        ce.strided_niceonly_batch(get_plan(510), table.modulus, res, 4, desc, 1)
    before = ce.LAUNCHES["strided_niceonly"]
    out = ce.strided_niceonly_batch(plan, table.modulus, res, 4, desc, 0)
    assert out.tolist() == [0] * 4
    assert ce.LAUNCHES["strided_niceonly"] == before  # the CPU launches nothing
