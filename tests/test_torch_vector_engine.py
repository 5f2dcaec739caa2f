"""The port's plain PyTorch kernel versions (nice_tpu_torch/ops/vector_engine.py)
held against the JAX package: limb primitives against Python ints, per-lane
num_uniques against the scalar oracle, K1 against the Pallas kernel (in
interpret mode) and the jnp megaloop, K2 and the survivor compaction against
the Pallas and jnp twins. Every quantity is an integer, so every comparison is
exact equality. Inputs are drawn with numpy from fixed seeds.

On the CPU the cuda_engine wrappers route to these plain versions; the same
tests therefore cover what the engine runs here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_tpu.ops import limbs as jlimbs
from nice_tpu.ops import pallas_engine as pe
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import vector_engine as jve
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import limbs_to_int, plan_from_reference

MASK32 = 0xFFFFFFFF


def _plan(base: int):
    """The port's plan, built from the JAX package's so both run one plan."""
    return plan_from_reference(dataclasses.asdict(jlimbs.get_plan(base)))


def _limbs(xs: list, n: int) -> list:
    """Values as an LSW-first limb list, one lane per value."""
    return [torch.tensor([(x >> (32 * i)) & MASK32 for x in xs],
                         dtype=torch.int64) for i in range(n)]


def _values(limbs: list) -> list:
    """Inverse of _limbs, checking every limb is a u32 value."""
    rows = [v.tolist() for v in limbs]
    assert all(0 <= w <= MASK32 for r in rows for w in r)
    return [limbs_to_int(col) for col in zip(*rows)]


def _start(plan, x: int) -> torch.Tensor:
    return ve.start_limbs_tensor(x, plan, "cpu")


def _jstart(base: int, x: int):
    return jlimbs.int_to_limbs(x, jlimbs.get_plan(base).limbs_n)


def _edge_values(plan, rng) -> list:
    """Carry-edge candidates of limbs_n limbs: all ones, 2^32k - 1 and 2^32k
    for every limb boundary k, the plan's range ends, and random values."""
    top = 1 << (32 * plan.limbs_n)
    vals = [top - 1, plan.range_start, plan.range_end - 1]
    for k in range(1, plan.limbs_n):
        vals += [(1 << (32 * k)) - 1, 1 << (32 * k), (1 << (32 * k)) + MASK32]
    for _ in range(6):
        words = rng.integers(0, 1 << 32, plan.limbs_n, dtype=np.uint64)
        vals.append(sum(int(w) << (32 * i) for i, w in enumerate(words)))
    return vals


@pytest.mark.parametrize("base", [40, 80, 510])
def test_limb_primitives_exact_on_carry_edges(base):
    plan = _plan(base)
    rng = np.random.default_rng(base)
    # mul32 on the 16-bit-half edges.
    edges = [0, 1, 0xFFFF, 0x10000, 0xFFFF0000, 0x8000_0000, MASK32]
    a = torch.tensor([x for x in edges for _ in edges], dtype=torch.int64)
    b = torch.tensor([y for _ in edges for y in edges], dtype=torch.int64)
    lo, hi = ve.mul32(a, b)
    for x, y, l_, h_ in zip(a.tolist(), b.tolist(), lo.tolist(), hi.tolist()):
        assert (h_ << 32) | l_ == x * y
    xs = _edge_values(plan, rng)
    n = _limbs(xs, plan.limbs_n)
    sq = ve.sqr_limbs(n, plan.limbs_sq)
    cu = ve.mul_limbs(sq, n, plan.limbs_cu)
    m_sq, m_cu = 1 << (32 * plan.limbs_sq), 1 << (32 * plan.limbs_cu)
    assert _values(sq) == [x * x % m_sq for x in xs]
    assert _values(cu) == [x * x % m_sq * x % m_cu for x in xs]
    for off in (0, 1, MASK32, 1 << 32, (1 << 40) + 12345):
        got = ve.add_u32(n, torch.tensor(off, dtype=torch.int64))
        assert _values(got) == [(x + off) % (1 << (32 * plan.limbs_n)) for x in xs]


def test_popcount32_matches_python():
    rng = np.random.default_rng(7)
    vals = [0, 1, MASK32, 0x8000_0000, 0x5555_5555] + [
        int(v) for v in rng.integers(0, 1 << 32, 64, dtype=np.uint64)]
    got = ve.popcount32(torch.tensor(vals, dtype=torch.int64))
    assert got.tolist() == [v.bit_count() for v in vals]


@pytest.mark.parametrize("base", [10, 17, 40, 50, 80, 97, 120, 510])
def test_num_uniques_matches_reference_oracle(base):
    plan = _plan(base)
    rng = np.random.default_rng(1000 + base)
    lanes = min(128, plan.range_end - plan.range_start)
    span = plan.range_end - plan.range_start - lanes
    # A seeded start anywhere in the range (b510's is ~1e270 wide).
    start = plan.range_start + int.from_bytes(rng.bytes(128), "little") % (span + 1)
    got = ve.uniques_batch(plan, lanes, _start(plan, start)).tolist()
    want = [jscalar.get_num_unique_digits(start + i, base) for i in range(lanes)]
    assert got == want


@pytest.mark.parametrize("base,start_off,valid", [(10, 0, 53), (40, 0, 2000)])
def test_k1_plain_matches_pallas_interpret(base, start_off, valid):
    # One batch of 2048 lanes (block_rows 8, so two grid steps), valid <
    # batch: the padding lanes land in bin 0 on both sides.
    plan = _plan(base)
    batch = 2048
    start = plan.range_start + start_off
    hist_j, nm_j = pe.detailed_batch(jlimbs.get_plan(base), batch,
                                     _jstart(base, start), np.int32(valid),
                                     block_rows=8)
    acc = torch.zeros(base + 2, dtype=torch.int32)
    hist_t, nm_t = ce.detailed_accum_megaloop(plan, batch, 1, acc,
                                              _start(plan, start), valid)
    assert hist_t is acc  # updated in place
    assert hist_t.tolist() == np.asarray(hist_j)[: base + 2].tolist()
    assert int(nm_t) == int(np.asarray(nm_j))
    if base == 10:
        assert int(nm_t) == 1  # 69, the only nice number of base 10


@pytest.mark.parametrize("n_iters", [1, 3])
@pytest.mark.parametrize("base", [17, 80])
def test_k1_plain_matches_jax_megaloop(base, n_iters):
    plan = _plan(base)
    rng = np.random.default_rng(base * 10 + n_iters)
    batch = 128
    valid = batch * n_iters - int(rng.integers(1, batch))
    start = plan.range_start + int(rng.integers(0, 10_000))
    acc0 = rng.integers(0, 1000, base + 2, dtype=np.int32)
    hist_j, nm_j = jve.detailed_accum_megaloop(
        jlimbs.get_plan(base), batch, n_iters, jnp.asarray(acc0),
        _jstart(base, start), np.int32(valid))
    hist_t, nm_t = ce.detailed_accum_megaloop(
        plan, batch, n_iters, torch.from_numpy(acc0.copy()),
        _start(plan, start), valid)
    assert hist_t.tolist() == np.asarray(hist_j).tolist()  # bin 0 included
    assert int(nm_t) == int(np.asarray(nm_j))


@pytest.mark.parametrize("n_iters", [1, 3])
def test_k1_plain_b510_matches_reference_oracle(n_iters):
    # The JAX megaloop at b510 (29/58/87 limbs) takes many minutes to compile
    # on the CPU (tests/test_megaloop.py keeps it out of tier 1), so b510 is
    # held against the reference's scalar oracle lane by lane instead: the
    # histogram of valid lanes, plus the padding lanes in bin 0.
    base = 510
    plan = _plan(base)
    rng = np.random.default_rng(510 + n_iters)
    batch = 64
    valid = batch * n_iters - int(rng.integers(1, batch))
    start = plan.range_start + int(rng.integers(0, 1 << 40))
    acc0 = rng.integers(0, 1000, base + 2, dtype=np.int32)
    hist_t, nm_t = ce.detailed_accum_megaloop(
        plan, batch, n_iters, torch.from_numpy(acc0.copy()),
        _start(plan, start), valid)
    want = acc0.astype(np.int64)
    nm = 0
    for i in range(valid):
        u = jscalar.get_num_unique_digits(start + i, base)
        want[u] += 1
        nm += u > plan.near_miss_cutoff
    want[0] += batch * n_iters - valid
    assert hist_t.tolist() == want.tolist()
    assert int(nm_t) == nm


def test_k2_plain_matches_pallas_interpret_b10():
    base, batch, start, valid = 10, 128, 47, 53
    plan = _plan(base)
    u_j = np.asarray(pe.uniques_batch(jlimbs.get_plan(base), batch,
                                      _jstart(base, start), block_rows=8))
    u_t = ce.uniques_batch(plan, batch, _start(plan, start))
    # Lanes past the base's range (n >= 100) lie outside both kernels'
    # fixed-width digit contract; the valid prefix is the contract.
    assert u_t[:valid].tolist() == u_j[:valid].tolist()
    cnt_j, idx_j, uq_j = pe.survivors_batch(
        jlimbs.get_plan(base), batch, plan.near_miss_cutoff, 16,
        _jstart(base, start), np.int32(valid), block_rows=8)
    cnt_t, idx_t, uq_t = ce.survivors_batch(
        plan, batch, plan.near_miss_cutoff, 16, _start(plan, start), valid)
    assert int(cnt_t) == int(np.asarray(cnt_j)) == 1
    assert idx_t.tolist() == np.asarray(idx_j).tolist()
    assert uq_t.tolist() == np.asarray(uq_j).tolist()
    assert start + int(idx_t[0]) == 69


@pytest.mark.parametrize("cap", [512, 4], ids=["fits", "overflow"])
@pytest.mark.parametrize("base", [40, 80])
def test_survivors_match_jax(base, cap):
    # A threshold below the batch's 20th-highest num_uniques makes survivors
    # plentiful, so the scatter is exercised densely; cap 4 overflows and
    # must keep the ordered prefix.
    plan = _plan(base)
    rng = np.random.default_rng(base + cap)
    batch, valid = 512, 500 - int(rng.integers(0, 50))
    start = plan.range_start + int(rng.integers(0, 1 << 30))
    u = jscalar.get_num_unique_digits
    thresh = sorted(u(start + i, base) for i in range(valid))[-20] - 1
    cnt_j, idx_j, uq_j = jve.survivors_batch(
        jlimbs.get_plan(base), batch, thresh, cap, _jstart(base, start),
        np.int32(valid))
    cnt_t, idx_t, uq_t = ce.survivors_batch(
        plan, batch, thresh, cap, _start(plan, start), valid)
    count = int(cnt_t)
    assert count == int(np.asarray(cnt_j))
    assert count > 4, "threshold too high: the test would be vacuous"
    assert idx_t.tolist() == np.asarray(idx_j).tolist()
    assert uq_t.tolist() == np.asarray(uq_j).tolist()
    kept = idx_t[: min(count, cap)].tolist()
    assert kept == sorted(kept)  # ascending lane order
    assert all(i < valid for i in kept)


def test_wrapper_rejects_mismatched_inputs():
    plan = _plan(40)
    st = _start(plan, plan.range_start)
    with pytest.raises(ValueError):
        ce.detailed_accum_megaloop(plan, 128, 1,
                                   torch.zeros(plan.base + 2, dtype=torch.int32),
                                   st, 129)
    with pytest.raises(ValueError):
        ce.uniques_batch(plan, 128, st[:1])
    with pytest.raises(ValueError):
        ce.uniques_batch(plan, 128, st.to(torch.int32))
