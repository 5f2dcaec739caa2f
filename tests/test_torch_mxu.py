"""K5, the tensor-core arm of the detailed and dense niceonly kernels, on the
CPU: its plain version (nice_tpu_torch/ops/mxu.py, reached through
vector_engine's megaloops with use_mxu=1) held against the JAX package's MXU
arm (nice_tpu/ops/mxu.py through its jnp megaloops, as
tests/test_property_differential.py runs it), against Python ints where the
JAX graph is too wide to compile here (b98, b510), and against the plain
K1/K4 lane for lane. Every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import vector_engine as jve
from nice_tpu.ops.limbs import get_plan as jget_plan
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor, autotune, engine, mxu
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _untuned(tmp_path, monkeypatch):
    """No winners table, a fresh floor controller."""
    monkeypatch.setattr(autotune, "WINNERS_PATH", str(tmp_path / "w.json"))
    autotune.reset_for_tests()
    adaptive_floor.reset_for_tests()
    yield
    autotune.reset_for_tests()
    adaptive_floor.reset_for_tests()


def _median(base: int) -> int:
    """A threshold about the median of num_uniques, where counts are many."""
    return (5 * base + 7) // 8


def _carry_start(plan, lanes: int) -> int:
    """A start whose lanes cross the largest limb carry inside the range."""
    for w in range(32 * (plan.limbs_n - 1), 0, -32):
        b = ((plan.range_start >> w) + 1) << w
        if plan.range_start + lanes < b < plan.range_end - lanes:
            return b - lanes // 2
    return None


def _starts(plan, lanes: int) -> list[int]:
    c = _carry_start(plan, lanes)
    return [plan.range_start] + ([c] if c is not None else [])


def test_accum_bound_and_supported_plans():
    # 12 digit rows of at most 255 x 255: far inside s32 for every plan.
    assert mxu.accum_bound() == 12 * 255 * 255 < 2**31
    for base in (10, 40, 97, 98, 510, 892):
        assert mxu.supports_plan(get_plan(base)), base
    # From b893 on, T and the staging pass a block's 48 KiB.
    assert mxu.smem_bytes(get_plan(892)) <= 48 * 1024
    assert not mxu.supports_plan(get_plan(893))
    assert not mxu.supports_plan(get_plan(1000))
    with pytest.raises(ValueError, match="K5 does not take"):
        ce.detailed_accum_megaloop(
            get_plan(1000), 64, 1, torch.zeros(1002, dtype=torch.int32),
            ve.start_limbs_tensor(get_plan(1000).range_start, get_plan(1000),
                                  CPU), 64, use_mxu=1)


@pytest.mark.parametrize("base", [10, 17, 40, 80])
def test_plain_k5_detailed_equals_jax_mxu_arm(base):
    """ve.detailed_accum_megaloop(use_mxu=1) == JAX's detailed megaloop on
    its MXU arm, bins and near-miss count, from range_start and across a
    limb carry (inside the range: outside it the two digit extractions
    differ by design)."""
    plan, jplan = get_plan(base), jget_plan(base)
    batch, n_iters = 128, 3
    rng = np.random.default_rng(base)
    for start in _starts(plan, batch * n_iters):
        valid = min(batch * n_iters - int(rng.integers(1, batch)),
                    plan.range_end - start)
        acc = rng.integers(0, 1000, base + 2, dtype=np.int32)
        h, nm = ve.detailed_accum_megaloop(
            plan, batch, n_iters, torch.from_numpy(acc.copy()),
            ve.start_limbs_tensor(start, plan, CPU), valid, use_mxu=1)
        jh, jnm = jve.detailed_accum_megaloop(
            jplan, batch, n_iters, acc.copy(),
            int_to_limbs(start, plan.limbs_n), np.int32(valid), use_mxu=True)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        assert int(nm) == int(jnm)
        h0, nm0 = ve.detailed_accum_megaloop(
            plan, batch, n_iters, torch.from_numpy(acc.copy()),
            ve.start_limbs_tensor(start, plan, CPU), valid)
        assert torch.equal(h, h0) and int(nm) == int(nm0)


@pytest.mark.parametrize("base", [10, 40])
@pytest.mark.parametrize("fused", [True, False])
def test_plain_k5_dense_equals_jax_mxu_arm(base, fused):
    """The plain K5's dense count in both TPU modes == JAX's jnp megaloops
    on the MXU arm (niceonly_filtered_megaloop fused, niceonly_dense_megaloop
    unfused), and == the plain K4 at the nice test and at the median."""
    plan, jplan = get_plan(base), jget_plan(base)
    batch, n_iters = 256, 2
    start = 47 if base == 10 else plan.range_start + 12_345
    valid = min(batch * n_iters - 9, plan.range_end - start)
    st = ve.start_limbs_tensor(start, plan, CPU)
    classes = ce.niceonly_classes(plan, fused, "cpu")
    got = ve.niceonly_dense_megaloop(plan, batch, n_iters, classes, st, valid,
                                     use_mxu=1).tolist()
    jstart = int_to_limbs(start, plan.limbs_n)
    if fused:
        jc, jp = jve.niceonly_filtered_megaloop(jplan, batch, n_iters, jstart,
                                                np.int32(valid), use_mxu=True)
        assert got == [int(jc), int(jp)]
    else:
        jc = jve.niceonly_dense_megaloop(jplan, batch, n_iters, jstart,
                                         np.int32(valid), use_mxu=True)
        assert got == [int(jc), 0]
    if base == 10:
        assert got[0] == 1  # 69
    for mu in (base, _median(base)):
        k5 = ve.niceonly_dense_megaloop(plan, batch, n_iters, classes, st,
                                        valid, mu, use_mxu=1)
        k4 = ve.niceonly_dense_megaloop(plan, batch, n_iters, classes, st,
                                        valid, mu)
        assert torch.equal(k5, k4)
    assert int(k5[0]) > 0  # the median threshold counts many lanes


def _carry_edge_candidates(base: int) -> list[int]:
    """Range endpoints, values about 2^32k limb boundaries, all-ones limbs
    and seeded randoms (tests/test_property_differential.py's set)."""
    plan = get_plan(base)
    lo, hi = plan.range_start, plan.range_end
    cands = {lo, hi - 1, (lo + hi) // 2}
    for k in range(1, plan.limbs_n + 1):
        b = 1 << (32 * k)
        for n in (b - 1, b, b + 1, b - 2, (b - 1) // 3):
            if lo <= n < hi:
                cands.add(n)
    ones = 0
    while True:
        ones = (ones << 32) | 0xFFFFFFFF
        if ones >= hi:
            break
        if ones >= lo:
            cands.add(ones)
    rng = random.Random(base)
    cands.update(rng.randrange(lo, hi) for _ in range(6))
    return sorted(cands)


def _limbs_of(xs: list, count: int) -> list[int]:
    return [[(int(x) >> (32 * k)) & 0xFFFFFFFF for k in range(count)]
            for x in xs]


@pytest.mark.parametrize("base", [98, 510])
def test_k5_products_equal_python_ints(base):
    """n^2 and n^3 through K5's GEMM split (n = S + i, i < 2^31) equal
    Python ints limb for limb: every carry-edge candidate, reached from a
    start below it by small offsets and by offsets near 2^31."""
    plan = get_plan(base)
    big = [0, 1, 2**31 - 1, 2**30 + 12_345]
    for c in _carry_edge_candidates(base):
        for start, offs in ((max(plan.range_start, c - 3), list(range(7))),
                            (c - big[2], big)):
            st = ve.start_limbs_tensor(start, plan, CPU)
            offsets = torch.tensor(offs, dtype=torch.int64)
            ns = [start + i for i in offs]
            n_limbs = [torch.tensor(col) for col in
                       zip(*_limbs_of(ns, plan.limbs_n))]
            wrapped = ve.add_u32_carry([st[k] for k in range(plan.limbs_n)],
                                       offsets)[1]
            over = ve.square_overflows(plan, n_limbs)
            if all(plan.range_start <= n < plan.range_end for n in ns):
                # Inside the range no lane leaves the GEMM's domain.
                assert not bool((wrapped | over).any())
            sq, cu = mxu.products_mxu(plan, st, offsets)
            got_sq = [list(r) for r in zip(*[x.tolist() for x in sq])]
            got_cu = [list(r) for r in zip(*[x.tolist() for x in cu])]
            msq = 1 << (32 * plan.limbs_sq)
            assert got_sq == _limbs_of([n * n % msq for n in ns],
                                       plan.limbs_sq), (base, start)
            assert got_cu == _limbs_of([(n * n % msq) * n for n in ns],
                                       plan.limbs_cu), (base, start)


@pytest.mark.parametrize("base", [98, 100, 510])
def test_plain_k5_equals_plain_k1_k4(base):
    """Lane for lane where the JAX graph does not compile here: the plain
    K5 gives K1's histogram and near misses and K4's [count, pruned] in both
    modes at the median threshold, from range_start and across the largest
    limb carry."""
    plan = get_plan(base)
    batch = 48 if base == 510 else 128
    for start in _starts(plan, 2 * batch):
        st = ve.start_limbs_tensor(start, plan, CPU)
        acc = torch.zeros(base + 2, dtype=torch.int32)
        h5, nm5 = ve.detailed_accum_megaloop(plan, batch, 2, acc.clone(), st,
                                             2 * batch - 5, use_mxu=1)
        h1, nm1 = ve.detailed_accum_megaloop(plan, batch, 2, acc.clone(), st,
                                             2 * batch - 5)
        assert torch.equal(h5, h1) and int(nm5) == int(nm1)
        for fused in (True, False):
            classes = ce.niceonly_classes(plan, fused, "cpu")
            k5 = ve.niceonly_dense_megaloop(plan, batch, 2, classes, st,
                                            2 * batch - 5, _median(base),
                                            use_mxu=1)
            k4 = ve.niceonly_dense_megaloop(plan, batch, 2, classes, st,
                                            2 * batch - 5, _median(base))
            assert torch.equal(k5, k4), (base, start, fused)


def test_wrappers_route_use_mxu_to_the_plain_k5():
    """On a CPU tensor the K1/K4 wrappers with use_mxu=1 run the plain K5
    and count no launch; a use_mxu other than 0 or 1 raises."""
    plan = get_plan(40)
    st = ve.start_limbs_tensor(plan.range_start + 99, plan, CPU)
    ce.reset_launches()
    h, nm = ce.detailed_accum_megaloop(plan, 64, 2, torch.zeros(
        42, dtype=torch.int32), st, 100, use_mxu=1)
    assert int(h.sum()) == 128 and sum(ce.LAUNCHES.values()) == 0
    classes = ce.niceonly_classes(plan, True, "cpu")
    assert ce.niceonly_dense_megaloop(plan, 64, 2, classes, st, 100,
                                      use_mxu=1).tolist()[1] > 0
    with pytest.raises(ValueError, match="use_mxu"):
        ce.niceonly_dense_megaloop(plan, 64, 2, classes, st, 100, use_mxu=2)


def test_detailed_field_b40_with_k5_equals_jax_engine(monkeypatch):
    """A whole b40 detailed field through the port's engine with use_mxu=1
    equals the JAX engine's on its MXU arm (NICE_TPU_MXU pins it there, in
    this test only), near misses included."""
    s = get_plan(40).range_start + 3_000_000
    field = (s, s + 6_000)
    got = engine.process_range_detailed(FieldSize(*field), 40, device="cpu",
                                        batch_size=512, segment=2, use_mxu=1)
    monkeypatch.setenv("NICE_TPU_MXU", "1")
    want = jengine.process_range_detailed(JFieldSize(*field), 40,
                                          backend="jnp", batch_size=512)
    assert [(d.num_uniques, d.count) for d in got.distribution] == \
        [(d.num_uniques, d.count) for d in want.distribution]
    assert [(n.number, n.num_uniques) for n in got.nice_numbers] == \
        [(n.number, n.num_uniques) for n in want.nice_numbers]
    assert engine.process_range_detailed(
        FieldSize(*field), 40, device="cpu", batch_size=512, segment=2,
        use_mxu=0) == got


def test_dense_engine_with_k5_equals_k4():
    """The b98 dense loop with use_mxu=1 (K5's plain version in K4's place)
    finds what it finds with K4, over a surviving stretch above 2^128."""
    adaptive_floor.reset_for_tests(pinned=4096)
    start = 413428759798923141071530212209627033363
    field = FieldSize(start, start + 60_000)
    k5 = engine.process_range_niceonly(field, 98, device="cpu",
                                       batch_size=4096, segment=2, use_mxu=1)
    assert engine.LAST_NICEONLY_STATS["use_mxu"] == 1
    assert engine.LAST_NICEONLY_STATS["runs"] > 0
    k4 = engine.process_range_niceonly(field, 98, device="cpu",
                                       batch_size=4096, segment=2, use_mxu=0)
    assert k5 == k4
    with pytest.raises(ValueError, match="strided"):
        engine.process_range_niceonly(FieldSize(47, 100), 10, device="cpu",
                                      use_mxu=1)
