"""scripts/generic_bound.py, the least multiplies one lane of K1, K2 or K5
needs at a plan (b510's bound): its products and digit-peel steps against
the lane's loops walked here on real values, and its counts at b40 and b80
against what the H100's constant-plan lanes of csrc/op_count.cu compile to.
"""

import json
import random

import pytest

from nice_tpu_torch.ops.limbs import (digit_chunk, get_plan, log2_fx,
                                      quotient_limbs)
from nice_tpu_torch.scripts import generic_bound as gb


def _mul_products(la, lb, lo):
    """Lane::mul's loops: row i, columns j = 0..lb, stop at lo."""
    count = 0
    for i in range(la):
        for j in range(lb + 1):
            if i + j >= lo:
                break
            if j < lb:
                count += 1
    return count


@pytest.mark.parametrize("la,lb,lo", [(2, 2, 3), (3, 2, 4), (4, 4, 7),
                                      (7, 4, 10), (29, 29, 58), (58, 29, 87),
                                      (5, 3, 4)])
def test_products_follow_lane_mul(la, lb, lo):
    assert gb.products(la, lb, lo) == _mul_products(la, lb, lo)


def _peel(value, nl, ndig, base):
    """Lane::digits on a value of nl u32 limbs: the digits it yields (least
    significant first) and its limb and digit steps."""
    e, div = digit_chunk(base)
    lfx = log2_fx(base)
    limbs = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(nl)]
    out, limb_steps, digit_steps = [], 0, 0
    rem = ndig
    while rem > e:
        rem -= e
        r = 0
        for i in reversed(range(nl)):
            cur = (r << 32) | limbs[i]
            limbs[i], r = divmod(cur, div)
            limb_steps += 1
        assert all(x == 0 for x in limbs[quotient_limbs(rem, lfx):])
        nl = min(nl, quotient_limbs(rem, lfx))
        for _ in range(e - 1):
            r, d = divmod(r, base)
            out.append(d)
            digit_steps += 1
        out.append(r)
    r = limbs[0]
    for _ in range(rem - 1):
        r, d = divmod(r, base)
        out.append(d)
        digit_steps += 1
    out.append(r)
    return out, limb_steps, digit_steps


def _digits(x, base):
    out = []
    while x:
        x, d = divmod(x, base)
        out.append(d)
    return out


@pytest.mark.parametrize("base", [40, 80, 97, 510])
def test_peel_walks_the_lane_on_values_in_range(base):
    """The steps peel() counts are those the lane's digit peel takes on
    n^2 and n^3 of numbers inside the base's range, and that walk yields
    their base-b digits."""
    plan = get_plan(base)
    rng = random.Random(base)
    for n in (plan.range_start, plan.range_end - 1,
              rng.randrange(plan.range_start, plan.range_end)):
        for value, nl, ndig in ((n * n, plan.limbs_sq, plan.d_sq),
                                (n ** 3, plan.limbs_cu, plan.d_cu)):
            got, limb_steps, digit_steps = _peel(value, nl, ndig, base)
            assert got == _digits(value, base)
            assert gb.peel(plan, nl, ndig) == (limb_steps, digit_steps)


def test_counts_at_b40_and_b80_match_the_constant_plan_lanes():
    """The H100's op_count.cu lanes (chip_smoke.py's timing phase) issue one
    IMAD.WIDE.U32.X a limb step and one IMAD.HI.U32 a digit division: 19
    and 31 at b40 (K1, K2, K5), 97 and 60 at b80 (K2), with 270 and 1182
    multiply-add instructions in all and 8 IMMAs in K5's b40 lane (two
    m16n8k16 halves a tile of two limbs: 2 + 2 tiles of n^2's 3 limbs and
    n^3's 4)."""
    b40, b80 = get_plan(40), get_plan(80)
    for kernel in gb.KERNELS:
        steps = gb.lane_ops(b40, kernel)["steps"]
        assert (steps["limb_steps"], steps["digit_steps"]) == (19, 31)
    k1 = gb.lane_ops(b40, "detailed_megaloop_kernel")
    assert k1["steps"]["products"] == 4 + 6
    assert k1["classes"] == {"multiply-add": 10 + 5 * 19 + 2 * 31}
    assert k1["classes"]["multiply-add"] <= 270
    k2 = gb.lane_ops(b80, "uniques_kernel")
    assert (k2["steps"]["limb_steps"], k2["steps"]["digit_steps"]) == (97, 60)
    assert k2["classes"]["multiply-add"] <= 1182
    k5 = gb.lane_ops(b40, "detailed_megaloop_mma_kernel")
    assert k5["steps"]["mma"] == k5["classes"]["tensor"] == 8
    assert k5["classes"]["multiply-add"] == 3 + 5 * 19 + 2 * 31
    assert k5["instructions"] == sum(k5["classes"].values())


def test_b510_counts_follow_its_shapes():
    plan = get_plan(510)
    assert (plan.limbs_n, plan.limbs_sq, plan.limbs_cu) == (29, 58, 87)
    k2 = gb.lane_ops(plan, "uniques_kernel")
    assert k2 == gb.lane_ops(plan, "detailed_megaloop_kernel")
    assert k2["steps"]["products"] == 29 * 29 + sum(min(29, 87 - i)
                                                    for i in range(58))
    limb, digit = k2["steps"]["limb_steps"], k2["steps"]["digit_steps"]
    assert k2["classes"]["multiply-add"] == (k2["steps"]["products"]
                                             + 5 * limb + 2 * digit)
    # Every digit but the leading one of each value is divided off.
    assert digit == plan.d_sq + plan.d_cu - 2 - (
        (plan.d_sq - 1) // 3 + (plan.d_cu - 1) // 3)
    k5 = gb.lane_ops(plan, "detailed_megaloop_mma_kernel")
    assert k5["steps"]["mma"] == 2 * (29 + 44)
    assert k5["classes"] == {"tensor": 146,
                             "multiply-add": 3 + 5 * limb + 2 * digit}


def test_lane_ops_refuses_another_kernel():
    with pytest.raises(ValueError, match="no count"):
        gb.lane_ops(get_plan(40), "strided_niceonly_kernel")


def test_main_prints_one_line_a_kernel(capsys):
    assert gb.main(["--base", "80"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["kernel"] for x in lines] == list(gb.KERNELS)
    assert all(x["base"] == 80 and x["instructions"] > 0 for x in lines)
