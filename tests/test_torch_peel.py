"""The digit peel of the port's CUDA kernels (nice_tpu_torch/csrc/
nice_kernels.cuh), modelled in Python from the plan words the wrappers send
(ops/cuda_engine.py plan_words) and held against exact integer division
and the kernels' plain PyTorch versions. No card is needed: the model
follows the header's u32 arithmetic step by step (every intermediate
reduced mod 2^32 where the kernel keeps it in 32 bits).
"""

import os
import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import BasePlan, get_plan, quotient_limbs

HEADER = os.path.join(os.path.dirname(ce.__file__), os.pardir, "csrc",
                      "nice_kernels.cuh")
M32 = (1 << 32) - 1
BASES = range(2, 2048)


def plan_word_names() -> list:
    """The PlanWord enum of nice_kernels.cuh, in order (PW_COUNT left out)."""
    with open(HEADER) as f:
        src = f.read()
    body = re.search(r"enum PlanWord \{(.*?)\};", src, re.S).group(1)
    names = [re.sub(r"\s*=.*", "", n).strip() for n in body.split(",")]
    names = [n for n in names if n]
    assert names[-1] == "PW_COUNT"
    return names[:-1]


NAMES = plan_word_names()
W = {name: i for i, name in enumerate(NAMES)}


def step_plan(base: int) -> list:
    """The plan words' digit-step entries for any base (the words of a
    real plan come from plan_words; these three depend on the base alone)."""
    words = [0] * len(NAMES)
    words[W["PW_BASE"]] = base
    m, mf, s = ce.digit_magics(base)
    words[W["PW_DIGIT_MAGIC"]] = m
    words[W["PW_DIGIT_MAGIC_FULL"]] = mf
    words[W["PW_DIGIT_SHIFT"]] = s
    return words


def umulhi(a: int, b: int) -> int:
    return (a * b) >> 32


def div_base(x: int, w) -> int:
    """nice_kernels.cuh div_base: __umulhi(x, digit_magic) >> digit_shift."""
    assert 0 <= x <= M32
    return umulhi(x, w[W["PW_DIGIT_MAGIC"]]) >> w[W["PW_DIGIT_SHIFT"]]


def div_base_full(x: int, w) -> int:
    """nice_kernels.cuh div_base_full: the round-up magic's add-and-shift
    fix-up, every sum in 32 bits."""
    assert 0 <= x <= M32
    t = umulhi(x, w[W["PW_DIGIT_MAGIC_FULL"]])
    return ((t + (((x - t) & M32) >> 1)) & M32) >> w[W["PW_DIGIT_SHIFT"]]


def edge_values(d: int) -> list:
    vals = {0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31, 2**32 - 1}
    for top in (2**31, 2**32):
        k = top // d
        vals |= {k * d - 1, k * d, k * d + 1, (k - 1) * d, (k - 1) * d - 1}
    return sorted(v for v in vals if 0 <= v <= M32)


def test_plan_words_follow_the_header_enum():
    plan = get_plan(40)
    words = list(ce.plan_words(plan))
    assert len(words) == len(NAMES)
    m, mf, s = ce.digit_magics(40)
    e = words[W["PW_CHUNK_E"]]
    want = {"PW_BASE": 40, "PW_LIMBS_N": plan.limbs_n,
            "PW_LIMBS_SQ": plan.limbs_sq, "PW_LIMBS_CU": plan.limbs_cu,
            "PW_D_SQ": plan.d_sq, "PW_D_CU": plan.d_cu,
            "PW_N_MASKS": plan.n_masks, "PW_CUTOFF": plan.near_miss_cutoff,
            "PW_CHUNK_E": 5, "PW_CHUNK_DIV": 40**e,
            "PW_CHUNK_MAGIC": M32 * (2**32 + 1) // 40**e,
            "PW_RES_MAGIC": M32 * (2**32 + 1) // 39,
            "PW_DIGIT_MAGIC": m, "PW_DIGIT_MAGIC_FULL": mf,
            "PW_DIGIT_SHIFT": s}
    assert set(want) | {"PW_LOG2_FX"} == set(NAMES)
    for name, value in want.items():
        assert words[W[name]] == value, name


@pytest.mark.parametrize("lo", range(2, 2048, 256))
def test_digit_step_equals_divmod_at_the_edges(lo):
    """Every base from 2 to 2047: the full-range step is exact on all of
    [0, 2^32), the short step below 2^31 (its domain: chunk remainders and
    quotients of a first digit)."""
    for d in range(lo, min(lo + 256, 2048)):
        w = step_plan(d)
        for x in edge_values(d):
            assert div_base_full(x, w) == x // d, (d, x)
            r = (x - div_base_full(x, w) * d) & M32
            assert r == x % d, (d, x)
            if x < 2**31:
                assert div_base(x, w) == x // d, (d, x)


@settings(max_examples=300, deadline=None)
@given(st.integers(2, 2047), st.integers(0, M32))
def test_digit_step_equals_divmod_on_drawn_values(d, x):
    w = step_plan(d)
    assert div_base_full(x, w) == x // d
    if x < 2**31:
        assert div_base(x, w) == x // d


def test_short_step_is_not_exact_past_2_31():
    # Why the last stage's first digit takes div_base_full: for some bases
    # the short magic is wrong on a value at or above 2^31, which a lane
    # outside the base's range can hand it.
    wrong = [d for d in BASES
             if any(div_base(x, step_plan(d)) != x // d
                    for x in edge_values(d) if x >= 2**31)]
    assert wrong


def divmod_magic(x: int, c: int, m: int):
    """nice_kernels.cuh divmod_magic: (x / c, x % c) for x < c * 2^32."""
    q = (x * m) >> 64
    rr = x - q * c
    if rr >= c:
        q, rr = q + 1, rr - c
    return q, rr


def peel_model(plan: BasePlan, limbs: list, ndig: int, masks: list) -> None:
    """Lane::digits of nice_kernels.cuh, its presence bits in u64 words."""
    w = list(ce.plan_words(plan))
    base, e = plan.base, w[W["PW_CHUNK_E"]]
    v, nl, rem = list(limbs), len(limbs), ndig

    def set_digit(d):
        assert d < base
        masks[d >> 6] |= 1 << (d & 63)

    while rem > e:
        rem -= e
        r = 0
        for i in range(nl - 1, -1, -1):
            v[i], r = divmod_magic((r << 32) | v[i], w[W["PW_CHUNK_DIV"]],
                                   w[W["PW_CHUNK_MAGIC"]])
        nl = min(nl, quotient_limbs(rem, w[W["PW_LOG2_FX"]]))
        for _ in range(1, e):
            q = div_base(r, w)
            set_digit(r - q * base)
            r = q
        set_digit(r)
    r = v[0]
    if rem > 1:
        q = div_base_full(r, w)
        set_digit(r - q * base)
        r = q
    for _ in range(2, rem):
        q = div_base(r, w)
        set_digit(r - q * base)
        r = q
    if r < 32 * plan.n_masks:  # the leading digit; past the words, dropped
        masks[r >> 6] |= 1 << (r & 63)


@pytest.mark.parametrize("base", [10, 17, 40, 98, 100, 510])
def test_peel_model_equals_plain_uniques(base):
    """The model's num_uniques equals the plain version's on lanes from
    range_start and across a 2^32 carry (past the range's end at b10 and
    b17, where the leading digit can be any u32)."""
    plan = get_plan(base)
    lanes = 48
    carry = ((plan.range_start >> 32) + 1) << 32
    for start in (plan.range_start,
                  (carry - lanes // 2) % (1 << (32 * plan.limbs_n))):
        st_t = ve.start_limbs_tensor(start, plan, "cpu")
        want = ve.uniques_batch(plan, lanes, st_t).tolist()
        got = []
        for g in range(lanes):
            n = (start + g) % (1 << (32 * plan.limbs_n))
            sq = n * n % (1 << (32 * plan.limbs_sq))
            cu = sq * n % (1 << (32 * plan.limbs_cu))
            masks = [0] * ((plan.n_masks + 1) // 2)
            for value, limbs, ndig in ((sq, plan.limbs_sq, plan.d_sq),
                                       (cu, plan.limbs_cu, plan.d_cu)):
                peel_model(plan, [(value >> (32 * i)) & M32
                                  for i in range(limbs)], ndig, masks)
            got.append(sum(bin(x).count("1") for x in masks))
        assert got == want, (base, start)


def test_kernel_ab_packs_each_tree_s_plan_words():
    """scripts/kernel_ab.py packs a plan in the order of the PlanWord enum
    of the tree it builds: this tree's gives plan_words, and an older
    layout (without the digit magics) its own words."""
    from nice_tpu_torch.scripts import kernel_ab

    csrc = os.path.dirname(HEADER)
    for base in (40, 98):
        plan = get_plan(base)
        assert list(kernel_ab.plan_words(kernel_ab.plan_word_names(csrc),
                                         plan)) == list(ce.plan_words(plan))
    old = NAMES[:W["PW_LOG2_FX"]] + ["PW_BASE_MAGIC", "PW_LOG2_FX",
                                    "PW_RES_MAGIC"]
    words = list(kernel_ab.plan_words(old, get_plan(40)))
    assert words[len(old) - 3] == M32 * (2**32 + 1) // 40
    assert words[:W["PW_LOG2_FX"]] == list(ce.plan_words(get_plan(40)))[:W["PW_LOG2_FX"]]


def test_kernel_ab_k5_split_edits_this_tree_or_raises(tmp_path):
    """Every --k5-split variant of scripts/kernel_ab.py that has a part in
    this tree's K5 layout finds each text it edits exactly once, and
    changes the copy; a tree that holds a text twice, or lacks it, makes
    split_tree raise, not drop the variant."""
    import shutil

    from nice_tpu_torch.scripts import kernel_ab

    csrc = os.path.dirname(HEADER)
    layout = kernel_ab.k5_layout(csrc)
    assert layout == "register"
    for variant, by_layout in kernel_ab.K5_SPLIT.items():
        assert layout in by_layout, variant
        copy = kernel_ab.split_tree(csrc, variant, str(tmp_path))
        for name, old, new in by_layout[layout]:
            with open(os.path.join(copy, name)) as f:
                text = f.read()
            assert new in text and old not in text.replace(new, ""), variant
    twice = tmp_path / "twice"
    shutil.copytree(csrc, twice)
    with open(twice / "nice_kernels.cuh", "a") as f:
        f.write("\n    k5_fill(sh, nt_sq, nt, false);\n")
    with pytest.raises(ValueError, match="2 times"):
        kernel_ab.split_tree(str(twice), "fill_skipped", str(tmp_path / "o"))
    lacking = tmp_path / "lacking"
    shutil.copytree(csrc, lacking)
    text = (lacking / "nice_kernels.cuh").read_text()
    (lacking / "nice_kernels.cuh").write_text(
        text.replace("k5_warp_mul(sh.s_sq, lsq", "k5_warp_mul(sh.s_sq,  lsq"))
    with pytest.raises(ValueError, match="0 times"):
        kernel_ab.split_tree(str(lacking), "constants_skipped",
                             str(tmp_path / "p"))
