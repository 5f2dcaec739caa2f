"""The plan tier of the port (K1, K2, K3 and K5's detailed mode built once per
base with the plan as constants: nice_tpu_torch/csrc/plan_kernels.cu,
nice_kernels.cuh PlanTier),
checked without a card: K3's division by the residue count (a multiply-high
by a host-computed magic, modelled here in the header's u32 arithmetic),
which plans take the tier, the per-base build's key and generated header,
the wrappers' routing, and the plain K3 against the JAX package's strided
Pallas kernel (interpret mode, at small sizes) and against Python integers
at b97, the tier's widest base.
"""

import contextlib
import os
import re
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nice_tpu.ops import pallas_engine as pe
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import stride_filter as jstride
from nice_tpu.ops.limbs import get_plan as jget_plan
from nice_tpu_torch.core import base_range
from nice_tpu_torch.ops import cuda_build
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import stride_filter
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

M32 = (1 << 32) - 1
HEADER = os.path.join(cuda_build.CSRC_DIR, "nice_kernels.cuh")
STRIDE_BASES = (10, 17, 40, 50, 80, 97)
# The residue counts of the stride tables at depths 1-3 (counted, not
# built: b97's depth-3 table would hold 8.2M residues).
RESIDUE_COUNTS = sorted({
    stride_filter.stride_residue_count(b, k)
    for b in STRIDE_BASES for k in (1, 2, 3)
    if (b - 1) * b**k < 1 << 32 and stride_filter.stride_residue_count(b, k)
})


def div_u32(x: int, d: int) -> int:
    """nice_kernels.cuh div_u32 with ce.u32_divisor's magic: __umulhi,
    then the add-and-shift fix-up, every sum in 32 bits."""
    magic, s1, s2 = ce.u32_divisor(d)
    assert 0 <= magic <= M32 and 0 <= s1 <= 1 and 0 <= s2 <= 31
    t = (x * magic) >> 32
    return ((t + (((x - t) & M32) >> s1)) & M32) >> s2


def edge_values(d: int) -> list:
    vals = {0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31, 2**31 + 1, M32 - 1, M32}
    for top in (2**20, 2**31, 2**32):
        k = top // d
        vals |= {k * d - 1, k * d, k * d + 1, (k - 1) * d, (k - 1) * d - 1}
    return sorted(v for v in vals if 0 <= v <= M32)


@pytest.mark.parametrize("d", RESIDUE_COUNTS)
def test_residue_magic_equals_floor_division_at_the_edges(d):
    for x in edge_values(d):
        assert div_u32(x, d) == x // d, (x, d)


@settings(max_examples=300, deadline=None)
@given(st.sampled_from(RESIDUE_COUNTS), st.integers(0, M32))
def test_residue_magic_equals_floor_division_on_drawn_values(d, x):
    assert div_u32(x, d) == x // d


@settings(max_examples=200, deadline=None)
@given(st.integers(1, M32), st.integers(0, M32))
def test_u32_divisor_is_exact_for_any_divisor(d, x):
    assert div_u32(x, d) == x // d


def test_u32_divisor_small_and_out_of_range_divisors():
    for d in (1, 2, 3, 4, 7, 8, 1 << 20, (1 << 31) + 1, M32):
        for x in edge_values(d):
            assert div_u32(x, d) == x // d, (x, d)
    for d in (0, 1 << 32):
        with pytest.raises(ValueError):
            ce.u32_divisor(d)


def _header_constant(name: str) -> int:
    with open(HEADER) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def test_plan_tier_takes_exactly_the_plans_of_at_most_four_limbs():
    assert ce.PLAN_TIER_LIMBS == _header_constant("kPlanTierLimbs") == 4
    taken = []
    for base in range(2, 2047):
        if base_range.get_base_range(base) is None:
            continue
        plan = get_plan(base)
        assert ce.plan_tier_takes(plan) == (plan.limbs_n <= 4), base
        if ce.plan_tier_takes(plan):
            taken.append(base)
    # Every base up to b97 and none above: K3's domain (strided_setup's
    # limbs_n <= 4).
    assert taken == [b for b in range(2, 98)
                     if base_range.get_base_range(b) is not None]
    assert get_plan(98).limbs_n == 5


def _parse_header(text: str) -> dict:
    out = {}
    for name, value in re.findall(r"^#define (\w+) (.*)$", text, re.M):
        out[name] = [int(v.strip().rstrip("ul")) for v in value.split(",")]
    return out


@pytest.mark.parametrize("lo", range(10, 98, 11))
def test_plan_header_round_trips_the_plan_words(lo):
    for base in range(lo, min(lo + 11, 98)):
        if base_range.get_base_range(base) is None:
            continue
        plan = get_plan(base)
        defs = _parse_header(ce.plan_header(plan))
        assert defs["NICE_PLAN"] == list(ce.plan_words(plan)), base
        assert defs["NICE_PLAN_TIER"] == [plan.limbs_n, plan.limbs_sq,
                                          plan.limbs_cu, plan.n_masks]


def test_plan_header_carries_extra_defines():
    text = ce.plan_header(get_plan(40), NICE_K3_R="136u", NICE_K3_M="1560u")
    defs = _parse_header(text)
    assert defs["NICE_K3_R"] == [136] and defs["NICE_K3_M"] == [1560]
    assert text.index("NICE_PLAN ") < text.index("NICE_K3_R")


def test_plan_build_key_follows_plan_words_sources_and_flags(tmp_path,
                                                             monkeypatch):
    h40, h80 = ce.plan_header(get_plan(40)), ce.plan_header(get_plan(80))
    key = cuda_build.plan_build_key("nvcc", h40)
    assert key == cuda_build.plan_build_key("nvcc", h40)
    assert key != cuda_build.plan_build_key("nvcc", h80)
    assert key != cuda_build.plan_build_key("other/nvcc", h40)
    with monkeypatch.context() as mp:
        mp.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-DX",))
        assert key != cuda_build.plan_build_key("nvcc", h40)
    # The main library's key does not follow the per-base source.
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    original = cuda_build.CSRC_DIR
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    assert key == cuda_build.plan_build_key("nvcc", h40)
    with open(csrc / "plan_kernels.cu", "a") as f:
        f.write("\n// edited\n")
    assert key != cuda_build.plan_build_key("nvcc", h40)
    shutil.copy(os.path.join(original, "plan_kernels.cu"), csrc)
    with open(csrc / "nice_kernels.cuh", "a") as f:
        f.write("\n// edited\n")
    assert key != cuda_build.plan_build_key("nvcc", h40)


def test_build_plan_writes_the_header_only_for_a_build(tmp_path, monkeypatch):
    """The generated header lands (whole, through a temporary name) in the
    key's directory when its library is built there; a build found on
    disk leaves the directory as it is, and nvcc sees the header."""
    builds = []

    def fake_nvcc_library(lib_path, sources, csrc=None, include=()):
        (key_dir,) = include
        with open(os.path.join(key_dir, cuda_build.PLAN_HEADER)) as f:
            builds.append(f.read())
        with open(lib_path, "w") as f:
            f.write("lib")
        return {"path": lib_path, "seconds": 1.0, "ptxas": "report"}

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "nvcc_library", fake_nvcc_library)
    header = ce.plan_header(get_plan(40))
    first = cuda_build.build_plan(header)
    key_dir = os.path.dirname(first["path"])
    assert os.path.basename(key_dir) == "plan-" + cuda_build.plan_build_key(
        "nvcc", header)
    assert builds == [header] and first["seconds"] == 1.0
    assert sorted(os.listdir(key_dir)) == [cuda_build.LIB_NAME,
                                           cuda_build.PLAN_HEADER]
    header_path = os.path.join(key_dir, cuda_build.PLAN_HEADER)
    os.remove(header_path)
    again = cuda_build.build_plan(header)
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    assert builds == [header] and not os.path.exists(header_path)


class _FakeLib:
    """Stands for a loaded library: records the C functions called and
    their argument counts; a shape query fills its out array."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((self.name, fn, len(args)))
            if fn.endswith("_launch_shape"):
                out = args[-1]
                for i, v in enumerate(
                        (1, 256, 8, 132, 3 if self.name == "plan" else 1)):
                    out[i] = v
            return 0
        return call


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that a wrapper goes past
    its plain version to its library's launch (faked here)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


# The C entries of K1 and K5's detailed mode (names built so that no string
# here reads as a series name to the reference's nicelint M1).
K1_MAIN, K1_PLAN, K5_PLAN = ("nice" + "_" + n for n in (
    "detailed_megaloop", "plan_detailed_megaloop",
    "plan_detailed_megaloop_mma"))


def _k1_launch(plan, use_mxu=0):
    """One detailed_accum_megaloop call on _OnCard tensors: 64 x 2 lanes,
    100 of them real."""
    ce.detailed_accum_megaloop(
        plan, 64, 2, _on_card(torch.zeros(plan.base + 2, dtype=torch.int32)),
        _on_card(torch.zeros(plan.limbs_n, dtype=torch.int64)), 100,
        use_mxu=use_mxu, nm_out=_on_card(torch.zeros((), dtype=torch.int32)))


def test_wrappers_route_by_plan_size(monkeypatch):
    """launch_shape asks the per-base library for K1, K2 and K3 at b10-b97
    and the main library for K1 and K2 above, and a per-base build is asked
    of load_plan with the base's own header. detailed_accum_megaloop
    launches K1 from the per-base library at b10-b97 (and K5 with use_mxu=1
    from its per-base entry), from the main library above, and counts
    LAUNCHES["detailed_megaloop_plan"] for the per-base K1 alone."""
    calls, headers = [], []

    def load_plan(header):
        headers.append(header)
        return _FakeLib("plan", calls)

    monkeypatch.setattr(cuda_build, "load_plan", load_plan)
    monkeypatch.setattr(cuda_build, "load", lambda: _FakeLib("main", calls))
    # plan_library keeps one library a plan for the process: none of the
    # fakes may outlive this test.
    ce.plan_library.cache_clear()
    try:
        for base in (10, 40, 80, 97):
            plan = get_plan(base)
            assert ce.launch_shape("uniques", plan, 1 << 18)["tier"] == "plan"
            assert ce.launch_shape("strided_niceonly", plan, 4352,
                                   1024)["tier"] == "plan"
            assert ce.launch_shape("detailed_megaloop", plan,
                                   1 << 21)["tier"] == "plan"
            # One load a base: the later calls found the first's library.
            assert headers[-1] == ce.plan_header(plan)
            assert headers.count(headers[-1]) == 1
    finally:
        ce.plan_library.cache_clear()
    assert all(lib == "plan" for lib, *_ in calls)
    calls.clear()
    for base in (98, 510):
        plan = get_plan(base)
        assert ce.launch_shape("uniques", plan, 1 << 18)["tier"] == "generic"
        assert ce.launch_shape("detailed_megaloop", plan,
                               1 << 21)["tier"] == "generic"
    assert [lib for lib, *_ in calls] == ["main"] * 4
    assert all(fn.endswith("_launch_shape") and "plan" not in fn
               for _, fn, _ in calls)

    # The launches, on tensors that say they are on the card.
    monkeypatch.setattr(ce, "_on_device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(ce, "_stream", lambda device: 0)
    monkeypatch.setattr(ce, "LAUNCHES", dict.fromkeys(ce.LAUNCHES, 0))
    monkeypatch.setattr(ce, "DISPATCH_SECONDS",
                        {k: [] for k in ce.DISPATCH_SECONDS})
    calls.clear()
    try:
        for base in (10, 40, 55, 80, 97):
            _k1_launch(get_plan(base))
        _k1_launch(get_plan(40), use_mxu=1)
        assert calls == [("plan", K1_PLAN, 8)] * 5 + [("plan", K5_PLAN, 9)]
        assert ce.LAUNCHES["detailed_megaloop"] == 5
        assert ce.LAUNCHES["detailed_megaloop_plan"] == 5
        assert ce.LAUNCHES["detailed_megaloop_mma"] == 1
        calls.clear()
        for base in (98, 510):
            _k1_launch(get_plan(base))
        _k1_launch(get_plan(510), use_mxu=1)
        assert calls == [("main", K1_MAIN, 9)] * 3
        assert ce.LAUNCHES["detailed_megaloop"] == 7
        assert ce.LAUNCHES["detailed_megaloop_plan"] == 5
        assert ce.LAUNCHES["detailed_megaloop_mma"] == 2
    finally:
        ce.plan_library.cache_clear()


def test_strided_wrapper_takes_no_plan_above_the_tier():
    table = stride_filter.get_stride_table(40, 1)
    res = torch.from_numpy(table.residues_u32.astype(np.int64))
    desc = torch.zeros((4, 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="descriptors carry 4"):
        ce.strided_niceonly_batch(get_plan(98), table.modulus, res, 4, desc, 1)


# --------------------------------------------------------------------------
# The plain K3 at b97 (the plan tier's widest base, 4/9/12 limbs)
# --------------------------------------------------------------------------

PERIODS = 2


def _b97_case():
    """Descriptor rows at b97, depth 1, mid-range (near the range's start
    the squares lead with zeros and num_uniques sits lower): a ragged run
    and runs across 2^32, 2^64 and 2^96; two padding rows of junk."""
    plan = get_plan(97)
    m = stride_filter.get_stride_table(97, 1).modulus
    span = PERIODS * m
    rng = np.random.default_rng(97)
    mid = (plan.range_start + plan.range_end) // 2
    lo = mid + int(rng.integers(1, m))
    rows = [(n0, lo, lo + span + 17)
            for n0 in range((lo // m) * m, lo + span + 17, span)]
    for width in (32, 64, 96):
        b = ((mid >> width) + 1) << width
        n0 = ((b - span // 2) // m) * m
        rows.append((n0, n0 + int(rng.integers(0, m)), n0 + span))
    desc = np.zeros((len(rows) + 2, 12), dtype=np.uint32)
    for i, (n0, lo_, hi) in enumerate(rows):
        desc[i, 0:4] = int_to_limbs(n0, 4)
        desc[i, 4:8] = int_to_limbs(lo_, 4)
        desc[i, 8:12] = int_to_limbs(hi, 4)
    desc[len(rows):] = rng.integers(0, 1 << 32, size=(2, 12), dtype=np.uint32)
    return rows, desc


def _plain_b97(desc, n_real, min_uniques=None):
    table = stride_filter.get_stride_table(97, 1)
    res = torch.from_numpy(table.residues_u32.astype(np.int64))
    return ce.strided_niceonly_batch(
        get_plan(97), table.modulus, res, PERIODS,
        torch.from_numpy(desc.astype(np.int64)), n_real, min_uniques)


@pytest.mark.parametrize("base", [17, 50])
def test_plain_k3_equals_pallas_kernel(base):
    """At small sizes (the JAX kernel runs in interpret mode), at the plan
    tier's bases that test_torch_strided.py leaves out: mid-range rows of
    PERIODS periods, two padding rows. The JAX kernel runs only the nice
    test, and no number at b17 or b50 is nice, so that comparison holds
    the padding rows and the zeros; the counts at a threshold near the
    median of num_uniques, where every real row counts many candidates,
    are held against the JAX package's scalar num_uniques."""
    plan = get_plan(base)
    table = stride_filter.get_stride_table(base, 1)
    m = table.modulus
    rng = np.random.default_rng(base)
    mid = (plan.range_start + plan.range_end) // 2
    rows = [(n0, n0 + int(rng.integers(0, m)), n0 + PERIODS * m)
            for n0 in ((mid // m + i * PERIODS) * m for i in range(3))]
    desc = np.zeros((len(rows) + 2, 12), dtype=np.uint32)
    for i, (n0, lo, hi) in enumerate(rows):
        desc[i, 0:4] = int_to_limbs(n0, 4)
        desc[i, 4:8] = int_to_limbs(lo, 4)
        desc[i, 8:12] = int_to_limbs(hi, 4)
    desc[len(rows):] = rng.integers(0, 1 << 32, size=(2, 12), dtype=np.uint32)
    jt = jstride.get_stride_table(base, 1)
    spec = pe.StrideSpec(jt.modulus, tuple(jt.valid_residues))
    want = np.asarray(pe.niceonly_strided_batch(
        jget_plan(base), spec, desc, periods=PERIODS, n_real=len(rows))
    ).reshape(-1)[: desc.shape[0]]
    res = torch.from_numpy(table.residues_u32.astype(np.int64))
    desc_t = torch.from_numpy(desc.astype(np.int64))
    got = ce.strided_niceonly_batch(plan, m, res, PERIODS, desc_t, len(rows))
    assert got.tolist() == want.tolist()
    assert got[len(rows):].tolist() == [0, 0]
    min_u = (5 * base + 7) // 8
    valid = set(table.valid_residues)
    counts = [sum(1 for c in range(lo, hi) if (c - n0) % m in valid
                  and min_u <= jscalar.get_num_unique_digits(c, base) <= base)
              for n0, lo, hi in rows]
    got_u = ce.strided_niceonly_batch(plan, m, res, PERIODS, desc_t,
                                      len(rows), min_u)
    assert got_u.tolist() == counts + [0, 0]
    assert all(c > 0 for c in counts)


def test_plain_k3_threshold_counts_equal_bigint_at_b97():
    rows, desc = _b97_case()
    min_u = (5 * 97 + 7) // 8
    table = stride_filter.get_stride_table(97, 1)
    m, valid = table.modulus, set(table.valid_residues)
    want = [sum(1 for c in range(max(lo, n0), min(hi, n0 + PERIODS * m))
                if (c - n0) % m in valid
                and min_u <= jscalar.get_num_unique_digits(c, 97) <= 97)
            for n0, lo, hi in rows]
    got = _plain_b97(desc, len(rows), min_u).tolist()
    assert got == want + [0, 0]
    assert all(w > 0 for w in want)  # every row, the carry rows included
