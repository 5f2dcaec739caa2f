"""KernelSpec registry: the contracts of the port's CUDA kernels K1-K5, the
ground truth of cudalint (the port's twin of nice_tpu/analysis/kernelspec.py,
which traces jaxprs and so cannot read a CUDA kernel).

One KernelSpec per C entry point that a wrapper in ``ops/cuda_engine.py``
loads, declaring:

* the kernels it launches and the TPU kernel each replaces (a
  ``"path:line"`` string of the JAX package: the port imports none of it);
* its library (the main one, ``csrc/nice_kernels.cu``, or the per-base one,
  ``csrc/plan_kernels.cu``) and the tier it runs a plan on (``tier``);
* the Python wrappers, the launch counters and the plain versions;
* the outputs' shapes and dtypes as functions of (plan, batch, n_iters),
  which C6 holds the plain versions to;
* the arguments it writes in place (the twin of jaxlint J3's donation);
* its C prototype's parameter types, which C6 holds the ctypes binding and
  the CUDA source to, and each scalar's static domain, which C2 holds to
  its C type;
* the value bounds of what it accumulates, which C2 checks by integer
  arithmetic over the domain (there is no jaxpr to interpret);
* its block size (``block_threads``, the counterpart of the reference's
  ``block_rows``): a whole number of warps from ``WARP`` (K5:
  ``MMA_THREADS_MIN``) to ``THREADS``, the rule ``block_threads_ok`` that
  the CUDA source, ``ops/cuda_engine.py`` and the plain versions also
  state, and C6 holds together. C2's int32 obligations do not depend on
  it: the budgets are per dispatch (a launch's lanes, whatever its blocks),
  and a block's shared bins and warp sums count at most its own lanes, fewer
  than the launch's.

The contract constants are written here a third time, beside their Python
mirrors (``ops/cuda_engine.py``, ``ops/mxu.py``, ``ops/engine.py``) and
their CUDA definitions, and C6 holds all three together (``MIRRORS``). The
reference's names are kept where they mean the same: ``HIST_ACC_BOUND`` is
the flush budget (``ACC_LIMIT // 2`` here, at most 2^30) and
``MAX_HIST_ROWS * 128`` is ``MAX_HIST_BINS``.

The registry imports only the standard library and the port's stdlib-only
``core/base_range.py``: ``plan_shape`` is its own copy of the limb counts
of ``ops/limbs.get_plan`` (which needs numpy), held to it by C6.
"""

from __future__ import annotations

import dataclasses
import functools
import random
from typing import Callable, Dict, Optional, Tuple

from nice_tpu_torch.core import base_range

I32_MAX = (1 << 31) - 1
U32_MAX = (1 << 32) - 1
C_TYPE_RANGE = {
    "int": (-(1 << 31), I32_MAX),
    "unsigned": (0, U32_MAX),
    "uint32_t": (0, U32_MAX),
    "long long": (-(1 << 63), (1 << 63) - 1),
    "int32_t": (-(1 << 31), I32_MAX),
}

# -- contract constants ------------------------------------------------------

# ops/engine.py ACC_LIMIT: the int32 bins' budget. The engine flushes the
# device accumulator before any bin could pass half of it.
ACC_LIMIT = (1 << 31) - 1
# The reference's name for the bound every carried int32 bin stays under
# (nice_tpu/analysis/kernelspec.py HIST_ACC_BOUND); ACC_LIMIT // 2 <= 2^30.
HIST_ACC_BOUND = (0, 1 << 30)
# The reference's histogram-row cap; its 128-bin rows make the port's bins.
MAX_HIST_ROWS = 16
MAX_HIST_BINS = MAX_HIST_ROWS * 128
# The strided pipeline's shapes (ops/cuda_engine.py).
STRIDED_DESC_MAX = 1024
STRIDED_PERIODS_MAX = 1024
STRIDED_OFFS_LANES_MAX = 1 << 20
DESC_WIDTH = 12
# Plans of at most this many limbs of n run K1, K2, K3 and K5's detailed mode
# on the per-base plan tier (nice_kernels.cuh kPlanTierLimbs).
PLAN_TIER_LIMBS = 4
# Threads a block of a grid-stride launch (nice_grid.cuh kThreads, kWarp,
# kMmaMinThreads): whole warps up to THREADS, the bound every kernel is
# compiled under and the default; K5's blocks take two warps at least.
THREADS = 256
WARP = 32
MMA_THREADS_MIN = 64
# K5 (ops/mxu.py and nice_kernels.cuh's K5 section).
TILE_LIMBS = 2
SMEM_LIMIT = 48 * 1024
SOURCE_PAD = 2
D_ROWS = 12
DIGIT_MAX = 255
# The kernels' tiers: Lane<limbs of n, n^2, n^3, mask words> capacities.
TIERS = {"small": (2, 4, 6, 2), "dense": (5, 9, 13, 4),
         "generic": (144, 288, 424, 64)}
# The C interfaces' own return codes (nice_kernels.cuh).
RETURN_CODES = {"kNoTier": -1, "kNoSmem": -2, "kPlanTierOnly": -3,
                "kOtherPlan": -4, "kBadThreads": -5}
# A CUDA grid's y extent (K3's rows ride on it).
GRID_Y_MAX = 65535

# The static domain of the engine's shapes, over which C2 discharges the
# budget: batch sizes (the reference's autotune sweep stops at 2^26),
# megaloop segments (clamped, so any), and the slices of a mesh (the
# reference suite's 8 virtual devices). batch_size * n_dev must stay at or
# below ACC_LIMIT // 2 for clamp_segment to hold the budget: a finding of
# C2 (ROADMAP queue 3) where an entry point admits more.
DOMAIN = {"batch_size": (1, 1 << 26), "segment": (1, 1 << 16),
          "n_dev": (1, 8)}
# The rare-path sub-batch K2 runs (ops/engine.py RARE_SCAN_BATCH, at most
# the batch).
RARE_SCAN_MAX = DOMAIN["batch_size"][1]


@dataclasses.dataclass(frozen=True)
class Mirror:
    """One contract constant and its copies: the Python mirror as (path,
    module-level name) and the CUDA definition as (path, constexpr name)."""
    name: str
    value: int
    py: Optional[Tuple[str, str]] = None
    cuda: Optional[Tuple[str, str]] = None


_CE = "nice_tpu_torch/ops/cuda_engine.py"
_MXU = "nice_tpu_torch/ops/mxu.py"
_ENGINE = "nice_tpu_torch/ops/engine.py"
CUH = "nice_tpu_torch/csrc/nice_kernels.cuh"
GRID = "nice_tpu_torch/csrc/nice_grid.cuh"
MAIN_CU = "nice_tpu_torch/csrc/nice_kernels.cu"
PLAN_CU = "nice_tpu_torch/csrc/plan_kernels.cu"
CUDA_BUILD = "nice_tpu_torch/ops/cuda_build.py"

MIRRORS = (
    Mirror("MAX_HIST_BINS", MAX_HIST_BINS, py=(_CE, "MAX_HIST_BINS")),
    Mirror("STRIDED_DESC_MAX", STRIDED_DESC_MAX, py=(_CE, "STRIDED_DESC_MAX")),
    Mirror("STRIDED_PERIODS_MAX", STRIDED_PERIODS_MAX,
           py=(_CE, "STRIDED_PERIODS_MAX")),
    Mirror("STRIDED_OFFS_LANES_MAX", STRIDED_OFFS_LANES_MAX,
           py=(_CE, "STRIDED_OFFS_LANES_MAX")),
    Mirror("DESC_WIDTH", DESC_WIDTH, py=(_CE, "DESC_WIDTH"),
           cuda=(PLAN_CU, "kDescWidth")),
    Mirror("PLAN_TIER_LIMBS", PLAN_TIER_LIMBS, py=(_CE, "PLAN_TIER_LIMBS"),
           cuda=(CUH, "kPlanTierLimbs")),
    Mirror("TILE_LIMBS", TILE_LIMBS, py=(_MXU, "TILE_LIMBS"),
           cuda=(CUH, "kTileLimbs")),
    Mirror("SMEM_LIMIT", SMEM_LIMIT, py=(_MXU, "SMEM_LIMIT"),
           cuda=(CUH, "kMmaSmemMax")),
    Mirror("SOURCE_PAD", SOURCE_PAD, py=(_MXU, "SOURCE_PAD"),
           cuda=(CUH, "kK5Pad")),
    Mirror("D_ROWS", D_ROWS, py=(_MXU, "D_ROWS")),
    Mirror("DIGIT_MAX", DIGIT_MAX, py=(_MXU, "_DIGIT_MAX")),
    Mirror("ACC_LIMIT", ACC_LIMIT, py=(_ENGINE, "ACC_LIMIT")),
    Mirror("THREADS", THREADS, py=(_CE, "BLOCK_THREADS_MAX"),
           cuda=(GRID, "kThreads")),
    Mirror("WARP", WARP, py=(_CE, "WARP"), cuda=(GRID, "kWarp")),
    Mirror("MMA_THREADS_MIN", MMA_THREADS_MIN,
           py=(_CE, "MMA_BLOCK_THREADS_MIN"), cuda=(GRID, "kMmaMinThreads")),
) + tuple(Mirror(name, code, cuda=(CUH, name))
          for name, code in RETURN_CODES.items())

# Where each tier's typedef lives (nice_kernels.cuh: SmallTier, DenseTier,
# GenericTier).
TIER_TYPEDEFS = {"small": "SmallTier", "dense": "DenseTier",
                 "generic": "GenericTier"}


# -- plans -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanShape:
    """What the contracts read of a base's plan: its limb and mask counts
    and its valid range (ops/limbs.BasePlan's fields of the same names)."""
    base: int
    limbs_n: int
    limbs_sq: int
    limbs_cu: int
    n_masks: int
    range_start: int
    range_end: int


def _limbs_for(value: int) -> int:
    return (max((value - 1).bit_length(), 1) + 31) // 32


def plan_shape(base: int) -> Optional[PlanShape]:
    """The plan's shape, as ops/limbs.get_plan computes it; None for a base
    without a valid range."""
    r = base_range.get_base_range(base)
    if r is None:
        return None
    d_sq, d_cu = base_range.sqube_digit_counts(base)
    return PlanShape(base, _limbs_for(r[1]), _limbs_for(base ** d_sq),
                     _limbs_for(base ** d_cu), (base + 31) // 32, r[0], r[1])


@functools.lru_cache(maxsize=None)
def valid_shapes(top: int = MAX_HIST_BINS + 2) -> Tuple[PlanShape, ...]:
    """The plan shape of every base up to `top` that has a valid range."""
    return tuple(s for s in map(plan_shape, range(3, top + 1)) if s)


def fits(shape: PlanShape, tier: str) -> bool:
    """Lane<...>::fits: the plan's counts within the tier's capacities."""
    nl, sq, cu, nm = TIERS[tier]
    return (shape.limbs_n <= nl and shape.limbs_sq <= sq
            and shape.limbs_cu <= cu and shape.n_masks <= nm)


def supports_base(shape: PlanShape) -> bool:
    return shape.base + 2 <= MAX_HIST_BINS


def plan_tier_takes(shape: PlanShape) -> bool:
    return shape.limbs_n <= PLAN_TIER_LIMBS


def k5_tiles(limbs: int) -> int:
    return -(-limbs // TILE_LIMBS)


def k5_smem_bytes(shape: PlanShape, front: int) -> int:
    """A K5 block's shared memory (nice_kernels.cuh k5_smem_bytes): `front`
    bytes rounded to 16 (K1's histogram in the detailed mode, 0 in the
    dense), S and S^2 padded, S^3, and T's words, 32 a tile."""
    source = SOURCE_PAD + shape.limbs_cu + 2
    return (-(-front // 16) * 16 + 4 * (2 * source + shape.limbs_cu)
            + 4 * 32 * (k5_tiles(shape.limbs_sq) + k5_tiles(shape.limbs_cu)))


def k5_front(shape: PlanShape) -> int:
    """The detailed mode's front: bins 0..base+1 and the near-miss count."""
    return 4 * (shape.base + 3)


def accum_bound() -> int:
    """K5's s32 column sum at most: D_ROWS digit rows times two bytes."""
    return D_ROWS * DIGIT_MAX * DIGIT_MAX


def reference_takes(shape: PlanShape) -> bool:
    """The reference's own bound on its MXU arm (limbs_n <= 64)."""
    return 2 * shape.limbs_n * DIGIT_MAX * 65535 <= I32_MAX


def k5_takes(shape: PlanShape, front: Optional[int] = None,
             wrapper: bool = True) -> bool:
    """Whether K5 takes the plan. The wrappers (mxu.supports_plan): the
    accumulator fits s32, the detailed block's shared memory fits
    SMEM_LIMIT, and the reference takes the plan. The C code (wrapper
    False) checks only its block's shared memory, `front` bytes of it
    before K5's own (the detailed mode's by default)."""
    if wrapper:
        return (accum_bound() <= I32_MAX and reference_takes(shape)
                and k5_smem_bytes(shape, k5_front(shape)) <= SMEM_LIMIT)
    front = k5_front(shape) if front is None else front
    return k5_smem_bytes(shape, front) <= SMEM_LIMIT


def block_threads_min(mma: int) -> int:
    """The least block size of K1/K3/K4 (mma 0) or K5 (mma 1)."""
    return MMA_THREADS_MIN if mma else WARP


def block_threads_ok(threads: int, mma: int = 0) -> bool:
    """Whether a kernel takes blocks of `threads` threads."""
    return (block_threads_min(mma) <= threads <= THREADS
            and threads % WARP == 0)


def pick_tier(shape: PlanShape) -> Optional[str]:
    """nice_kernels.cuh pick_tier: the first runtime-plan tier that holds
    the plan (K1 and K2 above the plan tier run the generic one)."""
    if fits(shape, "small"):
        return "small"
    if fits(shape, "generic"):
        return "generic"
    return None


def dense_tier(shape: PlanShape) -> Optional[str]:
    """nice_kernels.cu dense_tier: K4's and K5's dense mode."""
    if not fits(shape, "small") and fits(shape, "dense"):
        return "dense"
    return pick_tier(shape)


# -- the specs ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Param:
    """One parameter of a C entry point: its C type ("ptr" for any
    pointer), and for a scalar its static domain [lo, hi] (hi may be a
    function of the plan) and the narrower type the C code casts it to."""
    name: str
    ctype: str
    lo: Optional[int] = None
    hi: object = None
    cast: Optional[str] = None

    def high(self, shape: PlanShape) -> Optional[int]:
        return self.hi(shape) if callable(self.hi) else self.hi


def _ptr(name: str) -> Param:
    return Param(name, "ptr")


def _threads(mma: int = 0) -> Param:
    """The block size of a launch that takes K5 when mma, else K1/K3/K4
    (block_threads_ok: a multiple of WARP besides the domain)."""
    return Param("block_threads", "int", block_threads_min(mma), THREADS)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str                       # the C entry point
    source: str                     # the CUDA file that defines it
    library: str                    # "main" or "plan" (one build a base)
    kind: str                       # "launch" or "shape" (a shape query)
    kernels: Tuple[str, ...]        # K1-K5 it launches
    cuda_kernels: Tuple[str, ...]   # the __global__ kernels, tier by tier
    wrappers: Tuple[str, ...]       # public functions of ops/cuda_engine.py
    params: Tuple[Param, ...]
    launches: Tuple[str, ...] = ()  # cuda_engine.LAUNCHES keys
    plain: Tuple[str, ...] = ()     # "path:function" of the plain versions
    jax: Tuple[str, ...] = ()       # the TPU kernels it replaces, "path:line"
    # (plan shape, mma, wrapper) -> the tier it runs the plan on, or None
    # when it does not take the plan (another entry does, or none): as the
    # wrappers route and refuse plans (wrapper True), or as the C code
    # alone answers (a shape query, where K5 has no reference bound).
    tier: Callable = lambda shape, mma, wrapper=True: None  # noqa: E731
    modes: Tuple[int, ...] = (0,)   # the mma values it takes (1 = K5)
    outputs: Callable = lambda shape, batch, n_iters: ()  # noqa: E731
    in_place: Tuple[str, ...] = ()  # arguments it updates in place
    bounds: Tuple[Tuple[str, str], ...] = ()  # (output, what bounds it)
    witness_bases: Tuple[Tuple[int, int], ...] = ()  # (base, mma)


SPECS: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in SPECS:
        raise ValueError(f"spec {spec.name} registered twice")
    SPECS[spec.name] = spec
    return spec


def all_specs() -> Dict[str, KernelSpec]:
    return dict(SPECS)


# The TPU kernels (nice_tpu/ops/pallas_engine.py) and the pallas_call each
# reaches.
PALLAS = "nice_tpu/ops/pallas_engine.py"
JAX_CALLS = {
    "K1": f"{PALLAS}:181",  # _stats_callable, mode "detailed"
    "K2": f"{PALLAS}:466",  # _uniques_callable
    "K3": f"{PALLAS}:410",  # _strided_callable
    "K4": f"{PALLAS}:181",  # _stats_callable, modes "niceonly"/"-fused"
    "K5": f"{PALLAS}:181",  # the same call with use_mxu=True
}

# Entries of the C sources that no wrapper launches a kernel through: the
# error text of a return code.
HELPERS = {"nice_error_string": "the text of a return code; no kernel"}
# CUDA sources whose C functions are measuring tools, not kernels a wrapper
# loads.
EXEMPT_SOURCES = {
    "nice_tpu_torch/csrc/op_count.cu":
        "lanes built to be counted (chip_smoke.py's bounds); never launched",
    "nice_tpu_torch/csrc/imma_probe.cu":
        "the tensor cores' integer rate probe (chip_smoke.py)",
}
# ctypes signatures of entries that no source of this tree defines: the
# main library's K3 of an older tree, bound for scripts/kernel_ab.py's A/B.
LEGACY_ENTRIES = {"nice_strided_niceonly":
                  "an older tree's main-library K3 (scripts/kernel_ab.py)"}


def _k1_tier(shape: PlanShape, mma: int,
             wrapper: bool = True) -> Optional[str]:
    if (not supports_base(shape) or plan_tier_takes(shape)
            or pick_tier(shape) != "generic"):
        return None
    if mma and not k5_takes(shape, wrapper=wrapper):
        return None
    return "generic"


def _hist(shape, batch, n_iters):
    return (("hist_acc", (shape.base + 2,), "int32"), ("nm", (), "int32"))

register(KernelSpec(
    name="nice_detailed_megaloop",
    source=MAIN_CU, library="main", kind="launch", kernels=("K1", "K5"),
    cuda_kernels=("detailed_megaloop_kernel<GenericTier>",
                  "detailed_megaloop_mma_kernel_wide<GenericTier>"),
    wrappers=("detailed_accum_megaloop",),
    launches=("detailed_megaloop", "detailed_megaloop_mma"),
    plain=("nice_tpu_torch/ops/vector_engine.py:detailed_accum_megaloop",
           "nice_tpu_torch/ops/mxu.py:products_mxu"),
    jax=(f"{PALLAS}:164 _stats_callable (mode detailed)",
         f"{PALLAS}:549 _detailed_megaloop_callable",
         "nice_tpu/ops/mxu.py:162 sqr_limbs_mxu / mul_limbs_mxu"),
    params=(_ptr("plan_words"), _ptr("start"),
            Param("valid_total", "long long", 0, ACC_LIMIT // 2),
            Param("pad", "long long", 0, ACC_LIMIT // 2, cast="int32_t"),
            _ptr("hist"), _ptr("nm"), Param("mma", "int", 0, 2), _threads(),
            _ptr("stream")),
    tier=_k1_tier, modes=(0, 1), outputs=_hist,
    in_place=("hist_acc", "nm_out"),
    bounds=(("hist_acc", "every bin <= ACC_LIMIT // 2: clamp_segment and "
             "_flush_every (C2 k1_flush_budget)"),
            ("nm", "at most the launch's lanes <= ACC_LIMIT // 2")),
    witness_bases=((98, 0), (510, 0), (510, 1)),
))


def _k2_main_tier(shape: PlanShape, mma: int,
                  wrapper: bool = True) -> Optional[str]:
    if (not supports_base(shape) or plan_tier_takes(shape)
            or pick_tier(shape) != "generic"):
        return None
    return "generic"


def _uniques_out(shape, batch, n_iters):
    return (("uniques", (batch,), "int32"),)


_K2_PARAMS = (_ptr("plan_words"), _ptr("start"),
              Param("lanes", "long long", 1, RARE_SCAN_MAX), _ptr("out"),
              _ptr("stream"))

register(KernelSpec(
    name="nice_uniques",
    source=MAIN_CU, library="main", kind="launch", kernels=("K2",),
    cuda_kernels=("uniques_kernel<GenericTier>",),
    wrappers=("uniques_batch",), launches=("uniques",),
    plain=("nice_tpu_torch/ops/vector_engine.py:uniques_batch",),
    jax=(f"{PALLAS}:447 _uniques_callable",
         f"{PALLAS}:489 _survivors_callable"),
    params=_K2_PARAMS, tier=_k2_main_tier, outputs=_uniques_out,
    bounds=(("uniques", "num_uniques <= base"),),
    witness_bases=((510, 0),),
))


def _dense_tier(shape: PlanShape, mma: int,
                wrapper: bool = True) -> Optional[str]:
    if not supports_base(shape) or shape.base < 3:
        return None
    if mma and not k5_takes(shape, front=0, wrapper=wrapper):
        return None
    return dense_tier(shape)


def _dense_out(shape, batch, n_iters):
    return (("count_pruned", (2,), "int32"),)


register(KernelSpec(
    name="nice_niceonly_dense",
    source=MAIN_CU, library="main", kind="launch", kernels=("K4", "K5"),
    cuda_kernels=("niceonly_dense_kernel<SmallTier|DenseTier|GenericTier>",
                  "niceonly_dense_mma_kernel<SmallTier|DenseTier|"
                  "GenericTier>"),
    wrappers=("niceonly_dense_megaloop",),
    launches=("niceonly_dense", "niceonly_dense_mma"),
    plain=("nice_tpu_torch/ops/vector_engine.py:niceonly_dense_megaloop",
           "nice_tpu_torch/ops/mxu.py:products_mxu"),
    jax=(f"{PALLAS}:155 _make_kernel mode niceonly",
         f"{PALLAS}:143 _make_kernel mode niceonly-fused",
         "nice_tpu/ops/vector_engine.py:586 niceonly_dense_megaloop"),
    params=(_ptr("plan_words"), _ptr("start"), _ptr("classes"),
            Param("num_cls", "long long", 1, lambda s: s.base - 1,
                  cast="uint32_t"),
            Param("valid_total", "long long", 0,
                  lambda s: I32_MAX - s.base, cast="uint32_t"),
            Param("min_uniques", "int", 0, lambda s: s.base),
            Param("mma", "int", 0, 2), _ptr("out"), _threads(),
            _ptr("stream")),
    tier=_dense_tier, modes=(0, 1), outputs=_dense_out, in_place=("out",),
    bounds=(("count_pruned", "count and pruned each <= valid_total < "
             "2^31 - base (C2 k4_counts)"),),
    witness_bases=((98, 0), (100, 0), (98, 1)),
))

register(KernelSpec(
    name="nice_launch_shape",
    source=MAIN_CU, library="main", kind="shape", kernels=(),
    cuda_kernels=(), wrappers=("launch_shape",),
    params=(Param("kernel", "int", 0, 3), _ptr("plan_words"),
            Param("a", "long long", 0, ACC_LIMIT // 2),
            Param("b", "long long", 0, ACC_LIMIT // 2),
            Param("mma", "int", 0, 1), _threads(), _ptr("out")),
))


def _plan_tier(shape: PlanShape, mma: int,
               wrapper: bool = True) -> Optional[str]:
    if not supports_base(shape) or not plan_tier_takes(shape):
        return None
    return "plan"


register(KernelSpec(
    name="nice_plan_uniques",
    source=PLAN_CU, library="plan", kind="launch", kernels=("K2",),
    cuda_kernels=("uniques_kernel<PlanTier>",),
    wrappers=("uniques_batch",), launches=("uniques",),
    plain=("nice_tpu_torch/ops/vector_engine.py:uniques_batch",),
    jax=(f"{PALLAS}:447 _uniques_callable",
         f"{PALLAS}:489 _survivors_callable"),
    params=_K2_PARAMS, tier=_plan_tier, outputs=_uniques_out,
    bounds=(("uniques", "num_uniques <= base"),),
    witness_bases=((40, 0), (80, 0)),
))


def _k1_plan_tier(shape: PlanShape, mma: int,
                  wrapper: bool = True) -> Optional[str]:
    return None if mma else _plan_tier(shape, mma)


register(KernelSpec(
    name="nice_plan_detailed_megaloop",
    source=PLAN_CU, library="plan", kind="launch", kernels=("K1",),
    cuda_kernels=("detailed_megaloop_kernel<PlanTier>",),
    wrappers=("detailed_accum_megaloop",),
    launches=("detailed_megaloop", "detailed_megaloop_plan"),
    plain=("nice_tpu_torch/ops/vector_engine.py:detailed_accum_megaloop",),
    jax=(f"{PALLAS}:164 _stats_callable (mode detailed)",
         f"{PALLAS}:549 _detailed_megaloop_callable"),
    params=(_ptr("plan_words"), _ptr("start"),
            Param("valid_total", "long long", 0, ACC_LIMIT // 2),
            Param("pad", "long long", 0, ACC_LIMIT // 2, cast="int32_t"),
            _ptr("hist"), _ptr("nm"), _threads(), _ptr("stream")),
    tier=_k1_plan_tier, outputs=_hist, in_place=("hist_acc", "nm_out"),
    bounds=(("hist_acc", "every bin <= ACC_LIMIT // 2: clamp_segment and "
             "_flush_every (C2 k1_flush_budget)"),
            ("nm", "at most the launch's lanes <= ACC_LIMIT // 2")),
    witness_bases=((40, 0), (80, 0), (97, 0)),
))


def _k5_plan_tier(shape: PlanShape, mma: int,
                  wrapper: bool = True) -> Optional[str]:
    if not mma or not k5_takes(shape, wrapper=wrapper):
        return None
    return _plan_tier(shape, mma)


register(KernelSpec(
    name="nice_plan_detailed_megaloop_mma",
    source=PLAN_CU, library="plan", kind="launch", kernels=("K5",),
    cuda_kernels=("detailed_megaloop_mma_kernel<PlanTier>",),
    wrappers=("detailed_accum_megaloop",),
    launches=("detailed_megaloop_mma",),
    plain=("nice_tpu_torch/ops/vector_engine.py:detailed_accum_megaloop",
           "nice_tpu_torch/ops/mxu.py:products_mxu"),
    jax=(f"{PALLAS}:181 _stats_callable with use_mxu=True",
         "nice_tpu/ops/mxu.py:162 sqr_limbs_mxu / mul_limbs_mxu"),
    params=(_ptr("plan_words"), _ptr("start"),
            Param("valid_total", "long long", 0, ACC_LIMIT // 2),
            Param("pad", "long long", 0, ACC_LIMIT // 2, cast="int32_t"),
            _ptr("hist"), _ptr("nm"), Param("mma", "int", 1, 2),
            _threads(mma=1), _ptr("stream")),
    tier=_k5_plan_tier, modes=(1,), outputs=_hist,
    in_place=("hist_acc", "nm_out"),
    bounds=(("hist_acc", "as K1's (C2 k1_flush_budget); column sums <= "
             "accum_bound() (C2 k5_accum)"),
            ("nm", "at most the launch's lanes < 2^31 (C2 k5_lanes)")),
    witness_bases=((40, 1),),
))


def _strided_out(shape, batch, n_iters):
    return (("counts", (batch,), "int32"),)


register(KernelSpec(
    name="nice_plan_strided_niceonly",
    source=PLAN_CU, library="plan", kind="launch", kernels=("K3",),
    cuda_kernels=("strided_niceonly_kernel<PlanTier>",),
    wrappers=("strided_niceonly_batch",), launches=("strided_niceonly",),
    plain=("nice_tpu_torch/ops/vector_engine.py:niceonly_strided_counts",),
    jax=(f"{PALLAS}:391 _strided_callable",
         f"{PALLAS}:350 _make_strided_kernel"),
    params=(_ptr("plan_words"), _ptr("desc"),
            Param("n_real", "long long", 0, STRIDED_DESC_MAX),
            _ptr("residues"),
            Param("num_res", "long long", 1, STRIDED_OFFS_LANES_MAX,
                  cast="uint32_t"),
            Param("res_magic", "unsigned", 0, U32_MAX),
            Param("res_shift1", "int", 0, 1),
            Param("res_shift2", "int", 0, 31),
            Param("modulus", "long long", 1, U32_MAX, cast="uint32_t"),
            Param("periods", "long long", 1, STRIDED_PERIODS_MAX),
            Param("min_uniques", "int", 0, lambda s: s.base),
            _ptr("counts"), _threads(), _ptr("stream")),
    tier=_plan_tier, outputs=_strided_out, in_place=("counts",),
    bounds=(("counts", "a row's count <= periods * R <= "
             "STRIDED_OFFS_LANES_MAX (C2 k3_counts)"),),
    witness_bases=((40, 0), (80, 0)),
))

register(KernelSpec(
    name="nice_plan_launch_shape",
    source=PLAN_CU, library="plan", kind="shape", kernels=(),
    cuda_kernels=(), wrappers=("launch_shape",),
    params=(Param("kernel", "int", 0, 2), _ptr("plan_words"),
            Param("a", "long long", 0, ACC_LIMIT // 2),
            Param("b", "long long", 0, ACC_LIMIT // 2),
            Param("mma", "int", 0, 1), _threads(), _ptr("out")),
))


# -- launch_shape's kernels: which entry and tier the spec predicts ---------

# cuda_engine.launch_shape's kernel names: (the entries that may answer,
# the mma flag).
SHAPE_KERNELS = {
    "detailed_megaloop": (("nice_plan_detailed_megaloop",
                           "nice_detailed_megaloop"), 0),
    "uniques": (("nice_plan_uniques", "nice_uniques"), 0),
    "strided_niceonly": (("nice_plan_strided_niceonly",), 0),
    "niceonly_dense": (("nice_niceonly_dense",), 0),
    "detailed_megaloop_mma": (("nice_plan_detailed_megaloop_mma",
                               "nice_detailed_megaloop"), 1),
    "niceonly_dense_mma": (("nice_niceonly_dense",), 1),
}


def predicted_tier(kernel: str, shape: PlanShape,
                   wrapper: bool = True) -> Optional[str]:
    """The tier a LAUNCHES kernel runs a plan on, or None where it does not
    take the plan: as the wrappers route it, or (wrapper False) as
    cuda_engine.launch_shape, which asks the C code, must report it."""
    entries, mma = SHAPE_KERNELS[kernel]
    for name in entries:
        tier = SPECS[name].tier(shape, mma, wrapper)
        if tier is not None:
            return tier
    return None


# -- probes and witnesses ----------------------------------------------------

# The bases C6's shape check runs the plain versions at.
SWEEP_BASES = (10, 40, 55, 57, 80, 97, 98, 510)
# Bases that bracket each cap: the small tier's (b55 | b57), the plan
# tier's (b97 | b98), the reference's MXU bound (b1024 | b1025), the
# histogram's (b2045, the last valid base with base + 2 <= 2048 | b2048).
PROBE_BASES = (55, 57, 97, 98, 1024, 1025, 2045, 2048)


def carry_edges(shape: PlanShape, seed: int = 0, randoms: int = 16) -> list:
    """Candidates at the limb boundaries inside the base's range (a copy
    of tests/test_property_differential.py's _carry_edge_candidates,
    extended to every m * 2^(32j) the range holds: the reference's k-loop
    stops at 2^224, below b510's range): the range's ends and middle;
    2^(32k) and its neighbours; the lanes whose low limbs are all ones,
    m * 2^(32j) - 1, and m * 2^(32j), for the first and last multiple of
    each 2^(32j) inside the range; limbs all ones; seeded randoms."""
    lo, hi = shape.range_start, shape.range_end
    cands = {lo, hi - 1, (lo + hi) // 2}
    for k in range(1, 8):
        b = 1 << (32 * k)
        for n in (b - 1, b, b + 1, b - 2, (b - 1) // 3):
            if lo <= n < hi:
                cands.add(n)
    for j in range(1, shape.limbs_n):
        step = 1 << (32 * j)
        for m in (lo // step + 1, (hi - 1) // step):
            edge = m * step
            if lo < edge < hi:
                cands.update((edge - 1, edge))
    ones = 0
    while True:
        ones = (ones << 32) | U32_MAX
        if ones >= hi:
            break
        if ones >= lo:
            cands.add(ones)
    rng = random.Random(shape.base * 1000 + seed)
    for _ in range(randoms):
        cands.add(rng.randrange(lo, hi))
    return sorted(cands)


def limb_edges(shape: PlanShape) -> list:
    """The multiples m * 2^(32j) inside the range that carry_edges holds:
    where a lane's low j limbs roll over from all ones."""
    lo, hi = shape.range_start, shape.range_end
    out = set()
    for j in range(1, shape.limbs_n):
        step = 1 << (32 * j)
        for m in (lo // step + 1, (hi - 1) // step):
            if lo < m * step < hi:
                out.add(m * step)
    return sorted(out)


def witness_starts(shape: PlanShape, lanes: int, limit: int = 12) -> list:
    """Starts of `lanes`-lane windows inside the base's valid range, at most
    `limit`: first the limb edges', one straddling each m * 2^(32j) (its
    lane lanes // 2) and one starting at the all-ones lane before it, and
    the range's first and last windows (spread evenly when they are more
    than `limit`, the first and last kept); then windows centred on the
    rest of carry_edges' candidates, to fill the limit."""
    lo, hi = shape.range_start, shape.range_end - lanes
    edges = limb_edges(shape)
    first = {lo, hi}
    for edge in edges:
        first.update((edge - lanes // 2, edge - 1))
    first = sorted(s for s in first if lo <= s <= hi)
    if len(first) > limit:
        step = (len(first) - 1) / (limit - 1)
        first = sorted({first[round(i * step)] for i in range(limit)})
    rest = [min(max(c - lanes // 2, lo), hi) for c in carry_edges(shape)]
    rest = [s for s in rest if all(abs(s - f) >= lanes for f in first)]
    return sorted(first + rest[: max(0, limit - len(first))])
