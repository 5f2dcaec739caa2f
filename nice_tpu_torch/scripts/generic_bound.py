"""The least integer operations one lane of K1, K2 or K5 needs at a plan,
counted from the plan's shapes: the bound of the generic tier's kernels at
wide bases (b510).

    python -m nice_tpu_torch.scripts.generic_bound [--base 510]

A constant-plan lane of csrc/op_count.cu, whose SASS bounds the kernels at
b40 and b80, takes minutes of nvcc at b510 (29/58/87 limbs). So this counts
only the multiplies that a lane's steps need, at the plan's limb and digit
counts, as nice_kernels.cuh's Lane forms the steps:

  * a partial product of n^2 = n * n or of n^3 = n^2 * n, modulo the
    product's limbs (Lane::mul): one 32x32->64 multiply-add;
  * a limb step of a chunk division, (r << 32 | limb) / base^e
    (divmod_magic): four for the 64x64 high product by the chunk's
    reciprocal, one for the remainder x - q * base^e;
  * a digit off a chunk's remainder (div_base, div_base_full): one for the
    multiply-high by the digit magic, one for r - q * base;
  * K5: its products are its warp's IMMAs (mma.sync m16n8k16, one IMMA
    each), two 16-row halves of the warp per tile of 8 byte columns (two
    limbs), as every lane counts its warp's; i^2 and i^3 from i take three
    multiplies (a kernel that forms more, such as the squares of its quad's
    four offsets, does so by its own design, not because the function needs
    them); its digits are K1's.

Adds, shifts, compares, the presence bits, moves, address arithmetic and
loop control are left out, so the count stays below what any compiled lane
issues: chip_smoke.py holds it against the constant-plan lanes' SASS at
b40 and b80, where it finds exactly their multiply-highs and limb steps.
"""

from __future__ import annotations

import argparse
import json
import sys

KERNELS = ("detailed_megaloop_kernel", "uniques_kernel",
           "detailed_megaloop_mma_kernel")
MUL_PER_PRODUCT = 1
MUL_PER_LIMB_STEP = 5
MUL_PER_DIGIT = 2
MUL_K5_POWERS = 3  # i^2: one; i^3 = i^2 * i: two


def products(la: int, lb: int, lo: int) -> int:
    """Partial products of a * b mod 2^(32 lo), a of la limbs and b of lb,
    as Lane::mul forms them: row i takes columns j < lb with i + j < lo."""
    return sum(min(lb, lo - i) for i in range(min(la, lo)))


def peel(plan, nl: int, ndig: int) -> tuple[int, int]:
    """(limb steps, digit steps) of Lane::digits on a value of nl limbs and
    ndig digits: each chunk divides the value's limbs by base^e, which then
    shrink to quotient_limbs of the digits left, and takes e - 1 digits off
    its remainder by division; the last stage divides rem - 1 times."""
    from nice_tpu_torch.ops.limbs import digit_chunk, log2_fx, quotient_limbs

    e, _ = digit_chunk(plan.base)
    lfx = log2_fx(plan.base)
    limb_steps = digit_steps = 0
    rem = ndig
    while rem > e:
        rem -= e
        limb_steps += nl
        nl = min(nl, quotient_limbs(rem, lfx))
        digit_steps += e - 1
    return limb_steps, digit_steps + max(rem - 1, 0)


def lane_ops(plan, kernel: str) -> dict:
    """The operations one lane of `kernel` needs at `plan` (inside the
    base's range): {"instructions", "classes", "steps"}, in the form of
    chip_smoke.py's SASS counts (its lane_cycles reads them)."""
    if kernel not in KERNELS:
        raise ValueError(f"no count for {kernel}")
    n, sq, cu = plan.limbs_n, plan.limbs_sq, plan.limbs_cu
    limb_sq, digit_sq = peel(plan, sq, plan.d_sq)
    limb_cu, digit_cu = peel(plan, cu, plan.d_cu)
    steps = {"limb_steps": limb_sq + limb_cu,
             "digit_steps": digit_sq + digit_cu}
    mul = (MUL_PER_LIMB_STEP * steps["limb_steps"]
           + MUL_PER_DIGIT * steps["digit_steps"])
    classes: dict = {}
    if kernel == "detailed_megaloop_mma_kernel":
        from nice_tpu_torch.ops.mxu import tiles

        steps["mma"] = 2 * (tiles(sq) + tiles(cu))
        classes["tensor"] = steps["mma"]
        mul += MUL_K5_POWERS
    else:
        steps["products"] = products(n, n, sq) + products(sq, n, cu)
        mul += MUL_PER_PRODUCT * steps["products"]
    classes["multiply-add"] = mul
    return {"instructions": sum(classes.values()), "classes": classes,
            "steps": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=int, default=510)
    args = ap.parse_args(argv)

    from nice_tpu_torch.ops.limbs import get_plan

    plan = get_plan(args.base)
    for kernel in KERNELS:
        print(json.dumps({"kernel": kernel, "base": args.base,
                          **lane_ops(plan, kernel)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
