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
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan

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
