"""The nicelint rule modules of the port; each registers itself with
core.rule on import."""

from nice_tpu_torch.analysis.rules import (  # noqa: F401
    a1_atomic_write,
    d1_device_sync,
    k1_knobs,
    m1_metrics,
)
