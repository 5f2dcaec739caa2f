"""Crash-safe field-scan checkpointing (the port's copy of nice_tpu/ckpt).

snapshot.py — the on-disk format (versioned, CRC-guarded, atomic-rename
files, byte-compatible with the JAX package's); manager.py — the per-field
lifecycle (plan signature validation, resume-state packing, startup resume
scan). The engine knows nothing about files: it takes a checkpoint_cb and a
resume state (ops/engine.py); this package is where those become durable.
"""

from nice_tpu_torch.ckpt.manager import (
    FieldCheckpointer,
    find_resumable,
    plan_signature,
)
from nice_tpu_torch.ckpt.snapshot import (
    FORMAT_VERSION,
    SnapshotError,
    read_snapshot,
    write_snapshot,
)

__all__ = [
    "FORMAT_VERSION",
    "FieldCheckpointer",
    "SnapshotError",
    "find_resumable",
    "plan_signature",
    "read_snapshot",
    "write_snapshot",
]
