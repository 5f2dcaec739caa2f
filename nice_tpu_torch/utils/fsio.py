"""Atomic state-file writes: same-directory temp file + fsync + rename (the
port's copy of nice_tpu/utils/fsio.py).

Every module of the port that persists state (checkpoint snapshots, spool
journals) writes through this helper, which keeps the three load-bearing
properties in one place:

* the temp file lives in the TARGET directory (``os.replace`` across
  filesystems is not atomic);
* file contents are fsync'd before the rename, so the rename can never
  publish a partially written file after power loss;
* the directory entry is fsync'd after the rename (best-effort — skipped
  quietly on filesystems that refuse O_RDONLY directory fds), so the
  rename itself survives power loss.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

__all__ = ["atomic_write_bytes", "atomic_write_text", "atomic_write_json",
           "fsync_directory"]


def fsync_directory(path: str) -> None:
    """Best-effort fsync of the directory containing ``path``."""
    try:
        dfd = os.open(
            os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY
        )
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def atomic_write_bytes(path: str, data: bytes, *,
                       sync_directory: bool = True) -> int:
    """Atomically replace ``path`` with ``data``; returns len(data).

    On any failure the temp file is removed and the original ``path`` is
    left untouched (the error propagates)."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if sync_directory:
        fsync_directory(path)
    return len(data)


def atomic_write_text(path: str, text: str, *, encoding: str = "utf-8",
                      sync_directory: bool = True) -> int:
    return atomic_write_bytes(
        path, text.encode(encoding), sync_directory=sync_directory
    )


def atomic_write_json(path: str, obj: Any, *, indent: Optional[int] = None,
                      sort_keys: bool = False, default=None,
                      sync_directory: bool = True) -> int:
    return atomic_write_text(
        path,
        json.dumps(obj, indent=indent, sort_keys=sort_keys, default=default),
        sync_directory=sync_directory,
    )
