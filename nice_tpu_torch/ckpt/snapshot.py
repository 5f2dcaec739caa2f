"""Versioned, CRC-guarded, atomic-rename snapshot files (the port's copy of
nice_tpu/ckpt/snapshot.py: the same magic, version, layout and CRC, so a
file written by either package reads in the other).

One snapshot is ONE file: a fixed magic/version header, a JSON manifest
(small structured state: plan signature, cursor, survivor list — values that
can exceed u64 are carried as decimal strings), an npz payload (the
host-folded histogram accumulator and any other arrays), and a trailing
CRC-32 over everything after the magic.

Durability contract:
  * writes go to a same-directory temp file, fsync, then os.replace — a
    reader never observes a half-written snapshot, and a crash mid-write
    leaves the previous snapshot intact;
  * reads re-verify magic, version, section lengths, and the CRC before any
    payload bytes are interpreted; every corruption mode raises
    SnapshotError (callers decide whether that means "restart cleanly").
"""

from __future__ import annotations

import io
import json
import struct
import zlib

import numpy as np

from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.utils import fsio

MAGIC = b"NICECKPT"
FORMAT_VERSION = 1

_LEN = struct.Struct("<I")  # little-endian u32 section length / CRC


class SnapshotError(Exception):
    """Unreadable snapshot: bad magic, unknown version, truncation, or CRC
    mismatch. The snapshot must be discarded, never partially trusted.

    reason: "corrupt" (CRC/truncation/parse) or "version" (format version
    this build cannot read).
    """

    def __init__(self, message: str, reason: str = "corrupt"):
        super().__init__(message)
        self.reason = reason


def encode_snapshot(manifest: dict, arrays: dict[str, np.ndarray]) -> bytes:
    """The file's bytes for manifest + arrays (manifest gets
    `format_version` stamped in; arrays as an uncompressed npz)."""
    manifest = dict(manifest)
    manifest["format_version"] = FORMAT_VERSION
    manifest_bytes = json.dumps(manifest, sort_keys=True).encode("utf-8")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    body = (
        _LEN.pack(FORMAT_VERSION)
        + _LEN.pack(len(manifest_bytes))
        + manifest_bytes
        + _LEN.pack(len(payload))
        + payload
    )
    return MAGIC + body + _LEN.pack(zlib.crc32(body))


def write_snapshot(path: str, manifest: dict, arrays: dict[str, np.ndarray]) -> int:
    """Atomically write manifest + arrays to `path`; returns bytes written."""
    blob = encode_snapshot(manifest, arrays)
    # Fault site ckpt.write: "truncate" persists only half the blob (a
    # power loss mid-write), which read_snapshot must reject by its CRC.
    if faults.fire("ckpt.write", path=path) == "truncate":
        blob = blob[: len(blob) // 2]
    return fsio.atomic_write_bytes(path, blob)


def read_snapshot(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Read and fully validate a snapshot; returns (manifest, arrays).

    Raises SnapshotError on any structural defect; raises FileNotFoundError
    if the file does not exist (distinct: "no snapshot" vs "bad snapshot").
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC) + 3 * _LEN.size or not blob.startswith(MAGIC):
        raise SnapshotError(f"{path}: not a snapshot (bad magic or truncated)")
    body, trailer = blob[len(MAGIC):-_LEN.size], blob[-_LEN.size:]
    if zlib.crc32(body) != _LEN.unpack(trailer)[0]:
        raise SnapshotError(f"{path}: CRC mismatch (corrupt or truncated)")
    off = 0
    (version,) = _LEN.unpack_from(body, off)
    off += _LEN.size
    if version != FORMAT_VERSION:
        raise SnapshotError(
            f"{path}: unsupported snapshot format version {version} "
            f"(this build reads {FORMAT_VERSION})",
            reason="version",
        )
    (mlen,) = _LEN.unpack_from(body, off)
    off += _LEN.size
    if off + mlen + _LEN.size > len(body):
        raise SnapshotError(f"{path}: manifest length exceeds file")
    try:
        manifest = json.loads(body[off:off + mlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SnapshotError(f"{path}: manifest is not valid JSON: {e}") from e
    off += mlen
    (plen,) = _LEN.unpack_from(body, off)
    off += _LEN.size
    if off + plen != len(body):
        raise SnapshotError(f"{path}: payload length does not match file")
    try:
        with np.load(io.BytesIO(body[off:off + plen]), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except (OSError, ValueError, KeyError) as e:
        raise SnapshotError(f"{path}: payload is not a valid npz: {e}") from e
    if manifest.get("format_version") != FORMAT_VERSION:
        raise SnapshotError(f"{path}: manifest/header version disagree")
    return manifest, arrays
