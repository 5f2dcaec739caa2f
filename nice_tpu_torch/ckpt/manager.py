"""Per-field checkpoint lifecycle: save / validate / resume / delete (the
port's copy of nice_tpu/ckpt/manager.py, with its metrics, journal events
and flight-recorder records).

The engine produces opaque resume states ({cursor, hist, nice_numbers,
remaining} — see ops/engine.py's checkpoint_cb contract); this module binds
one such stream to a claimed field and a checkpoint directory:

  * FieldCheckpointer.save is the engine's checkpoint_cb — each call writes
    one atomic snapshot (ckpt/snapshot.py) carrying the field identity, the
    plan signature, and the scan state;
  * load() re-validates everything before any resume happens: CRC/version at
    the format layer, then the plan signature (mode, base, batch size,
    backend, runtime) and the field identity. A stale or mismatched
    snapshot is rejected (file removed) and the caller restarts the scan
    cleanly — never a silent resume into wrong state;
  * find_resumable() is the client's startup scan: the newest valid snapshot
    in the directory wins, so a restarted client picks up the same claim it
    died holding instead of claiming a fresh field.

The runtime in the signature names the torch build and the device
(torch-<version>-cuda-sm<major><minor>, torch-<version>-cpu, or host for
the scalar backend), so a snapshot from another runtime, the JAX package's
included, is rejected with reason "signature", as the reference rejects one
from another jax build. Engine states themselves resume across the two
packages; the files read in both.

Numbers that can exceed u64 (candidates run past 2^64 at bases 60+) travel
as decimal strings in the manifest; only the histogram rides in the binary
payload.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from nice_tpu_torch.ckpt.snapshot import (
    SnapshotError,
    read_snapshot,
    write_snapshot,
)
from nice_tpu_torch.core.types import DataToClient, SearchMode
from nice_tpu_torch.obs import flight, journal
from nice_tpu_torch.obs.series import CKPT_BYTES, CKPT_REJECTED, CKPT_WRITES

log = logging.getLogger("nice_tpu_torch.ckpt")


def runtime(backend: str, device) -> str:
    """The runtime a snapshot's cursor was produced on."""
    if backend != "device":
        return "host"
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"torch-{torch.__version__}-cuda-sm{major}{minor}"
    return f"torch-{torch.__version__}-{dev.type}"


def plan_signature(mode: SearchMode, base: int, backend: str,
                   batch_size: int | None, device="cuda") -> dict:
    """The compatibility fingerprint a snapshot must match to be resumed:
    mode, base, backend, batch size (None: "resolved by the tuner"; the
    cursor is an absolute number position either way), the runtime, and
    the state contract, 3 as the JAX engine's megaloop states (the
    remaining set has the granularity of one segment or run)."""
    return {
        "mode": "detailed" if mode == SearchMode.DETAILED else "niceonly",
        "base": base,
        "backend": backend,
        "batch_size": batch_size,
        "runtime": runtime(backend, device),
        "state": 3,
    }


def _state_to_snapshot(state: dict) -> tuple[dict, dict[str, np.ndarray]]:
    manifest = {
        "cursor": str(int(state["cursor"])),
        "nice_numbers": [
            [str(int(n)), int(u)] for n, u in state["nice_numbers"]
        ],
        "near_miss_count": len(state["nice_numbers"]),
    }
    if state.get("remaining") is not None:
        # The uncovered [start, end) segments (decimal strings — candidates
        # exceed u64 at bases 60+). "filtered" marks a niceonly
        # remaining-set whose gaps are provably empty.
        manifest["remaining"] = [
            [str(int(s)), str(int(e))] for s, e in state["remaining"]
        ]
        manifest["filtered"] = bool(state.get("filtered"))
    arrays: dict[str, np.ndarray] = {}
    if state.get("hist") is not None:
        arrays["hist"] = np.asarray(state["hist"], dtype=np.int64)
    return manifest, arrays


def _snapshot_to_state(manifest: dict, arrays: dict[str, np.ndarray]) -> dict:
    state = {
        "cursor": int(manifest["cursor"]),
        "hist": arrays.get("hist"),
        "nice_numbers": [
            (int(n), int(u)) for n, u in manifest["nice_numbers"]
        ],
    }
    if manifest.get("remaining") is not None:
        state["remaining"] = [
            (int(s), int(e)) for s, e in manifest["remaining"]
        ]
        state["filtered"] = bool(manifest.get("filtered"))
    return state


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


class FieldCheckpointer:
    """Checkpoint stream for one claimed field.

    save() is safe to hand to the engine as checkpoint_cb (it is invoked from
    the collector thread); load()/delete() run on the client main thread
    between fields, never concurrently with save().
    """

    def __init__(self, ckpt_dir: str, data: DataToClient, mode: SearchMode,
                 backend: str, batch_size: int | None, device="cuda"):
        self.dir = ckpt_dir
        self.data = data
        self.mode = mode
        self.signature = plan_signature(mode, data.base, backend, batch_size,
                                        device)
        os.makedirs(ckpt_dir, exist_ok=True)
        self.path = os.path.join(ckpt_dir, f"claim-{data.claim_id}.ckpt")
        self.saves = 0

    # -- write side (engine checkpoint_cb) --------------------------------

    def save(self, state: dict) -> None:
        manifest, arrays = _state_to_snapshot(state)
        manifest["signature"] = self.signature
        manifest["field"] = self.data.to_json()
        nbytes = write_snapshot(self.path, manifest, arrays)
        self.saves += 1
        CKPT_WRITES.inc()
        CKPT_BYTES.inc(nbytes)
        flight.record(
            "checkpoint", claim=self.data.claim_id,
            cursor=str(manifest["cursor"]), bytes=nbytes,
        )
        journal.record_client_event(
            "ckpt_save", claim_id=self.data.claim_id,
            cursor=str(manifest["cursor"]), bytes=nbytes,
        )
        log.debug(
            "checkpoint: claim %d cursor %s (%d bytes)",
            self.data.claim_id, manifest["cursor"], nbytes,
        )

    # -- read side ---------------------------------------------------------

    def load(self) -> Optional[dict]:
        """Validated resume state, or None (no snapshot / rejected one).

        A rejected snapshot is deleted so the scan restarts cleanly and the
        next checkpoint overwrites nothing stale."""
        t0 = time.monotonic()
        try:
            manifest, arrays = read_snapshot(self.path)
        except FileNotFoundError:
            return None
        except SnapshotError as e:
            log.warning("rejecting snapshot %s: %s", self.path, e)
            CKPT_REJECTED.labels(e.reason).inc()
            self.delete()
            return None
        reason = self.mismatch(manifest)
        if reason is not None:
            log.warning(
                "rejecting snapshot %s (%s): plan signature/field mismatch "
                "(snapshot %s/%s, current %s/%s)",
                self.path, reason, manifest.get("signature"),
                manifest.get("field"), self.signature, self.data.to_json(),
            )
            CKPT_REJECTED.labels(reason).inc()
            self.delete()
            return None
        flight.record(
            "restore", claim=self.data.claim_id,
            cursor=str(manifest.get("cursor")),
        )
        state = _snapshot_to_state(manifest, arrays)
        # secs covers read + validation + state reconstruction: the
        # ckpt_resume segment of the field's critical-path waterfall.
        journal.record_client_event(
            "ckpt_resume", claim_id=self.data.claim_id,
            cursor=str(manifest.get("cursor")),
            secs=round(time.monotonic() - t0, 6),
        )
        return state

    def mismatch(self, manifest: dict) -> Optional[str]:
        """None when the manifest matches this field and signature, else the
        reason it is rejected: "state_version" for the same plan under
        another state contract, "signature" for anything else."""
        if (manifest.get("signature") == self.signature
                and manifest.get("field") == self.data.to_json()):
            return None
        snap_sig = manifest.get("signature")
        if (isinstance(snap_sig, dict)
                and manifest.get("field") == self.data.to_json()
                and {k: v for k, v in snap_sig.items() if k != "state"}
                == {k: v for k, v in self.signature.items() if k != "state"}):
            return "state_version"
        return "signature"

    def delete(self) -> None:
        _remove(self.path)


def find_resumable(
    ckpt_dir: str, mode: SearchMode, backend: str, batch_size: int | None,
    device="cuda",
) -> Optional[tuple[DataToClient, dict, "FieldCheckpointer"]]:
    """Startup scan: newest snapshot in ckpt_dir whose plan signature matches
    the current configuration. Returns (field, resume_state, checkpointer) or
    None. Snapshots that fail structural validation are rejected and removed;
    signature mismatches (e.g. a niceonly snapshot found by a detailed
    client) are left alone — another configuration may still resume them."""
    paths = sorted(
        glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt")),
        key=os.path.getmtime,
        reverse=True,
    )
    for path in paths:
        try:
            manifest, arrays = read_snapshot(path)
        except FileNotFoundError:
            continue
        except SnapshotError as e:
            log.warning("rejecting snapshot %s: %s", path, e)
            CKPT_REJECTED.labels(e.reason).inc()
            _remove(path)
            continue
        try:
            data = DataToClient.from_json(manifest["field"])
        except (KeyError, TypeError, ValueError):
            log.warning("rejecting snapshot %s: malformed field record", path)
            CKPT_REJECTED.labels("corrupt").inc()
            _remove(path)
            continue
        ckptr = FieldCheckpointer(ckpt_dir, data, mode, backend, batch_size,
                                  device)
        if manifest.get("signature") != ckptr.signature:
            log.info(
                "snapshot %s has a different plan signature; not resuming it "
                "under this configuration", path,
            )
            continue
        return data, _snapshot_to_state(manifest, arrays), ckptr
    return None
