"""The card's peaks: its 32-bit integer multiply-add rate.

NVIDIA's CUDA C++ Programming Guide, "Arithmetic Instructions" throughput
table: 32-bit integer multiply and multiply-add, 64 results a clock an SM
at compute capability 9.0 (H100). The peak is that figure times the SM count
(torch.cuda.get_device_properties) times the SM's maximum clock
(nvidia-smi clocks.max.sm), all read from the card the run uses. A card
whose capability the table lacks has no peak, and the shares of it are not
reported.
"""

from __future__ import annotations

import subprocess

INT32_MAD_PER_SM_CLOCK = {(9, 0): 64}


def smi(fields: str, index: int = 0) -> list[str] | None:
    """nvidia-smi's csv answer for `fields` on card `index`, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return [v.strip() for v in lines[0].split(",")] if lines else None


def card(index: int = 0) -> dict:
    """{"sms", "capability", "max_sm_mhz", "power_limit_w"} of a card."""
    import torch

    props = torch.cuda.get_device_properties(index)
    info = {"sms": props.multi_processor_count,
            "capability": (props.major, props.minor),
            "max_sm_mhz": None, "power_limit_w": None}
    values = smi("clocks.max.sm,power.limit", index)
    if values:
        for key, v in zip(("max_sm_mhz", "power_limit_w"), values):
            try:
                info[key] = float(v)
            except ValueError:
                pass
    return info


def int32_mad_per_s(info: dict) -> float | None:
    """The card's 32-bit multiply-adds a second, or None."""
    per = INT32_MAD_PER_SM_CLOCK.get(tuple(info["capability"]))
    if per is None or not info.get("max_sm_mhz"):
        return None
    return info["sms"] * info["max_sm_mhz"] * 1e6 * per
