"""The yardstick of the device step: the least work the tables' statistics
need, counted from the traffic's shapes and the reference's areas, never
from any kernel's tensors, and the least time the card could take for it.

Bytes: each ROI pixel of each input channel read once at its stored width,
and each ROI's packed row written once.  Operations: ``ops_per_px`` float32
operations per ROI pixel (the configuration states what it counts).
"""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def tables_work(areas, work: dict, n_channels: int) -> dict:
    """{"bytes", "ops"} of one unit of a tables configuration."""
    px = int(sum(areas))
    return {"bytes": px * n_channels * int(work["bytes_per_px"])
            + len(areas) * int(work["out_bytes_per_roi"]),
            "ops": px * float(work["ops_per_px"])}


def peak(kind: str):
    """The card's peaks by ``torch.cuda.get_device_name()``, or None."""
    with open(PEAKS, encoding="utf-8") as f:
        return json.load(f).get(kind)


def least_seconds(bytes_: float, ops: float, pk: dict) -> float:
    """The larger of the bytes at the memory rate and the operations at the
    float32 rate."""
    return max(bytes_ / pk["hbm_bytes_per_s"], ops / pk["f32_flops_per_s"])
