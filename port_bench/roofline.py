"""A layer's least time on the card from its work and the peaks."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def load_peaks() -> dict:
    return json.loads(PEAKS.read_text())


def least_seconds(work: dict, peaks: dict) -> float:
    """The larger of the bytes' time at the HBM rate and the operations'
    time: float32 products on the TF32 tensor-core peak (no float32-exact
    method beats it), other operations on the FP32 peak."""
    t_bytes = work.get("bytes", 0.0) / peaks["hbm_bytes_per_s"]
    t_ops = (work.get("tf32_flop", 0.0) / peaks["tf32_flop_per_s"]
             + work.get("flop", 0.0) / peaks["fp32_flop_per_s"])
    return max(t_bytes, t_ops)
