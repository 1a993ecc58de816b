"""What decides ``correct``: the window's raw maps against the reference.

The numbers compared (``checks/<config>.json`` gives each its limit):

* ``mismatch_pct``: over the compared frames, the largest share (%) of a
  frame's pixels at which the program and the reference disagree: one map
  is NaN (invalid) where the other is not, or both are valid and differ
  by more than ``tol_px``.
* ``frames_missing``: compared frames whose map never came or has another
  shape than the frame (limit 0).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import maps_for


def mismatch_pct(got: np.ndarray, want: np.ndarray, tol_px: float) -> float:
    gi, wi = np.isnan(got), np.isnan(want)
    with np.errstate(invalid="ignore"):
        far = ~gi & ~wi & (np.abs(got - want) > tol_px)
    return 100.0 * float(np.mean((gi != wi) | far))


def compare(samples: list[tuple[int, np.ndarray | None]], lefts, rights,
            cfg: dict, checks: dict, device, root,
            precision: str = "float32") -> dict:
    """``samples``: (pool index, the program's map for that pair). Returns
    {number: {"value", "limit"}}; the reference runs once per pair."""
    pairs = sorted({p for p, _ in samples})
    weights = root / cfg["weights"] if "weights" in cfg else None
    ref = maps_for(checks)(lefts[pairs], rights[pairs], cfg, device,
                           precision=precision, block=checks["block"],
                           weights=weights)
    ref = dict(zip(pairs, ref))
    tol = checks["tol_px"]
    worst, missing = 0.0, 0
    for p, got in samples:
        if got is None or got.shape != ref[p].shape:
            missing += 1
            continue
        worst = max(worst, mismatch_pct(got, ref[p], tol))
    return {"mismatch_pct": {"value": worst,
                             "limit": checks["limits"]["mismatch_pct"]},
            "frames_missing": {"value": missing, "limit": 0}}


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
