"""Raw disparity maps from host images: cost, SGM, WTA (plain PyTorch)."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.census import census_volume
from port_bench.reference.mccnn import load_tower, mccnn_volume
from port_bench.reference.sgm import sgm_total
from port_bench.reference.wta import winner_take_all

PRECISIONS = ("float32", "bfloat16", "tf32")


def penalties(cfg: dict) -> tuple[float, float]:
    """P1 and P2: the configuration's, or for a census-scaled cost (census
    and MC-CNN) (bits / 3, 4 bits) with bits the census window's pixels
    but the centre, as the program's defaults are documented."""
    wh, ww = cfg.get("census_window", (5, 5))
    bits = wh * ww - 1
    p1 = cfg.get("p1")
    p2 = cfg.get("p2")
    return (bits / 3.0 if p1 is None else float(p1),
            bits * 4.0 if p2 is None else float(p2))


def disparity_maps(lefts: np.ndarray, rights: np.ndarray, cfg: dict,
                   device, precision: str = "float32", block: int = 4,
                   weights=None) -> np.ndarray:
    """(N, H, W) host images -> (N, H, W) float32 raw maps, NaN invalid.

    ``cfg`` is a benchmark configuration (``configs/<name>.json``): its
    ``cost`` ("census" or "mccnn"), ``num_disparities``, ``min_disparity``,
    ``census_window``, ``num_paths``, ``p1``, ``p2``, ``uniqueness_ratio``,
    ``disp12_max_diff``, ``subpixel``; for MC-CNN ``weights`` (a path to
    the flax-layout ``.npz``) and ``scale``. Frames run ``block`` at a
    time on ``device``. WLS does not touch the raw map; a speckle filter
    does, and is refused.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if cfg.get("speckle_window_size", 0) > 0:
        raise ValueError("the raw map is speckle-filtered and this "
                         "reference has no speckle filter")
    D, md = int(cfg["num_disparities"]), int(cfg["min_disparity"])
    p1, p2 = penalties(cfg)
    tower = load_tower(weights, device) if cfg["cost"] == "mccnn" else None
    vol_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    out = []
    for lo in range(0, len(lefts), block):
        l = torch.as_tensor(lefts[lo:lo + block], dtype=torch.float32,
                            device=device)
        r = torch.as_tensor(rights[lo:lo + block], dtype=torch.float32,
                            device=device)
        if cfg["cost"] == "census":
            cost = census_volume(l, r, D, md, tuple(cfg["census_window"]),
                                 vol_dtype)
        elif cfg["cost"] == "mccnn":
            cost = mccnn_volume(l, r, tower, D, md, float(cfg["scale"]),
                                precision == "tf32").to(vol_dtype)
        else:
            raise ValueError(f"cost {cfg['cost']!r}: the reference has "
                             "census and mccnn")
        total = sgm_total(cost, p1, p2, int(cfg["num_paths"]))
        del cost
        out.append(winner_take_all(
            total, md, int(cfg["uniqueness_ratio"]),
            int(cfg["disp12_max_diff"]), bool(cfg["subpixel"])).cpu())
        del total
    return torch.cat(out).numpy()
