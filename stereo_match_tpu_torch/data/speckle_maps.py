"""Disparity maps for the speckle filter's checks and timings.

``speckled`` puts outlier blobs into a disparity map, as a matcher's
mismatches leave them; ``noisy_ramp`` is a ramp with noise and holes,
whose winding components take tens of sweeps; ``serpentine`` is one
component whose min-label fixpoint takes a sweep for every few turns.
All are seeded or fixed, so every check and every timed tree sees the
same map. This module imports nothing of the package
(``tools/frame_probe.py`` loads it by path to feed other checkouts the
same maps).
"""

from __future__ import annotations

import numpy as np
import torch


def speckled(disp: torch.Tensor, seed: int = 5,
             blobs: int = 600) -> torch.Tensor:
    """``disp`` with ``blobs`` 2x2 and 4x4 outlier blobs (values in [0,
    120)) at places drawn from a seeded CPU generator."""
    out = disp.clone()
    rng = torch.Generator(device="cpu").manual_seed(seed)
    H, W = out.shape
    for k in range(blobs):
        size = 2 if k % 2 else 4
        y = int(torch.randint(0, H - size, (1,), generator=rng))
        x = int(torch.randint(0, W - size, (1,), generator=rng))
        out[y:y + size, x:x + size] = \
            float(torch.rand(1, generator=rng)) * 120
    return out


def noisy_ramp(H: int, W: int, seed: int = 7, holes: float = 0.15,
               blobs: bool = True) -> np.ndarray:
    """A float32 (H, W) ramp from 5 to 60 along x with N(0, 0.3) noise, a
    share ``holes`` of NaN pixels and, with ``blobs``, one 2x2 or 4x4
    outlier blob (values in [0, 100)) for every 400 pixels."""
    rng = np.random.default_rng(seed)
    d = np.tile(np.linspace(5, 60, W, dtype=np.float32), (H, 1))
    d += rng.normal(0, 0.3, (H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < holes] = np.nan
    if blobs:
        for _ in range(H * W // 400):
            y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
            s = int(rng.choice([2, 4]))
            d[y:y + s, x:x + s] = rng.uniform(0, 100)
    return d


def serpentine(H: int, W: int) -> np.ndarray:
    """A float32 (H, W) map of NaN holding one snake of 5.0: the even rows
    whole, each odd row one pixel joining them at alternate ends."""
    d = np.full((H, W), np.nan, np.float32)
    for row in range(0, H, 2):
        d[row, :] = 5.0
        if row + 1 < H:
            d[row + 1, -1 if (row // 2) % 2 == 0 else 0] = 5.0
    return d
