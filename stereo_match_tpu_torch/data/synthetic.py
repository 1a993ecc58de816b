"""Synthetic stereo scenes with exact ground truth (numpy).

The same code as ``stereo_match_tpu/data/synthetic.py``: that module's
package imports JAX, which the port must not load, so the scene functions
the port's checks use live here too. The same seed gives the same
images in both packages.
"""

from __future__ import annotations

import numpy as np


def random_dot_pair(height: int, width: int, gt_disparity: np.ndarray,
                    seed: int = 0, blur: float = 1.0,
                    noise: float = 0.0,
                    shading: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Render a (left, right) pair from a world texture and a GT disparity.

    Convention: d = x_left - x_right >= 0; right[y, x - d] = left[y, x].
    Occluded right pixels keep the farthest (smallest-d) contributor.
    ``shading`` in [0, 1] modulates brightness by disparity (closer =
    brighter) before the right view is painted. Returns float32 images in
    [0, 255].
    """
    rng = np.random.default_rng(seed)
    gt = np.asarray(gt_disparity)
    pad = int(np.ceil(gt.max())) + 8
    tex = rng.uniform(0, 255, size=(height, width + pad)).astype(np.float32)
    if blur > 0:
        r = max(1, int(3 * blur))
        xs = np.arange(-r, r + 1)
        k = np.exp(-0.5 * (xs / blur) ** 2)
        k /= k.sum()
        tex = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, tex)
        tex = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, tex)
    left = tex[:, pad:pad + width].copy()
    if shading > 0:
        rel = gt / max(float(gt.max()), 1e-6)
        left = left * (1.0 - shading + shading * rel)

    right = np.full((height, width), -1.0, np.float32)
    depth_order = np.argsort(gt, axis=None)  # paint far (small d) first
    ys, xs = np.unravel_index(depth_order, gt.shape)
    xr = (xs - np.round(gt[ys, xs])).astype(int)
    ok = (xr >= 0) & (xr < width)
    right[ys[ok], xr[ok]] = left[ys[ok], xs[ok]]
    holes = right < 0              # never-seen pixels get fresh texture
    right[holes] = rng.uniform(0, 255, size=int(holes.sum()))
    if noise > 0:
        left = left + rng.normal(0, noise, left.shape).astype(np.float32)
        right = right + rng.normal(0, noise, right.shape).astype(np.float32)
    return np.clip(left, 0, 255), np.clip(right, 0, 255)


def slanted_scene(height: int = 120, width: int = 160,
                  d_min: float = 2.0, d_max: float = 20.0) -> np.ndarray:
    """GT disparity: a horizontally slanted plane (subpixel everywhere)."""
    ramp = np.linspace(d_min, d_max, width, dtype=np.float32)
    return np.tile(ramp, (height, 1))


def rough_scene(height: int = 120, width: int = 160, seed: int = 0,
                d_min: float = 2.0, d_max: float = 24.0,
                cell: int = 16) -> np.ndarray:
    """GT disparity: smooth random terrain (bilinear-upsampled noise grid).

    The fractal-ish counterpart to the piecewise scenes: continuous
    disparity with slopes in every direction, used for MC-CNN training
    diversity and held-out evaluation.
    """
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (height // cell + 2, width // cell + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, height)
    xs = np.linspace(0, coarse.shape[1] - 1.001, width)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    g = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
         + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
         + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
         + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
    return (d_min + (d_max - d_min) * g).astype(np.float32)
