"""Seeded stereo pairs for the benchmark's traffic (numpy only).

``random_dot_pair`` is a frozen copy of
``stereo_match_tpu_torch/data/synthetic.py::random_dot_pair``: the
benchmark keeps its own so that a change to the program's data module
cannot change what is measured. ``street_disparity`` composes a KITTI-like
ground truth from a seed: a far background, a ground plane whose disparity
grows towards the bottom rows, and a few fronto-parallel boxes (vehicles,
poles). Every pair has the same size; only the content follows the seed.
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


def street_disparity(height: int, width: int, rng: np.random.Generator,
                     max_disparity: float, boxes: int = 4) -> np.ndarray:
    """A KITTI-like float32 ground truth, every value in [1, max_disparity].

    The background sits at 2-6 px; below a horizon at 35-50 % of the
    height a ground plane rises linearly to 0.55-0.8 of ``max_disparity``
    at the bottom row; ``boxes`` fronto-parallel boxes stand on it at
    8-65 % of ``max_disparity``.
    """
    gt = np.full((height, width), rng.uniform(2.0, 6.0), np.float32)
    horizon = int(height * rng.uniform(0.35, 0.5))
    bottom = max_disparity * rng.uniform(0.55, 0.8)
    rows = np.arange(height - horizon, dtype=np.float32)
    ramp = gt[0, 0] + (bottom - gt[0, 0]) * rows / max(len(rows) - 1, 1)
    gt[horizon:] = np.maximum(gt[horizon:], ramp[:, None])
    for _ in range(boxes):
        d = max_disparity * rng.uniform(0.08, 0.65)
        h = int(height * rng.uniform(0.12, 0.35))
        w = int(width * rng.uniform(0.04, 0.2))
        y1 = int(rng.uniform(horizon, height))
        x0 = int(rng.uniform(0, width - w))
        gt[max(0, y1 - h):y1, x0:x0 + w] = np.maximum(
            gt[max(0, y1 - h):y1, x0:x0 + w], d)
    return np.clip(gt, 1.0, max_disparity)


def pair_seed(seed: int, index: int) -> np.random.SeedSequence:
    """The seed sequence of pair ``index`` under a run's ``--seed`` (any
    whole number; negative ones are taken modulo 2**64)."""
    return np.random.SeedSequence([seed % 2 ** 64, index])


def make_pool(seed: int, count: int, height: int, width: int,
              max_disparity: float, noise: float,
              boxes: int) -> tuple[np.ndarray, np.ndarray]:
    """``count`` seeded 8-bit grayscale pairs: (count, H, W) uint8 lefts
    and rights, as a camera delivers them."""
    lefts = np.empty((count, height, width), np.uint8)
    rights = np.empty_like(lefts)
    for i in range(count):
        rng = np.random.default_rng(pair_seed(seed, i))
        gt = street_disparity(height, width, rng, max_disparity, boxes)
        texture_seed = int(rng.integers(0, 2 ** 63))
        left, right = random_dot_pair(height, width, gt, seed=texture_seed,
                                      noise=noise)
        lefts[i] = np.rint(left).astype(np.uint8)
        rights[i] = np.rint(right).astype(np.uint8)
    return lefts, rights
