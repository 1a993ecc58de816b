"""Synthetic stereo scenes with exact ground truth (numpy).

The same code as ``stereo_match_tpu/data/synthetic.py``: that module's
package imports JAX, which the port must not load, so the scene functions
live here too. The same seed gives the same images in both packages.
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


def box_scene(height: int = 120, width: int = 160,
              background: float = 4.0, foreground: float = 12.0) -> np.ndarray:
    """GT disparity: a raised box on a constant-depth background."""
    gt = np.full((height, width), background, np.float32)
    gt[height // 4: 3 * height // 4, width // 3: 3 * width // 4] = foreground
    return gt


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


def multi_box_scene(height: int = 120, width: int = 160,
                    background: float = 8.0,
                    boxes=((0.1, 0.15, 0.35, 0.45, 60.0),
                           (0.55, 0.5, 0.85, 0.9, 90.0),
                           (0.2, 0.6, 0.45, 0.8, 40.0))) -> np.ndarray:
    """GT disparity: several raised boxes (large occlusions at each left
    edge — the disparity jump hides `fg - bg` columns in the right view)."""
    gt = np.full((height, width), background, np.float32)
    for y0, x0, y1, x1, d in boxes:
        gt[int(y0 * height):int(y1 * height),
           int(x0 * width):int(x1 * width)] = d
    return gt


def adversarial_pair(height: int, width: int, gt_disparity: np.ndarray,
                     seed: int = 0, blur: float = 1.0,
                     flat_bands: int = 0, flat_width: float = 0.08,
                     periodic_bands: int = 0, period: int = 16,
                     gain: float = 1.0, bias: float = 0.0,
                     vignette: float = 0.0,
                     noise_left: float = 0.0,
                     noise_right: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Adversarial stereo pair: the failure modes real scenes have.

    Built on the :func:`random_dot_pair` geometry (same painter's-order
    occlusion handling) with a structured world texture and asymmetric
    photometry:

    * ``flat_bands`` horizontal TEXTURELESS bands (constant intensity) of
      ``flat_width`` x height each — matching is ill-posed inside them;
    * ``periodic_bands`` vertical bands of horizontally PERIODIC texture
      (period ``period`` px) — every multiple-of-period disparity is a
      plausible match (repeated-facade aliasing);
    * photometric asymmetry applied to the RIGHT view only: ``gain`` /
      ``bias`` (exposure mismatch) and ``vignette`` (radial falloff,
      0..1) — violates brightness constancy;
    * independent sensor noise per view.
    """
    rng = np.random.default_rng(seed)
    gt = np.asarray(gt_disparity)
    pad = int(np.ceil(gt.max())) + 8
    wp = width + pad
    tex = rng.uniform(0, 255, size=(height, wp)).astype(np.float32)
    if blur > 0:
        r = max(1, int(3 * blur))
        xs = np.arange(-r, r + 1)
        k = np.exp(-0.5 * (xs / blur) ** 2)
        k /= k.sum()
        tex = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, tex)
        tex = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, tex)
    for i in range(flat_bands):
        y0 = int((i + 0.5) * height / max(flat_bands, 1))
        y1 = min(height, y0 + max(2, int(flat_width * height)))
        tex[y0:y1, :] = float(rng.uniform(60, 200))
    for i in range(periodic_bands):
        x0 = int((i + 0.35) * wp / max(periodic_bands, 1))
        x1 = min(wp, x0 + wp // (3 * max(periodic_bands, 1)))
        xs = np.arange(wp)[None, :]
        stripes = 127.5 + 110.0 * np.sin(2 * np.pi * xs / period)
        tex[:, x0:x1] = np.broadcast_to(stripes, tex.shape)[:, x0:x1]

    left = tex[:, pad:pad + width].copy()
    right = np.full((height, width), -1.0, np.float32)
    depth_order = np.argsort(gt, axis=None)
    ys, xs = np.unravel_index(depth_order, gt.shape)
    xr = (xs - np.round(gt[ys, xs])).astype(int)
    ok = (xr >= 0) & (xr < width)
    right[ys[ok], xr[ok]] = left[ys[ok], xs[ok]]
    holes = right < 0
    right[holes] = rng.uniform(0, 255, size=int(holes.sum()))

    if gain != 1.0 or bias != 0.0:
        right = gain * right + bias
    if vignette > 0:
        yy = (np.arange(height)[:, None] - height / 2) / (height / 2)
        xx = (np.arange(width)[None, :] - width / 2) / (width / 2)
        right = right * (1.0 - vignette * (yy ** 2 + xx ** 2) / 2.0)
    if noise_left > 0:
        left = left + rng.normal(0, noise_left, left.shape).astype(np.float32)
    if noise_right > 0:
        right = right + rng.normal(0, noise_right,
                                   right.shape).astype(np.float32)
    return (np.clip(left, 0, 255).astype(np.float32),
            np.clip(right, 0, 255).astype(np.float32))


def shaded_shapes_pair(height: int, width: int, gt_disparity: np.ndarray,
                       seed: int = 0,
                       noise_saltpepper: float = 0.0,
                       gain_right: float = 1.0,
                       tex_scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """A DIFFERENT renderer family for out-of-distribution evaluation.

    Unlike :func:`random_dot_pair`/:func:`adversarial_pair` (dense i.i.d.
    dot texture + gaussian noise), this composes large smooth structures:
    low-frequency blobs, linear gradients, and sparse bright speckles,
    with disparity-proportional Lambertian-ish shading — then corrupts
    with SALT-AND-PEPPER noise and a right-view gain. Models trained on
    the dot renderer have seen none of these statistics (used for the
    MC-CNN out-of-renderer transfer check, VERDICT round 2 #7).

    ``tex_scale`` scales the structures (blob radii, speckle size and
    density) with resolution, the way a higher-resolution camera sees
    the SAME world: rendering at KITTI width with ``tex_scale = W/160``
    then downsampling 7.8x reproduces the statistics of a native-width
    render — the resolution-consistency the monodepth train/eval
    protocol relies on.
    """
    rng = np.random.default_rng(seed)
    gt = np.asarray(gt_disparity)
    pad = int(np.ceil(gt.max())) + 8
    wp = width + pad
    yy = np.arange(height)[:, None]
    xx = np.arange(wp)[None, :]
    tex = 40.0 + 50.0 * (xx / wp) + 30.0 * (yy / height)
    for _ in range(60):           # smooth blobs
        cy, cx = rng.uniform(0, height), rng.uniform(0, wp)
        s = rng.uniform(6, 30) * tex_scale
        a = rng.uniform(-60, 60)
        tex = tex + a * np.exp(-(((yy - cy) / s) ** 2 + (((xx - cx) / s) ** 2)))
    ns = max(30, int(height * wp // 300 / max(tex_scale, 1.0) ** 2))
    sy = rng.integers(0, height, ns)
    sx = rng.integers(0, wp, ns)
    k = max(1, int(round(tex_scale)))
    for dy2 in range(k):           # speckles scale with resolution too
        for dx2 in range(k):
            tex[np.clip(sy + dy2, 0, height - 1),
                np.clip(sx + dx2, 0, wp - 1)] = 255.0
    tex = np.clip(tex, 0, 255).astype(np.float32)

    rel = gt / max(float(gt.max()), 1e-6)
    left = tex[:, pad:pad + width] * (0.6 + 0.4 * rel)
    right = np.full((height, width), -1.0, np.float32)
    depth_order = np.argsort(gt, axis=None)
    ys, xs = np.unravel_index(depth_order, gt.shape)
    xr = (xs - np.round(gt[ys, xs])).astype(int)
    ok = (xr >= 0) & (xr < width)
    right[ys[ok], xr[ok]] = left[ys[ok], xs[ok]]
    holes = right < 0
    right[holes] = float(np.median(left))
    right = right * gain_right
    if noise_saltpepper > 0:
        for img in (left, right):
            m = rng.uniform(size=img.shape)
            img[m < noise_saltpepper / 2] = 0.0
            img[m > 1 - noise_saltpepper / 2] = 255.0
    return (np.clip(left, 0, 255).astype(np.float32),
            np.clip(right, 0, 255).astype(np.float32))
