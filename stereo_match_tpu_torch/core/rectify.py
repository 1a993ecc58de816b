"""Epipolar rectification (numpy float64 setup, PyTorch per-pixel warp).

Counterpart of ``stereo_match_tpu/core/rectify.py``, which replaces the
reference's ``cv2.stereoRectify`` + ``initUndistortRectifyMap`` + ``remap``
(``stereo_vision/stereo_vision.py:99-127``):

* :func:`stereo_rectify` — Bouguet's algorithm in float64 numpy, the JAX
  package's code as it is (host-side, once per calibration);
* :func:`rectification_maps` — the per-pixel inverse warp in float32 torch
  on the target device, from a float64 host inverse of ``P[:3,:3] @ R``;
* :func:`remap_bilinear` — bilinear resampling with a zero border.

The alpha semantics match OpenCV: alpha<0 = no scaling, alpha=0 = zoom so
only valid pixels remain, alpha=1 = keep every source pixel. The warp runs
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stereo_match_tpu_torch.core.camera import (check_epipoles, relative_pose,
                                                rodrigues, rotation_to_vector)
from stereo_match_tpu_torch.utils.backend import entry_device


@dataclass
class RectificationResult:
    R1: np.ndarray  # 3x3 rectifying rotation, left
    R2: np.ndarray  # 3x3 rectifying rotation, right
    P1: np.ndarray  # 3x4 new projection, left
    P2: np.ndarray  # 3x4 new projection, right
    Q: np.ndarray   # 4x4 disparity-to-depth matrix

    @property
    def baseline(self) -> float:
        """|Tx| in world units (P2[0,3] = Tx * f)."""
        f = self.P2[0, 0]
        return float(abs(self.P2[0, 3] / f)) if f else 0.0


def _undistort_normalize(pts: np.ndarray, K: np.ndarray, dist: np.ndarray,
                         iters: int = 20) -> np.ndarray:
    """Pixel coords -> normalized undistorted coords (iterative inversion)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (pts[:, 0] - cx) / fx
    y = (pts[:, 1] - cy) / fy
    if not np.any(dist):
        return np.stack([x, y], axis=-1)
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x, y], axis=-1)


def _distort(x: np.ndarray, y: np.ndarray, dist) -> tuple:
    """Apply the radial-tangential distortion model to normalized coords."""
    k1, k2, p1, p2, k3 = (list(np.ravel(dist)) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _valid_rectangles(K: np.ndarray, dist: np.ndarray, R: np.ndarray,
                      P: np.ndarray, image_size: tuple[int, int],
                      n: int = 9) -> tuple[np.ndarray, np.ndarray]:
    """Inner/outer axis-aligned rects of the warped image boundary.

    Samples an n*n grid over the source image, maps each point through
    undistort -> R -> P, and returns (inner, outer) as [x0, y0, x1, y1].
    Inner = largest rect fully inside the warped image; outer = bounding box.
    """
    w, h = image_size
    xs = np.arange(n) * (w - 1) / (n - 1)
    ys = np.arange(n) * (h - 1) / (n - 1)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    norm = _undistort_normalize(pts, K, dist)
    ones = np.ones((norm.shape[0], 1))
    rays = (R @ np.concatenate([norm, ones], axis=-1).T).T
    proj = (P[:3, :3] @ rays.T).T
    uv = proj[:, :2] / proj[:, 2:3]
    u = uv[:, 0].reshape(n, n)
    v = uv[:, 1].reshape(n, n)
    outer = np.array([u.min(), v.min(), u.max(), v.max()])
    inner = np.array([u[:, 0].max(), v[0, :].max(), u[:, -1].min(), v[-1, :].min()])
    return inner, outer


def stereo_rectify(K_l: np.ndarray, K_r: np.ndarray,
                   image_size: tuple[int, int],
                   R: np.ndarray, T: np.ndarray,
                   dist_l: np.ndarray | None = None,
                   dist_r: np.ndarray | None = None,
                   alpha: float = -1.0,
                   zero_disparity: bool = True) -> RectificationResult:
    """Bouguet stereo rectification (OpenCV-compatible semantics).

    ``R``, ``T`` map left-camera points into the right camera frame
    (``x_r = R x_l + T``) as produced by :func:`relative_pose`.
    ``image_size`` is (width, height).

    The construction: split the inter-camera rotation evenly between the two
    views, then rotate both so the new x-axis is parallel to the baseline;
    choose a common focal length and principal points that keep the views
    centered; optionally rescale by ``alpha`` between the all-valid (0) and
    all-pixels (1) croppings.
    """
    dist_l = np.zeros(5) if dist_l is None else np.asarray(dist_l, np.float64).ravel()
    dist_r = np.zeros(5) if dist_r is None else np.asarray(dist_r, np.float64).ravel()
    K_l = np.asarray(K_l, np.float64)
    K_r = np.asarray(K_r, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    w, h = int(image_size[0]), int(image_size[1])

    # Split the rotation: each camera takes half, bringing both to the
    # average orientation.
    om = rotation_to_vector(R)
    r_half = rodrigues(-0.5 * om)
    t = r_half @ T

    # Rotate so the dominant baseline axis (x: horizontal pair, y: vertical
    # pair) aligns with the image axis -> epipolar lines become scanlines.
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if t[idx] > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww *= np.arccos(min(abs(t[idx]) / nt, 1.0)) / nw
    wR = rodrigues(ww)
    R1 = wR @ r_half.T
    R2 = wR @ r_half
    t_new = R2 @ T

    # Common focal length: the smaller of the two cameras' cross-axis
    # focals (shrunk for barrel distortion).
    other = idx ^ 1
    fc_new = np.inf
    for K, dist in ((K_l, dist_l), (K_r, dist_r)):
        fc = K[other, other]
        if dist[0] < 0:
            fc *= 1 + dist[0] * (w * w + h * h) / (4 * fc * fc)
        fc_new = min(fc_new, fc)

    # Principal points: center each view's projected corners.
    cc_new = []
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=np.float64)
    for K, dist, Rk in ((K_l, dist_l, R1), (K_r, dist_r, R2)):
        norm = _undistort_normalize(corners, K, dist)
        rays = (Rk @ np.concatenate([norm, np.ones((4, 1))], axis=-1).T).T
        uv = fc_new * rays[:, :2] / rays[:, 2:3]
        avg = uv.mean(axis=0)
        cc_new.append(np.array([(w - 1) / 2.0, (h - 1) / 2.0]) - avg)
    if zero_disparity:
        cc_mean = (cc_new[0] + cc_new[1]) * 0.5
        cc_new = [cc_mean.copy(), cc_mean.copy()]
    else:
        cc_new[0][other] = cc_new[1][other] = (cc_new[0][other] + cc_new[1][other]) * 0.5

    def make_P(cc):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = cc
        P[2, 2] = 1.0
        return P

    P1 = make_P(cc_new[0])
    P2 = make_P(cc_new[1])
    P2[idx, 3] = t_new[idx] * fc_new

    if alpha >= 0:
        inner1, outer1 = _valid_rectangles(K_l, dist_l, R1, P1, (w, h))
        inner2, outer2 = _valid_rectangles(K_r, dist_r, R2, P2, (w, h))

        def scale_for(rects, reducer):
            vals = []
            for (cc0, rect) in rects:
                cx0, cy0 = cc0
                vals += [cx0 / (cx0 - rect[0]), cy0 / (cy0 - rect[1]),
                         (w - 1 - cx0) / (rect[2] - cx0),
                         (h - 1 - cy0) / (rect[3] - cy0)]
            return reducer(vals)

        s0 = scale_for([(cc_new[0], inner1), (cc_new[1], inner2)], max)
        s1 = scale_for([(cc_new[0], outer1), (cc_new[1], outer2)], min)
        s = s0 * (1 - alpha) + s1 * alpha
        fc_new *= s
        P1 = make_P(cc_new[0])
        P2 = make_P(cc_new[1])
        P2[idx, 3] = t_new[idx] * fc_new

    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cc_new[0][0]
    Q[1, 3] = -cc_new[0][1]
    Q[2, 3] = fc_new
    Q[3, 2] = -1.0 / t_new[idx]
    Q[3, 3] = (cc_new[0][idx] - cc_new[1][idx]) / t_new[idx]

    return RectificationResult(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)


def rectification_maps(K, R, P, image_size: tuple[int, int], dist=None,
                       device: torch.device | str = "cuda"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse warp maps for one view, on ``device``.

    For each rectified pixel, the source-image pixel to sample: rectified
    pixel -> ray via inv(P[:3,:3] @ R) -> distort -> project by K
    (``cv2.initUndistortRectifyMap``). ``image_size`` = (w, h). Returns
    (map_x, map_y), each (h, w) float32.
    """
    device = entry_device(device)
    w, h = image_size
    Kf = np.asarray(K, np.float32)
    # the 3x3 inverse is calibration math: float64 on the host, then
    # float32 for the per-pixel grid
    M = np.linalg.inv(np.asarray(P)[:3, :3].astype(np.float64)
                      @ np.asarray(R).astype(np.float64)).astype(np.float32)
    M = torch.as_tensor(M, device=device)
    uu = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    vv = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    # broadcast arithmetic in full float32, not a matrix product
    xn = M[0, 0] * uu + M[0, 1] * vv + M[0, 2]
    yn = M[1, 0] * uu + M[1, 1] * vv + M[1, 2]
    wn = M[2, 0] * uu + M[2, 1] * vv + M[2, 2]
    x = xn / wn
    y = yn / wn
    if dist is not None and np.any(np.asarray(dist)):
        k1, k2, p1, p2, k3 = (list(np.ravel(np.asarray(dist))) + [0.0] * 5)[:5]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = xd, yd
    map_x = float(Kf[0, 0]) * x + float(Kf[0, 2])
    map_y = float(Kf[1, 1]) * y + float(Kf[1, 2])
    return map_x, map_y


def remap_bilinear(image: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear resample ``image`` at (map_x, map_y); border = 0.

    ``image`` is (H, W) or (H, W, C); maps are (H', W'). Matches
    ``cv2.remap(..., INTER_LINEAR)`` with a constant zero border. Integer
    images are rounded (half to even) back to their type.
    """
    img = torch.as_tensor(image, device=map_x.device)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    imgf = img.to(torch.float32)

    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = (map_x - x0)[..., None]
    fy = (map_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = imgf[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], vals, 0.0)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    if img.dtype.is_floating_point:
        out = out.to(img.dtype)
    else:
        out = torch.round(out).to(img.dtype)
    return out[..., 0] if squeeze else out


def rectify_pair(pose_l: np.ndarray, pose_r: np.ndarray,
                 K_l: np.ndarray, K_r: np.ndarray, image_l, image_r,
                 alpha: float = -1.0,
                 dist_l: np.ndarray | None = None,
                 dist_r: np.ndarray | None = None,
                 check: bool = True, device: torch.device | str = "cuda"):
    """End-to-end pair rectification from camera-to-world poses.

    Capability parity with ``stereo_vision/stereo_vision.py:50-129``.
    Returns (rect_l, rect_r, result), the images as tensors on ``device``.

    ``check`` runs the reference's epipole gate first (``check_epipoles``)
    and raises ``ValueError`` when an epipole falls inside an image (e.g.
    a forward-motion pair, which planar rectification cannot handle).
    """
    device = entry_device(device)
    h, w = np.asarray(image_l).shape[:2]
    if check and not check_epipoles(K_l, K_r, pose_l, pose_r, (h, w)):
        raise ValueError(
            "epipole falls inside an image (forward/backward motion pair): "
            "planar rectification is degenerate for this geometry. Capture "
            "with lateral baseline, or pass check=False to attempt it "
            "anyway.")
    R, t = relative_pose(pose_l, pose_r)
    result = stereo_rectify(K_l, K_r, (w, h), R, t,
                            dist_l=dist_l, dist_r=dist_r, alpha=alpha)
    mx1, my1 = rectification_maps(K_l, result.R1, result.P1, (w, h), dist_l,
                                  device)
    mx2, my2 = rectification_maps(K_r, result.R2, result.P2, (w, h), dist_r,
                                  device)
    rect_l = remap_bilinear(torch.as_tensor(np.asarray(image_l)), mx1, my1)
    rect_r = remap_bilinear(torch.as_tensor(np.asarray(image_r)), mx2, my2)
    return rect_l, rect_r, result
