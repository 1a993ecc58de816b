"""Camera calibration from planar (chessboard) views: Zhang's method.

Counterpart of ``stereo_match_tpu/core/calibration.py``, which covers the
reference's calibration experiment (``try_try.py:109-191``,
``cv2.findChessboardCorners`` + ``cv2.calibrateCamera``) from scratch:
per-view homographies (normalized DLT), closed-form intrinsics from the
absolute-conic constraints, extrinsics recovery, and joint nonlinear
refinement of intrinsics, k1/k2 distortion and poses (scipy
``least_squares``). The calibration math is the JAX package's float64 host
numpy as it is; corner detection goes through OpenCV, imported at the
call. :func:`undistort_image` warps with the port's own
``core/rectify.remap_bilinear`` on the caller's device (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from stereo_match_tpu_torch.core.camera import rodrigues, rotation_to_vector
from stereo_match_tpu_torch.utils.backend import entry_device


@dataclass
class CalibrationResult:
    K: np.ndarray                    # 3x3 intrinsics
    dist: np.ndarray                 # (k1, k2) radial distortion
    rvecs: list = field(default_factory=list)   # per-view rotation vectors
    tvecs: list = field(default_factory=list)   # per-view translations
    rms: float = 0.0                 # reprojection RMS in pixels


def chessboard_object_points(cols: int, rows: int, square: float = 1.0) -> np.ndarray:
    """(cols*rows, 2) planar grid coordinates (Z = 0 implied)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64) * square


def find_chessboard_corners(image: np.ndarray, pattern: tuple[int, int]):
    """Detect inner chessboard corners (cv2-backed; None if not found)."""
    try:
        import cv2
    except Exception:
        return None
    gray = image if image.ndim == 2 else cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    found, corners = cv2.findChessboardCorners(gray, pattern)
    if not found:
        return None
    corners = cv2.cornerSubPix(
        gray, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 0.01))
    return corners.reshape(-1, 2).astype(np.float64)


def _normalize_points(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Similarity transform to zero-mean, sqrt(2) RMS (Hartley)."""
    mean = pts.mean(axis=0)
    scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - mean, axis=1)), 1e-12)
    T = np.array([[scale, 0, -scale * mean[0]],
                  [0, scale, -scale * mean[1]],
                  [0, 0, 1]])
    homog = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (T @ homog.T).T[:, :2], T


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Planar homography dst ~ H src via the normalized DLT."""
    sn, Ts = _normalize_points(np.asarray(src, np.float64))
    dn, Td = _normalize_points(np.asarray(dst, np.float64))
    n = len(sn)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = sn[i]
        u, v = dn[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def _intrinsics_from_homographies(Hs: list[np.ndarray]) -> np.ndarray:
    """Closed-form K from >= 3 homographies (absolute-conic constraints)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.asarray(V)
    _, _, vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam
    return np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1]])


def _extrinsics_from_homography(K: np.ndarray, H: np.ndarray):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    t = lam * (Kinv @ h3)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    # project to the nearest rotation
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:       # plane must be in front of the camera
        R[:, :2] *= -1
        t = -t
    return rotation_to_vector(R), t


def _project(params, obj_pts, n_views):
    """Reprojection of all views given the packed parameter vector."""
    fx, fy, cx, cy, k1, k2 = params[:6]
    out = []
    for i in range(n_views):
        rt = params[6 + 6 * i: 12 + 6 * i]
        R = rodrigues(rt[:3])
        t = rt[3:]
        P = (R[:, :2] @ obj_pts.T).T + t     # (n, 3): planar points, Z=0
        x = P[:, 0] / P[:, 2]
        y = P[:, 1] / P[:, 2]
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        out.append(np.stack([fx * x * rad + cx, fy * y * rad + cy], axis=-1))
    return np.concatenate(out, axis=0)


def calibrate_camera(object_points: np.ndarray,
                     image_points: list[np.ndarray],
                     refine: bool = True) -> CalibrationResult:
    """Zhang calibration from n >= 3 views of one planar target.

    ``object_points``: (m, 2) planar target coordinates. ``image_points``:
    list of (m, 2) detected pixel positions per view.
    """
    if len(image_points) < 3:
        raise ValueError("need at least 3 views for closed-form intrinsics")
    obj = np.asarray(object_points, np.float64)
    Hs = [homography_dlt(obj, ip) for ip in image_points]
    K = _intrinsics_from_homographies(Hs)
    rvecs, tvecs = [], []
    for H in Hs:
        r, t = _extrinsics_from_homography(K, H)
        rvecs.append(r)
        tvecs.append(t)

    dist = np.zeros(2)
    if refine:
        from scipy.optimize import least_squares
        n_views = len(image_points)
        x0 = np.concatenate(
            [[K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.0, 0.0]]
            + [np.concatenate([rvecs[i], tvecs[i]]) for i in range(n_views)])
        target = np.concatenate(image_points, axis=0)

        def residual(p):
            return (_project(p, obj, n_views) - target).ravel()

        sol = least_squares(residual, x0, method="lm", max_nfev=200)
        p = sol.x
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
        dist = p[4:6].copy()
        rvecs = [p[6 + 6 * i: 9 + 6 * i] for i in range(n_views)]
        tvecs = [p[9 + 6 * i: 12 + 6 * i] for i in range(n_views)]
        rms = float(np.sqrt(np.mean(residual(p) ** 2)))
    else:
        res = np.concatenate(
            [_project(np.concatenate([[K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0],
                                      np.concatenate([rvecs[i], tvecs[i]])]),
                      obj, 1) - image_points[i]
             for i in range(len(image_points))], axis=0)
        rms = float(np.sqrt(np.mean(res ** 2)))

    return CalibrationResult(K=K, dist=dist, rvecs=rvecs, tvecs=tvecs, rms=rms)


def undistort_image(image, K: np.ndarray, dist: np.ndarray,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """Remove radial distortion (k1, k2) with the port's remap: the
    (H, W) or (H, W, C) image resampled on ``device``, a tensor of the
    image's dtype there."""
    from stereo_match_tpu_torch.core.rectify import (rectification_maps,
                                                     remap_bilinear)
    device = entry_device(device)
    h, w = np.asarray(image).shape[:2]
    d5 = np.array([dist[0], dist[1] if len(dist) > 1 else 0.0, 0, 0, 0])
    P = np.hstack([K, np.zeros((3, 1))])
    mx, my = rectification_maps(K, np.eye(3), P, (w, h), d5, device=device)
    return remap_bilinear(torch.as_tensor(np.asarray(image)), mx, my)
