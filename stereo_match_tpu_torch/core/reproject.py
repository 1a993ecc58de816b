"""Disparity -> depth -> 3-D point reprojection (PyTorch).

Counterpart of ``stereo_match_tpu/core/reproject.py``: replaces
``cv2.reprojectImageTo3D`` (``disparity_calculation.py:302``) with
broadcast float32 arithmetic on the disparity's device.
"""

from __future__ import annotations

import numpy as np
import torch


def make_q_matrix(f: float, cx: float, cy: float, tx: float,
                  cx_prime: float | None = None) -> np.ndarray:
    """Build the 4x4 disparity-to-depth matrix.

    Q maps (u, v, d, 1) -> homogeneous (X, Y, Z, W). ``tx`` is the (signed)
    baseline; the reference hard-codes f=1164, c=(360,640), Tx=-22 variants
    (``disparity_calculation.py:293-299``).
    """
    cx2 = cx if cx_prime is None else cx_prime
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cx
    Q[1, 3] = -cy
    Q[2, 3] = f
    Q[3, 2] = -1.0 / tx
    Q[3, 3] = (cx - cx2) / tx
    return Q


def reproject_image_to_3d(disparity: torch.Tensor, Q,
                          handle_missing: bool = True) -> torch.Tensor:
    """Disparity map (H, W) -> points (H, W, 3) via the Q matrix.

    ``cv2.reprojectImageTo3D`` semantics: each pixel (u, v) with disparity
    d maps through Q as a homogeneous point. With ``handle_missing``,
    non-finite disparities (and W = 0) map to the sentinel 10000 in all
    three coordinates, as cv2 does, so callers can mask them. Q is a
    float32 copy of the given matrix; the arithmetic is broadcast, not a
    matrix product.
    """
    disparity = torch.as_tensor(disparity, dtype=torch.float32)
    H, W = disparity.shape
    dev = disparity.device
    Q = torch.as_tensor(np.asarray(Q, np.float32), device=dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    d = disparity

    def row(i):
        return Q[i, 0] * u + Q[i, 1] * v + Q[i, 2] * d + Q[i, 3]

    X, Y, Z, w0 = row(0), row(1), row(2), row(3)
    safe_w = torch.where(w0.abs() < 1e-12, 1e-12, w0)
    pts = torch.stack([X, Y, Z], dim=-1) / safe_w[..., None]
    if handle_missing:
        bad = ~torch.isfinite(disparity) | (w0.abs() < 1e-12)
        pts = torch.where(bad[..., None], 10000.0, pts)
    return pts


def disparity_to_depth(disparity: torch.Tensor, f: float, baseline: float,
                       eps: float = 1e-6) -> torch.Tensor:
    """Z = f * B / d with non-positive disparities -> 0 depth."""
    d = torch.as_tensor(disparity, dtype=torch.float32)
    z = f * baseline / torch.clamp(d, min=eps)
    return torch.where(d > eps, z, 0.0)
