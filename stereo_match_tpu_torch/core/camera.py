"""Camera models and coordinate conventions (numpy, float64).

The same code as ``stereo_match_tpu/core/camera.py``: that module is numpy
only, but its package's ``__init__`` imports the JAX rectification, which
the port must not load, so the port keeps its own copy. Parity targets:
reference ``build_npz.py:132-175`` (convention change),
``disparity_calculation.py:270-272`` (portrait principal-point swap),
``stereo_vision/stereo_vision.py:80-81`` (relative pose).

All poses are 4x4 camera-to-world matrices in OpenCV camera convention
(x right, y down, z forward) unless stated otherwise.
"""

from __future__ import annotations

import numpy as np

# Basis change from the ARKit *camera* frame to the OpenCV camera frame,
# keyed by device orientation. ARKit cameras: portrait mode has x down,
# y right, z backward; landscape-right matches ARKit world (x right, y up,
# z backward). OpenCV cameras: x right, y down, z forward.
_ARKIT_CAM_TO_CV = {
    "P": np.array([[0.0, 1, 0, 0],
                   [1, 0, 0, 0],
                   [0, 0, -1, 0],
                   [0, 0, 0, 1]]),
    "LR": np.array([[-1.0, 0, 0, 0],
                    [0, 1, 0, 0],
                    [0, 0, -1, 0],
                    [0, 0, 0, 1]]),
    "LL": np.array([[1.0, 0, 0, 0],
                    [0, -1, 0, 0],
                    [0, 0, -1, 0],
                    [0, 0, 0, 1]]),
}

# Basis change from a z-up world (x right, y forward, z up) to the ARKit
# world frame (x right, y up, z backward).
_WORLD_TO_ARKIT_WORLD = np.array([[1.0, 0, 0, 0],
                                  [0, 0, -1, 0],
                                  [0, 1, 0, 0],
                                  [0, 0, 0, 1]])


def arkit_to_opencv_extrinsic(transform: np.ndarray, mode: str = "P") -> np.ndarray:
    """Convert an ARKit camera transform to an OpenCV-convention pose.

    ``transform`` is the 4x4 ARKit camera-to-ARKit-world matrix (row-major;
    callers must transpose ARKit's column-major JSON first). ``mode`` is the
    device orientation: 'P' (portrait), 'LR' (landscape right), anything
    else = landscape left. Returns the camera-to-world pose with a z-up
    world and an OpenCV camera basis. Parity: ``build_npz.py:132-175``.
    """
    cam_basis = _ARKIT_CAM_TO_CV.get(mode, _ARKIT_CAM_TO_CV["LL"])
    return _WORLD_TO_ARKIT_WORLD @ np.asarray(transform, dtype=np.float64) @ cam_basis


def intrinsic_from_params(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def portrait_swap_principal_point(K: np.ndarray) -> np.ndarray:
    """Swap cx/cy of an intrinsic matrix (portrait-capture quirk).

    The reference swaps the principal point for portrait ARKit captures
    because frames are stored rotated (``disparity_calculation.py:270-272``).
    """
    K = np.array(K, dtype=np.float64, copy=True)
    K[0, 2], K[1, 2] = K[1, 2], K[0, 2]
    return K


def relative_pose(pose_l: np.ndarray, pose_r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rotation/translation mapping left-camera points into the right frame.

    ``x_r = R @ x_l + t`` for camera-to-world poses. Parity:
    ``stereo_vision/stereo_vision.py:80-81``.
    """
    Rl, Rr = pose_l[:3, :3], pose_r[:3, :3]
    R = Rr.T @ Rl
    t = Rr.T @ (pose_l[:3, 3] - pose_r[:3, 3])
    return R, t


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector -> rotation matrix (Rodrigues' formula)."""
    r = np.asarray(r, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def rotation_to_vector(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> rotation vector (inverse Rodrigues)."""
    R = np.asarray(R, dtype=np.float64)
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # Near-pi: axis from the symmetric part.
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # Fix signs using off-diagonals.
        i = int(np.argmax(axis))
        if axis[i] > 0:
            for j in range(3):
                if j != i and A[i, j] < 0:
                    axis[j] = -axis[j]
        axis /= max(np.linalg.norm(axis), 1e-12)
        return axis * theta
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    axis /= 2.0 * np.sin(theta)
    return axis * theta


def check_epipoles(K_l: np.ndarray, K_r: np.ndarray,
                   pose_l: np.ndarray, pose_r: np.ndarray,
                   image_shape: tuple[int, int]) -> bool:
    """True when both epipoles fall outside the image (rectifiable pair).

    Parity: ``stereo_vision/stereo_vision.py:12-47``. The epipole in each
    view is the projection of the other camera's center.
    """
    h, w = image_shape[:2]

    def _epipole_inside(K, pose_self, center_other) -> bool:
        Rcw = pose_self[:3, :3].T
        c = Rcw @ (center_other - pose_self[:3, 3])
        if abs(c[2]) < 1e-12:
            return False  # epipole at infinity: outside
        p = K @ (c / c[2])
        return bool(0 <= p[0] < w and 0 <= p[1] < h and c[2] > 0)

    inside_l = _epipole_inside(K_l, pose_l, pose_r[:3, 3])
    inside_r = _epipole_inside(K_r, pose_r, pose_l[:3, 3])
    return not (inside_l or inside_r)
