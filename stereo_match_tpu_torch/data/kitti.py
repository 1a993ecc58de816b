"""KITTI-2015 stereo loader (numpy; the same code as
``stereo_match_tpu/data/kitti.py``, whose package imports JAX).

The benchmark dataset for the framework's headline metric (BASELINE.md:
fps/chip and bad-3px at 1242x375, 128 disparities). No reference
equivalent — the reference only handles ARKit captures — but required by
the test strategy (SURVEY.md §4: golden outputs on KITTI pairs).

Layout expected: ``<root>/image_2/<id>.png`` (left), ``image_3`` (right),
``disp_occ_0`` / ``disp_noc_0`` ground-truth disparity PNGs (uint16, value =
disparity * 256, 0 = invalid).
"""

from __future__ import annotations

import os

import numpy as np

from stereo_match_tpu_torch.data.image import image_read


def _cv2():
    """cv2, which reads and writes the 16-bit PNGs; ImportError naming it."""
    try:
        import cv2
    except ImportError:
        raise ImportError("KITTI's 16-bit disparity PNGs need cv2 "
                          "(opencv-python); it does not import") from None
    return cv2


def read_kitti_disparity(path: str) -> np.ndarray:
    """Ground-truth disparity: uint16 PNG / 256; 0 -> NaN (invalid)."""
    cv2 = _cv2()
    raw = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    disp = raw.astype(np.float32) / 256.0
    disp[raw == 0] = np.nan
    return disp


def write_kitti_disparity(path: str, disparity: np.ndarray) -> None:
    """Write disparity in KITTI submission format (uint16 = d * 256)."""
    cv2 = _cv2()
    d = np.asarray(disparity, np.float32)
    enc = np.where(np.isfinite(d) & (d > 0), d * 256.0, 0.0)
    cv2.imwrite(str(path), np.clip(enc, 0, 65535).astype(np.uint16))


def load_kitti_pair(root: str, frame_id: str, occ: bool = True):
    """Returns (left RGB, right RGB, gt disparity or None) for one frame."""
    left = image_read(os.path.join(root, "image_2", f"{frame_id}.png"))
    right = image_read(os.path.join(root, "image_3", f"{frame_id}.png"))
    gt_dir = "disp_occ_0" if occ else "disp_noc_0"
    gt_path = os.path.join(root, gt_dir, f"{frame_id}.png")
    gt = read_kitti_disparity(gt_path) if os.path.isfile(gt_path) else None
    return left, right, gt


def list_kitti_frames(root: str) -> list[str]:
    d = os.path.join(root, "image_2")
    if not os.path.isdir(d):
        return []
    return sorted(f[:-4] for f in os.listdir(d) if f.endswith(".png") and "_10" in f)
