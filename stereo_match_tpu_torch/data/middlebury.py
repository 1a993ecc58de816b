"""Middlebury stereo loader (PFM disparity + calib files; numpy, the same
code as ``stereo_match_tpu/data/middlebury.py``, whose package imports JAX).

Supports the accuracy-parity evaluation on Middlebury pairs (BASELINE.md).
No reference equivalent; the reference's informal oracle was the OpenCV
``aloe`` sample pair (``try_try.py:56-57``).
"""

from __future__ import annotations

import os
import re

import numpy as np

from stereo_match_tpu_torch.data.image import image_read


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file (Middlebury GT disparity format)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        channels = 3 if header == "PF" else 1
        dims = f.readline().decode("ascii").strip()
        while dims.startswith("#"):
            dims = f.readline().decode("ascii").strip()
        w, h = map(int, dims.split())
        scale = float(f.readline().decode("ascii").strip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, dtype=endian + "f4", count=w * h * channels)
    data = data.reshape(h, w, channels) if channels > 1 else data.reshape(h, w)
    # PFM rows are stored bottom-up.
    return np.flipud(data).copy()


def write_pfm(path: str, image: np.ndarray) -> None:
    img = np.asarray(image, np.float32)
    channels = img.shape[2] if img.ndim == 3 else 1
    with open(path, "wb") as f:
        f.write(b"PF\n" if channels == 3 else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode("ascii"))
        f.write(b"-1.0\n")
        np.flipud(img).astype("<f4").tofile(f)


def read_calib(path: str) -> dict:
    """Parse a Middlebury ``calib.txt`` (cam0/cam1 matrices, ndisp, etc.)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            val = val.strip()
            if val.startswith("["):
                rows = [r.strip() for r in val.strip("[]").split(";")]
                out[key.strip()] = np.array(
                    [[float(x) for x in re.split(r"\s+", r) if x] for r in rows])
            else:
                try:
                    out[key.strip()] = float(val) if "." in val else int(val)
                except ValueError:
                    out[key.strip()] = val
    return out


def load_middlebury_pair(scene_dir: str):
    """Returns (left RGB, right RGB, gt disparity or None, calib dict)."""
    left = image_read(os.path.join(scene_dir, "im0.png"))
    right = image_read(os.path.join(scene_dir, "im1.png"))
    gt_path = os.path.join(scene_dir, "disp0.pfm")
    gt = None
    if os.path.isfile(gt_path):
        gt = read_pfm(gt_path)
        gt[~np.isfinite(gt)] = np.nan
    calib_path = os.path.join(scene_dir, "calib.txt")
    calib = read_calib(calib_path) if os.path.isfile(calib_path) else {}
    return left, right, gt, calib
