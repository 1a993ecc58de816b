"""Image conversions (numpy).

``to_grayscale`` of ``stereo_match_tpu/data/image.py``, whose package
imports JAX. Images are RGB numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def to_grayscale(image: np.ndarray) -> np.ndarray:
    """RGB -> single-channel luma (ITU-R BT.601, matching cv2.cvtColor)."""
    img = np.asarray(image)
    if img.ndim == 2:
        return img
    w = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    gray = img[..., :3].astype(np.float32) @ w
    if img.dtype == np.uint8:
        return np.round(gray).astype(np.uint8)
    return gray.astype(img.dtype)
