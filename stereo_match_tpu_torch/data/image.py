"""Image file I/O and conversions (numpy).

The same code as ``stereo_match_tpu/data/image.py``, whose package imports
JAX: the image half of the reference's ``handy_function`` surface. Images
are RGB uint8 numpy arrays (the reference keeps OpenCV BGR; conversion
happens at the file boundary only). Files go through cv2, else PIL, as in
the JAX package; the codec is imported at the first call, and without
either the call raises ImportError naming both.
"""

from __future__ import annotations

import numpy as np


def _codec():
    """("cv2", module) or ("PIL", Image); ImportError without either."""
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return "PIL", Image
    except ImportError:
        raise ImportError("image files need cv2 (opencv-python) or PIL "
                          "(pillow); neither imports") from None


def image_read(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image file as RGB (or single-channel) uint8."""
    name, lib = _codec()
    if name == "cv2":
        flag = lib.IMREAD_GRAYSCALE if grayscale else lib.IMREAD_COLOR
        img = lib.imread(str(path), flag)
        if img is None:
            raise FileNotFoundError(path)
        if not grayscale:
            img = lib.cvtColor(img, lib.COLOR_BGR2RGB)
        return img
    img = lib.open(path)
    img = img.convert("L" if grayscale else "RGB")
    return np.asarray(img)


def image_save(path: str, image: np.ndarray) -> None:
    """Save an RGB / grayscale / float image to disk.

    Float images are min-max normalized to uint8 like the reference's
    disparity dumps (``plot_functions.py:99-100``).
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        img = ((img - lo) * scale).astype(np.uint8)
    name, lib = _codec()
    if name == "cv2":
        out = img
        if img.ndim == 3 and img.shape[2] == 3:
            out = lib.cvtColor(img, lib.COLOR_RGB2BGR)
        if not lib.imwrite(str(path), out):
            raise IOError(f"failed to write {path}")
    else:
        lib.fromarray(img).save(path)


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


def normalize_to_uint8(image: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 255] uint8 (``plot_functions.py:99-100``)."""
    img = np.asarray(image, np.float64)
    lo, hi = np.nanmin(img), np.nanmax(img)
    if hi <= lo:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) * (255.0 / (hi - lo))).astype(np.uint8)
