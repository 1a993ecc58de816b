"""The ``handy_function`` utility surface.

The same code as ``stereo_match_tpu/utils/handy.py`` on the port's modules.

The reference imports a personal utility library (``handy_function``) that is
NOT in its repo; this module provides the same call surface, reconstructed
from the reference's call sites (SURVEY.md §1 L1): npz_load
(``disparity_calculation.py:243``), image_save (:247), image_show
(``rectified_img_cal.py:286``), image_read (``disparity_test.py:73``),
path_join (``build_npz.py:98``), json_read (:184), is_file (:205),
directory_current_get (``rectified_img_cal.py:315``), intrinsic_cal
(``mapTo3D.py:153``), depthTo3D (:154), mesh_to_ply (:159).
"""

from __future__ import annotations

import json
import os

import numpy as np

from stereo_match_tpu_torch.core.camera import intrinsic_from_params
from stereo_match_tpu_torch.core.reproject import depth_to_points
from stereo_match_tpu_torch.data.image import image_read, image_save  # noqa: F401 (re-export)
from stereo_match_tpu_torch.data.ply import write_mesh_ply


def npz_load(path: str, key: str | None = None):
    """Load an npz archive; with ``key``, return that entry."""
    data = np.load(path, allow_pickle=True)
    if key is not None:
        return data[key]
    return data


def npz_save(path: str, **arrays) -> str:
    np.savez(path, **arrays)
    return path


def json_read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def json_write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def path_join(*parts: str) -> str:
    return os.path.join(*parts)


def is_file(path: str) -> bool:
    return os.path.isfile(path)


def is_directory(path: str) -> bool:
    return os.path.isdir(path)


def directory_current_get() -> str:
    return os.getcwd()


def image_show(image, title: str = "image") -> None:
    """Display an image (matplotlib; no-op if unavailable/headless)."""
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        plt.figure(title)
        plt.imshow(np.asarray(image), cmap="gray" if np.asarray(image).ndim == 2 else None)
        plt.title(title)
        plt.axis("off")
    except Exception:
        pass


def intrinsic_cal(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """Intrinsic matrix from parameters (``mapTo3D.py:153`` surface)."""
    return intrinsic_from_params(fx, fy, cx, cy)


def depthTo3D(depth, K, pose=None) -> np.ndarray:
    """Depth image -> 3-D points (``mapTo3D.py:154`` surface), numpy."""
    return depth_to_points(depth, K, pose).cpu().numpy()


def mesh_to_ply(path: str, vertices, faces, colors=None) -> None:
    """Triangle mesh -> PLY file (``mapTo3D.py:159`` surface)."""
    write_mesh_ply(path, vertices, faces, colors)
