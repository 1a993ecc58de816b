"""ARKit capture-session ingestion (numpy; the same code as
``stereo_match_tpu/data/arkit.py``, whose package imports JAX, on the
port's ``core/camera.py``).

Rebuilds the reference's dataset-packer capability (``build_npz.py:178-243``)
as a library: parse the session JSON (``frames[*].camera.{transform,
intrinsics}``, stored column-major), convert ARKit camera poses to the
OpenCV convention, pair each frame with its JPEG by timestamp-suffixed
filename, skip missing/duplicate images, and pack the result into an
``.npz`` stage artifact with the exact on-disk contract consumed by the
downstream pipeline (``disparity_calculation.py:243-266``):

``image_data[i] = {timestamp, image_mat, frame_id, extrinsic, intrinsic,
image_name}``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from stereo_match_tpu_torch.core.camera import arkit_to_opencv_extrinsic
from stereo_match_tpu_torch.data.image import image_read


@dataclass
class ArkitFrame:
    timestamp: float
    frame_id: int
    extrinsic: np.ndarray  # 4x4 camera-to-world, OpenCV convention
    intrinsic: np.ndarray  # 3x3
    image_name: str
    image_mat: np.ndarray | None = field(default=None, repr=False)

    def to_dict(self) -> dict:
        return {
            "timestamp": self.timestamp,
            "image_mat": self.image_mat,
            "frame_id": self.frame_id,
            "extrinsic": self.extrinsic,
            "intrinsic": self.intrinsic,
            "image_name": self.image_name,
        }


def _column_major_to_matrix(values, n: int) -> np.ndarray:
    """ARKit JSON stores matrices flattened column-major
    (``build_npz.py:215-223`` transposes them)."""
    return np.asarray(values, dtype=np.float64).reshape(n, n).T


def parse_session(session_json: str | dict, image_dir: str | None = None,
                  mode: str = "P", image_suffix: str = "-1.000.jpeg",
                  load_images: bool = True) -> tuple[list[ArkitFrame], int]:
    """Parse an ARKit session into frames; returns (frames, n_skipped).

    ``session_json`` is a path or an already-parsed dict with a ``frames``
    list. Frames whose image file is missing, or whose timestamp duplicates
    a previous frame, are skipped with a counter (``build_npz.py:205-209``).
    """
    if isinstance(session_json, (str, os.PathLike)):
        with open(session_json) as f:
            session = json.load(f)
        if image_dir is None:
            image_dir = os.path.dirname(os.fspath(session_json))
    else:
        session = session_json
    image_dir = image_dir or "."

    frames: list[ArkitFrame] = []
    seen_names: set[str] = set()
    skipped = 0
    for i, frame in enumerate(session.get("frames", [])):
        cam = frame.get("camera", frame)
        raw_ts = frame.get("timestamp", cam.get("timestamp", i))
        ts = float(raw_ts)
        name = f"{raw_ts}{image_suffix}"
        path = os.path.join(image_dir, name)
        if name in seen_names:
            skipped += 1
            continue
        image = None
        if load_images:
            if not os.path.isfile(path):
                skipped += 1
                continue
            image = image_read(path)
        seen_names.add(name)
        transform = _column_major_to_matrix(cam["transform"], 4)
        intrinsic = _column_major_to_matrix(cam["intrinsics"], 3)
        extrinsic = arkit_to_opencv_extrinsic(transform, mode)
        frames.append(ArkitFrame(
            timestamp=ts, frame_id=len(frames), extrinsic=extrinsic,
            intrinsic=intrinsic, image_name=name, image_mat=image))
    return frames, skipped


def build_npz(session_json: str, image_dir: str | None = None,
              out_path: str = "tmp.npz", mode: str = "P") -> tuple[str, int]:
    """session JSON + JPEGs -> ``tmp.npz`` (the reference's stage-0 artifact,
    ``build_npz.py:241-243``). Returns (path, n_frames)."""
    frames, _ = parse_session(session_json, image_dir, mode=mode)
    image_data = np.array([f.to_dict() for f in frames], dtype=object)
    np.savez(out_path, image_data=image_data)
    return out_path, len(frames)


def scan_image_directory(image_dir: str, frames_ts: list[float],
                         suffix: str = ".jpeg") -> list[tuple[str, int]]:
    """Match image files to the *nearest* session timestamp.

    The early-ingestion variant (``build_npz_backup.py:94``,
    ``io_functions.py:96-98``): scan the directory, parse each file's
    leading timestamp, and pair it with the closest JSON frame. Returns
    [(filename, frame_index)] sorted by filename.
    """
    ts = np.asarray(frames_ts, np.float64)
    out = []
    for name in sorted(os.listdir(image_dir)):
        if not name.endswith(suffix):
            continue
        try:
            stamp = float(name.split("-")[0])
        except ValueError:
            continue
        out.append((name, int(np.argmin(np.abs(ts - stamp)))))
    return out


def load_npz_frames(path: str) -> list[dict]:
    """Load the stage-0 artifact (``hf.npz_load`` surface,
    ``disparity_calculation.py:243``)."""
    with np.load(path, allow_pickle=True) as data:
        return list(data["image_data"])
