"""PLY point-cloud I/O (numpy).

The same code as ``write_ply`` / ``read_ply`` in
``stereo_match_tpu/data/ply.py``, whose package imports JAX: capability
parity with the reference ASCII writer (``io_functions.py:15-44``), plus a
binary little-endian variant.
"""

from __future__ import annotations

import numpy as np

_ASCII_HEADER = """ply
format ascii 1.0
element vertex {n}
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
end_header
"""

_BINARY_HEADER = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
end_header
"""


def write_ply(path: str, points: np.ndarray, colors: np.ndarray,
              binary: bool = False, scrub_nonfinite: bool = True) -> int:
    """Write a colored point cloud; returns the number of vertices written.

    ``points``: (..., 3) float; ``colors``: (..., 3) uint8 (RGB). Non-finite
    points are replaced by zeros when ``scrub_nonfinite`` (the reference
    scrubs NaN/Inf before writing, ``disparity_calculation.py:316-319``).
    """
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    cols = np.asarray(colors).reshape(-1, 3)
    if cols.dtype != np.uint8:
        cols = np.clip(cols, 0, 255).astype(np.uint8)
    if pts.shape[0] != cols.shape[0]:
        raise ValueError(f"points/colors length mismatch: {pts.shape[0]} vs {cols.shape[0]}")
    if scrub_nonfinite:
        bad = ~np.isfinite(pts).all(axis=1)
        pts = pts.copy()
        pts[bad] = 0.0
    n = pts.shape[0]
    if binary:
        with open(path, "wb") as f:
            f.write(_BINARY_HEADER.format(n=n).encode("ascii"))
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write(_ASCII_HEADER.format(n=n))
            data = np.concatenate([pts, cols.astype(np.float32)], axis=1)
            np.savetxt(f, data, fmt="%f %f %f %d %d %d")
    return n


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an x/y/z + r/g/b PLY (ASCII or binary little-endian)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header_lines if l.startswith("format"))
        n = int(next(l.split()[-1] for l in header_lines if l.startswith("element vertex")))
        props = [l.split() for l in header_lines if l.startswith("property")]
        names = [p[2] for p in props]
        if names[:6] != ["x", "y", "z", "red", "green", "blue"]:
            raise ValueError(f"unsupported PLY property layout: {names}")
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            data = np.atleast_2d(data)
            return data[:, :3].astype(np.float32), data[:, 3:6].astype(np.uint8)
        if fmt == "binary_little_endian":
            rec = np.fromfile(f, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        raise ValueError(f"unsupported PLY format: {fmt}")
