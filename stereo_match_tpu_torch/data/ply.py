"""PLY point-cloud I/O (numpy).

The same code as ``stereo_match_tpu/data/ply.py``, whose package imports
JAX: capability parity with the reference ASCII writer
(``io_functions.py:15-44``), plus a binary little-endian variant, the mesh
writer and the transform file.
"""

from __future__ import annotations

import struct

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


def write_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                   colors: np.ndarray | None = None) -> None:
    """Write a triangle mesh (capability parity with ``hf.mesh_to_ply``,
    used at ``mapTo3D.py:159``)."""
    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    has_color = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            cols = np.clip(np.asarray(colors).reshape(-1, 3), 0, 255).astype(np.uint8)
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            if has_color:
                f.write(f"{v[0]:f} {v[1]:f} {v[2]:f} {cols[i][0]} {cols[i][1]} {cols[i][2]}\n")
            else:
                f.write(f"{v[0]:f} {v[1]:f} {v[2]:f}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_transform(path: str, transform: np.ndarray) -> None:
    """Persist a 4x4 transform (parity: ``io_functions.py:111-120``)."""
    np.savez(path, transform=np.asarray(transform))


def struct_size() -> int:
    """Bytes per binary vertex record (x,y,z f32 + r,g,b u8)."""
    return struct.calcsize("<fffBBB")
