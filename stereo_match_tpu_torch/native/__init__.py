"""ctypes bindings for the host library ``smt_native.cpp`` (the port's copy).

``smt_native.cpp`` is a byte-for-byte copy of the JAX package's source
(a test holds the two equal): Bowyer-Watson Delaunay triangulation and
slanted-plane rasterization, the host half of the ELAS pipeline, and the union-find
speckle filter (``cv::filterSpeckles``). It is
built with ``g++`` at first use into
``build/stereo_match_tpu_torch/native/<hash>/`` (keyed on a hash of the
source and flags; never into a package directory), then loaded with
``ctypes``. Without a compiler, ``delaunay`` and ``rasterize_planes`` fall
back to scipy and numpy, and ``speckle_filter_host`` to the port's plain
speckle filter on the CPU (``ops/speckle.py``), as the JAX package's fall
back to scipy, numpy and its XLA filter; ``available()`` says which one
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "smt_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libsmt_native.so"

_lib: ctypes.CDLL | None = None
_build_failed = False


def build() -> Path:
    """Compile ``smt_native.cpp`` once per source hash; return the library.

    Raises ``RuntimeError`` when ``g++`` is missing or fails.
    """
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        run = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)],
                             capture_output=True, text=True)
        if run.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({run.returncode}):\n"
                               f"{run.stdout}{run.stderr}")
        os.replace(tmp, lib)       # atomic: concurrent builds agree
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        _build_failed = True
        return None
    dp, ip, fp = (ctypes.POINTER(t) for t in
                  (ctypes.c_double, ctypes.c_int, ctypes.c_float))
    lib.smt_delaunay.restype = ctypes.c_int
    lib.smt_delaunay.argtypes = [dp, ctypes.c_int, ip, ctypes.c_int]
    lib.smt_rasterize_planes.restype = None
    lib.smt_rasterize_planes.argtypes = [ip, ctypes.c_int, dp, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, fp]
    lib.smt_speckle_filter.restype = ctypes.c_int
    lib.smt_speckle_filter.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the C++ library built and loaded."""
    return _load() is not None


def delaunay(points_xy: np.ndarray) -> np.ndarray:
    """(n, 2) points -> (m, 3) int32 triangle vertex indices."""
    pts = np.ascontiguousarray(points_xy, dtype=np.float64)
    n = len(pts)
    lib = _load()
    if lib is None:
        from scipy.spatial import Delaunay
        return Delaunay(pts).simplices.astype(np.int32)
    max_tris = max(4 * n, 64)
    out = np.empty((max_tris, 3), np.int32)
    m = lib.smt_delaunay(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_tris)
    if m < 0:
        raise RuntimeError("delaunay triangle buffer overflow")
    return out[:m].copy()


def rasterize_planes(triangles: np.ndarray, support_xyd: np.ndarray,
                     height: int, width: int) -> np.ndarray:
    """Triangles + (x, y, d) vertices -> (H, W) float32 interpolated
    disparity prior (NaN outside the support hull)."""
    tris = np.ascontiguousarray(triangles, np.int32)
    sup = np.ascontiguousarray(support_xyd, np.float64)
    lib = _load()
    if lib is None:
        return _rasterize_py(tris, sup, height, width)
    mu = np.empty((height, width), np.float32)
    lib.smt_rasterize_planes(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(tris),
        sup.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(sup),
        height, width, mu.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return mu


def _rasterize_py(tris, sup, height, width):
    mu = np.full((height, width), np.nan, np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    for a, b, c in tris:
        ax, ay, ad = sup[a]
        bx, by, bd = sup[b]
        cx, cy, cd = sup[c]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-12:
            continue
        l1 = ((by - cy) * (xx - cx) + (cx - bx) * (yy - cy)) / den
        l2 = ((cy - ay) * (xx - cx) + (ax - cx) * (yy - cy)) / den
        l3 = 1.0 - l1 - l2
        inside = (l1 >= -1e-9) & (l2 >= -1e-9) & (l3 >= -1e-9)
        mu[inside] = (l1 * ad + l2 * bd + l3 * cd)[inside].astype(np.float32)
    return mu


def speckle_filter_host(disparity: np.ndarray, max_speckle_size: int,
                        max_diff: float) -> np.ndarray:
    """Host-side exact speckle filter (``cv::filterSpeckles`` semantics):
    a float32 copy of the (H, W) map, 4-connected components of pixels
    within ``max_diff`` (NaN invalid) smaller than ``max_speckle_size`` set
    to NaN by the library's union-find, in place on the copy. Without the
    library, the port's plain speckle filter on the CPU
    (``ops/speckle.speckle_filter``)."""
    disp = np.ascontiguousarray(disparity, np.float32).copy()
    lib = _load()
    if lib is None:
        import torch

        from stereo_match_tpu_torch.ops.speckle import speckle_filter
        return speckle_filter(torch.from_numpy(disp), max_speckle_size,
                              max_diff).numpy()
    lib.smt_speckle_filter(
        disp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        disp.shape[0], disp.shape[1], float(max_diff), int(max_speckle_size))
    return disp
