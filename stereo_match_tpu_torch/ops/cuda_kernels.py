"""The four CUDA kernels of the census + SGM main path, with their plain
PyTorch versions and launch counts.

=====  ===================  ==============================================
K1     ``census_words``     csrc/census.cu       (census_words_pallas)
K2     ``census_volume``    csrc/cost_volume.cu  (census_volume_pallas)
K3     ``sgm_path_scan``    csrc/sgm.cu          (sgm_census_hpair_pallas,
                                                  sgm_scan3_pallas, the scans
                                                  of sgm_scan3_stats_pallas)
K4     ``wta_lr``           csrc/wta.cu          (the WTA statistics of
                                                  sgm_scan3_stats_pallas,
                                                  lr_mask_pallas)
=====  ===================  ==============================================

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version (``*_plain``, also the on-card reference of the checks), a
CUDA tensor launches the kernel or raises. The kernels are compiled with
``nvcc`` for ``sm_90a`` into a plain-C shared library at first use, keyed on
a hash of the sources and flags, under ``build/stereo_match_tpu_torch/``,
and called through ``ctypes`` on PyTorch's current stream. A C entry point
allocates nothing and returns ``cudaGetLastError()``; the wrapper allocates
the outputs and raises on a nonzero code.

``launches`` counts, per kernel, the launches made by the wrappers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from stereo_match_tpu_torch.ops.census import census_transform
from stereo_match_tpu_torch.ops.cost_volume import census_volume_from_words
from stereo_match_tpu_torch.ops.sgm import (PATH_DIRECTIONS_8,
                                            aggregate_direction)
from stereo_match_tpu_torch.ops.wta import lr_consistency_mask

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("census.cu", "cost_volume.cu", "sgm.cu", "wta.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libsmt_kernels.so"

launches = {"census_words": 0, "census_volume": 0, "sgm_path_scan": 0,
            "wta_lr": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------------- build ----

def find_nvcc() -> str:
    """nvcc on PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """Compile the kernels (once per source hash); return (library, log).

    The log is nvcc's ``-Xptxas -v`` report: registers, shared memory and
    spills of every kernel.
    """
    nvcc = find_nvcc()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    log = out_dir / "ptxas.log"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / name) for name in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)       # atomic: concurrent builds agree
    return lib, log.read_text() if log.exists() else ""


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        signatures = {
            "smt_census_words": [p, p, i, i, i, i, i, p],
            "smt_census_volume": [p, p, p, i, i, i, i, p],
            "smt_sgm_path_scan": [p, p, i, i, i, i, i, f, f, i, p],
            "smt_wta_lr": [p, p, p, i, i, i, i, i, i, i, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``smt_<name>`` on the device's current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(_library(), "smt_" + name)(*args, stream)
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{code} ({torch.cuda.get_device_name(device)})")
    launches[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors; raises otherwise."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"and {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_window(window: tuple[int, int]) -> tuple[int, int]:
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError("census window must be odd in both dimensions")
    if wh * ww - 1 > 32:
        raise ValueError(f"census window {window} needs {wh * ww - 1} bits; "
                         "K1/K2 pack one 32-bit word")
    return wh, ww


# ------------------------------------------------------- K1 census_words ----

def census_words_plain(imgs: torch.Tensor,
                       window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """(V, H, W) float32 views -> (V, H, W) int32 single-word census."""
    return torch.stack([census_transform(img, window)[..., 0] for img in imgs])


def census_words(imgs: torch.Tensor,
                 window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """(V, H, W) float32 views -> (V, H, W) int32 single-word census (K1)."""
    wh, ww = _check_window(window)
    _check(imgs, "imgs", torch.float32, 3)
    if _on_cpu(imgs):
        return census_words_plain(imgs, window)
    V, H, W = imgs.shape
    out = torch.empty((V, H, W), dtype=torch.int32, device=imgs.device)
    _launch("census_words", imgs.device, _ptr(imgs), _ptr(out), V, H, W,
            wh, ww)
    return out


# ------------------------------------------------------ K2 census_volume ----

def census_volume_plain(cl: torch.Tensor, cr: torch.Tensor,
                        num_disparities: int,
                        min_disparity: int = 0) -> torch.Tensor:
    """(H, W) int32 census words of both views -> (D, H, W) float32."""
    return census_volume_from_words(cl[None], cr[None], num_disparities,
                                    min_disparity)


def census_volume(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int,
                  min_disparity: int = 0) -> torch.Tensor:
    """(H, W) int32 census words of both views -> (D, H, W) float32 (K2).

    Hamming cost of ``cl[y, x]`` against ``cr[y, x - d]``, 1e4 where x < d.
    """
    if min_disparity < 0:
        raise ValueError("census_volume needs min_disparity >= 0")
    _check(cl, "cl", torch.int32, 2)
    _check(cr, "cr", torch.int32, 2)
    if cl.shape != cr.shape:
        raise ValueError(f"census images differ: {cl.shape} vs {cr.shape}")
    if _on_cpu(cl, cr):
        return census_volume_plain(cl, cr, num_disparities, min_disparity)
    H, W = cl.shape
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=cl.device)
    _launch("census_volume", cl.device, _ptr(cl), _ptr(cr), _ptr(out), H, W,
            num_disparities, min_disparity)
    return out


# ------------------------------------------------------ K3 sgm_path_scan ----

def _check_scan(cost: torch.Tensor, total: torch.Tensor, dy: int,
                dx: int) -> None:
    _check(cost, "cost", torch.float32, 3)
    _check(total, "total", torch.float32, 3)
    if cost.shape != total.shape:
        raise ValueError(f"cost {tuple(cost.shape)} and total "
                         f"{tuple(total.shape)} differ")
    if dy not in (-1, 0, 1) or dx not in (-1, 0, 1) or dy == dx == 0:
        raise ValueError(f"bad path direction {(dy, dx)}")
    if cost.shape[0] > 1024:
        raise ValueError("sgm_path_scan runs one thread per disparity: "
                         "at most 1024")


def sgm_path_scan_plain(cost: torch.Tensor, total: torch.Tensor, dy: int,
                        dx: int, p1: float, p2: float,
                        accumulate: bool) -> torch.Tensor:
    """Add (or, with ``accumulate=False``, write) L_(dy,dx) into ``total``."""
    L = aggregate_direction(cost, dy, dx, p1, p2)
    return total.add_(L) if accumulate else total.copy_(L)


def sgm_path_scan(cost: torch.Tensor, total: torch.Tensor, dy: int, dx: int,
                  p1: float, p2: float, accumulate: bool) -> torch.Tensor:
    """One SGM path direction over (D, H, W) ``cost``, into ``total`` (K3).

    Updates ``total`` in place (the first direction of a frame passes
    ``accumulate=False`` and overwrites it) and returns it.
    """
    _check_scan(cost, total, dy, dx)
    if _on_cpu(cost, total):
        return sgm_path_scan_plain(cost, total, dy, dx, p1, p2, accumulate)
    D, H, W = cost.shape
    _launch("sgm_path_scan", cost.device, _ptr(cost), _ptr(total), D, H, W,
            dy, dx, float(p1), float(p2), int(accumulate))
    return total


def aggregate_paths(cost: torch.Tensor, p1: float, p2: float,
                    num_paths: int = 8, scan=sgm_path_scan) -> torch.Tensor:
    """The SGM total over the first ``num_paths`` of ``PATH_DIRECTIONS_8``.

    One ``scan`` per direction, in the order ``ops/sgm.py::sgm_aggregate``
    adds them, the first writing the total. ``scan`` is K3 by default;
    ``sgm_path_scan_plain`` gives the plain version on any device.
    """
    total = torch.empty_like(cost)
    for i, (dy, dx) in enumerate(PATH_DIRECTIONS_8[:num_paths]):
        scan(cost, total, dy, dx, p1, p2, accumulate=i > 0)
    return total


# ------------------------------------------------------------- K4 wta_lr ----

def wta_lr_plain(total: torch.Tensor, min_disparity: int = 0,
                 uniqueness_ratio: int = 15, disp12_max_diff: int = 1,
                 subpixel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, H, W) aggregated costs -> (disp, disp_right), each (H, W) float32.

    The statistics form of ``ops/wta.py::extract_disparity``: per pixel the
    best cost, its first index, the costs at idx +- 1 and the best cost
    outside idx +- 1; the right-view argmin over in-frame d (ties to the
    smallest d); then subpixel, uniqueness and the disp12 check.
    """
    D, H, W = total.shape
    big = 3e9
    d_iota = torch.arange(D, device=total.device)[:, None, None]
    best = total.amin(dim=0)
    idx = torch.where(total == best[None], d_iota, D).amin(dim=0)
    edge = torch.full_like(total[:1], big)
    c0 = torch.cat([edge, total[:-1]]).gather(0, idx[None])[0]
    c2 = torch.cat([total[1:], edge]).gather(0, idx[None])[0]
    near = (d_iota - idx[None]).abs() <= 1
    second = torch.where(near, big, total).amin(dim=0)

    disp = idx.to(torch.float32)
    if subpixel:
        denom = c0 - 2.0 * best + c2
        offset = torch.where(denom > 1e-9,
                             (c0 - c2) / (2.0 * torch.clamp(denom, min=1e-9)),
                             0.0).clamp(-0.5, 0.5)
        disp = disp + torch.where((idx == 0) | (idx == D - 1), 0.0, offset)
    disp = disp + min_disparity
    mask = second * 100.0 > best * (100.0 + uniqueness_ratio) \
        if uniqueness_ratio > 0 else torch.ones_like(disp, dtype=torch.bool)

    rbest = torch.full((H, W), big, dtype=torch.float32, device=total.device)
    ridx = torch.zeros((H, W), dtype=torch.int64, device=total.device)
    for d in range(min(D, W)):          # ascending d, strict <: first on ties
        v = total[d, :, d:]
        better = v < rbest[:, :W - d]
        rbest[:, :W - d] = torch.where(better, v, rbest[:, :W - d])
        ridx[:, :W - d] = torch.where(better, d, ridx[:, :W - d])
    disp_right = (ridx + min_disparity).to(torch.float32)

    mask = mask & lr_consistency_mask(disp, disp_right, disp12_max_diff,
                                      min_disparity)
    return torch.where(mask, disp, torch.nan), disp_right


def wta_lr(total: torch.Tensor, min_disparity: int = 0,
           uniqueness_ratio: int = 15, disp12_max_diff: int = 1,
           subpixel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, H, W) aggregated costs -> (disp, disp_right) (K4).

    ``disp`` is float32 with NaN where the uniqueness or disp12 check fails
    (``uniqueness_ratio <= 0`` / ``disp12_max_diff < 0`` disable them);
    ``disp_right`` is the right-view WTA disparity used by the check.
    """
    _check(total, "total", torch.float32, 3)
    if _on_cpu(total):
        return wta_lr_plain(total, min_disparity, uniqueness_ratio,
                            disp12_max_diff, subpixel)
    D, H, W = total.shape
    disp = torch.empty((H, W), dtype=torch.float32, device=total.device)
    disp_right = torch.empty_like(disp)
    _launch("wta_lr", total.device, _ptr(total), _ptr(disp), _ptr(disp_right),
            D, H, W, min_disparity, uniqueness_ratio, disp12_max_diff,
            int(subpixel))
    return disp, disp_right
