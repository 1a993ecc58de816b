"""The CUDA kernels of the port, with their plain PyTorch versions and
launch counts.

=====  ======================  ===========================================
K1     ``census_words``        csrc/census.cu       (census_words_pallas)
K2     ``census_volume``       csrc/cost_volume.cu  (census_volume_pallas)
K3     ``sgm_path_scan``       csrc/sgm.cu          (sgm_census_hpair_pallas,
                                                     sgm_scan3_pallas, the
                                                     scans of
                                                     sgm_scan3_stats_pallas)
K4     ``wta_lr``              csrc/wta.cu          (the WTA statistics of
                                                     sgm_scan3_stats_pallas,
                                                     lr_mask_pallas)
K5     ``speckle_sweep``       csrc/speckle.cu      (the labels of
                                                     speckle_filter_pallas)
K6     ``speckle_count_keep``  csrc/speckle.cu      (the sizes and threshold
                                                     of speckle_filter_pallas)
K7     ``fgs_solve``           csrc/wls.cu          (fgs_solve_pallas)
K8     ``mccnn_conv3x3``       csrc/mccnn.cu        (mccnn_tower_pallas, the
                                                     tower of
                                                     mccnn_fused_volume_pallas)
K9     ``mccnn_volume``        csrc/mccnn.cu        (mccnn_volume_pallas,
                                                     mccnn_volume_mxu_pallas,
                                                     mccnn_volume_flat_pallas,
                                                     the volume of
                                                     mccnn_fused_volume_pallas)
=====  ======================  ===========================================

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version (``*_plain``, also the on-card reference of the checks), a
CUDA tensor launches the kernel or raises. The kernels are compiled with
``nvcc`` for ``sm_90a`` at first use, one ``nvcc`` per source, all started
together, then linked into a plain-C shared library, keyed on a hash of the
sources and flags, under ``build/stereo_match_tpu_torch/``, and called
through ``ctypes`` on PyTorch's current stream. A C entry point
allocates nothing and returns ``cudaGetLastError()``; the wrapper allocates
the outputs and raises on a nonzero code.

``launches`` counts, per kernel, the calls of its C entry point made by
the wrappers: K5 counts two per sweep (rows, then columns); K6's entry
runs its count and keep kernels as one.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as Fn

from stereo_match_tpu_torch.ops.census import census_transform
from stereo_match_tpu_torch.ops.cost_volume import (INVALID_COST,
                                                    _invalid_mask,
                                                    _shift_plane,
                                                    census_volume_from_words)
from stereo_match_tpu_torch.ops.sgm import (PATH_DIRECTIONS_8,
                                            aggregate_direction)
from stereo_match_tpu_torch.ops.wta import lr_consistency_mask

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("census.cu", "cost_volume.cu", "sgm.cu", "wta.cu",
           "speckle.cu", "wls.cu", "mccnn.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libsmt_kernels.so"

launches = {"census_words": 0, "census_volume": 0, "sgm_path_scan": 0,
            "wta_lr": 0, "speckle_sweep": 0, "speckle_count_keep": 0,
            "fgs_solve": 0, "mccnn_conv3x3": 0, "mccnn_volume": 0}

# Packed speckle connectivity: the bit a pixel sets when it is connected to
# its left neighbour, and the one for the pixel above.
CONN_LEFT, CONN_UP = 1, 2


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

    One ``nvcc -c`` per source, all running at once, then one link. The
    log is nvcc's ``-Xptxas -v`` report: registers, shared memory and
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
        work = Path(tempfile.mkdtemp(dir=out_dir))
        objs = [work / (Path(name).stem + ".o") for name in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / name),
                                   "-o", str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        outs = [(name, proc.communicate()[0], proc.returncode)
                for name, proc in zip(SOURCES, procs)]
        report = "".join(out for _, out, _ in outs)
        failed = [f"{name} ({rc}):\n{out}" for name, out, rc in outs if rc]
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(work / LIB_NAME),
                 *map(str, objs)], capture_output=True, text=True)
            if link.returncode:
                failed.append(f"link ({link.returncode}):\n{link.stdout}"
                              f"{link.stderr}")
        if failed:
            shutil.rmtree(work)
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        log.write_text(report)
        os.replace(work / LIB_NAME, lib)   # atomic: concurrent builds agree
        shutil.rmtree(work)
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
            "smt_speckle_sweep": [p, p, i, i, i, p, p],
            "smt_speckle_count_keep": [p, p, p, p, i, i, i, i, p],
            "smt_fgs_solve": [p, p, p, p, p, i, i, i, f, p],
            "smt_mccnn_conv3x3": [p, p, p, p, i, i, i, i, i, i, i, p],
            "smt_mccnn_volume": [p, p, p, i, i, i, i, i, f, p],
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


# ------------------------------------------------------ K5 speckle_sweep ----

def _check_labels(labels: torch.Tensor, conn: torch.Tensor) -> None:
    _check(labels, "labels", torch.int32, 2)
    _check(conn, "conn", torch.uint8, 2)
    if labels.shape != conn.shape:
        raise ValueError(f"labels {tuple(labels.shape)} and conn "
                         f"{tuple(conn.shape)} differ")


def _seg_min_scan(labels: torch.Tensor, brk: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Inclusive running min along ``dim``, restarted where ``brk`` is set.

    ``cummin`` over ``label - seg * M``, ``seg`` the running count of
    breaks: every segment starts below all earlier keys (``M`` exceeds any
    label), so the minimum restarts there; adding ``seg * M`` back gives
    the labels.
    """
    if reverse:
        labels, brk = labels.flip(dim), brk.flip(dim)
    seg = torch.cumsum(brk.to(torch.int64), dim)
    M = labels.numel() + 2
    out = torch.cummin(labels.to(torch.int64) - seg * M, dim).values + seg * M
    return (out.flip(dim) if reverse else out).to(torch.int32)


def speckle_sweep_plain(labels: torch.Tensor,
                        conn: torch.Tensor) -> torch.Tensor:
    """One sweep (x-forward, x-reverse, y-forward, y-reverse) in place.

    Returns a bool tensor: whether the sweep lowered any label.
    """
    cx = (conn & CONN_LEFT) != 0          # pixel joins the run of x - 1
    cy = (conn & CONN_UP) != 0            # pixel joins the run of y - 1
    # reverse scans: a pixel joins the run of x + 1 (y + 1) when that pixel
    # is connected back to it; the last column (row) starts a run anyway
    cx_next = torch.zeros_like(cx)
    cx_next[:, :-1] = cx[:, 1:]
    cy_next = torch.zeros_like(cy)
    cy_next[:-1, :] = cy[1:, :]
    new = _seg_min_scan(labels, ~cx, 1, False)
    new = _seg_min_scan(new, ~cx_next, 1, True)
    new = _seg_min_scan(new, ~cy, 0, False)
    new = _seg_min_scan(new, ~cy_next, 0, True)
    changed = (new != labels).any()
    labels.copy_(new)
    return changed


def speckle_sweep(labels: torch.Tensor, conn: torch.Tensor) -> torch.Tensor:
    """One min-label sweep over (H, W) int32 ``labels``, in place (K5).

    ``conn`` is the (H, W) uint8 packed connectivity (``CONN_LEFT``,
    ``CONN_UP``). Returns a one-element tensor on the labels' device,
    nonzero when the sweep lowered a label; reading it syncs the host.
    """
    _check_labels(labels, conn)
    if _on_cpu(labels, conn):
        return speckle_sweep_plain(labels, conn)
    H, W = labels.shape
    changed = torch.zeros(1, dtype=torch.int32, device=labels.device)
    for axis in (1, 0):                    # rows, then columns
        _launch("speckle_sweep", labels.device, _ptr(labels), _ptr(conn), H,
                W, axis, _ptr(changed))
    return changed


# ------------------------------------------------- K6 speckle_count_keep ----

def speckle_count_keep_plain(d: torch.Tensor, labels: torch.Tensor,
                             threshold: int,
                             unconverged: bool) -> torch.Tensor:
    """Pixels of components under ``threshold`` pixels -> NaN.

    ``unconverged`` keeps every valid pixel (the sweeps hit their cap).
    """
    sizes = torch.bincount(labels.reshape(-1).to(torch.int64),
                           minlength=labels.numel() + 2)
    keep = (sizes[labels.to(torch.int64)] >= threshold) | bool(unconverged)
    return torch.where(keep & torch.isfinite(d), d, torch.nan)


def speckle_count_keep(d: torch.Tensor, labels: torch.Tensor, threshold: int,
                       unconverged: bool) -> torch.Tensor:
    """Component sizes by label, then the size threshold (K6).

    ``d``: (H, W) float32 disparities; ``labels``: their (H, W) int32
    component labels after the sweeps (``H * W + 1`` for invalid pixels).
    Returns ``d`` with NaN where the pixel is invalid or its component has
    fewer than ``threshold`` pixels, unless ``unconverged``.
    """
    _check(d, "d", torch.float32, 2)
    _check(labels, "labels", torch.int32, 2)
    if d.shape != labels.shape:
        raise ValueError(f"d {tuple(d.shape)} and labels "
                         f"{tuple(labels.shape)} differ")
    if _on_cpu(d, labels):
        return speckle_count_keep_plain(d, labels, threshold, unconverged)
    H, W = d.shape
    count = torch.zeros(H * W, dtype=torch.int32, device=d.device)
    out = torch.empty_like(d)
    _launch("speckle_count_keep", d.device, _ptr(d), _ptr(labels),
            _ptr(count), _ptr(out), H, W, int(threshold), int(unconverged))
    return out


# ---------------------------------------------------------- K7 fgs_solve ----

def _check_solve(f: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor) -> None:
    _check(f, "f", torch.float32, 3)
    _check(wp, "wp", torch.float32, 2)
    _check(wn, "wn", torch.float32, 2)
    if wp.shape != f.shape[1:] or wn.shape != f.shape[1:]:
        raise ValueError(f"weights {tuple(wp.shape)}, {tuple(wn.shape)} do "
                         f"not match the slab {tuple(f.shape)}")
    if f.shape[0] not in (1, 2):
        raise ValueError("fgs_solve takes one or two right-hand sides")


def fgs_solve_plain(f: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor,
                    lam: float) -> torch.Tensor:
    """Solve (I + lam*A) u = f along axis 1 of the (C, S, N) slab ``f``.

    ``wp``/``wn`` (S, N): edge weights to the scan-order predecessor /
    successor (``wp[0] = wn[S-1] = 0``). The Thomas algorithm of
    ``ops/wls.py::_tridiagonal_smooth_rows``, vectorised over the N lines,
    in the reference's operation order.
    """
    C, S, N = f.shape
    lam = torch.tensor(lam, dtype=torch.float32, device=f.device)
    a = -lam * wp
    c = -lam * wn
    b = (1.0 - a) - c
    cp = torch.empty_like(wp)
    u = torch.empty_like(f)
    cp_prev = torch.zeros(N, dtype=torch.float32, device=f.device)
    dp_prev = torch.zeros((C, N), dtype=torch.float32, device=f.device)
    for s in range(S):
        denom = b[s] - a[s] * cp_prev
        cp_prev = c[s] / denom
        dp_prev = (f[:, s] - a[s] * dp_prev) / denom
        cp[s] = cp_prev
        u[:, s] = dp_prev
    u_next = torch.zeros((C, N), dtype=torch.float32, device=f.device)
    for s in range(S - 1, -1, -1):
        u_next = u[:, s] - cp[s] * u_next
        u[:, s] = u_next
    return u


def fgs_solve(f: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor,
              lam: float) -> torch.Tensor:
    """Tridiagonal solves along axis 1 of a (C, S, N) slab (K7).

    ``lam`` is a float32 value (the smoother's lambda schedule is computed
    in float32); C = 1 or 2 right-hand sides share one elimination.
    """
    _check_solve(f, wp, wn)
    if _on_cpu(f, wp, wn):
        return fgs_solve_plain(f, wp, wn, lam)
    C, S, N = f.shape
    cp = torch.empty_like(wp)
    u = torch.empty_like(f)
    _launch("fgs_solve", f.device, _ptr(f), _ptr(wp), _ptr(wn), _ptr(cp),
            _ptr(u), C, S, N, float(lam))
    return u


# ------------------------------------------------------ K8 mccnn_conv3x3 ----

MCCNN_MAX_FEATURES = 128


@contextlib.contextmanager
def _fp32_cudnn():
    """cuDNN in full float32: its float32 convolutions default to TF32.

    ``cudnn.flags`` defaults to ``enabled=False``, which would turn cuDNN
    off, hence ``enabled=True``; matmuls are kept out of TF32 as well.
    """
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def conv_taps(weight: torch.Tensor) -> torch.Tensor:
    """(F, C_in, 3, 3) OIHW weights -> the (3, 3, C_in, F) layout K8 reads.

    The flax kernel layout: taps, then input channels, then outputs, so a
    block's staging of a few input channels reads contiguous rows of F.
    """
    return weight.permute(2, 3, 1, 0).contiguous()


def mccnn_conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, relu: bool,
                        normalize: bool) -> torch.Tensor:
    """One MC-CNN tower layer: (V, C_in, H, W) -> (V, F, H, W).

    ``F.conv2d`` with one pixel of zero padding (flax ``padding="SAME"``,
    per layer) and ``bias`` (``weight`` is OIHW), then ReLU when ``relu``,
    then each pixel's F-vector divided by sqrt(sum of squares + 1e-12)
    when ``normalize``. On the card cuDNN runs in full float32.
    """
    with _fp32_cudnn() if x.is_cuda else contextlib.nullcontext():
        y = Fn.conv2d(x, weight, bias, padding=1)
    if relu:
        y = torch.relu(y)
    if normalize:
        y = y / torch.sqrt(torch.sum(y * y, dim=1, keepdim=True) + 1e-12)
    return y


def mccnn_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  relu: bool, normalize: bool,
                  taps: torch.Tensor | None = None) -> torch.Tensor:
    """One MC-CNN tower layer: (V, C_in, H, W) -> (V, F, H, W) (K8).

    ``weight`` (F, C_in, 3, 3) and ``bias`` (F,) float32, F <= 128.
    ``taps`` is ``conv_taps(weight)``, the kernel's layout; a caller that
    runs every frame (``models/mccnn.py::MCCNNFeatures``) passes the copy
    it made once, otherwise it is made here.
    """
    _check(x, "x", torch.float32, 4)
    _check(weight, "weight", torch.float32, 4)
    _check(bias, "bias", torch.float32, 1)
    V, C_in, H, W = x.shape
    F = weight.shape[0]
    if weight.shape != (F, C_in, 3, 3) or bias.shape != (F,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit {C_in} input "
                         "channels and 3x3 taps")
    if F > MCCNN_MAX_FEATURES:
        raise ValueError(f"{F} features: K8 holds at most "
                         f"{MCCNN_MAX_FEATURES} per pixel")
    if taps is None:
        taps = conv_taps(weight)
    _check(taps, "taps", torch.float32, 4)
    if taps.shape != (3, 3, C_in, F):
        raise ValueError(f"taps {tuple(taps.shape)}: expected "
                         f"{(3, 3, C_in, F)}")
    if _on_cpu(x, weight, bias, taps):
        return mccnn_conv3x3_plain(x, weight, bias, relu, normalize)
    y = torch.empty((V, F, H, W), dtype=torch.float32, device=x.device)
    _launch("mccnn_conv3x3", x.device, _ptr(x), _ptr(taps), _ptr(bias),
            _ptr(y), V, C_in, F, H, W, int(relu), int(normalize))
    return y


# ------------------------------------------------------- K9 mccnn_volume ----

def mccnn_volume_plain(fl: torch.Tensor, fr: torch.Tensor,
                       num_disparities: int, min_disparity: int = 0,
                       scale: float = 24.0) -> torch.Tensor:
    """(F, H, W) features of both views -> (D, H, W) float32 cost.

    The plane loop of ``models/mccnn.py::mccnn_cost_volume``: the right
    features shifted by d (edge-replicated), the channel sum of the
    products, scale * (1 - sim) * 0.5, then INVALID_COST where x < d.
    """
    _, H, W = fl.shape
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=fl.device)
    for i in range(num_disparities):
        sim = torch.sum(fl * _shift_plane(fr, min_disparity + i), dim=0)
        out[i] = scale * (1.0 - sim) * 0.5
    mask = _invalid_mask(W, num_disparities, min_disparity, fl.device)
    return out.masked_fill_(mask, INVALID_COST)


def mccnn_volume(fl: torch.Tensor, fr: torch.Tensor, num_disparities: int,
                 min_disparity: int = 0, scale: float = 24.0) -> torch.Tensor:
    """(F, H, W) features of both views -> (D, H, W) float32 cost (K9).

    ``out[i, y, x] = scale * (1 - <fl[:, y, x], fr[:, y, x - d]>) * 0.5``
    with ``d = min_disparity + i``, exactly INVALID_COST (1e4) where x < d.
    """
    if min_disparity < 0:
        raise ValueError("mccnn_volume needs min_disparity >= 0")
    if num_disparities < 1:
        raise ValueError("mccnn_volume needs num_disparities >= 1")
    _check(fl, "fl", torch.float32, 3)
    _check(fr, "fr", torch.float32, 3)
    if fl.shape != fr.shape:
        raise ValueError(f"features differ: {tuple(fl.shape)} vs "
                         f"{tuple(fr.shape)}")
    if _on_cpu(fl, fr):
        return mccnn_volume_plain(fl, fr, num_disparities, min_disparity,
                                  scale)
    F, H, W = fl.shape
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=fl.device)
    _launch("mccnn_volume", fl.device, _ptr(fl), _ptr(fr), _ptr(out), F, H,
            W, num_disparities, min_disparity, float(scale))
    return out
