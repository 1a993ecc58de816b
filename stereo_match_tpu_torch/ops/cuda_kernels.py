"""The CUDA kernels of the port, with their plain PyTorch versions and
launch counts.

=====  ======================  ===========================================
K1     ``census_words``        csrc/census.cu       (census_words_pallas;
                                                     windows over 33 pixels
                                                     in several words)
K2     ``census_volume``       csrc/cost_volume.cu  (census_volume_pallas,
                                                     one or more words,
                                                     float32 or int16;
                                                     census_volume_T_pallas,
                                                     ``transposed=True``)
K3     ``sgm_path_scan``       csrc/sgm.cu          (sgm_census_hpair_pallas,
                                                     sgm_scan3_pallas,
                                                     sgm_scan_pallas, the
                                                     scans of
                                                     sgm_scan3_stats_pallas;
                                                     float32 or int16, carry
                                                     in and out)
K4     ``wta_lr``              csrc/wta.cu          (the WTA statistics of
                                                     sgm_scan3_stats_pallas,
                                                     lr_mask_pallas fused)
       ``wta_stats``           csrc/wta.cu          (wta_stats_pallas)
       ``right_wta``           csrc/wta.cu          (right_wta_pallas)
       ``lr_mask``             csrc/wta.cu          (lr_mask_pallas, float
                                                     tolerance)
K5     ``speckle_filter``      csrc/speckle.cu      (speckle_filter_pallas:
                                                     labels to the fixpoint,
                                                     sizes and threshold in
                                                     one cooperative launch;
                                                     K6, the count and keep,
                                                     are its last phases)
K7     ``fgs_solve``           csrc/wls.cu          (fgs_solve_pallas; rows
                                                     or columns of the slab
                                                     as it lies, each line
                                                     split into segments)
K8     ``mccnn_conv3x3``       csrc/mccnn.cu        (mccnn_tower_pallas, the
                                                     tower of
                                                     mccnn_fused_volume_pallas;
                                                     3xTF32 tensor cores for
                                                     C_in > 1, FP32 for
                                                     C_in = 1; a bfloat16
                                                     mode, ``bf16=True``, on
                                                     the bf16 tensor cores,
                                                     bf16 channels-last
                                                     activations)
K9     ``mccnn_volume``        csrc/mccnn.cu        (mccnn_volume_pallas,
                                                     mccnn_volume_mxu_pallas,
                                                     mccnn_volume_flat_pallas,
                                                     the volume of
                                                     mccnn_fused_volume_pallas)
K10    ``census_scan``         csrc/sgm.cu          (sgm_census_scan_pallas;
                                                     K3's horizontal walk on
                                                     costs rebuilt from the
                                                     census words)
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

``launches`` counts, per kernel entry, the calls of its C entry point made
by the wrappers: K5 counts one per speckle filter, whatever its sweeps;
K4's four entries count apart.
``extract_disparity_fast`` runs K4's ``wta_stats``, ``right_wta`` and
``lr_mask`` entries.
K2, K3 and K4 take float32 or int16 volumes (``census_volume``'s
``dtype``); int16 SGM follows the XLA int16 path (P1 and P2 truncated).
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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fn

from stereo_match_tpu_torch.ops.census import _to_int32, census_transform
from stereo_match_tpu_torch.ops.cost_volume import (
    INVALID_COST, _invalid_mask, _shift_plane, census_volume_from_words,
    census_volume_T_from_words, volume_dtype)
from stereo_match_tpu_torch.ops.sgm import (PATH_DIRECTIONS_8,
                                            aggregate_direction)
from stereo_match_tpu_torch.ops.wta import (disparity_from_stats,
                                            lr_consistency_mask)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("census.cu", "cost_volume.cu", "sgm.cu", "wta.cu",
           "speckle.cu", "wls.cu", "mccnn.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libsmt_kernels.so"

launches = {"census_words": 0, "census_volume": 0, "sgm_path_scan": 0,
            "wta_lr": 0, "wta_stats": 0, "right_wta": 0, "lr_mask": 0,
            "speckle_filter": 0, "fgs_solve": 0,
            "mccnn_conv3x3": 0, "mccnn_volume": 0, "census_scan": 0,
            "mccnn_fused_volume": 0}

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
            "smt_census_volume": [p, p, p, i, i, i, i, i, i, i, p],
            "smt_sgm_path_scan": [p, p, p, p, i, i, i, i, i, f, f, i, i, p],
            "smt_wta_lr": [p, p, p, i, i, i, i, i, i, i, i, p],
            "smt_wta_stats": [p, p, p, p, p, p, i, i, i, i, p],
            "smt_right_wta": [p, p, i, i, i, i, p],
            "smt_lr_mask": [p, p, p, i, i, f, p],
            "smt_census_scan": [p, p, p, i, i, i, i, f, f, f, i, i, p],
            "smt_speckle_filter": [p, p, p, p, p, p, i, i, i, f, i, p],
            "smt_fgs_solve": [p, p, p, p, p, i, i, i, i, f, p],
            "smt_mccnn_conv3x3": [p, p, p, p, i, i, i, i, i, i, i, i, p],
            "smt_mccnn_conv3x3_bf16": [p, p, p, p, i, i, i, i, i, i, i, i,
                                       p],
            "smt_mccnn_conv3x3_bf16_probe": [p, p, p, p, i, i, i, i, i, i,
                                             p],
            "smt_mccnn_volume": [p, p, p, i, i, i, i, i, f, p],
            "smt_mccnn_fused_volume": [p, p, p, p, i, i, i, i, i, f, i, p],
            "smt_mccnn_fused_volume_probe": [p, p, p, p, i, i, i, i, i, f,
                                             i, i, i, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, device: torch.device, *args,
            entry: str | None = None) -> None:
    """Call C entry point ``smt_<entry or name>`` on the device's current
    stream; count it as a launch of ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(_library(), "smt_" + (entry or name))(*args, stream)
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{code} ({torch.cuda.get_device_name(device)})")
    launches[name] += 1


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """The tensor's device address; NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


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


def _check_volume(t: torch.Tensor, name: str, ndim: int = 3) -> bool:
    """Check a contiguous float32 or int16 volume; True for int16."""
    _check(t, name, torch.int16 if t.dtype == torch.int16 else torch.float32,
           ndim)
    return t.dtype == torch.int16


def n_census_words(window: tuple[int, int]) -> int:
    """The int32 words of a census window: ceil((wh * ww - 1) / 32)."""
    return -(-(window[0] * window[1] - 1) // 32)


def _check_window(window: tuple[int, int]) -> tuple[int, int]:
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError("census window must be odd in both dimensions")
    if wh * ww < 2:
        raise ValueError(f"census window {window} has no neighbour")
    return wh, ww


def _check_words(t: torch.Tensor, name: str) -> torch.Tensor:
    """Contiguous int32 census words, (R, C) for one word or (nw, R, C);
    returned as (nw, R, C)."""
    if t.dim() == 2:
        t = t[None]
    _check(t, name, torch.int32, 3)
    return t


# ------------------------------------------------------- K1 census_words ----

def census_words_plain(imgs: torch.Tensor,
                       window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """(V, H, W) float32 views -> (V, nw, H, W) int32 census words."""
    return torch.stack([census_transform(img, window).permute(2, 0, 1)
                        for img in imgs]).contiguous()


CENSUS_TILE = (16, 128)  # K1's tile: rows (two bands of a warp each), columns
CENSUS_PIXELS = 4        # adjacent pixels a lane of K1
CENSUS_PASS = 16         # window columns a pass of K1's generic body compares


def census_tile_bytes(window: tuple[int, int]) -> int:
    """K1's shared memory for a window: the staged tile's rows, each padded
    for the last lane's 16-byte reads of its last pass
    (``census.cu::tile_pitch``)."""
    wh, ww = window
    TH, TW = CENSUS_TILE
    cw = CENSUS_PASS
    slice_ = -(-(cw + CENSUS_PIXELS - 1) // 4) * 4
    reach = CENSUS_PIXELS * (TW // CENSUS_PIXELS - 1) + \
        (ww - 1) // cw * cw + slice_
    pitch = -(-max(TW + ww - 1, reach) // 4) * 4
    return (TH + wh - 1) * pitch * 4


def census_words_tiled_plain(imgs: torch.Tensor,
                             window: tuple[int, int] = (5, 5),
                             tile: tuple[int, int] = CENSUS_TILE
                             ) -> torch.Tensor:
    """K1's arithmetic on any device, tile by tile: the model the tests hold
    to ``census_words_plain`` and the JAX package.

    Each (rows, cols) tile of a view is staged with its halo by clamped
    coordinates (the edge replication); each window row is compared in
    passes of ``CENSUS_PASS`` columns, a pass's bits put into a
    64-bit accumulator a pixel at its fill, a word written whenever 32 have
    filled, the centre's bit taken out of the pass that holds it (the
    kernel's templated windows, 5x5 and 7x9, set each bit at the position
    this order gives it).
    """
    wh, ww = _check_window(window)
    ry, rx = wh // 2, ww // 2
    V, H, W = imgs.shape
    TH, TW = tile
    cw = CENSUS_PASS
    out = torch.empty((V, n_census_words(window), H, W), dtype=torch.int32,
                      device=imgs.device)
    for y0 in range(0, H, TH):
        ys = torch.arange(y0 - ry, y0 + TH + ry, device=imgs.device)
        for x0 in range(0, W, TW):
            xs = torch.arange(x0 - rx, x0 + TW + rx, device=imgs.device)
            staged = imgs[:, ys.clamp(0, H - 1)][:, :, xs.clamp(0, W - 1)]
            centre = staged[:, ry:ry + TH, rx:rx + TW]
            acc = torch.zeros(centre.shape, dtype=torch.int64,
                              device=imgs.device)
            fill = word = 0
            h, w = min(TH, H - y0), min(TW, W - x0)
            for dy in range(wh):
                for c0 in range(0, ww, cw):
                    n = min(cw, ww - c0)
                    bits = torch.zeros_like(acc)
                    for j in range(n):
                        nb = staged[:, dy:dy + TH, c0 + j:c0 + j + TW]
                        bits |= (nb < centre).to(torch.int64) << j
                    if dy == ry and c0 <= rx < c0 + n:
                        k = rx - c0
                        bits = (bits & ((1 << k) - 1)) | \
                            ((bits >> (k + 1)) << k)
                        n -= 1
                    acc |= bits << fill
                    fill += n
                    if fill >= 32:
                        out[:, word, y0:y0 + h, x0:x0 + w] = _to_int32(
                            acc[:, :h, :w] & 0xFFFFFFFF)
                        acc >>= 32
                        fill -= 32
                        word += 1
            if fill:
                out[:, word, y0:y0 + h, x0:x0 + w] = _to_int32(
                    acc[:, :h, :w])
    return out


def census_words(imgs: torch.Tensor,
                 window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """(V, H, W) float32 views -> (V, nw, H, W) int32 census words (K1).

    ``nw = n_census_words(window)``: bit k of the descriptor is bit k % 32
    of word k // 32 (``ops/census.py::census_transform``'s packing). On the
    card the window's staged tile must fit a block's shared memory
    (``census_tile_bytes`` <= 232448 bytes: a square window up to 175
    pixels across); the plain version on the CPU takes any window.
    """
    wh, ww = _check_window(window)
    _check(imgs, "imgs", torch.float32, 3)
    if _on_cpu(imgs):
        return census_words_plain(imgs, window)
    if census_tile_bytes(window) > SMEM_MAX:
        raise ValueError(f"census window {window}: K1's staged tile takes "
                         f"{census_tile_bytes(window)} bytes of shared "
                         f"memory, more than the {SMEM_MAX} a block has")
    V, H, W = imgs.shape
    out = torch.empty((V, n_census_words(window), H, W), dtype=torch.int32,
                      device=imgs.device)
    _launch("census_words", imgs.device, _ptr(imgs), _ptr(out), V, H, W,
            wh, ww)
    return out


# ------------------------------------------------------ K2 census_volume ----

MAX_CENSUS_WORDS = 8   # K2 holds a pixel's words in registers

def census_volume_plain(cl: torch.Tensor, cr: torch.Tensor,
                        num_disparities: int, min_disparity: int = 0,
                        dtype=torch.float32,
                        transposed: bool = False) -> torch.Tensor:
    """(H, W) or (nw, H, W) int32 census words of both views -> (D, H, W)
    volume.

    ``transposed``: (W, H) or (nw, W, H) words -> the (D, W, H) volume.
    """
    build = census_volume_T_from_words if transposed \
        else census_volume_from_words
    cl, cr = (w[None] if w.dim() == 2 else w for w in (cl, cr))
    return build(cl, cr, num_disparities, min_disparity, dtype)


def census_volume(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int,
                  min_disparity: int = 0, dtype=torch.float32,
                  transposed: bool = False) -> torch.Tensor:
    """(nw, H, W) int32 census words of both views -> (D, H, W) volume (K2).

    Hamming cost of ``cl[:, y, x]`` against ``cr[:, y, x - d]``, summed over
    the ``nw`` words; where x < d, 1e4 (``dtype`` float32) or 1024 (int16).
    A single word may come as an (H, W) tensor. With ``transposed`` the
    words are (nw, W, H) and the volume is (D, W, H), as
    ``census_volume_T_pallas`` builds it for the horizontal scans.
    """
    if min_disparity < 0:
        raise ValueError("census_volume needs min_disparity >= 0")
    dt = volume_dtype(dtype)
    cl, cr = _check_words(cl, "cl"), _check_words(cr, "cr")
    if cl.shape != cr.shape:
        raise ValueError(f"census images differ: {cl.shape} vs {cr.shape}")
    if _on_cpu(cl, cr):
        return census_volume_plain(cl, cr, num_disparities, min_disparity, dt,
                                   transposed)
    nw, R, C = cl.shape
    if nw > MAX_CENSUS_WORDS:
        raise ValueError(f"census_volume takes at most {MAX_CENSUS_WORDS} "
                         f"words a pixel on the card, got {nw}")
    out = torch.empty((num_disparities, R, C), dtype=dt, device=cl.device)
    _launch("census_volume", cl.device, _ptr(cl), _ptr(cr), _ptr(out), R, C,
            nw, num_disparities, min_disparity, int(transposed),
            int(dt == torch.int16))
    return out


# ------------------------------------------------------ K3 sgm_path_scan ----

SCAN_MAX_DISPARITIES = 1024   # K3 and K10: a line's disparities in one warp


def _check_scan_disparities(name: str, D: int) -> None:
    """The card's limit of K3 and K10, checked where the kernel runs: the
    plain scans on the CPU take any D."""
    if D > SCAN_MAX_DISPARITIES:
        raise ValueError(f"{name} on the card holds a line's disparities in "
                         f"one warp's registers: at most "
                         f"{SCAN_MAX_DISPARITIES}, got {D}")


def _check_scan(cost: torch.Tensor, total: torch.Tensor, dy: int, dx: int,
                init_carry: torch.Tensor | None,
                return_carry: bool) -> None:
    _check_volume(cost, "cost")
    _check(total, "total", cost.dtype, 3)
    if cost.shape != total.shape:
        raise ValueError(f"cost {tuple(cost.shape)} and total "
                         f"{tuple(total.shape)} differ")
    if dy not in (-1, 0, 1) or dx not in (-1, 0, 1) or dy == dx == 0:
        raise ValueError(f"bad path direction {(dy, dx)}")
    if (init_carry is not None or return_carry) and dy == 0:
        raise ValueError("horizontal directions take no carry")
    if init_carry is not None:
        _check(init_carry, "init_carry", cost.dtype, 2)
        want = (cost.shape[0], cost.shape[2])
        if tuple(init_carry.shape) != want:
            raise ValueError(f"init_carry {tuple(init_carry.shape)}: "
                             f"expected {want}")


def sgm_path_scan_plain(cost: torch.Tensor, total: torch.Tensor, dy: int,
                        dx: int, p1: float, p2: float, accumulate: bool,
                        init_carry: torch.Tensor | None = None,
                        return_carry: bool = False):
    """Add (or, with ``accumulate=False``, write) L_(dy,dx) into ``total``.

    With ``return_carry`` also returns the scan-order-last row of L, the
    (D, W) carry of ``init_carry`` for the next row shard.
    """
    L = aggregate_direction(cost, dy, dx, p1, p2, init_carry)
    total = total.add_(L) if accumulate else total.copy_(L)
    if return_carry:
        return total, L[:, -1 if dy > 0 else 0].clone()
    return total


def sgm_path_scan(cost: torch.Tensor, total: torch.Tensor, dy: int, dx: int,
                  p1: float, p2: float, accumulate: bool,
                  init_carry: torch.Tensor | None = None,
                  return_carry: bool = False):
    """One SGM path direction over (D, H, W) ``cost``, into ``total`` (K3).

    Updates ``total`` in place (the first direction of a frame passes
    ``accumulate=False`` and overwrites it) and returns it. ``cost`` and
    ``total`` are float32, or int16 (P1 and P2 truncated to integers, as
    the XLA int16 path does). For dy != 0, ``init_carry`` (D, W) is the
    previous row shard's carry and ``return_carry`` returns
    ``(total, carry)`` with this shard's (``ops/sgm.py::aggregate_direction``).
    On the card D is at most ``SCAN_MAX_DISPARITIES`` (1024: one warp
    holds a line's disparities in registers; a larger D raises ValueError);
    the plain scan on the CPU takes any D.
    """
    _check_scan(cost, total, dy, dx, init_carry, return_carry)
    extra = () if init_carry is None else (init_carry,)
    if _on_cpu(cost, total, *extra):
        return sgm_path_scan_plain(cost, total, dy, dx, p1, p2, accumulate,
                                   init_carry, return_carry)
    _check_scan_disparities("sgm_path_scan", cost.shape[0])
    D, H, W = cost.shape
    i16 = cost.dtype == torch.int16
    if i16:
        p1, p2 = int(p1), int(p2)
    carry = torch.empty((D, W), dtype=cost.dtype, device=cost.device) \
        if return_carry else None
    _launch("sgm_path_scan", cost.device, _ptr(cost), _ptr(total),
            _ptr(init_carry), _ptr(carry), D, H, W, dy, dx, float(p1),
            float(p2), int(accumulate), int(i16))
    return (total, carry) if return_carry else total


def aggregate_paths(cost: torch.Tensor, p1: float, p2: float,
                    num_paths: int = 8, scan=sgm_path_scan) -> torch.Tensor:
    """The SGM total over the first ``num_paths`` of ``PATH_DIRECTIONS_8``.

    One ``scan`` per direction, in the order ``ops/sgm.py::sgm_aggregate``
    adds them, the first writing the total (of the volume's dtype).
    ``scan`` is K3 by default; ``sgm_path_scan_plain`` gives the plain
    version on any device.
    """
    total = torch.empty_like(cost)
    for i, (dy, dx) in enumerate(PATH_DIRECTIONS_8[:num_paths]):
        scan(cost, total, dy, dx, p1, p2, accumulate=i > 0)
    return total


# ------------------------------------------------------------- K4 wta_lr ----

WTA_BIG = 3e9   # c0 / c2 / second where no such d exists


def wta_stats_plain(total: torch.Tensor):
    """(D, H, W) float32 or int16 costs -> (best, idx, c0, c2, second).

    Per pixel the best cost, its first index (int32), the costs at idx -+ 1
    and the best cost outside idx +- 1, float32, 3e9 where no such d
    exists: ``_wta_stats_rows`` of the JAX package.
    """
    total = total.to(torch.float32)
    D = total.shape[0]
    d_iota = torch.arange(D, device=total.device)[:, None, None]
    best = total.amin(dim=0)
    idx = torch.where(total == best[None], d_iota, D).amin(dim=0)
    edge = torch.full_like(total[:1], WTA_BIG)
    c0 = torch.cat([edge, total[:-1]]).gather(0, idx[None])[0]
    c2 = torch.cat([total[1:], edge]).gather(0, idx[None])[0]
    near = (d_iota - idx[None]).abs() <= 1
    second = torch.where(near, WTA_BIG, total).amin(dim=0)
    return best, idx.to(torch.int32), c0, c2, second


def right_wta_plain(total: torch.Tensor) -> torch.Tensor:
    """(D, H, W) costs -> (H, W) int32 argmin over in-frame d of
    C(d, y, xr + d), ties to the smallest d (without min_disparity)."""
    total = total.to(torch.float32)
    D, H, W = total.shape
    rbest = torch.full((H, W), WTA_BIG, dtype=torch.float32,
                       device=total.device)
    ridx = torch.zeros((H, W), dtype=torch.int32, device=total.device)
    for d in range(min(D, W)):          # ascending d, strict <: first on ties
        v = total[d, :, d:]
        better = v < rbest[:, :W - d]
        rbest[:, :W - d] = torch.where(better, v, rbest[:, :W - d])
        ridx[:, :W - d] = torch.where(better, d, ridx[:, :W - d])
    return ridx


WTA_TILE = 64   # K4's widest staged tile, in columns


def wta_walk_plain(total: torch.Tensor, tile: int = WTA_TILE):
    """K4's walk of a (D, H, W) total, in the kernel's order of visits.

    Returns ``(best, idx, c0, c2, second, ridx)``, which must equal
    ``wta_stats_plain`` and ``right_wta_plain`` bit for bit. Left
    statistics: S d-phases a column (S = 4 for 64-column tiles, else 8;
    phase s takes d = s, s + S, ...), each walked once for its first
    minimum b1 at i1 and b2, the minimum of its other costs; the first
    argmin is the (cost, d) lexicographic min of the b1, and the best cost
    outside idx +- 1 the min over the phases of b2 where i1 is within 1 of
    idx, else b1 (idx - 1, idx, idx + 1 lie in distinct phases). Right
    view: tile by tile of ``tile`` columns, each diagonal's cells in
    increasing d with strict <, from the running (minimum, argmin) of
    xr = x - d (3e9 and 0 at the start); a later tile holds larger d of the
    same xr. (``right_wta`` stages 32 planes by 256 columns a tile, plane
    block after plane block within a column block: a diagonal meets its
    cells in the same increasing d.)
    """
    total = total.to(torch.float32)
    D, H, W = total.shape
    dev = total.device
    S = 4 if tile > 32 else 8
    inf = torch.full((H, W), float("inf"), device=dev)
    b1s, i1s, b2s = [], [], []
    for s in range(S):
        sub = total[s::S]
        if sub.shape[0] == 0:
            b1s.append(inf)
            i1s.append(torch.full((H, W), D, device=dev))
            b2s.append(inf)
            continue
        d_iota = torch.arange(s, D, S, device=dev)[:, None, None]
        b1 = sub.amin(dim=0)
        first = torch.where(sub == b1[None], d_iota, D).amin(dim=0)
        b1s.append(b1)
        i1s.append(first)
        b2s.append(torch.where(d_iota == first[None], float("inf"), sub)
                   .amin(dim=0) if sub.shape[0] > 1 else inf)
    b1s, i1s, b2s = torch.stack(b1s), torch.stack(i1s), torch.stack(b2s)
    best = b1s.amin(dim=0)
    idx = torch.where(b1s == best[None], i1s, D).amin(dim=0)
    near = (i1s - idx[None]).abs() <= 1
    second = torch.where(near, b2s, b1s).amin(dim=0).clamp(max=WTA_BIG)
    edge = torch.full_like(total[:1], WTA_BIG)
    c0 = torch.cat([edge, total[:-1]]).gather(0, idx[None])[0]
    c2 = torch.cat([total[1:], edge]).gather(0, idx[None])[0]
    rbest = torch.full((H, W), WTA_BIG, device=dev)
    ridx = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for x0 in range(0, W, tile):
        x1 = min(x0 + tile, W)
        for d in range(D):
            lo = max(x0, d)                      # x - d >= 0
            if lo >= x1:
                continue
            v = total[d, :, lo:x1]
            r = slice(lo - d, x1 - d)
            better = v < rbest[:, r]
            rbest[:, r] = torch.where(better, v, rbest[:, r])
            ridx[:, r] = torch.where(better, d, ridx[:, r])
    return best, idx.to(torch.int32), c0, c2, second, ridx


def tie_heavy_total(D: int, H: int, W: int, seed: int = 0):
    """A (D, H, W) float32 numpy total made to stress K4's ties.

    Small integer costs (exact in int16 too), the rows cycling through:
    random costs 0..3; constant planes; the minimum at d = 0; at d = D - 1;
    a run of equal minima over idx - 1 .. idx + 1; equal costs along every
    right-view diagonal C(d, y, xr + d).
    """
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (D, H, W)).astype(np.float32)
    for y in range(H):
        kind = y % 6
        if kind == 1:
            t[:, y] = float(rng.integers(0, 4))
        elif kind in (2, 3):
            t[:, y] += 2.0
            t[0 if kind == 2 else D - 1, y] = rng.integers(0, 2, W)
        elif kind == 4:
            t[:, y] += 2.0
            at = rng.integers(0, D, W)
            for k in (-1, 0, 1):
                d = np.clip(at + k, 0, D - 1)
                t[d, y, np.arange(W)] = 1.0
        elif kind == 5:
            x = np.arange(W)[None, :] - np.arange(D)[:, None]   # xr
            t[:, y] = 1.0 + (x % 3 == 0)
    return t


def wta_lr_plain(total: torch.Tensor, min_disparity: int = 0,
                 uniqueness_ratio: int = 15, disp12_max_diff: int = 1,
                 subpixel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, H, W) aggregated costs -> (disp, disp_right), each (H, W) float32.

    The statistics form of ``ops/wta.py::extract_disparity``: per pixel the
    best cost, its first index, the costs at idx +- 1 and the best cost
    outside idx +- 1; the right-view argmin over in-frame d (ties to the
    smallest d); then subpixel, uniqueness and the disp12 check.
    """
    disp, mask = disparity_from_stats(wta_stats_plain(total), total.shape[0],
                                      min_disparity, uniqueness_ratio,
                                      subpixel)
    disp_right = (right_wta_plain(total) + min_disparity).to(torch.float32)
    mask = mask & lr_mask_plain(disp, disp_right, disp12_max_diff)
    return torch.where(mask, disp, torch.nan), disp_right


def wta_lr(total: torch.Tensor, min_disparity: int = 0,
           uniqueness_ratio: int = 15, disp12_max_diff: int = 1,
           subpixel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, H, W) float32 or int16 aggregated costs -> (disp, disp_right) (K4).

    ``disp`` is float32 with NaN where the uniqueness or disp12 check fails
    (``uniqueness_ratio <= 0`` / ``disp12_max_diff < 0`` disable them);
    ``disp_right`` is the right-view WTA disparity used by the check.
    """
    i16 = _check_volume(total, "total")
    if _on_cpu(total):
        return wta_lr_plain(total, min_disparity, uniqueness_ratio,
                            disp12_max_diff, subpixel)
    D, H, W = total.shape
    disp = torch.empty((H, W), dtype=torch.float32, device=total.device)
    disp_right = torch.empty_like(disp)
    _launch("wta_lr", total.device, _ptr(total), _ptr(disp), _ptr(disp_right),
            D, H, W, min_disparity, uniqueness_ratio, disp12_max_diff,
            int(subpixel), int(i16))
    return disp, disp_right


def wta_stats(total: torch.Tensor):
    """(D, H, W) float32 or int16 costs -> (best, idx, c0, c2, second) (K4).

    The five (H, W) maps of ``wta_stats_plain``: idx int32, the rest
    float32.
    """
    i16 = _check_volume(total, "total")
    if _on_cpu(total):
        return wta_stats_plain(total)
    D, H, W = total.shape
    f32 = dict(dtype=torch.float32, device=total.device)
    best, c0, c2, second = (torch.empty((H, W), **f32) for _ in range(4))
    idx = torch.empty((H, W), dtype=torch.int32, device=total.device)
    _launch("wta_stats", total.device, _ptr(total), _ptr(best), _ptr(idx),
            _ptr(c0), _ptr(c2), _ptr(second), D, H, W, int(i16))
    return best, idx, c0, c2, second


def right_wta(total: torch.Tensor) -> torch.Tensor:
    """(D, H, W) float32 or int16 costs -> (H, W) int32 right-view argmin
    (K4; ties to the smallest d, without min_disparity)."""
    i16 = _check_volume(total, "total")
    if _on_cpu(total):
        return right_wta_plain(total)
    D, H, W = total.shape
    ridx = torch.empty((H, W), dtype=torch.int32, device=total.device)
    _launch("right_wta", total.device, _ptr(total), _ptr(ridx), D, H, W,
            int(i16))
    return ridx


def lr_mask_plain(disp: torch.Tensor, disp_right: torch.Tensor,
                  disp12_max_diff: float) -> torch.Tensor:
    """(H, W) bool disp12 check of ``ops/wta.py::lr_consistency_mask``."""
    return lr_consistency_mask(disp, disp_right, disp12_max_diff)


def lr_mask(disp: torch.Tensor, disp_right: torch.Tensor,
            disp12_max_diff: float) -> torch.Tensor:
    """The disp12 check of (H, W) float32 maps -> (H, W) bool (K4).

    True where ``xr = round(x - disp)`` (half to even) lies in the frame
    and ``|disp - disp_right[xr]| <= disp12_max_diff``; NaN ``disp`` gives
    False; ``disp12_max_diff < 0`` gives all True. The tolerance is a float
    (rounded to float32), as ``lr_mask_pallas`` takes ELAS's ``lr_tol``.
    """
    _check(disp, "disp", torch.float32, 2)
    _check(disp_right, "disp_right", torch.float32, 2)
    if disp.shape != disp_right.shape:
        raise ValueError(f"disp {tuple(disp.shape)} and disp_right "
                         f"{tuple(disp_right.shape)} differ")
    if _on_cpu(disp, disp_right):
        return lr_mask_plain(disp, disp_right, disp12_max_diff)
    H, W = disp.shape
    mask = torch.empty((H, W), dtype=torch.bool, device=disp.device)
    _launch("lr_mask", disp.device, _ptr(disp), _ptr(disp_right), _ptr(mask),
            H, W, float(disp12_max_diff))
    return mask


def extract_disparity_fast(agg: torch.Tensor, min_disparity: int = 0,
                           uniqueness_ratio: int = 15,
                           disp12_max_diff: int = 1, subpixel: bool = True,
                           return_right: bool = False, stats=None):
    """``ops/wta.py::extract_disparity`` on K4's stand-alone entries.

    The JAX package's ``extract_disparity_fast``: ``stats`` is the
    ``(best, idx, c0, c2, second[, right_idx])`` tuple when the caller has
    it; otherwise ``wta_stats`` computes it from ``agg`` (float32 or int16,
    one volume pass). The disp12 check takes the right view from
    ``right_wta`` unless ``stats`` carries it, and runs on ``lr_mask``. The
    rest is ``ops/wta.py::disparity_from_stats``.
    """
    if agg.dtype not in (torch.float32, torch.int16):
        agg = agg.to(torch.float32)
    if stats is None:
        stats = wta_stats(agg)
    disp, mask = disparity_from_stats(stats, agg.shape[0], min_disparity,
                                      uniqueness_ratio, subpixel)
    disp_right = None
    if disp12_max_diff >= 0 or return_right:
        ridx = stats[5] if len(stats) > 5 else right_wta(agg)
        disp_right = (ridx + min_disparity).to(torch.float32)
    if disp12_max_diff >= 0:
        mask = mask & lr_mask(disp, disp_right, disp12_max_diff)
    disp = torch.where(mask, disp, torch.nan)
    return (disp, disp_right) if return_right else disp


# ----------------------------------------------------- K5 speckle_filter ----

def _neighbor_shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift (H, W) by (dy, dx) filling exposed cells."""
    out = torch.roll(x, (dy, dx), dims=(0, 1))
    if dy == 1:
        out[0, :] = fill
    elif dy == -1:
        out[-1, :] = fill
    if dx == 1:
        out[:, 0] = fill
    elif dx == -1:
        out[:, -1] = fill
    return out


def connectivity(d: torch.Tensor, max_diff: float) -> torch.Tensor:
    """(H, W) float32 disparities -> (H, W) uint8 packed connectivity.

    Bit ``CONN_LEFT`` of a pixel is set when it is connected to its left
    neighbour (``conn_x`` of the reference), bit ``CONN_UP`` when it is
    connected to the pixel above (``conn_y``). Only valid pixels set bits;
    an invalid neighbour compares as ``inf``, which joins nothing unless
    ``max_diff`` is inf, as in the reference.
    """
    valid = torch.isfinite(d)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=d.device)
    dval = torch.where(valid, d, inf)
    tol = torch.tensor(max_diff, dtype=torch.float32, device=d.device)
    conn_x = valid & ((_neighbor_shift(dval, 0, 1, inf) - dval).abs() <= tol)
    conn_y = valid & ((_neighbor_shift(dval, 1, 0, inf) - dval).abs() <= tol)
    return (conn_x.to(torch.uint8) * CONN_LEFT) | \
        (conn_y.to(torch.uint8) * CONN_UP)


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
    _check_labels(labels, conn)
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


def speckle_count_keep_plain(d: torch.Tensor, labels: torch.Tensor,
                             threshold: int,
                             unconverged: bool) -> torch.Tensor:
    """Pixels of components under ``threshold`` valid pixels -> NaN.

    Sizes count the valid pixels of a label, as the reference's
    ``segment_sum`` of ``valid`` does (an invalid pixel can take a
    component's label when ``max_diff`` is inf). ``unconverged`` keeps
    every valid pixel (the sweeps hit their cap).
    """
    valid = torch.isfinite(d)
    sizes = torch.zeros(labels.numel() + 2, dtype=torch.int64,
                        device=d.device).scatter_add_(
        0, labels.reshape(-1).to(torch.int64), valid.reshape(-1).to(
            torch.int64))
    keep = (sizes[labels.to(torch.int64)] >= threshold) | bool(unconverged)
    return torch.where(keep & valid, d, torch.nan)


def speckle_fixpoint_plain(d: torch.Tensor, threshold: int, max_diff: float,
                           max_iters: int = 64):
    """The plain speckle filter: (out, sweeps, unconverged).

    Labels start as ``y * W + x`` (``H * W + 1`` for invalid pixels); sweeps
    run while one lowers a label, at most ``max_iters``; ``unconverged``
    is whether the last sweep still lowered one. Reads the changed flag on
    the host once a sweep. The model of K5 ``speckle_filter``, which
    reports the same ``sweeps`` and ``unconverged`` in its ``stats``.
    """
    _check(d, "d", torch.float32, 2)
    H, W = d.shape
    lin = torch.arange(H * W, dtype=torch.int32, device=d.device).view(H, W)
    labels = torch.where(torch.isfinite(d), lin, H * W + 1).to(
        torch.int32).contiguous()
    conn = connectivity(d, max_diff)
    changed, sweeps = True, 0
    while changed and sweeps < max_iters:
        changed = bool(speckle_sweep_plain(labels, conn))
        sweeps += 1
    return (speckle_count_keep_plain(d, labels, threshold, changed), sweeps,
            changed)


# csrc/speckle.cu keeps a label in 30 bits of a word and stages a whole row
# in shared memory
SPECKLE_MAX_PIXELS, SPECKLE_MAX_WIDTH = 1 << 29, 25600


def speckle_filter(d: torch.Tensor, threshold: int, max_diff: float,
                   max_iters: int = 64):
    """The whole speckle filter on (H, W) float32 ``d`` (K5).

    Returns ``(out, stats)``: ``out`` is ``d`` with NaN where the pixel is
    invalid or its component has fewer than ``threshold`` valid pixels
    (every valid pixel is kept if ``max_iters`` sweeps did not converge);
    ``stats`` is an int32 tensor ``[sweeps, unconverged]`` on ``d``'s
    device. On a CUDA tensor this is one cooperative kernel launch and no
    host sync (reading ``stats`` syncs; the filter itself never does); a
    card that cannot run it raises. A CPU tensor runs
    ``speckle_fixpoint_plain``.
    """
    _check(d, "d", torch.float32, 2)
    if _on_cpu(d):
        out, sweeps, unconverged = speckle_fixpoint_plain(d, threshold,
                                                          max_diff, max_iters)
        return out, torch.tensor([sweeps, int(unconverged)],
                                 dtype=torch.int32)
    H, W = d.shape
    if H * W >= SPECKLE_MAX_PIXELS or W > SPECKLE_MAX_WIDTH:
        raise ValueError(f"speckle_filter: {H}x{W}; the card takes fewer "
                         f"than {SPECKLE_MAX_PIXELS} pixels and rows of at "
                         f"most {SPECKLE_MAX_WIDTH}")
    dev = d.device
    out = torch.empty_like(d)
    labels = torch.empty((H, W), dtype=torch.int32, device=dev)
    count = torch.empty(H * W, dtype=torch.int32, device=dev)
    flags = torch.empty(max(int(max_iters), 1), dtype=torch.int32,
                        device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    _launch("speckle_filter", dev, _ptr(d), _ptr(out), _ptr(labels),
            _ptr(count), _ptr(flags), _ptr(stats), H, W,
            min(int(threshold), 2 ** 31 - 1), float(max_diff),
            int(max_iters))
    return out, stats


# ---------------------------------------------------------- K7 fgs_solve ----

# The segments K7 splits a line into: the 32 lanes of a warp along a row
# (axis 1), the 16 warps of a block along a column (axis 0); csrc/wls.cu's
# kRowSegments and kColWarps.
FGS_SEGMENTS = {0: 16, 1: 32}
SMEM_MAX = 232448   # dynamic shared memory a block may take (H100)


def _check_solve(f: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor,
                 axis: int) -> None:
    _check(f, "f", torch.float32, 3)
    _check(wp, "wp", torch.float32, 2)
    _check(wn, "wn", torch.float32, 2)
    if wp.shape != f.shape[1:] or wn.shape != f.shape[1:]:
        raise ValueError(f"weights {tuple(wp.shape)}, {tuple(wn.shape)} do "
                         f"not match the slab {tuple(f.shape)}")
    if f.shape[0] not in (1, 2):
        raise ValueError("fgs_solve takes one or two right-hand sides")
    if axis not in (0, 1):
        raise ValueError(f"fgs_solve solves along axis 0 or 1, not {axis}")


def _along_axis0(solve, f, wp, wn, lam, axis, *extra):
    """Run ``solve`` (which solves along axis 0) along ``axis``."""
    if axis == 0:
        return solve(f, wp, wn, lam, *extra)
    u = solve(f.transpose(1, 2).contiguous(), wp.T.contiguous(),
              wn.T.contiguous(), lam, *extra)
    return u.transpose(1, 2).contiguous()


def _tridiagonal(wp: torch.Tensor, wn: torch.Tensor, lam: float):
    """The rows (a, b, c) of I + lam*A, in the reference's operations."""
    lam = torch.tensor(lam, dtype=wp.dtype, device=wp.device)
    a = -lam * wp
    c = -lam * wn
    return a, (1.0 - a) - c, c


def _thomas(f, wp, wn, lam):
    C, S, N = f.shape
    a, b, c = _tridiagonal(wp, wn, lam)
    cp = torch.empty_like(wp)
    u = torch.empty_like(f)
    cp_prev = torch.zeros(N, dtype=f.dtype, device=f.device)
    dp_prev = torch.zeros((C, N), dtype=f.dtype, device=f.device)
    for s in range(S):
        denom = b[s] - a[s] * cp_prev
        cp_prev = c[s] / denom
        dp_prev = (f[:, s] - a[s] * dp_prev) / denom
        cp[s] = cp_prev
        u[:, s] = dp_prev
    u_next = torch.zeros((C, N), dtype=f.dtype, device=f.device)
    for s in range(S - 1, -1, -1):
        u_next = u[:, s] - cp[s] * u_next
        u[:, s] = u_next
    return u


def fgs_solve_plain(f: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor,
                    lam: float, axis: int) -> torch.Tensor:
    """Solve (I + lam*A) u = f along ``axis`` of the (H, W) planes of ``f``.

    ``f`` (C, H, W); ``wp``/``wn`` (H, W): edge weights to the predecessor /
    successor along ``axis`` (zero at each line's two ends, the Neumann
    boundary). The sequential Thomas algorithm of
    ``ops/wls.py::_tridiagonal_smooth_rows``, vectorised over the lines, in
    the reference's operation order, in the dtype of ``f`` (float64 gives
    the reference of the card checks). Along axis 1 it solves the
    transposed slab.
    """
    return _along_axis0(_thomas, f, wp, wn, lam, axis)


def _shifted(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[..., i + k, :] along dim -2, ``fill`` (a number, or a tensor that
    broadcasts) where i + k leaves it."""
    n = x.shape[-2]
    pad = torch.zeros_like(x[..., :min(abs(k), n), :]) + fill
    if k > 0:
        return torch.cat([x[..., k:, :], pad], -2)[..., :n, :]
    return torch.cat([pad, x[..., :max(n + k, 0), :]], -2)[..., -n:, :]


def _partitioned(f, wp, wn, lam, segments):
    C, S, N = f.shape
    P = segments
    m = max(2, -(-S // P))
    pad = P * m - S                  # identity rows: zero weights and data
    wp, wn = (Fn.pad(w, (0, 0, 0, pad)) for w in (wp, wn))
    a, b, c = _tridiagonal(wp, wn, lam)
    # one more right-hand side, of ones: A is a Laplacian, so I + lam*A
    # maps all ones to all ones, and every pivot below is that side's value
    # plus its row's off-diagonal magnitudes, never a cancelling difference
    f = torch.cat([Fn.pad(f, (0, 0, 0, pad)), torch.ones_like(a)[None]])
    f = f.reshape(C + 1, P, m, N)
    a, b, c = (t.reshape(P, m, N) for t in (a, b, c))
    # forward: row j of a segment becomes a'_j x_s + x_j + c'_j x_(j+1) =
    # d'_j (rows 0 and 1 only normalised; row 0's a' couples to the
    # previous segment's last unknown)
    ap, cp, dp = torch.empty_like(a), torch.empty_like(c), torch.empty_like(f)
    for j in range(m):
        if j < 2:
            den = b[:, j]
            ap[:, j] = a[:, j] / den
            dp[:, :, j] = f[:, :, j] / den
        else:
            g = f[:, :, j] - a[:, j] * dp[:, :, j - 1]
            spike = -(a[:, j] * ap[:, j - 1])
            den = (g[C] - spike) - c[:, j]
            ap[:, j] = spike / den
            dp[:, :, j] = g / den
        cp[:, j] = c[:, j] / den
    # backward, for row 0 only: A x_(e-1) + x_s + B x_e = D, x_e the
    # segment's last unknown and x_(e-1) the previous segment's
    A, B, D = ap[:, 0], cp[:, 0], dp[:, :, 0]
    if m > 2:
        app, cpp, dpp = ap[:, m - 2], cp[:, m - 2], dp[:, :, m - 2]
        for j in range(m - 3, 0, -1):
            dpp = dp[:, :, j] - cp[:, j] * dpp
            app = ap[:, j] - cp[:, j] * app
            cpp = -(cp[:, j] * cpp)
        g = D - B * dpp
        Bn = -(B * cpp)
        den = (g[C] - A) - Bn
        A, B, D = A / den, Bn / den, g / den
    F, G, R = ap[:, m - 1], cp[:, m - 1], dp[:, :, m - 1]
    # the reduced system in the segments' last unknowns: eliminate the
    # first ones (one step of cyclic reduction) ...
    A1, B1, D1 = (_shifted(t, 1, 0.0) for t in (A, B, D))
    ea, ec = -(F * A), -(G * B1)
    ed = (R - F * D) - G * D1
    eb = (ed[C] - ea) - ec
    # ... then parallel cyclic reduction, identity rows (ones side 1) past
    # either end
    identity_d = torch.zeros((C + 1, 1, 1), dtype=f.dtype, device=f.device)
    identity_d[C] = 1.0
    s = 1
    while s < P:
        (am, bm, cm, dm), (aq, bq, cq, dq) = (
            [_shifted(t, k, v) for t, v in ((ea, 0.0), (eb, 1.0), (ec, 0.0),
                                            (ed, identity_d))]
            for k in (-s, s))
        k1, k2 = ea / bm, ec / bq
        ea, ec = -(k1 * am), -(k2 * cq)
        ed = (ed - k1 * dm) - k2 * dq
        eb = (ed[C] - ea) - ec
        s *= 2
    xe = ed[:C] / eb
    xs = (D[:C] - A * _shifted(xe, -1, 0.0)) - B * xe
    # back substitution inside each segment
    u = torch.empty_like(f[:C])
    u[:, :, 0], u[:, :, m - 1] = xs, xe
    x = xe
    for j in range(m - 2, 0, -1):
        x = (dp[:C, :, j] - ap[:, j] * xs) - cp[:, j] * x
        u[:, :, j] = x
    return u.reshape(C, P * m, N)[:, :S].contiguous()


def fgs_solve_partitioned_plain(f: torch.Tensor, wp: torch.Tensor,
                                wn: torch.Tensor, lam: float, axis: int,
                                segments: int | None = None) -> torch.Tensor:
    """K7's partitioned algorithm in plain torch, in the kernel's operations.

    The same solve as :func:`fgs_solve_plain`. Each line is padded with
    identity rows to ``segments`` segments of m = max(2, ceil(S / segments))
    unknowns (``segments`` defaults to K7's for ``axis``). Each segment
    eliminates locally, keeping the coupling ("spike") columns to its first
    unknown and to its neighbours'; the segments' first and last unknowns
    form a reduced tridiagonal system, solved by one step of cyclic
    reduction and parallel cyclic reduction; then each segment
    back-substitutes. Every pivot is taken from a right-hand side of ones,
    carried along (I + lam*A maps ones to ones), rather than by a
    subtraction that cancels (Grassmann, Taksar and Heyman's rule for
    M-matrices), so it is far closer to a float64 solve than the
    sequential float32 one. For the tests and ``chip_smoke.py``: the kernel
    is held to it bit for bit, and it is held to the float64 plain solve.
    """
    P = FGS_SEGMENTS[axis] if segments is None else segments
    if P < 1:
        raise ValueError(f"segments must be positive, not {P}")
    return _along_axis0(_partitioned, f, wp, wn, lam, axis, P)


def _fgs_len(S: int, axis: int) -> int:
    """Unknowns a segment of a line of S along ``axis`` (at least 2)."""
    return max(2, -(-S // FGS_SEGMENTS[axis]))


def fgs_solve(f: torch.Tensor, wp: torch.Tensor, wn: torch.Tensor,
              lam: float, axis: int) -> torch.Tensor:
    """Tridiagonal solves along ``axis`` of the (C, H, W) slab ``f`` (K7).

    ``axis=1`` solves the rows (along W), ``axis=0`` the columns. ``wp``,
    ``wn`` (H, W) as :func:`fgs_solve_plain` takes them; ``lam`` is a
    float32 value (the smoother's lambda schedule is computed in float32);
    C = 1 or 2 right-hand sides share one elimination. On the card the
    kernel runs :func:`fgs_solve_partitioned_plain`'s algorithm.
    """
    _check_solve(f, wp, wn, axis)
    if _on_cpu(f, wp, wn):
        return fgs_solve_plain(f, wp, wn, lam, axis)
    C, H, W = f.shape
    if axis == 1 and (3 + C) * 32 * (_fgs_len(W, 1) | 1) * 4 > SMEM_MAX:
        raise ValueError(f"fgs_solve: rows of {W} do not fit one warp's "
                         f"shared memory on the card")
    Hp = FGS_SEGMENTS[0] * _fgs_len(H, 0)
    scratch = torch.empty((3 + C, Hp, -(-W // 32) * 32), dtype=f.dtype,
                          device=f.device) if axis == 0 else None
    u = torch.empty_like(f)
    _launch("fgs_solve", f.device, _ptr(f), _ptr(wp), _ptr(wn),
            _ptr(scratch), _ptr(u), C, H, W, axis, float(lam))
    return u


# ------------------------------------------------------ K8 mccnn_conv3x3 ----

MCCNN_MAX_FEATURES = 128


@contextlib.contextmanager
def fp32_cudnn():
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
    """(F, C_in, 3, 3) OIHW weights -> the (3, 3, C_in, F) layout K8 reads
    for C_in = 1.

    The flax kernel layout: taps, then input channels, then outputs, so a
    block's staging of a few input channels reads contiguous rows of F.
    """
    return weight.permute(2, 3, 1, 0).contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives, as a float32 whose low 13 bits
    are zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo), both TF32: hi = tf32(x), lo = tf32(x - hi).

    hi + lo equals x within 2^-22 of |x|; K8 forms a product as
    lo*hi + hi*lo + hi*hi (3xTF32).
    """
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def _mccnn_padded(C_in: int, F: int) -> tuple[int, int]:
    """(C8, F8): C_in to a multiple of 8 (the k8 steps), F to the next of
    32, 64, 112, 128 (K8's n8 tile counts); ValueError for F > 128."""
    _check_mccnn_features(F)
    return -(-C_in // 8) * 8, next(n for n in (32, 64, 112, 128) if n >= F)


def _check_mccnn_features(F: int) -> None:
    """K8's limit on the card: a pixel's F outputs in one block."""
    if F > MCCNN_MAX_FEATURES:
        raise ValueError(f"{F} features: K8 on the card holds at most "
                         f"{MCCNN_MAX_FEATURES} per pixel (the plain layer "
                         "on the CPU takes any F)")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 value (ties to even), as float32:
    what ``__float2bfloat16_rn`` gives and what a flax layer in bfloat16
    stores."""
    return x.to(torch.bfloat16).to(torch.float32)


def mccnn_pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """(F, C_in, 3, 3) OIHW -> the float32 layout K8's 3xTF32 body reads,
    the (3, 3, C_in, F) taps zero-padded to C8 input and F8 output channels
    (``_mccnn_padded``): (2, 3, 3, C8, F8), ``tf32_split``'s hi then lo."""
    F, C_in = weight.shape[:2]
    C8, F8 = _mccnn_padded(C_in, F)
    packed = torch.zeros((2, 3, 3, C8, F8), dtype=torch.float32,
                         device=weight.device)
    for i, part in enumerate(tf32_split(conv_taps(weight))):
        packed[i, :, :, :C_in, :F] = part
    return packed


MCCNN_BF16_K = 16   # K8's bfloat16 body: input channels a k16 step (a stage)


def _mccnn_c16(C_in: int) -> int:
    """C_in padded to a multiple of 16: the k16 steps of the bf16 body."""
    return -(-C_in // MCCNN_BF16_K) * MCCNN_BF16_K


def mccnn_pack_weights_bf16(weight: torch.Tensor) -> torch.Tensor:
    """(F, C_in, 3, 3) OIHW -> the bfloat16 layout K8's bfloat16
    tensor-core body reads: (9, F8, C16), element [3 ky + kx, f, c] =
    bf16(weight[f, c, ky, kx]), zero where f >= F or c >= C_in (F8 as
    ``_mccnn_padded``, C16 a multiple of 16). K-major: a tap's output f is
    a row of input channels, so 8 of them are one ldmatrix row of B."""
    F, C_in = weight.shape[:2]
    F8 = _mccnn_padded(C_in, F)[1]
    packed = torch.zeros((9, F8, _mccnn_c16(C_in)), dtype=torch.bfloat16,
                         device=weight.device)
    packed[:, :F, :C_in] = weight.permute(2, 3, 0, 1).reshape(9, F, C_in)
    return packed


def mccnn_weight_layout(weight: torch.Tensor,
                        bf16: bool = False) -> torch.Tensor:
    """(F, C_in, 3, 3) OIHW -> the one copy of the weights K8 reads, chosen
    by C_in: ``conv_taps`` for C_in = 1 (the FP32 body; rounded to
    bfloat16 for ``bf16``), otherwise ``mccnn_pack_weights`` (the 3xTF32
    body) or for ``bf16`` ``mccnn_pack_weights_bf16`` (the bfloat16 body).
    ValueError for F > ``MCCNN_MAX_FEATURES``, which K8 does not take."""
    _check_mccnn_features(weight.shape[0])
    if weight.shape[1] > 1:
        return (mccnn_pack_weights_bf16 if bf16 else mccnn_pack_weights)(
            weight)
    return conv_taps(bf16_round(weight) if bf16 else weight)


def _mccnn_layout_spec(C_in: int, F: int,
                       bf16: bool) -> tuple[tuple[int, ...], torch.dtype]:
    """The shape and dtype of ``mccnn_weight_layout``'s copy."""
    if C_in == 1:
        return (3, 3, 1, F), torch.float32
    C8, F8 = _mccnn_padded(C_in, F)
    if bf16:
        return (9, F8, _mccnn_c16(C_in)), torch.bfloat16
    return (2, 3, 3, C8, F8), torch.float32


def _check_bf16_out(normalize: bool, bf16: bool, bf16_out: bool,
                    channels_last: bool = False) -> None:
    if bf16_out and (not bf16 or normalize):
        raise ValueError("bf16_out: a bfloat16 channels-last output is for "
                         "the bfloat16 mode's layers without the norm")
    if channels_last and (bf16 or normalize):
        raise ValueError("channels_last: a float32 channels-last output is "
                         "for the float32 mode's layers without the norm")


def _check_mccnn_io(x: torch.Tensor, normalize: bool, bf16: bool,
                    bf16_out: bool, channels_last: bool = False) -> None:
    """x: a float32 (V, C, H, W) tensor, contiguous, or in the bfloat16
    mode also a bfloat16 one in ``torch.channels_last``; ``bf16_out`` only
    in the bfloat16 mode and ``channels_last`` only in float32, both
    without the norm."""
    _check_bf16_out(normalize, bf16, bf16_out, channels_last)
    if x.dim() != 4 or x.dtype not in ((torch.float32, torch.bfloat16)
                                       if bf16 else (torch.float32,)):
        raise ValueError(f"x: expected a 4-d float32 tensor"
                         f"{' (or bfloat16, channels-last)' if bf16 else ''}"
                         f", got {tuple(x.shape)} {x.dtype}")
    if x.dtype == torch.float32 and not x.is_contiguous():
        raise ValueError("x: a float32 input must be contiguous (V, C, H, W)")
    if x.dtype == torch.bfloat16 and not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError("x: a bfloat16 input must be in torch.channels_last "
                         "memory format")


def mccnn_conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, relu: bool, normalize: bool,
                        bf16: bool = False, bf16_out: bool = False,
                        channels_last: bool = False) -> torch.Tensor:
    """One MC-CNN tower layer: (V, C_in, H, W) -> (V, F, H, W).

    ``F.conv2d`` with one pixel of zero padding (flax ``padding="SAME"``,
    per layer) and ``bias`` (``weight`` is OIHW), then ReLU when ``relu``,
    then each pixel's F-vector divided by sqrt(sum of squares + 1e-12)
    when ``normalize``. On the card cuDNN runs in full float32.

    ``bf16``: the layer as flax computes it with ``compute_dtype``
    bfloat16 (XLA on a CPU): x and the weights rounded to bfloat16, their
    products summed in float32, the sum rounded to bfloat16, the bias
    rounded to bfloat16 added and the result rounded again; then ReLU, or
    the float32 norm of the rounded values. x may then also be a bfloat16
    tensor in ``torch.channels_last`` (the same values; any other floating
    x is computed in its own dtype, as float64 for a reference). The
    output is
    float32 (V, F, H, W), holding bfloat16 values but for the norm, or
    with ``bf16_out`` (no norm) those values as a bfloat16 channels-last
    tensor; in float32 with ``channels_last`` (no norm) a float32 tensor
    in ``torch.channels_last`` (the same values).
    """
    _check_bf16_out(normalize, bf16, bf16_out, channels_last)
    if x.dtype == torch.bfloat16:            # to float32 (V, C, H, W) strides
        x = torch.empty(x.shape, device=x.device).copy_(x)
    if bf16:
        x, weight = bf16_round(x), bf16_round(weight)
    with fp32_cudnn() if x.is_cuda else contextlib.nullcontext():
        y = Fn.conv2d(x, weight, None if bf16 else bias, padding=1)
    if bf16:
        y = bf16_round(bf16_round(y) + bf16_round(bias)[:, None, None])
    if relu:
        y = torch.relu(y)
    if normalize:
        y = y / torch.sqrt(torch.sum(y * y, dim=1, keepdim=True) + 1e-12)
    if bf16_out:
        y = y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def mccnn_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  relu: bool, normalize: bool,
                  layout: torch.Tensor | None = None,
                  bf16: bool = False, bf16_out: bool = False,
                  channels_last: bool = False) -> torch.Tensor:
    """One MC-CNN tower layer: (V, C_in, H, W) -> (V, F, H, W) (K8).

    ``weight`` (F, C_in, 3, 3) and ``bias`` (F,) float32. The kernel reads
    ``layout``, ``mccnn_weight_layout(weight, bf16)``: the taps in the
    FP32 body that runs C_in = 1, the packed taps in the tensor-core body
    that runs C_in > 1 (3xTF32 for float32; for ``bf16`` the bfloat16
    (9, F8, C16) taps on the bfloat16 tensor cores). A caller that runs
    every frame (``models/mccnn.py::MCCNNFeatures``) passes the copy it
    made once; otherwise it is made here. ``bf16`` computes what
    ``mccnn_conv3x3_plain(..., bf16=True)`` does. x: float32, contiguous;
    for ``bf16`` also bfloat16 in ``torch.channels_last`` (flax's NHWC),
    which the bfloat16 body reads (a float32 input is rounded to it by one
    ``.to`` first). The output: float32 (V, F, H, W), or with ``bf16_out``
    (``bf16`` and no norm) bfloat16 channels-last, which the next layer
    reads as it is, or with ``channels_last`` (float32, no norm) float32
    in ``torch.channels_last``, which K11 reads as it is (the layer before
    the last, when K11 follows). Any other dtype or memory format raises
    ValueError.
    On the card F is at most ``MCCNN_MAX_FEATURES`` (128; a wider layer
    raises ValueError); the plain layer on the CPU takes any F and needs
    no layout.
    """
    _check_mccnn_io(x, normalize, bf16, bf16_out, channels_last)
    _check(weight, "weight", torch.float32, 4)
    _check(bias, "bias", torch.float32, 1)
    V, C_in, H, W = x.shape
    F = weight.shape[0]
    if weight.shape != (F, C_in, 3, 3) or bias.shape != (F,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit {C_in} input "
                         "channels and 3x3 taps")
    if layout is not None:
        want, dtype = _mccnn_layout_spec(C_in, F, bf16)
        _check(layout, "layout", dtype, len(want))
        if tuple(layout.shape) != want:
            raise ValueError(f"layout {tuple(layout.shape)}: expected {want}")
    if _on_cpu(x, weight, bias, *(() if layout is None else (layout,))):
        return mccnn_conv3x3_plain(x, weight, bias, relu, normalize, bf16,
                                   bf16_out, channels_last)
    _check_mccnn_features(F)
    if layout is None:
        layout = mccnn_weight_layout(weight, bf16)
    if not bf16:
        y = torch.empty((V, F, H, W), dtype=torch.float32, device=x.device,
                        memory_format=torch.channels_last
                        if channels_last else torch.contiguous_format)
        _launch("mccnn_conv3x3", x.device, _ptr(x), _ptr(layout), _ptr(bias),
                _ptr(y), V, C_in, F, H, W, int(relu), int(normalize),
                int(channels_last))
        return y
    if C_in == 1:
        x = x.to(torch.float32)              # the C_in = 1 body reads float32
    else:
        x = x.to(torch.bfloat16, memory_format=torch.channels_last)
    y = torch.empty((V, F, H, W), dtype=torch.bfloat16, device=x.device,
                    memory_format=torch.channels_last) if bf16_out else \
        torch.empty((V, F, H, W), dtype=torch.float32, device=x.device)
    _launch("mccnn_conv3x3", x.device, _ptr(x), _ptr(layout), _ptr(bias),
            _ptr(y), V, C_in, F, H, W, int(relu), int(normalize),
            int(bf16_out), entry="mccnn_conv3x3_bf16")
    return y


MCCNN_TILE = (8, 32)   # K8's tensor-core tile: rows (a warp each), columns


def mccnn_bf16_warps(F: int) -> tuple[int, int]:
    """(F8, NS) of K8's bfloat16 body: F padded to 32, 64, 112 or 128, and
    the warps that share a pair of tile rows (1 up to 64, else 2), each
    taking F8 / (8 NS) n8 tiles."""
    F8 = _mccnn_padded(1, F)[1]
    return F8, 1 if F8 <= 64 else 2


def mccnn_bf16_a_rows(row: int, mt: int, tap: int, k16: int) -> np.ndarray:
    """(32, 3) ints: for each lane of a warp, the (halo row, halo column,
    first channel) of the 8 channels its ``ldmatrix.x4`` row reads for A
    of m16 tile ``mt`` (columns 16 mt on) of tile row ``row`` at tap
    (ky, kx) = divmod(tap, 3) and k16 step ``k16``: pixel lane & 15 of the
    tile, channels 8 (lane >> 4) on (``csrc/mccnn.cu``, ``a_lane``)."""
    lane = np.arange(32)
    ky, kx = divmod(tap, 3)
    return np.stack([np.full(32, row + ky), 16 * mt + (lane & 15) + kx,
                     MCCNN_BF16_K * k16 + 8 * (lane >> 4)], axis=1)


def mccnn_bf16_b_rows(nh: int, nw: int, n: int, tap: int,
                      k16: int) -> np.ndarray:
    """(32, 2) ints: for each lane, the (layout row [tap, output], first
    channel) of the 8 channels its ``ldmatrix.x4`` row reads for B of the
    n8 pair n, n + 1 of the warp that takes tiles nh * nw on: output
    8 (nh nw + n) + 8 (lane >> 4) + (lane & 7), channels 8 ((lane >> 3)
    & 1) on (``b_lane``); the row is tap * F8 + output."""
    lane = np.arange(32)
    out = 8 * (nh * nw + n) + 8 * (lane >> 4) + (lane & 7)
    return np.stack([out, MCCNN_BF16_K * k16 + 8 * ((lane >> 3) & 1)],
                    axis=1)


def _ldmatrix(rows: np.ndarray, matrices: int) -> np.ndarray:
    """``ldmatrix.m8n8.x{matrices}``: rows (..., 32, 8), lane l's row of 8
    b16 values (lanes 8 j ... 8 j + 7 give matrix j's rows) -> registers
    (..., 32, matrices, 2): lane i gets, of each matrix, row i // 4,
    elements 2 (i % 4) and 2 (i % 4) + 1."""
    lane = np.arange(32)
    src = 8 * np.arange(matrices)[None, :] + (lane // 4)[:, None]
    col = (2 * (lane % 4))[:, None, None] + np.arange(2)[None, None, :]
    return rows[..., src[:, :, None], col]


def _mma_m16n8k16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``mma.m16n8k16.row.col`` by its fragment layout, float64: a (..., 32,
    4, 2), b (..., 32, 2, 2) -> d (..., 32, 4), D = A B with, for lane
    (g, t) = divmod(lane, 4): a[r, e] = A[g + 8 (r & 1), 2 t + e +
    8 (r >> 1)], b[r, e] = B[2 t + e + 8 r, g], d[r] = D[g + 8 (r >> 1),
    2 t + (r & 1)]."""
    g, t = np.divmod(np.arange(32), 4)
    r, e = np.arange(4)[:, None], np.arange(2)[None, :]
    A = np.zeros(a.shape[:-3] + (16, 16))
    A[..., g[:, None, None] + 8 * (r & 1), 2 * t[:, None, None] + e +
      8 * (r >> 1)] = a
    rb = np.arange(2)[:, None]
    B = np.zeros(b.shape[:-3] + (16, 8))
    B[..., 2 * t[:, None, None] + e + 8 * rb, g[:, None, None]] = b
    D = A @ B
    return D[..., g[:, None] + 8 * (np.arange(4) >> 1),
             2 * t[:, None] + (np.arange(4) & 1)]


def mccnn_bf16_c_map(row: int, mt: int, nh: int, nw: int,
                     n: int) -> tuple[np.ndarray, np.ndarray]:
    """(tile column, output channel), each (32, 4), of accumulator c[r] of
    each lane for m16 tile ``mt`` and n8 tile ``n`` of the warp (row, nh):
    pixel 16 mt + g + 8 (r >> 1), channel 8 (nh nw + n) + 2 t + (r & 1)."""
    g, t = np.divmod(np.arange(32), 4)
    r = np.arange(4)
    return (16 * mt + g[:, None] + 8 * (r >> 1),
            8 * (nh * nw + n) + 2 * t[:, None] + (r & 1))


def mccnn_conv3x3_bf16_tiled_plain(x: np.ndarray,
                                   weight: np.ndarray) -> np.ndarray:
    """K8's bfloat16 body as its tiles, warps and fragments compute it, in
    float64 numpy: the sums before the bias, (V, C_in, H, W) x and
    (F, C_in, 3, 3) weights -> (V, F, H, W).

    A model of ``csrc/mccnn.cu``'s ``conv3x3_bf16_kernel``: the 8 x 32
    output tiles with their 10 x 34 halo, zero outside the frame and past
    C_in; the (9, F8, C16) layout (``mccnn_pack_weights_bf16``'s index
    map); for each m16 tile (tile row, half; a warp takes two tile rows)
    and share nh of the n8 tiles, stage, tap and n8 pair, A and B read by
    ``ldmatrix`` from the rows ``mccnn_bf16_a_rows`` and
    ``mccnn_bf16_b_rows`` give, multiplied by the fragment layout of
    ``mma.m16n8k16`` and accumulated, written back by
    ``mccnn_bf16_c_map``. An index error in those maps shows here as sums
    that differ from a float64 convolution. (The order of the float32
    sums, a rounded add each k16 step, is the kernel's alone: the model
    sums in float64.)
    """
    V, C_in, H, W = x.shape
    F = weight.shape[0]
    F8, NS = mccnn_bf16_warps(F)
    NW = F8 // 8 // NS
    C16 = _mccnn_c16(C_in)
    TH, TW = MCCNN_TILE
    BY, BX = -(-H // TH), -(-W // TW)
    # the halo of every block: (V, BY, BX, TH + 2, TW + 2, C16)
    xp = np.zeros((V, BY * TH + 2, BX * TW + 2, C16))
    xp[:, 1:H + 1, 1:W + 1, :C_in] = np.transpose(x, (0, 2, 3, 1))
    hy = (np.arange(BY) * TH)[:, None] + np.arange(TH + 2)[None, :]
    hx = (np.arange(BX) * TW)[:, None] + np.arange(TW + 2)[None, :]
    halo = xp[:, hy[:, None, :, None], hx[None, :, None, :]]
    layout = np.zeros((9, F8, C16))
    layout[:, :F, :C_in] = np.transpose(weight, (2, 3, 0, 1)).reshape(
        9, F, C_in)
    out = np.zeros((V, F8, BY * TH, BX * TW))
    eight = np.arange(8)
    for row in range(TH):
        for mt in range(2):
            for nh in range(NS):
                acc = np.zeros((V, BY, BX, NW, 32, 4))
                for k16 in range(C16 // MCCNN_BF16_K):
                    for tap in range(9):
                        ar = mccnn_bf16_a_rows(row, mt, tap, k16)
                        a = _ldmatrix(halo[:, :, :, ar[:, 0:1], ar[:, 1:2],
                                           ar[:, 2:3] + eight], 4)
                        for n in range(0, NW, 2):
                            # x4, or x2 for a last odd tile: the rows of
                            # lanes 0-15 alone
                            m = 4 if n + 1 < NW else 2
                            br = mccnn_bf16_b_rows(nh, NW, n, tap,
                                                   k16)[:8 * m]
                            rows = np.zeros((32, 8))
                            rows[:8 * m] = layout[tap, br[:, 0:1],
                                                  br[:, 1:2] + eight]
                            b = _ldmatrix(rows, m)
                            for j in range(m // 2):
                                acc[:, :, :, n + j] += _mma_m16n8k16(
                                    a, b[:, 2 * j:2 * j + 2])
                for n in range(NW):
                    col, ch = mccnn_bf16_c_map(row, mt, nh, NW, n)
                    for by in range(BY):
                        for bx in range(BX):
                            out[:, ch, by * TH + row, bx * TW + col] = \
                                acc[:, by, bx, n]
    return out[:, :F, :H, :W]


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


def mccnn_volume_tf32x3_plain(fl: torch.Tensor, fr: torch.Tensor,
                              num_disparities: int, min_disparity: int = 0,
                              scale: float = 24.0) -> torch.Tensor:
    """K9's arithmetic on any device: the model the tests hold to the plain
    volume and to float64.

    Channels padded with zeros to k8 steps; each operand split by
    ``tf32_split``; each k8 step adds its lo*hi, hi*lo and hi*hi sums, in
    that order, into the float32 total (each sum of eight products exact
    in float64 as in the tensor core; the adds round to nearest where the
    tensor core's accumulator truncates); then scale * (1 - total) * 0.5
    and INVALID_COST where x < d.
    """
    F, H, W = fl.shape
    pad = -F % 8
    parts = []
    for f in (fl, fr):
        f = Fn.pad(f, (0, 0, 0, 0, 0, pad)).reshape(-1, 8, H, W)
        parts.append(tuple(p.double() for p in tf32_split(f)))
    (lh, ll), (rh, rl) = parts
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=fl.device)
    for i in range(num_disparities):
        d = min_disparity + i
        sh, sl = _shift_plane(rh, d), _shift_plane(rl, d)
        sums = [(a * b).sum(1) for a, b in ((ll, sh), (lh, sl), (lh, sh))]
        total = torch.zeros((H, W), dtype=torch.float32, device=fl.device)
        for k in range(sh.shape[0]):
            for s in sums:
                total = (total.double() + s[k]).float()
        out[i] = scale * (1.0 - total) * 0.5
    mask = _invalid_mask(W, num_disparities, min_disparity, fl.device)
    return out.masked_fill_(mask, INVALID_COST)


def mccnn_volume(fl: torch.Tensor, fr: torch.Tensor, num_disparities: int,
                 min_disparity: int = 0, scale: float = 24.0) -> torch.Tensor:
    """(F, H, W) features of both views -> (D, H, W) float32 cost (K9).

    ``out[i, y, x] = scale * (1 - <fl[:, y, x], fr[:, y, x - d]>) * 0.5``
    with ``d = min_disparity + i``, exactly INVALID_COST (1e4) where x < d.
    Any F, D >= 1 and min_disparity >= 0. The kernel forms the products on
    the tensor cores in 3xTF32 (``mccnn_volume_tf32x3_plain`` is its
    arithmetic), within 1e-4 of the plain channel sum on unit features.
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


# ------------------------------------------------ K11 mccnn_fused_volume ----

MCCNN_FUSED_TW = 128      # K11: a step's columns a view; planes a block
MCCNN_FUSED_BAND_NT = 18  # K11: n8 tiles of an m16 tile's band, 144 j
MCCNN_FUSED_WARPS = 16    # K11: warps of a block, one block an SM
MCCNN_FUSED_SMEM = 232448  # K11: dynamic shared memory a block may take
# K11's staging buffers by (F8, bf16): as many as fit beside the ring and
# the tail (csrc/mccnn.cu, smt_mccnn_fused_volume)
MCCNN_FUSED_BUFFERS = {(32, True): 4, (64, True): 6, (112, True): 4,
                       (128, True): 4, (32, False): 4, (64, False): 4,
                       (112, False): 3, (128, False): 2}
_BOX = 136                # K11: pixel slots of a staged view's row (130 used)
_VOL_PO = 132             # K9's and K11's plane row pitch in a tile, floats


class FusedLayout(NamedTuple):
    """K11's launch and its shared memory (``csrc/mccnn.cu``, ``FvBytes``),
    offsets in bytes from the block's 1024-B aligned base."""
    F8: int         # output channels, padded: 32, 64, 112 or 128
    NS: int         # warps sharing a pixel's channels (1: all F8 in one)
    WARPS: int      # warps of a block
    ST: int         # staging buffers
    KC: int         # input channels a stage (32 B a pixel)
    prefetch: bool  # the next step's first stage lands during the band
    split: bool     # features as TF32 hi and lo planes (F8 <= 64)
    ring: int       # the right ring, [planes][F8][256] float32
    red: int        # partial sums of squares, [NS][256] float32
    region: int     # buffer b at region + b * stage
    stage: int      # bytes a buffer: the two views' boxes, then weights
    weights: int    # the weight rows' offset in a buffer
    tail: int       # the left tile [planes][F8][128], then the volume's
    bars: int       # one mbarrier a buffer
    smem: int       # bytes the launch asks for (with 1024 of alignment)


def mccnn_fused_layout(F: int, bf16: bool) -> FusedLayout:
    """K11's layout for F features in the bfloat16 or float32 mode: K8's
    F8, 16 warps on wgmma (warpgroup w / 4 the 64 pixels of its four m16
    tiles, all F8, so one warp holds a pixel's channels); ST buffers of one
    kernel
    row's stage (both views' 130 staged pixels of 32 B, each view's box 136
    slots, then the three taps' weight rows, 32 B in bfloat16, 64 B in
    float32), 1024-B aligned; the tail from buffer 1 on where that fits in
    ``MCCNN_FUSED_SMEM`` (``prefetch``), else from buffer 0. Up to
    F8 = 64 the features are kept as the band reads them, TF32 hi and lo
    in two planes (``split``), so the band splits nothing."""
    F8 = _mccnn_padded(1, F)[1]
    ST = MCCNN_FUSED_BUFFERS[F8, bf16]

    def up(n: int) -> int:
        return -(-n // 1024) * 1024
    act = 2 * _BOX * 32
    stage = up(act + 3 * F8 * (32 if bf16 else 64))
    planes = 2 if F8 <= 64 else 1
    ring = planes * F8 * 2 * MCCNN_FUSED_TW * 4
    red = 2 * 2 * MCCNN_FUSED_TW * 4
    tail = max(planes * F8 * MCCNN_FUSED_TW * 4,
               MCCNN_FUSED_TW * _VOL_PO * 4)
    region = up(ring + red)

    def smem(tail_at: int) -> int:
        return region + max(ST * stage, tail_at + tail) + 8 * ST + 1024
    pre = smem(stage) <= MCCNN_FUSED_SMEM
    tail_at = stage if pre else 0
    return FusedLayout(F8, 1, MCCNN_FUSED_WARPS, ST, 16 if bf16 else 8, pre,
                       planes == 2, 0, ring, region, stage, act,
                       region + tail_at,
                       region + max(ST * stage, tail_at + tail),
                       smem(tail_at))


def mccnn_fused_weight_layout(weight: torch.Tensor,
                              bf16: bool = False) -> torch.Tensor:
    """(F, C_in, 3, 3) OIHW -> K11's copy of the last layer's weights
    (``fused_from_k8_layout`` of K8's): each stage's rows contiguous, so one
    bulk copy stages them."""
    return fused_from_k8_layout(mccnn_weight_layout(weight, bf16), bf16)


def fused_from_k8_layout(layout: torch.Tensor, bf16: bool) -> torch.Tensor:
    """K8's copy of a C_in > 1 layer's weights -> K11's, by stage (KC input
    channels, kernel row ky) and tap kx, each stage contiguous. Float32,
    from K8's (2, 3, 3, C8, F8): (C8 / 8, 9, 2, 2, F8, 4), for (chunk,
    tap), part (hi, lo), group q and output n the words of channels
    8 chunk + 2t + q, t = 0 ... 3: the wgmma B operand, K-major core
    matrices of 8 outputs by 16 B, the k8 step's logical k = t, t + 4
    being channel 2t, 2t + 1 (so that A's pair is one 8-B read). Bfloat16,
    from K8's (9, F8, C16): (C16 / 16, 9, F8, 16), the two 8-channel
    halves of row n swapped where bit 2 of n is set (the 32-B swizzle of
    the staged input, which keeps ldmatrix rows in distinct banks)."""
    if bf16:
        _, F8, C16 = layout.shape
        w = layout.view(9, F8, C16 // 16, 2, 8).permute(2, 0, 1, 3, 4)
        swap = ((torch.arange(F8, device=layout.device) >> 2) & 1).bool()
        w = torch.where(swap[None, None, :, None, None], w.flip(3), w)
        return w.reshape(C16 // 16, 9, F8, 16).contiguous()
    C8, F8 = layout.shape[3:]
    return layout.view(2, 9, C8 // 8, 4, 2, F8).permute(
        2, 1, 0, 4, 5, 3).contiguous()


def _fused_layout_spec(C_in: int, F: int,
                       bf16: bool) -> tuple[tuple[int, ...], torch.dtype]:
    """The shape and dtype of ``mccnn_fused_weight_layout``'s copy."""
    C8, F8 = _mccnn_padded(C_in, F)
    if bf16:
        return (_mccnn_c16(C_in) // 16, 9, F8, 16), torch.bfloat16
    return (C8 // 8, 9, 2, 2, F8, 4), torch.float32


def _check_fused(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 num_disparities: int, bf16: bool) -> None:
    if not (x.dim() == 4 and x.dtype == torch.float32 and
            x.is_contiguous(memory_format=torch.channels_last)):
        _check_mccnn_io(x, True, bf16, False)  # or float32 channels-last
    _check(weight, "weight", torch.float32, 4)
    _check(bias, "bias", torch.float32, 1)
    V, C_in = x.shape[:2]
    F = weight.shape[0]
    if V != 2:
        raise ValueError(f"x: the last layer's input of both views, (2, "
                         f"C_in, H, W), got {tuple(x.shape)}")
    if weight.shape != (F, C_in, 3, 3) or bias.shape != (F,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} do not fit {C_in} input "
                         "channels and 3x3 taps")
    if num_disparities < MCCNN_FUSED_TW or \
            num_disparities % MCCNN_FUSED_TW:
        raise ValueError(f"the fused MC-CNN volume needs num_disparities a "
                         f"multiple of {MCCNN_FUSED_TW}, got "
                         f"{num_disparities}")


def mccnn_fused_volume_plain(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, num_disparities: int,
                             scale: float = 24.0,
                             bf16: bool = False) -> torch.Tensor:
    """K11's function: the last tower layer with its norm
    (``mccnn_conv3x3_plain``), then the volume at min_disparity 0
    (``mccnn_volume_plain``). x as ``mccnn_fused_volume`` takes it."""
    if x.dtype == torch.float32:
        x = x.contiguous()                   # the layer's NCHW order
    f = mccnn_conv3x3_plain(x, weight, bias, False, True, bf16)
    return mccnn_volume_plain(f[0], f[1], num_disparities, 0, scale)


def mccnn_fused_volume(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, num_disparities: int,
                       scale: float = 24.0,
                       layout: torch.Tensor | None = None,
                       bf16: bool = False) -> torch.Tensor:
    """The last MC-CNN tower layer, its L2 norm and the feature-dot volume
    in one launch (K11): (2, C_in, H, W) -> (D, H, W) float32 cost.

    What ``mccnn_conv3x3(x, weight, bias, False, True, layout, bf16)``
    then ``mccnn_volume(f[0], f[1], D, 0, scale)`` compute (K8's last
    launch and K9), without the features in device memory: x is the last
    layer's input of both views (float32, contiguous or in
    ``torch.channels_last``; for ``bf16`` also bfloat16 in
    ``torch.channels_last``, as K8's bfloat16 mode passes it). The kernel
    reads it channels-last (K8 writes it so on the one-kernel path:
    ``MCCNNFeatures.hidden(channels_last=True)``); another x is copied to
    that first, float32 with C_in padded to a multiple of 4. ``layout``:
    K11's copy of the weights (``mccnn_fused_weight_layout``, which
    ``MCCNNFeatures`` keeps as ``layout_fused``), or K8's copy of the last
    layer's (made into K11's here), or None (made here). num_disparities a
    multiple of 128 (ValueError otherwise). On the card F is at most
    ``MCCNN_MAX_FEATURES`` and a multiple of 8, C_in at least 2 (each
    ValueError otherwise); the plain version on the CPU takes any.
    """
    _check_fused(x, weight, bias, num_disparities, bf16)
    _, C_in, H, W = x.shape
    F = weight.shape[0]
    if layout is not None:
        specs = [_mccnn_layout_spec(C_in, F, bf16)]
        if C_in > 1 and F <= MCCNN_MAX_FEATURES:
            specs.append(_fused_layout_spec(C_in, F, bf16))
        if not any(layout.dtype == dtype and tuple(layout.shape) == want
                   for want, dtype in specs):
            raise ValueError(f"layout {tuple(layout.shape)} {layout.dtype}: "
                             f"expected K8's or K11's copy, one of "
                             f"{[(w, str(d)) for w, d in specs]}")
        _check(layout, "layout", layout.dtype, layout.dim())
    if _on_cpu(x, weight, bias, *(() if layout is None else (layout,))):
        return mccnn_fused_volume_plain(x, weight, bias, num_disparities,
                                        scale, bf16)
    _check_mccnn_features(F)
    if F % 8 or C_in < 2:
        raise ValueError(f"K11 takes F a multiple of 8 and C_in >= 2 (the "
                         f"last layer of a tower of two or more), got F = "
                         f"{F}, C_in = {C_in}")
    if layout is None:
        layout = mccnn_fused_weight_layout(weight, bf16)
    elif tuple(layout.shape) == _mccnn_layout_spec(C_in, F, bf16)[0]:
        layout = fused_from_k8_layout(layout, bf16)   # K8's copy
    if bf16:
        x = x.to(torch.bfloat16, memory_format=torch.channels_last)
        if C_in % 8 or x.data_ptr() % 16:
            raise ValueError("K11's bfloat16 mode reads a pixel's channels "
                             "16 B at a time: C_in a multiple of 8, x "
                             "16-B aligned")
    elif C_in % 4 or x.data_ptr() % 16 or not x.is_contiguous(
            memory_format=torch.channels_last):
        C4 = -(-C_in // 4) * 4               # TMA's 16-B pixel stride
        xc = torch.zeros((2, H, W, C4), device=x.device).permute(0, 3, 1, 2)
        xc[:, :C_in] = x                     # (2, C4, H, W), channels-last
        x, C_in = xc, C4
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=x.device)
    _launch("mccnn_fused_volume", x.device, _ptr(x), _ptr(layout),
            _ptr(bias), _ptr(out), C_in, F, H, W, num_disparities,
            float(scale), int(bf16))
    return out


def _mma_m16n8k8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``mma.m16n8k8.row.col`` (TF32) by its fragment layout, float64: a
    (..., 32, 4), b (..., 32, 2) -> d (..., 32, 4), D = A B with, for lane
    (g, t) = divmod(lane, 4): a = A[g, t], A[g + 8, t], A[g, t + 4],
    A[g + 8, t + 4]; b = B[t, g], B[t + 4, g]; d[r] = D[g + 8 (r >> 1),
    2 t + (r & 1)]."""
    g, t = np.divmod(np.arange(32), 4)
    A = np.zeros(a.shape[:-2] + (16, 8))
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        A[..., g + dr, t + dk] = a[..., r]
    B = np.zeros(b.shape[:-2] + (8, 8))
    B[..., t, g] = b[..., 0]
    B[..., t + 4, g] = b[..., 1]
    D = A @ B
    r = np.arange(4)
    return D[..., g[:, None] + 8 * (r >> 1), 2 * t[:, None] + (r & 1)]


def mccnn_fused_volume_tiled_plain(x: np.ndarray, weight: np.ndarray,
                                   bias: np.ndarray, num_disparities: int,
                                   scale: float = 24.0,
                                   bf16: bool = False) -> torch.Tensor:
    """K11 as its blocks, warps, shared-memory addresses and fragments walk
    the frame: (2, C_in, H, W) x, (F, C_in, 3, 3) weights and (F,) bias
    (numpy) -> the (D, H, W) float32 volume.

    A model of ``csrc/mccnn.cu``'s ``mccnn_fused_volume_kernel`` as the
    wrapper launches it (``mccnn_fused_layout``): a block per row and 128
    planes, walking 128-column steps; each stage (one kernel row of KC
    channels: 16 in bfloat16, 8 in float32) as the TMA boxes of the
    channels-last input (zeros outside the frame and past C_in; bfloat16
    with the 32-B swizzle) and the bulk copy of K11's weight rows
    (``mccnn_fused_weight_layout``) place it in a buffer; each warp's A and
    B read at the kernel's addresses (``ldmatrix`` rows, or the float32
    8-B A pairs, k = t, t + 4 being channels 2t, 2t + 1, and the hi and lo
    B words at the wgmma descriptors' core-matrix addresses; a warp's 16
    rows of its warpgroup's m64 as an m16 tile) and multiplied by the
    fragment layout of ``mma``; the
    epilogue's bias and roundings, each pixel's sum of squares split over
    lanes and warps as the kernel splits it, the norm; the features
    stored at the kernel's swizzled addresses (up to F8 = 64 the TF32 hi
    in one plane and the rest in another, where the kernel keeps the rest's
    TF32 rounding), the right ones in the ring slot of their columns; the
    band's A and B read back from those addresses for each lane, its cells placed by the accumulator map into
    the 128-plane tile at rows shifted by the global row's misalignment,
    and each plane row stored as the kernel stores it (its 16-B aligned
    middle by one bulk copy, the ends cell by cell). The sums of the layer
    are float64 (exact on inputs whose products and sums are exact, as the
    tests choose); the band's dot products are taken, from the operands
    the fragments read, as ``mccnn_volume_plain`` takes them (one
    ``torch.sum`` over channels a plane), so an index error in any of
    those maps shows as a volume that differs from
    ``mccnn_fused_volume_plain``'s. The kernel's own order of the float32
    sums is its alone.
    """
    x = np.asarray(x, np.float64)
    w = np.asarray(weight, np.float64)
    bias = torch.from_numpy(np.asarray(bias, np.float32))
    _, C, H, W = x.shape
    F, D, TW = w.shape[0], num_disparities, MCCNN_FUSED_TW
    lay = mccnn_fused_layout(F, bf16)
    F8, NS, WARPS, KC = lay.F8, lay.NS, lay.WARPS, lay.KC
    NT = F8 // 8
    NW, RWARPS = NT // NS, WARPS // NS
    MT = 16 // RWARPS
    P, RP, LP = 2 if lay.split else 1, F8 * 2 * TW, F8 * TW   # planes
    es = 2 if bf16 else 4                    # bytes an element
    px_e = 32 // es                          # elements a staged pixel
    act_e = lay.weights // es                # the weight rows' offset
    row_e = 16                               # elements a weight row
    if bf16:
        x = bf16_round(torch.from_numpy(x)).numpy()
    wt = mccnn_fused_weight_layout(torch.from_numpy(w.astype(np.float32)),
                                   bf16).float().double().numpy().reshape(-1)
    CK = -(-C // KC) * KC
    nst = 3 * (CK // KC)
    xl_ = np.transpose(x, (0, 2, 3, 1))      # channels-last (2, H, W, C)
    lane = np.arange(32)
    g, t = np.divmod(lane, 4)
    r4 = np.arange(4)
    eight = np.arange(8)
    rows = np.arange(H)
    FL = torch.zeros((F, H, W))
    FR = torch.zeros((D, F, H, W))
    steps = []     # (d0, x0, {busy warp: its first j}) of each step
    for c in range(D // TW):
        d0 = TW * c
        rf = np.zeros((H, P * RP), np.float32)          # the ring
        for tl in range(-(-W // TW)):
            x0, xr0 = TW * tl, TW * tl - d0
            acc = np.zeros((WARPS, H, MT, NW, 32, 4))
            for s in range(nst):
                ky, c0 = s % 3, s // 3 * KC
                buf = np.zeros((H, lay.stage // es))
                hx = np.arange(TW + 2)
                gy = rows - 1 + ky
                for v in range(2):
                    gx = (x0, xr0)[v] + hx - 1
                    ok = ((gy >= 0) & (gy < H))[:, None] & \
                        ((gx >= 0) & (gx < W))[None, :]
                    for ci in range(KC):
                        if c0 + ci >= C:
                            continue
                        val = np.where(ok, xl_[v][np.clip(gy, 0, H - 1)][
                            :, np.clip(gx, 0, W - 1), c0 + ci], 0.0)
                        p = v * _BOX + hx
                        if bf16:    # TMA's 32-B swizzle: half ^ bit 2 of p
                            off = p * px_e + (((ci >> 3) ^ (hx >> 2)) & 1) \
                                * 8 + (ci & 7)
                        else:
                            off = p * px_e + ci
                        buf[:, off] = val
                # the bulk copy: stage s's 3 F8 weight rows as they lie
                src = wt[s * 3 * F8 * row_e:(s + 1) * 3 * F8 * row_e]
                buf[:, act_e:act_e + src.size] = src
                for warp in range(WARPS):
                    nh, mw = divmod(warp, RWARPS)
                    view = mw * MT >> 3
                    for kx in range(3):
                        for m in range(MT):
                            if bf16:
                                # A by ldmatrix (this warp's 16 rows of its
                                # warpgroup's m64), B (k, n) where the
                                # descriptor's 32-B swizzle puts it: row
                                # kx F8 + n, half k >> 3 ^ bit 2 of the row
                                p = 16 * ((mw * MT + m) & 7) + kx + \
                                    (lane & 15)
                                off = (view * _BOX + p) * px_e + \
                                    (((lane >> 4) ^ (p >> 2)) & 1) * 8
                                a = _ldmatrix(buf[:, off[:, None] + eight], 4)
                                k = 2 * t[:, None, None] + \
                                    np.arange(2)[None, None, :] + \
                                    8 * np.arange(2)[None, :, None]
                                for n in range(NW):
                                    row = (kx * F8 + (nh * NW + n) * 8 +
                                           g)[:, None, None]
                                    boff = act_e + row * row_e + (
                                        ((k >> 3) ^ (row >> 2)) & 1) * 8 + \
                                        (k & 7)
                                    acc[warp, :, m, n] += _mma_m16n8k16(
                                        a, buf[:, boff])
                            else:
                                # wgmma: this warp's 16 rows of its
                                # warpgroup's m64, B from the descriptors'
                                # K-major core matrices (group q: k = 4q +
                                # t is channel 2t + q)
                                p = view * _BOX + 16 * ((mw * MT + m) & 7) + \
                                    kx + g
                                u = p * px_e + 2 * t
                                v8 = (p + 8) * px_e + 2 * t
                                a = np.stack([buf[:, u], buf[:, v8],
                                              buf[:, u + 1], buf[:, v8 + 1]],
                                             -1)
                                ah, al = (q.numpy() for q in tf32_split(
                                    torch.from_numpy(a.astype(np.float32))))
                                for n in range(NW):
                                    row = (nh * NW + n) * 8 + g

                                    def b(part, row=row):
                                        return np.stack([buf[:, act_e + (
                                            ((kx * 2 + part) * 2 + q) * F8 +
                                            row) * 4 + t] for q in (0, 1)],
                                            -1)
                                    bh, bl = b(0), b(1)
                                    acc[warp, :, m, n] += (
                                        _mma_m16n8k8(al, bh) +
                                        _mma_m16n8k8(ah, bl) +
                                        _mma_m16n8k8(ah, bh))
            # the epilogue: bias and roundings, each pixel's sum of squares
            # a lane's channels n by n, the quad (s0 + s1) + (s2 + s3), the
            # NS warps r0 + r1, the norm; the features into shared memory
            vals, quads = {}, {}
            for warp in range(WARPS):
                nh = warp // RWARPS
                ss = np.zeros((H, MT, 32, 2), np.float32)
                for n in range(NW):
                    f = (nh * NW + n) * 8 + 2 * t[:, None] + (r4 & 1)
                    b = torch.where(torch.from_numpy(f < F),
                                    bias[np.minimum(f, F - 1)], 0.0)
                    v = torch.from_numpy(acc[warp, :, :, n].astype(
                        np.float32))
                    v = bf16_round(bf16_round(v) + bf16_round(b)) if bf16 \
                        else v + b
                    vals[warp, n] = v.numpy()
                    for e in range(2):
                        for half in range(2):
                            q = vals[warp, n][..., 2 * half + e]
                            ss[..., half] = ss[..., half] + q * q
                quad = ss.reshape(H, MT, 8, 4, 2)
                quads[warp] = (quad[..., 0, :] + quad[..., 1, :]) + \
                    (quad[..., 2, :] + quad[..., 3, :])   # (H, MT, 8, 2)
            lf = np.zeros((H, P * LP), np.float32)
            for warp in range(WARPS):
                nh, mw = divmod(warp, RWARPS)
                view = mw * MT >> 3
                total = quads[mw]
                for h in range(1, NS):
                    total = total + quads[h * RWARPS + mw]
                # torch's sqrt and division, as the plain layer takes them
                # (its float32 sqrt on the CPU is not always the nearest)
                norm = torch.sqrt(torch.from_numpy(total) + 1e-12)[:, :, g]
                for m in range(MT):
                    for n in range(NW):
                        for r in range(4):
                            f = (nh * NW + n) * 8 + 2 * t + (r & 1)
                            col = 16 * ((mw * MT + m) & 7) + g + 8 * (r >> 1)
                            keep = f < F
                            val = (torch.from_numpy(vals[warp, n][:, m, :, r])
                                   / norm[:, m, :, r >> 1]).numpy()
                            swz = (f & 3) << 3
                            if view == 0:
                                dst, at, pl = lf, f * TW + (col ^ swz), LP
                            else:
                                dst, pl = rf, RP
                                at = f * 2 * TW + (((xr0 + col) & 255) ^ swz)
                            val = val[:, keep]
                            if lay.split:   # hi, and the rest of the value
                                hi = tf32_round(torch.from_numpy(val)).numpy()
                                dst[:, at[keep]] = hi
                                dst[:, pl + at[keep]] = val - hi
                            else:
                                dst[:, at[keep]] = val
            # the band, an m16 tile at a time (two warps share its n8
            # tiles): each lane's A and B reads, the cells of its
            # accumulators
            jws = {}
            for warp in range(8):
                xa = x0 + 16 * warp
                if xa >= W:
                    continue
                jw = jws[warp] = xa - d0 - TW + 1
                swz = t << 3
                A = np.zeros((H, 16, F), np.float32)
                B = np.zeros((H, F, 8 * MCCNN_FUSED_BAND_NT), np.float32)
                for k in range(0, F, 8):
                    for dr, dk in ((0, 0), (8, 0), (0, 4), (8, 4)):
                        at = (k + t + dk) * TW + ((16 * warp + g + dr) ^ swz)
                        A[:, g + dr, k + t + dk] = lf[:, at] + (
                            lf[:, LP + at] if lay.split else 0)
                    for n in range(MCCNN_FUSED_BAND_NT):
                        cb = ((jw + 8 * n + g) & 255) ^ swz
                        for dk in (0, 4):
                            at = (k + t + dk) * 2 * TW + cb
                            B[:, k + t + dk, 8 * n + g] = rf[:, at] + (
                                rf[:, RP + at] if lay.split else 0)
                for n in range(MCCNN_FUSED_BAND_NT):
                    for e in range(4):
                        row = g + 8 * (e >> 1)
                        xs = xa + row
                        j = jw + 8 * n + 2 * t + (e & 1)
                        i = xs - j - d0
                        ok = (i >= 0) & (i < TW) & (xs < W)
                        FL[:, :, xs[ok]] = torch.from_numpy(
                            np.transpose(A[:, row[ok]], (2, 0, 1)).copy())
                        ok &= j >= 0
                        FR[d0 + i[ok], :, :, xs[ok]] = torch.from_numpy(
                            np.transpose(B[:, :, (8 * n + 2 * t + (e & 1))
                                           [ok]], (2, 1, 0)).copy())
            steps.append((d0, x0, jws))
    cost = torch.empty((D, H, W))
    for p in range(D):
        sim = torch.sum(FL * FR[p], dim=0)
        cost[p] = scale * (1.0 - sim) * 0.5
    cost = cost.numpy()
    # the band's epilogue: all 128 planes into one tile whose rows are
    # shifted by the global row's misalignment; then plane row i by thread
    # i, its 16-B aligned middle by one bulk copy and its ends cell by cell
    out = np.full((D * H * W), np.nan, np.float32)
    for d0, x0, jws in steps:
        ncols = min(TW, W - x0)
        st = np.full((H, TW * _VOL_PO), np.nan, np.float32)
        for warp, jw in jws.items():
            for n in range(MCCNN_FUSED_BAND_NT):
                for e in range(4):
                    xl = 16 * warp + g + 8 * (e >> 1)
                    j = jw + 8 * n + 2 * t + (e & 1)
                    i = x0 + xl - j - d0
                    ok = (i >= 0) & (i < TW)
                    xl, j, i = xl[ok], j[ok], i[ok]
                    sh = ((d0 + i)[None, :] * H + rows[:, None]) * W % 4
                    val = np.where(
                        j < 0, np.float32(1e4),
                        cost[d0 + i, :, np.minimum(x0 + xl, W - 1)].T)
                    np.put_along_axis(st, i * _VOL_PO + xl + sh, val,
                                      axis=1)
        for i in range(TW):
            for y in range(H):
                row = ((d0 + i) * H + y) * W + x0
                src = i * _VOL_PO + row % 4            # column 0
                a, e = -(-row // 4) * 4, (row + ncols) // 4 * 4
                head = tail = row + ncols
                if e > a:
                    out[a:e] = st[y, src + a - row:src + e - row]
                    head, tail = a, e
                for q in (*range(row, head), *range(tail, row + ncols)):
                    out[q] = st[y, src + q - row]
    return torch.from_numpy(out.reshape(D, H, W))


# -------------------------------------------------------- K10 census_scan ----

def census_scan_plain(cl: torch.Tensor, cr: torch.Tensor, total: torch.Tensor,
                      min_disparity: int, p1: float, p2: float,
                      reverse: bool, invalid_cost: float,
                      accumulate: bool) -> torch.Tensor:
    """K2's volume with ``invalid_cost`` at x < d, scanned along (0, +-1)."""
    D, H, W = total.shape
    vol = census_volume_plain(cl, cr, D, min_disparity)
    vol.masked_fill_(_invalid_mask(W, D, min_disparity, cl.device),
                     invalid_cost)
    return sgm_path_scan_plain(vol, total, 0, -1 if reverse else 1, p1, p2,
                               accumulate)


def census_scan(cl: torch.Tensor, cr: torch.Tensor, total: torch.Tensor,
                min_disparity: int, p1: float, p2: float,
                reverse: bool = False, invalid_cost: float = INVALID_COST,
                accumulate: bool = False) -> torch.Tensor:
    """One horizontal SGM scan with costs rebuilt from census words (K10).

    ``cl``, ``cr``: (H, W) or (1, H, W) int32 single-word census of both
    views;
    ``total``: (D, H, W) float32, updated in place (added into, or with
    ``accumulate=False`` written) and returned. The cost of disparity
    ``d = min_disparity + i`` at x is ``popc(cl[y, x] ^ cr[y, x - d])``,
    or ``invalid_cost`` where x < d (1e4 as K2 writes; 1024 for the int16
    wire of the streaming pipeline). ``reverse`` scans right to left.
    On the card D is at most ``SCAN_MAX_DISPARITIES`` (1024, K3's line
    warp; a larger D raises ValueError); the plain scan on the CPU takes
    any D.
    """
    if min_disparity < 0:
        raise ValueError("census_scan needs min_disparity >= 0")
    cl, cr = _check_words(cl, "cl"), _check_words(cr, "cr")
    if cl.shape[0] != 1 or cr.shape[0] != 1:
        raise ValueError("census_scan takes single-word census (at most 33 "
                         "pixels a window)")
    cl, cr = cl[0], cr[0]
    _check(total, "total", torch.float32, 3)
    if cl.shape != cr.shape or tuple(total.shape[1:]) != tuple(cl.shape):
        raise ValueError(f"census images {tuple(cl.shape)}, "
                         f"{tuple(cr.shape)} and total "
                         f"{tuple(total.shape)} do not fit")
    if _on_cpu(cl, cr, total):
        return census_scan_plain(cl, cr, total, min_disparity, p1, p2,
                                 reverse, invalid_cost, accumulate)
    _check_scan_disparities("census_scan", total.shape[0])
    D, H, W = total.shape
    _launch("census_scan", cl.device, _ptr(cl), _ptr(cr), _ptr(total), D, H,
            W, min_disparity, float(p1), float(p2), float(invalid_cost),
            -1 if reverse else 1, int(accumulate))
    return total
