"""External raw cost-volume ingestion (the MC-CNN ``left.bin`` contract).

Counterpart of ``stereo_match_tpu/data/costbin.py``. The reference's
external MC-CNN tool dumps a float32 cost volume as ``left.bin`` with shape
(1, disp_max, W, H), which ``mapTo3D_mc_cnn.py:71`` memmaps. The reader and
writer are numpy and copied here (the JAX package's ``data`` package
imports JAX); the volume then runs through the port's SGM (K3), WTA (K4)
and, with a guide, the WLS smoother (K7).
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_match_tpu_torch.ops.cuda_kernels import aggregate_paths, wta_lr
from stereo_match_tpu_torch.ops.wls import wls_filter_disparity
from stereo_match_tpu_torch.utils.backend import entry_device


def read_cost_bin(path: str, disp_max: int, width: int, height: int,
                  mmap: bool = True) -> np.ndarray:
    """Read an external (1, D, W, H) float32 dump -> (D, H, W) volume."""
    shape = (1, disp_max, width, height)
    if mmap:
        raw = np.memmap(path, dtype=np.float32, mode="r", shape=shape)
    else:
        raw = np.fromfile(path, dtype=np.float32).reshape(shape)
    return np.ascontiguousarray(np.transpose(raw[0], (0, 2, 1)))


def write_cost_bin(path: str, volume: np.ndarray) -> None:
    """Write a (D, H, W) volume in the external (1, D, W, H) contract."""
    vol = np.asarray(volume, np.float32)
    out = np.transpose(vol, (0, 2, 1))[None]
    out.astype("<f4").tofile(path)


def external_volume_to_disparity(volume: np.ndarray, p1: float = 8.0,
                                 p2: float = 96.0, num_paths: int = 8,
                                 guide=None, lmbda: float = 8000.0,
                                 sigma: float = 1.2,
                                 device: torch.device | str = "cuda"
                                 ) -> np.ndarray:
    """Aggregate + extract + (optionally) WLS-refine an external volume.

    Capability parity with ``mapTo3D_mc_cnn.py:68-105``, where the external
    disparities are WLS-filtered before reprojection: SGM over
    ``num_paths`` directions, WTA without the uniqueness test and with the
    disp12 check at 1, then the WLS smoother guided by ``guide``. Runs on
    ``device``; returns a numpy (H, W) float32 map, NaN invalid.
    """
    device = entry_device(device)
    vol = torch.as_tensor(np.array(volume, np.float32, order="C"),
                          device=device)
    total = aggregate_paths(vol, p1, p2, num_paths)
    disp, _ = wta_lr(total, uniqueness_ratio=0, disp12_max_diff=1)
    if guide is not None:
        disp = wls_filter_disparity(
            disp, torch.as_tensor(guide, dtype=torch.float32, device=device),
            lmbda=lmbda, sigma_color=sigma)
    return disp.cpu().numpy()
