"""The census + SGM stereo matcher (PyTorch).

Counterpart of ``stereo_match_tpu/pipeline/stereo.py:53-217``: the census
branch of ``_match_core``, :class:`StereoMatcher` (with ``batched``) and the
LRU-cached :func:`compute_disparity` with its int16 disparity*16 contract.

The path is four kernels (``ops/cuda_kernels.py``): census words of both
views (K1), the (D, H, W) Hamming volume (K2), one SGM scan per path
direction added into the total (K3, ``num_paths`` launches), and WTA with
subpixel, uniqueness and the disp12 check (K4). CPU tensors run the
kernels' plain versions; CUDA tensors run the kernels.

The slice covers census costs with a single-word window (at most 33
pixels), 2, 4 or 8 paths, any ``min_disparity >= 0``, float32 volumes, and
no speckle or WLS post-filter; any other configuration raises
``NotImplementedError`` naming its ROADMAP.md entry.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops.cuda_kernels import (aggregate_paths,
                                                     census_volume,
                                                     census_words, wta_lr)
from stereo_match_tpu_torch.ops.wta import to_fixed_point


def check_slice(cfg: DisparityConfig) -> None:
    """Raise unless the port implements ``cfg`` (see the module doc)."""
    if cfg.cost != "census":
        raise NotImplementedError(
            f"cost={cfg.cost!r} is not ported yet (ROADMAP.md, queue 1: "
            "other costs and MC-CNN)")
    wh, ww = cfg.census_window
    if wh * ww - 1 > 32:
        raise NotImplementedError(
            f"census window {cfg.census_window} needs several words; the "
            "port's K1/K2 take one (ROADMAP.md, queue 2: multiword census)")
    if cfg.num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    if cfg.min_disparity < 0:
        raise NotImplementedError(
            "min_disparity < 0 is not ported (ROADMAP.md, queue 1: other "
            "costs and matchers)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the port keeps float32 volumes (ROADMAP.md,"
            " queue 2: int16 scans)")
    if cfg.speckle_window_size > 0:
        raise NotImplementedError(
            "speckle filtering is not ported yet (ROADMAP.md, queue 1: post "
            "stack); set speckle_window_size=0")
    if cfg.wls:
        raise NotImplementedError(
            "the WLS post-filter is not ported yet (ROADMAP.md, queue 1: post "
            "stack); set wls=False")


def _match_core(left_gray: torch.Tensor, right_gray: torch.Tensor,
                cfg: DisparityConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) images -> (raw, filtered) float32 disparities, NaN invalid.

    Without a post-filter in the slice, ``filtered`` is ``raw``.
    """
    check_slice(cfg)
    imgs = torch.stack([left_gray, right_gray]).to(torch.float32).contiguous()
    words = census_words(imgs, cfg.census_window)
    vol = census_volume(words[0], words[1], cfg.num_disparities,
                        cfg.min_disparity)
    total = aggregate_paths(vol, cfg.P1, cfg.P2, cfg.num_paths)
    disp, _ = wta_lr(total, cfg.min_disparity, cfg.uniqueness_ratio,
                     cfg.disp12_max_diff, cfg.subpixel)
    return disp, disp


class StereoMatcher:
    """Stereo matcher for a fixed config on one device.

    >>> matcher = StereoMatcher(DisparityConfig(num_disparities=128,
    ...                                         wls=False), device="cuda")
    >>> raw, filtered = matcher(left_gray, right_gray)
    """

    def __init__(self, config: DisparityConfig | None = None,
                 device: torch.device | str = "cpu"):
        self.config = config or DisparityConfig()
        check_slice(self.config)
        self.device = torch.device(device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def __call__(self, left_gray, right_gray):
        return _match_core(self._tensor(left_gray), self._tensor(right_gray),
                           self.config)

    def batched(self, lefts, rights):
        """Match a leading batch axis of frames (a capture sequence)."""
        lefts, rights = self._tensor(lefts), self._tensor(rights)
        outs = [_match_core(l, r, self.config) for l, r in zip(lefts, rights)]
        return (torch.stack([raw for raw, _ in outs]),
                torch.stack([filtered for _, filtered in outs]))


# compute_disparity's matcher cache, keyed on the full config repr, method
# and device; LRU-bounded so a parameter sweep cannot grow it without end.
_MATCHER_CACHE_CAP = 8
_MATCHER_CACHE: OrderedDict[tuple[str, str, str], Any] = OrderedDict()


def compute_disparity(gray_l, gray_r, config: DisparityConfig | None = None,
                      method: str = "SGBM",
                      device: torch.device | str = "cpu"):
    """Reference-parity surface: (displ16, filtered16) int16 disparity*16.

    ``method``: "SGBM" (census + SGM); "BM" (StereoBM) is not ported yet.
    Returns numpy arrays, as the JAX package does.
    """
    cfg = config or DisparityConfig()
    method = method.upper()
    if method == "BM":
        raise NotImplementedError("method='BM' (StereoBM) is not ported yet "
                                  "(ROADMAP.md, queue 1: other costs and "
                                  "matchers)")
    key = (repr(cfg), method, str(torch.device(device)))
    matcher = _MATCHER_CACHE.get(key)
    if matcher is None:
        matcher = StereoMatcher(cfg, device=device)
        _MATCHER_CACHE[key] = matcher
        while len(_MATCHER_CACHE) > _MATCHER_CACHE_CAP:
            _MATCHER_CACHE.popitem(last=False)
    else:
        _MATCHER_CACHE.move_to_end(key)
    raw, filtered = matcher(gray_l, gray_r)
    return (to_fixed_point(raw, cfg.min_disparity).cpu().numpy(),
            to_fixed_point(filtered, cfg.min_disparity).cpu().numpy())
