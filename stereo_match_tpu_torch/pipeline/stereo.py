"""The stereo pipeline (PyTorch): classic or MC-CNN cost, SGM, post stack.

Counterpart of ``stereo_match_tpu/pipeline/stereo.py``: ``_match_core``
(census, sad, ssd or bt, or the volume of any ``cost_fn`` such as
``costs.MCCNNCost``) with its post stack, :class:`StereoMatcher` (with
``batched``), the LRU-cached :func:`compute_disparity` with its int16
disparity*16 contract (``method="SGBM"``, or ``"BM"`` for the true StereoBM
of ``pipeline/block_matching.py``), and the flagship flow
:func:`run_pipeline` (rectify from poses -> match -> WLS -> reproject ->
PLY).

The matching path runs on the kernels of ``ops/cuda_kernels.py``: census
words of both views (K1, one or more words) and the (D, H, W) Hamming
volume (K2), or the plain torch sad, ssd or bt volume, or with
``costs.MCCNNCost`` the feature tower (K8, one launch per layer) and the
feature-dot volume (K9), or at min_disparity 0 and D a multiple of 128 K8
for the layers but the last and K11 (the last layer, its norm and the
volume in one launch); then one SGM scan per path direction added into
the total (K3, ``num_paths`` launches), WTA with subpixel, uniqueness and
the disp12 check (K4); then, when configured, the speckle filter's label
sweeps (K5) and component sizes (K6), and the WLS smoother's tridiagonal
solves (K7, two per WLS iteration). CPU tensors run the kernels' plain
versions; CUDA tensors run the kernels. Each ``_match_core`` call counts a
frame and issues its cost, SGM and WTA under the spans ``smt.cost``,
``smt.sgm`` and ``smt.wta``; a matcher's upload runs under ``smt.upload``
(``utils/profiling.py``). The entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; without a
card they raise.

Every cost family of the JAX package runs, census at any odd window, with
2, 4 or 8 paths, float32 or (census) int16 volumes, and the speckle and
WLS post-filters. A negative ``min_disparity`` raises ``ValueError``, as
the reference does; a volume dtype other than float32 or int16 raises
``NotImplementedError``. ``dtype="int16"`` runs K2, K3 and K4 on int16
census volumes as the JAX package's XLA path does (INVALID 1024, P1 and P2
truncated to integers): half the memory of the float32 volumes; the other
families and a ``cost_fn`` volume stay float32, as in JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.costs import ClassicCost, census_cost
from stereo_match_tpu_torch.core.rectify import (RectificationResult,
                                                 rectify_pair)
from stereo_match_tpu_torch.core.reproject import reproject_image_to_3d
from stereo_match_tpu_torch.data.image import to_grayscale
from stereo_match_tpu_torch.data.ply import write_ply
from stereo_match_tpu_torch.ops.cost_volume import (COST_FAMILIES,
                                                    check_min_disparity)
from stereo_match_tpu_torch.ops.cuda_kernels import aggregate_paths, wta_lr
from stereo_match_tpu_torch.ops.speckle import speckle_filter
from stereo_match_tpu_torch.ops.wls import (wls_confidence_cv2,
                                            wls_filter_disparity)
from stereo_match_tpu_torch.ops.wta import to_fixed_point
from stereo_match_tpu_torch.utils.backend import entry_device
from stereo_match_tpu_torch.utils.profiling import count, span


@dataclass
class StereoResult:
    """Outputs of one pipeline run (host-side numpy arrays)."""
    disparity: np.ndarray                 # raw float32, NaN invalid
    disparity_filtered: np.ndarray        # WLS-refined (dense)
    rect_left: np.ndarray | None = None
    rect_right: np.ndarray | None = None
    rectification: RectificationResult | None = None
    points: np.ndarray | None = None      # (H, W, 3) when reprojected
    meta: dict[str, Any] = field(default_factory=dict)


def check_slice(cfg: DisparityConfig, cost_fn=None) -> None:
    """Raise unless the port implements ``cfg`` (see the module doc).

    With a ``cost_fn`` the volume comes from it and ``cfg.cost`` and the
    census window are not read, as in the JAX package.
    """
    if cost_fn is None:
        if cfg.cost == "mccnn":
            raise ValueError("unknown cost family: mccnn (cost='mccnn' "
                             "needs cost_fn=costs.MCCNNCost(...))")
        if cfg.cost not in COST_FAMILIES:
            raise ValueError(f"unknown cost family: {cfg.cost}")
        wh, ww = cfg.census_window
        if cfg.cost == "census" and (wh % 2 == 0 or ww % 2 == 0):
            raise ValueError("census window must be odd in both dimensions")
    if cfg.num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    check_min_disparity(cfg.min_disparity)
    if cfg.dtype not in ("float32", "int16"):
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the port builds float32 or int16 volumes "
            "(the JAX package's census path also takes other types; "
            "ROADMAP.md, section 3)")


def _check_volume(vol, cfg: DisparityConfig, like: torch.Tensor) -> None:
    """A ``cost_fn`` volume must be what K3 reads; nothing is converted."""
    if not torch.is_tensor(vol):
        raise TypeError(f"cost_fn returned {type(vol).__name__}, not a "
                        "tensor")
    want = (cfg.num_disparities, *like.shape)
    if vol.dtype != torch.float32 or tuple(vol.shape) != want:
        raise ValueError(f"cost_fn volume {tuple(vol.shape)} {vol.dtype}: "
                         f"expected {want} torch.float32")
    if vol.device != like.device:
        raise ValueError(f"cost_fn volume on {vol.device}, the matcher "
                         f"runs on {like.device}")
    if not vol.is_contiguous():
        raise ValueError("cost_fn volume must be contiguous")


def _match_core(left_gray: torch.Tensor, right_gray: torch.Tensor,
                cfg: DisparityConfig,
                cost_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) images -> (raw, filtered) float32 disparities, NaN invalid.

    ``cost_fn`` overrides the cost family (e.g. a ``costs.MCCNNCost``);
    without it, census on K1/K2 (float32 or, with ``cfg.dtype="int16"``,
    int16), or the float32 sad, ssd or bt volume (``ClassicCost``).
    ``raw`` is the speckle-filtered WTA map; ``filtered`` its WLS
    refinement (dense) when ``cfg.wls``, else ``raw``.
    """
    check_slice(cfg, cost_fn)
    count("frames", 1)
    left = left_gray.to(torch.float32)
    right = right_gray.to(torch.float32)
    with span("smt.cost"):
        if cost_fn is not None:
            vol = cost_fn(left, right)
            _check_volume(vol, cfg, left)
        elif cfg.cost == "census":
            vol = census_cost(left, right, cfg, cfg.dtype)
        else:
            vol = ClassicCost(cfg)(left, right)
    with span("smt.sgm"):
        total = aggregate_paths(vol, cfg.P1, cfg.P2, cfg.num_paths)
    del vol                   # free the volumes before the post stack runs
    with span("smt.wta"):
        disp, disp_right = wta_lr(total, cfg.min_disparity,
                                  cfg.uniqueness_ratio, cfg.disp12_max_diff,
                                  cfg.subpixel)
    del total
    disp = speckle_filter(disp, cfg.speckle_window_size, cfg.speckle_range)
    if not cfg.wls:
        return disp, disp
    # OpenCV DisparityWLSFilter wiring: the confidence of the reference's
    # right-matcher pair, from the right view that K4 already computed
    confidence = wls_confidence_cv2(disp, disp_right) \
        if cfg.wls_lr_confidence else None
    filtered = wls_filter_disparity(disp, left, cfg.lmbda, cfg.sigma,
                                    cfg.wls_iters, confidence=confidence)
    return disp, filtered


class StereoMatcher:
    """Stereo matcher for a fixed config on one device.

    >>> matcher = StereoMatcher(DisparityConfig(), device="cuda")
    >>> raw, filtered = matcher(left_gray, right_gray)

    ``cost_fn`` (e.g. ``costs.MCCNNCost(model.to(device), config)``)
    replaces the census volume; it must return a contiguous float32
    (D, H, W) tensor on ``device``.
    """

    def __init__(self, config: DisparityConfig | None = None, cost_fn=None,
                 device: torch.device | str = "cuda"):
        self.config = config or DisparityConfig()
        check_slice(self.config, cost_fn)
        self.cost_fn = cost_fn
        self.device = entry_device(device)

    def _upload(self, left, right) -> list[torch.Tensor]:
        """Both views as float32 tensors on the matcher's device, under one
        ``smt.upload`` span; counts the bytes copied from host memory onto
        a card."""
        with span("smt.upload"):
            out = [torch.as_tensor(a, dtype=torch.float32, device=self.device)
                   for a in (left, right)]
        count("upload_bytes", sum(
            t.nbytes for a, t in zip((left, right), out)
            if t.is_cuda and not (torch.is_tensor(a) and a.is_cuda)))
        return out

    def __call__(self, left_gray, right_gray):
        return _match_core(*self._upload(left_gray, right_gray),
                           self.config, self.cost_fn)

    def batched(self, lefts, rights):
        """Match a leading batch axis of frames (a capture sequence)."""
        lefts, rights = self._upload(lefts, rights)
        outs = [_match_core(l, r, self.config, self.cost_fn)
                for l, r in zip(lefts, rights)]
        return (torch.stack([raw for raw, _ in outs]),
                torch.stack([filtered for _, filtered in outs]))


# compute_disparity's matcher cache, keyed on the full config repr, method
# and device; LRU-bounded so a parameter sweep cannot grow it without end.
_MATCHER_CACHE_CAP = 8
_MATCHER_CACHE: OrderedDict[tuple[str, str, str], Any] = OrderedDict()


def compute_disparity(gray_l, gray_r, config: DisparityConfig | None = None,
                      method: str = "SGBM",
                      device: torch.device | str = "cuda"):
    """Reference-parity surface: (displ16, filtered16) int16 disparity*16.

    ``method``: "SGBM" (the configured cost + SGM) or "BM" (the true
    StereoBM of :class:`~stereo_match_tpu_torch.pipeline.block_matching.
    BlockMatcher`: x-Sobel prefilter, SAD WTA, texture threshold). Returns
    numpy arrays, as the JAX package does.
    """
    cfg = config or DisparityConfig()
    method = method.upper()
    key = (repr(cfg), method, str(entry_device(device)))
    matcher = _MATCHER_CACHE.get(key)
    if matcher is None:
        if method == "BM":
            from stereo_match_tpu_torch.pipeline.block_matching import \
                BlockMatcher
            matcher = BlockMatcher(cfg, device=device)
        else:
            matcher = StereoMatcher(cfg, device=device)
        _MATCHER_CACHE[key] = matcher
        while len(_MATCHER_CACHE) > _MATCHER_CACHE_CAP:
            _MATCHER_CACHE.popitem(last=False)
    else:
        _MATCHER_CACHE.move_to_end(key)
    raw, filtered = matcher(gray_l, gray_r)
    return (to_fixed_point(raw, cfg.min_disparity).cpu().numpy(),
            to_fixed_point(filtered, cfg.min_disparity).cpu().numpy())


def run_pipeline(pose_l, pose_r, K_l, K_r, image_l, image_r,
                 config: DisparityConfig | None = None,
                 alpha: float = -1.0,
                 reproject: bool = True,
                 ply_path: str | None = None,
                 q_override: np.ndarray | None = None,
                 disparity_band: tuple[float, float] | None = None,
                 matcher=None,
                 device: torch.device | str = "cuda") -> StereoResult:
    """Full flagship flow on one pair (``disparity_calculation.py`` parity).

    Rectify from camera-to-world poses, match, refine, reproject the
    WLS-filtered map to 3-D and optionally write a PLY. ``q_override``
    reproduces the reference's hard-coded-Q quirk (:293-299);
    ``disparity_band`` its (10, 20) PLY mask (:312). ``matcher`` overrides
    the matching stage with any ``(gray_l, gray_r) -> (raw, filtered)``
    callable. Rectification, matching and reprojection run on ``device``;
    the result holds numpy arrays.
    """
    cfg = config or DisparityConfig()
    device = entry_device(device)
    rect_l, rect_r, rectification = rectify_pair(
        pose_l, pose_r, K_l, K_r, np.asarray(image_l), np.asarray(image_r),
        alpha=alpha, device=device)
    rect_l, rect_r = rect_l.cpu().numpy(), rect_r.cpu().numpy()
    gray_l = to_grayscale(rect_l)
    gray_r = to_grayscale(rect_r)

    matcher = matcher or StereoMatcher(cfg, device=device)
    raw, filtered = matcher(gray_l, gray_r)
    result = StereoResult(
        disparity=_numpy(raw), disparity_filtered=_numpy(filtered),
        rect_left=rect_l, rect_right=rect_r, rectification=rectification)

    if reproject or ply_path:
        Q = q_override if q_override is not None else rectification.Q
        filtered = torch.as_tensor(filtered, dtype=torch.float32,
                                   device=device)
        pts = reproject_image_to_3d(filtered, Q).cpu().numpy()
        result.points = pts
        if ply_path:
            disp = result.disparity_filtered
            if disparity_band is not None:
                lo, hi = disparity_band
                mask = (disp > lo) & (disp < hi)
            else:
                mask = np.isfinite(result.disparity)
            colors = rect_l
            if colors.ndim == 2:
                colors = np.stack([colors] * 3, axis=-1)
            n = write_ply(ply_path, pts[mask], colors[mask])
            result.meta["ply_vertices"] = n
    return result


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
