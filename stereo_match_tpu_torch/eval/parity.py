"""Accuracy parity against OpenCV StereoSGBM at production settings.

The same code as ``stereo_match_tpu/eval/parity.py`` on the port's
``config.py`` and ``eval/metrics.py``.

The reference's matcher IS ``cv2.StereoSGBM`` configured by settings.ini
(``stereo_vision/stereo_vision.py:132-184``, ``settings.ini:1-23``), so the
framework's accuracy target is stated against it: bad-3px within 2 points
on scenes with known ground truth (BASELINE.md).

This module exists for tests and the committed ACCURACY.json artifact —
cv2 here is the *oracle*, never a compute path. NOTE: this environment's
cv2 build has no ximgproc (contrib), so the WLS post-filter has no OpenCV
oracle; WLS parity is established against the published FGS algorithm
instead (``ops/wls.py``).
"""

from __future__ import annotations

import numpy as np


def opencv_sgbm_disparity(left: np.ndarray, right: np.ndarray,
                          config=None, mode: str = "hh") -> np.ndarray:
    """Run cv2.StereoSGBM with a :class:`DisparityConfig`'s parameters.

    Mirrors the reference's construction (``stereo_vision/stereo_vision.py:
    148-163``): P1/P2 derived as 8*ch*w^2 / 32*ch*w^2, the ten SGBM params
    taken from the config. Returns float32 disparity with NaN invalids
    (OpenCV's (min_disparity-1)*16 sentinel decoded).

    ``mode``: "hh" (8-path, matches the framework's num_paths=8), "sgbm"
    (OpenCV default 5-path), or "3way".
    """
    import cv2

    from stereo_match_tpu_torch.config import DisparityConfig
    cfg = config or DisparityConfig()
    modes = {"hh": cv2.STEREO_SGBM_MODE_HH,
             "sgbm": cv2.STEREO_SGBM_MODE_SGBM,
             "3way": cv2.STEREO_SGBM_MODE_SGBM_3WAY}
    # OpenCV derives P1/P2 from channels*window^2 on the *image* cost
    # (reference :148-149); always the SAD-family scaling, regardless of
    # the framework-side cost choice.
    w = cfg.window_size
    matcher = cv2.StereoSGBM_create(
        minDisparity=cfg.min_disparity,
        numDisparities=cfg.num_disparities,
        blockSize=cfg.block_size,
        P1=8 * cfg.channels * w ** 2,
        P2=32 * cfg.channels * w ** 2,
        disp12MaxDiff=cfg.disp12_max_diff,
        uniquenessRatio=cfg.uniqueness_ratio,
        speckleWindowSize=cfg.speckle_window_size,
        speckleRange=cfg.speckle_range,
        preFilterCap=cfg.pre_filter_cap,
        mode=modes[mode],
    )
    l8 = np.clip(np.asarray(left), 0, 255).astype(np.uint8)
    r8 = np.clip(np.asarray(right), 0, 255).astype(np.uint8)
    fixed = matcher.compute(l8, r8).astype(np.float32) / 16.0
    return np.where(fixed < cfg.min_disparity, np.nan, fixed)


def opencv_bm_disparity(left: np.ndarray, right: np.ndarray,
                        config=None) -> np.ndarray:
    """Run cv2.StereoBM with a :class:`DisparityConfig`'s parameters.

    The oracle for the BM fallback mode (reference
    ``stereo_vision/stereo_vision.py:165-166`` creates the matcher with
    numDisparities/blockSize only and inherits OpenCV defaults —
    x-Sobel prefilter capped at 31, textureThreshold 10, uniqueness 15 —
    which are the defaults of ``DisparityConfig``'s BM block). Returns
    float32 disparity with NaN invalids.
    """
    import cv2

    from stereo_match_tpu_torch.config import DisparityConfig
    cfg = config or DisparityConfig()
    matcher = cv2.StereoBM_create(numDisparities=cfg.num_disparities,
                                  blockSize=cfg.block_size)
    matcher.setPreFilterType(cv2.STEREO_BM_PREFILTER_XSOBEL)
    matcher.setPreFilterCap(cfg.bm_pre_filter_cap)
    matcher.setTextureThreshold(cfg.texture_threshold)
    matcher.setUniquenessRatio(cfg.uniqueness_ratio)
    matcher.setMinDisparity(cfg.min_disparity)
    matcher.setDisp12MaxDiff(cfg.disp12_max_diff)
    matcher.setSpeckleWindowSize(cfg.speckle_window_size)
    matcher.setSpeckleRange(cfg.speckle_range)
    l8 = np.clip(np.asarray(left), 0, 255).astype(np.uint8)
    r8 = np.clip(np.asarray(right), 0, 255).astype(np.uint8)
    fixed = matcher.compute(l8, r8).astype(np.float32) / 16.0
    return np.where(fixed < cfg.min_disparity, np.nan, fixed)


def parity_report(scene_name: str, gt: np.ndarray, ours: np.ndarray,
                  cv2_disp: np.ndarray) -> dict:
    """Scorecards for both matchers + the deltas the target is stated on."""
    from stereo_match_tpu_torch.eval.metrics import compare_disparities
    ours_m = compare_disparities(ours, gt)
    ref_m = compare_disparities(cv2_disp, gt)
    return {
        "scene": scene_name,
        "ours": ours_m,
        "opencv_sgbm": ref_m,
        "bad3_delta": ours_m["bad3"] - ref_m["bad3"],
        "epe_delta": ours_m["epe"] - ref_m["epe"],
        "density_delta": ours_m["density"] - ref_m["density"],
    }
