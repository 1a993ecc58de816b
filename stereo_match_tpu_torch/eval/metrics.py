"""Disparity evaluation metrics (bad-px, EPE, density) in PyTorch.

Counterpart of ``stereo_match_tpu/eval/metrics.py``; accepts tensors on any
device or numpy arrays and returns 0-d float32 tensors (plain floats from
:func:`compare_disparities`).
"""

from __future__ import annotations

import torch


def _as_f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _valid_mask(pred, gt, extra_mask=None):
    pred = _as_f32(pred)
    gt = _as_f32(gt).to(pred.device)
    mask = torch.isfinite(gt) & torch.isfinite(pred)
    if extra_mask is not None:
        mask = mask & torch.as_tensor(extra_mask, dtype=torch.bool,
                                      device=pred.device)
    return pred, gt, mask


def bad_pixel_rate(pred, gt, threshold: float = 3.0,
                   relative: float = 0.05, mask=None) -> torch.Tensor:
    """Fraction of valid pixels with error > threshold (KITTI D1 semantics).

    A pixel is bad when |pred-gt| > threshold AND |pred-gt| > relative*|gt|
    (set relative=0 for plain bad-N).
    """
    pred, gt, m = _valid_mask(pred, gt, mask)
    err = (pred - gt).abs()
    bad = (err > threshold) & (err > relative * gt.abs())
    return (bad & m).sum() / m.sum().clamp(min=1)


def end_point_error(pred, gt, mask=None) -> torch.Tensor:
    """Mean absolute disparity error over valid pixels."""
    pred, gt, m = _valid_mask(pred, gt, mask)
    err = torch.where(m, (pred - gt).abs(), 0.0)
    return err.sum() / m.sum().clamp(min=1)


def density(pred, valid_value: float = 0.0) -> torch.Tensor:
    """Fraction of pixels carrying a valid (finite, > valid_value) estimate."""
    pred = _as_f32(pred)
    return (torch.isfinite(pred) & (pred > valid_value)).float().mean()


def compare_disparities(pred, gt, mask=None) -> dict:
    """Full scorecard as plain floats."""
    return {
        "epe": float(end_point_error(pred, gt, mask)),
        "bad1": float(bad_pixel_rate(pred, gt, 1.0, 0.0, mask)),
        "bad2": float(bad_pixel_rate(pred, gt, 2.0, 0.0, mask)),
        "bad3": float(bad_pixel_rate(pred, gt, 3.0, 0.0, mask)),
        "d1": float(bad_pixel_rate(pred, gt, 3.0, 0.05, mask)),
        "density": float(density(pred)),
        "valid_px": int(torch.isfinite(_as_f32(gt)).sum()),
    }
