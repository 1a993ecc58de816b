"""Winner-take-all disparity with subpixel, uniqueness and left-right
consistency (plain PyTorch).

Counterpart of ``stereo_match_tpu/ops/wta.py`` on (D, H, W) float32 or
int16 volumes. Invalid disparities are NaN in the float API;
:func:`to_fixed_point` converts to the int16 disparity*16 contract (invalid
-> (min_disparity - 1) * 16, as OpenCV emits). ``torch.round`` rounds half
to even, like ``jnp.round``.
"""

from __future__ import annotations

import torch

BIG = 1e9   # cost beyond the disparity range / outside the frame
BIG_I16 = 30000   # the same for int16 volumes (the XLA int16 path's)


def wta_disparity(agg: torch.Tensor) -> torch.Tensor:
    """Integer argmin over the D axis of (D, H, W), first on ties. int32."""
    return agg.argmin(dim=0).to(torch.int32)


def _big_sentinel(dtype: torch.dtype) -> float:
    return BIG_I16 if dtype == torch.int16 else BIG


def _neighbor_costs(agg: torch.Tensor, disp_idx: torch.Tensor):
    """(c[d-1], c[d], c[d+1]) at the winner as float32; the volume's big
    sentinel beyond the D range."""
    edge = torch.full_like(agg[:1], _big_sentinel(agg.dtype))
    up = torch.cat([edge, agg[:-1]], dim=0)
    down = torch.cat([agg[1:], edge], dim=0)
    idx = disp_idx.long()[None]
    return tuple(v.gather(0, idx)[0].to(torch.float32)
                 for v in (up, agg, down))


def subpixel_refine(agg: torch.Tensor, disp_idx: torch.Tensor) -> torch.Tensor:
    """Parabola interpolation around the winning disparity.

    d* = d + (C[d-1] - C[d+1]) / (2 * (C[d-1] - 2C[d] + C[d+1])), clamped to
    ±0.5; at the D-range edges the integer disparity is kept.
    """
    D = agg.shape[0]
    c0, c1, c2 = _neighbor_costs(agg, disp_idx)
    denom = c0 - 2.0 * c1 + c2
    offset = torch.where(denom > 1e-9,
                         (c0 - c2) / (2.0 * torch.clamp(denom, min=1e-9)),
                         0.0)
    offset = offset.clamp(-0.5, 0.5)
    at_edge = (disp_idx == 0) | (disp_idx == D - 1)
    return disp_idx.to(torch.float32) + torch.where(at_edge, 0.0, offset)


def uniqueness_mask(agg: torch.Tensor, disp_idx: torch.Tensor,
                    uniqueness_ratio: int) -> torch.Tensor:
    """True where the winner beats every non-neighbour cost by the ratio.

    OpenCV semantics: invalid if any d with |d - best| > 1 has
    cost[d] * 100 <= cost[best] * (100 + uniquenessRatio).
    """
    if uniqueness_ratio <= 0:
        return torch.ones(agg.shape[1:], dtype=torch.bool, device=agg.device)
    D = agg.shape[0]
    if agg.dtype == torch.int16:       # the products need 32 bits
        agg = agg.to(torch.int32)
    best = agg.amin(dim=0)
    ds = torch.arange(D, device=agg.device)[:, None, None]
    neighbor = (ds - disp_idx[None]).abs() <= 1
    violates = (agg * 100 <= best[None] * (100 + uniqueness_ratio)) & ~neighbor
    return ~violates.any(dim=0)


def right_disparity_from_volume(agg: torch.Tensor,
                                min_disparity: int = 0) -> torch.Tensor:
    """Right-view WTA disparity from the left-anchored cost volume.

    C_right(y, x_r, d) = C_left(y, x_r + d, d): each d plane shifts left by
    d along W, samples past the frame cost the volume's big sentinel, then
    argmin over d (first on ties). Returns float32 (H, W) with integer
    values.
    """
    D, H, W = agg.shape
    sheared = torch.full_like(agg, _big_sentinel(agg.dtype))
    for d in range(min(D, W)):
        sheared[d, :, :W - d] = agg[d, :, d:]
    return (sheared.argmin(dim=0) + min_disparity).to(torch.float32)


def lr_consistency_mask(disp_left: torch.Tensor, disp_right: torch.Tensor,
                        disp12_max_diff: int,
                        min_disparity: int = 0) -> torch.Tensor:
    """disp12 check: |d_L(x) - d_R(x - round(d_L(x)))| <= disp12_max_diff.

    ``disp12_max_diff < 0`` disables the check. A NaN or out-of-frame
    sample gives False; the sampling index is clamped before the read.
    """
    if disp12_max_diff < 0:
        return torch.ones(disp_left.shape, dtype=torch.bool,
                          device=disp_left.device)
    W = disp_left.shape[1]
    x = torch.arange(W, device=disp_left.device, dtype=torch.float32)
    xr = torch.round(x[None, :] - disp_left)
    inframe = (xr >= 0) & (xr < W)
    xrc = torch.where(inframe, xr, 0.0).long()
    d_r = disp_right.gather(1, xrc)
    return ((disp_left - d_r).abs() <= disp12_max_diff) & inframe


def extract_disparity(agg: torch.Tensor, min_disparity: int = 0,
                      uniqueness_ratio: int = 15, disp12_max_diff: int = 1,
                      subpixel: bool = True, return_right: bool = False):
    """Aggregated (D, H, W) volume -> float32 disparity map, NaN invalids.

    The full OpenCV-equivalent WTA stage: argmin, uniqueness, subpixel,
    LR consistency. ``return_right`` also returns the right-view WTA
    disparity computed for the disp12 check. Float32 and int16 volumes
    keep their dtype (int16: 30000 beyond the D range and outside the
    frame, uniqueness products in int32, as the XLA int16 path has it);
    others become float32.
    """
    if agg.dtype not in (torch.float32, torch.int16):
        agg = agg.to(torch.float32)
    idx = wta_disparity(agg)
    disp = subpixel_refine(agg, idx) if subpixel else idx.to(torch.float32)
    disp = disp + min_disparity

    mask = uniqueness_mask(agg, idx, uniqueness_ratio)
    disp_right = right_disparity_from_volume(agg, min_disparity)
    mask = mask & lr_consistency_mask(disp, disp_right, disp12_max_diff,
                                      min_disparity)
    disp = torch.where(mask, disp, torch.nan)
    return (disp, disp_right) if return_right else disp


def disparity_from_stats(stats, num_levels: int, min_disparity: int = 0,
                         uniqueness_ratio: int = 15, subpixel: bool = True):
    """(disp, mask) from the per-pixel WTA statistics.

    ``stats`` is the ``(best, idx, c0, c2, second)`` tuple of (H, W) maps
    (``cuda_kernels.wta_stats``); ``num_levels`` is the volume's D.
    ``disp`` is the float32 disparity before any masking, ``mask`` the
    uniqueness check: the (H, W)-sized tail of the JAX fast path
    (``stereo_match_tpu/ops/wta.py::extract_disparity_fast``) before its
    disp12 check.
    """
    best, idx, c0, c2, second = stats[:5]
    disp = idx.to(torch.float32)
    if subpixel:
        denom = c0 - 2.0 * best + c2
        offset = torch.where(denom > 1e-9,
                             (c0 - c2) / (2.0 * torch.clamp(denom, min=1e-9)),
                             0.0).clamp(-0.5, 0.5)
        at_edge = (idx == 0) | (idx == num_levels - 1)
        disp = disp + torch.where(at_edge, 0.0, offset)
    disp = disp + min_disparity
    if uniqueness_ratio > 0:
        mask = second * 100.0 > best * (100.0 + uniqueness_ratio)
    else:
        mask = torch.ones(best.shape, dtype=torch.bool, device=best.device)
    return disp, mask


def to_fixed_point(disparity: torch.Tensor,
                   min_disparity: int = 0) -> torch.Tensor:
    """float NaN-invalid -> int16 disparity*16."""
    invalid = float((min_disparity - 1) * 16)
    fixed = torch.where(torch.isfinite(disparity),
                        torch.round(disparity * 16.0), invalid)
    return fixed.to(torch.int16)


def from_fixed_point(disparity16: torch.Tensor,
                     min_disparity: int = 0) -> torch.Tensor:
    """int16 disparity*16 -> float with NaN invalids."""
    d = disparity16.to(torch.float32) / 16.0
    return torch.where(d < min_disparity, torch.nan, d)
