"""Winner-take-all with subpixel, uniqueness and the disp12 check (plain
PyTorch), as OpenCV's StereoSGBM defines them.

Per pixel: the first d of least total; a parabola through the totals at
d - 1, d, d + 1 moves it by at most half a pixel (not at the range's
ends); the pixel is invalid unless every total at |d' - d| > 1 exceeds
the best by the uniqueness ratio (``second * 100 > best * (100 + u)``);
and unless the right view's winner at x - round(disp), the first d of
least total ``total[d, y, x_r + d]`` over the d that stay in the frame,
lies within ``disp12_max_diff`` of it. Invalid pixels are NaN.
"""

from __future__ import annotations

import torch


def _right_disparity(total: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W) totals -> (N, H, W) float32 right-view winners."""
    N, D, H, W = total.shape
    sheared = torch.full_like(total, float("inf"))
    for d in range(min(D, W)):
        sheared[:, d, :, :W - d] = total[:, d, :, d:]
    return sheared.argmin(dim=1).to(torch.float32)


def winner_take_all(total: torch.Tensor, min_disparity: int,
                    uniqueness_ratio: int, disp12_max_diff: int,
                    subpixel: bool) -> torch.Tensor:
    """(N, D, H, W) totals (float32 values) -> (N, H, W) float32 maps."""
    total = total.to(torch.float32)
    N, D, H, W = total.shape
    idx = total.argmin(dim=1, keepdim=True)
    best = total.gather(1, idx)[:, 0]
    c0 = total.gather(1, (idx - 1).clamp(min=0))[:, 0]
    c2 = total.gather(1, (idx + 1).clamp(max=D - 1))[:, 0]
    ds = torch.arange(D, device=total.device)[None, :, None, None]
    near = (ds - idx).abs() <= 1
    second = total.masked_fill(near, float("inf")).amin(dim=1)
    idx = idx[:, 0]
    disp = idx.to(torch.float32)
    if subpixel:
        denom = c0 - 2.0 * best + c2
        offset = torch.where(denom > 1e-9,
                             (c0 - c2) / (2.0 * torch.clamp(denom, min=1e-9)),
                             0.0).clamp(-0.5, 0.5)
        at_edge = (idx == 0) | (idx == D - 1)
        disp = disp + torch.where(at_edge, 0.0, offset)
    disp = disp + min_disparity
    valid = torch.ones_like(disp, dtype=torch.bool)
    if uniqueness_ratio > 0:
        valid &= second * 100.0 > best * (100.0 + uniqueness_ratio)
    if disp12_max_diff >= 0:
        right = _right_disparity(total) + min_disparity
        x = torch.arange(W, device=total.device, dtype=torch.float32)
        xr = torch.round(x - disp)
        inframe = (xr >= 0) & (xr < W)
        d_r = right.gather(2, torch.where(inframe, xr, 0.0).long())
        valid &= inframe & ((disp - d_r).abs() <= disp12_max_diff)
    return torch.where(valid, disp, torch.nan)
