"""Census cost volume (plain PyTorch).

Census (Zabih & Woodfill, ECCV 1994) over a ``wh x ww`` window with edge
replication: bit k of a pixel is 1 where its k-th neighbour is strictly
darker than it. The cost of d at (y, x) is the number of bits in which
left (y, x) and right (y, x - d) differ; where x < d there is no right
sample and the cost is ``INVALID`` (1e4), as the program documents it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INVALID = 1e4


def census_bits(imgs: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """(N, H, W) float32 images -> (N, K, H, W) bool census bits, K the
    window's pixels but the centre."""
    wh, ww = window
    N, H, W = imgs.shape
    ry, rx = wh // 2, ww // 2
    padded = F.pad(imgs[:, None], (rx, rx, ry, ry), mode="replicate")[:, 0]
    bits = [padded[:, dy:dy + H, dx:dx + W] < imgs
            for dy in range(wh) for dx in range(ww)
            if (dy, dx) != (ry, rx)]
    return torch.stack(bits, dim=1)


def census_volume(lefts: torch.Tensor, rights: torch.Tensor,
                  num_disparities: int, min_disparity: int,
                  window: tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W) float32 views -> the (N, D, H, W) Hamming volume in
    ``dtype`` (the counts are whole numbers, exact in either type)."""
    bl, br = census_bits(lefts, window), census_bits(rights, window)
    N, _, H, W = bl.shape
    out = torch.full((N, num_disparities, H, W), INVALID, dtype=dtype,
                     device=lefts.device)
    for i in range(num_disparities):
        d = min_disparity + i
        if d >= W:
            continue
        diff = (bl[..., d:] != br[..., :W - d]).sum(dim=1)
        out[:, i, :, d:] = diff.to(dtype)
    return out
