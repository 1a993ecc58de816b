"""Census matching-cost volume (plain PyTorch), planes layout (D, H, W).

Counterpart of the census branch of ``stereo_match_tpu/ops/cost_volume.py``.
The other cost families (SAD, SSD, Birchfield–Tomasi) are not ported yet
(ROADMAP.md, queue 1), nor the int16 volume (queue 2).
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.ops.census import census_transform, popcount32

# Cost where the right-image sample at x - d falls off the frame. Finite, so
# SGM arithmetic stays NaN-free; the same value as the JAX package.
INVALID_COST = 1e4


def _shift_plane(arr: torch.Tensor, d: int) -> torch.Tensor:
    """(..., W) plane sampled at x - d: out[..., x] = arr[..., x - d].

    The x - d < 0 region holds the edge replica (it is overwritten by
    INVALID_COST downstream).
    """
    if d == 0:
        return arr
    W = arr.shape[-1]
    d = min(d, W)
    edge = arr[..., :1].expand(*arr.shape[:-1], d)
    return torch.cat([edge, arr[..., :W - d]], dim=-1)


def _invalid_mask(W: int, num_disparities: int, min_disparity: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """(D, 1, W) bool: True where x - d < 0 (no right sample)."""
    d = (min_disparity + torch.arange(num_disparities, device=device))
    x = torch.arange(W, device=device)
    return x[None, None, :] < d[:, None, None]


def census_volume_from_words(cl: torch.Tensor, cr: torch.Tensor,
                             num_disparities: int,
                             min_disparity: int = 0) -> torch.Tensor:
    """(words, H, W) int32 census words of both views -> (D, H, W) float32.

    ``out[i, y, x]`` is the Hamming distance between ``cl[:, y, x]`` and
    ``cr[:, y, x - d]`` with ``d = min_disparity + i``, or INVALID_COST
    where ``x < d``. Built plane by plane, so no int64 temporary larger
    than one plane exists.
    """
    _, H, W = cl.shape
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=cl.device)
    for i in range(num_disparities):
        shifted = _shift_plane(cr, min_disparity + i)
        out[i] = popcount32(torch.bitwise_xor(cl, shifted)).sum(dim=0)
    mask = _invalid_mask(W, num_disparities, min_disparity, cl.device)
    return out.masked_fill_(mask, INVALID_COST)


def census_cost_volume(left: torch.Tensor, right: torch.Tensor,
                       num_disparities: int, min_disparity: int = 0,
                       window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """(D, H, W) float32 Hamming cost between census descriptors."""
    cl = census_transform(left, window).permute(2, 0, 1)   # (words, H, W)
    cr = census_transform(right, window).permute(2, 0, 1)
    return census_volume_from_words(cl, cr, num_disparities, min_disparity)


def build_cost_volume(left: torch.Tensor, right: torch.Tensor,
                      num_disparities: int, min_disparity: int = 0,
                      cost: str = "census",
                      window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """Dispatch to the named cost family; only census is ported so far.

    Returns the (D, H, W) float32 planes-layout volume.
    """
    if cost != "census":
        raise NotImplementedError(
            f"cost={cost!r} is not ported yet (ROADMAP.md, queue 1: other "
            "costs and matchers)")
    return census_cost_volume(left, right, num_disparities, min_disparity,
                              window)
