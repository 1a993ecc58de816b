"""Census matching-cost volume (plain PyTorch), planes layout (D, H, W).

Counterpart of the census branch of ``stereo_match_tpu/ops/cost_volume.py``,
float32 (INVALID 1e4) or int16 (INVALID 1024) volumes, and of the
transposed (D, W, H) volume that ``census_volume_T_pallas`` fed the
streaming pipeline. The other cost families (SAD, SSD, Birchfield–Tomasi)
are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.ops.census import census_transform, popcount32

# Cost where the right-image sample at x - d falls off the frame. Finite, so
# SGM arithmetic stays NaN-free; the same values as the JAX package. The
# int16 value keeps 8-path sums well inside the int16 range (8 * (1024+P2)).
INVALID_COST = 1e4
INVALID_COST_I16 = 1024

VOLUME_DTYPES = {"float32": torch.float32, "int16": torch.int16}


def volume_dtype(dtype) -> torch.dtype:
    """float32 or int16, given as a torch dtype or its name; else raises."""
    dt = VOLUME_DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.int16):
        raise ValueError(f"census volumes are float32 or int16, not {dtype!r}")
    return dt


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
                             num_disparities: int, min_disparity: int = 0,
                             dtype=torch.float32) -> torch.Tensor:
    """(words, H, W) int32 census words of both views -> (D, H, W) volume.

    ``out[i, y, x]`` is the Hamming distance between ``cl[:, y, x]`` and
    ``cr[:, y, x - d]`` with ``d = min_disparity + i``, or INVALID_COST
    (float32; INVALID_COST_I16 for ``dtype`` int16) where ``x < d``. Built
    plane by plane, so no int64 temporary larger than one plane exists.
    """
    dt = volume_dtype(dtype)
    _, H, W = cl.shape
    out = torch.empty((num_disparities, H, W), dtype=dt, device=cl.device)
    for i in range(num_disparities):
        shifted = _shift_plane(cr, min_disparity + i)
        out[i] = popcount32(torch.bitwise_xor(cl, shifted)).sum(dim=0)
    mask = _invalid_mask(W, num_disparities, min_disparity, cl.device)
    return out.masked_fill_(mask, INVALID_COST_I16 if dt == torch.int16
                            else INVALID_COST)


def census_volume_T_from_words(clT: torch.Tensor, crT: torch.Tensor,
                               num_disparities: int, min_disparity: int = 0,
                               dtype=torch.float32) -> torch.Tensor:
    """Transposed words (words, W, H) -> the (D, W, H) volume.

    Equals ``census_volume_from_words`` on the (words, H, W) words with its
    two last axes swapped: ``out[i, x, y]`` compares ``clT[:, x, y]`` with
    ``crT[:, x - d, y]``.
    """
    vol = census_volume_from_words(clT.transpose(1, 2), crT.transpose(1, 2),
                                   num_disparities, min_disparity, dtype)
    return vol.transpose(1, 2).contiguous()


def census_cost_volume(left: torch.Tensor, right: torch.Tensor,
                       num_disparities: int, min_disparity: int = 0,
                       window: tuple[int, int] = (5, 5),
                       dtype=torch.float32) -> torch.Tensor:
    """(D, H, W) Hamming cost between census descriptors, float32 or int16."""
    cl = census_transform(left, window).permute(2, 0, 1)   # (words, H, W)
    cr = census_transform(right, window).permute(2, 0, 1)
    return census_volume_from_words(cl, cr, num_disparities, min_disparity,
                                    dtype)


def build_cost_volume(left: torch.Tensor, right: torch.Tensor,
                      num_disparities: int, min_disparity: int = 0,
                      cost: str = "census",
                      window: tuple[int, int] = (5, 5),
                      dtype=torch.float32) -> torch.Tensor:
    """Dispatch to the named cost family; only census is ported so far.

    Returns the (D, H, W) planes-layout volume, float32 or int16.
    """
    if cost != "census":
        raise NotImplementedError(
            f"cost={cost!r} is not ported yet (ROADMAP.md, queue 1: other "
            "costs and matchers)")
    return census_cost_volume(left, right, num_disparities, min_disparity,
                              window, dtype)
