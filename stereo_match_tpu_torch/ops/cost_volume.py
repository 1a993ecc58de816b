"""Matching-cost volumes (plain PyTorch), planes layout (D, H, W).

Counterpart of ``stereo_match_tpu/ops/cost_volume.py``: census + Hamming
(float32, INVALID 1e4, or int16, INVALID 1024; one or more census words),
the transposed (D, W, H) census volume that ``census_volume_T_pallas`` fed
the streaming pipeline, block SAD / SSD (the StereoBM capability) and
Birchfield–Tomasi on x-Sobel prefiltered images with ``pre_filter_cap``
(the pixel cost inside OpenCV's StereoSGBM). The SAD, SSD and BT families
are XLA in the JAX package, so they are plain torch here, on the CPU and
on the card alike; their box filters subtract float32 cumulative sums, as
the JAX package's do (the two sum in other orders, so those volumes agree
to rounding, not bit for bit).

A negative ``min_disparity`` is refused with a ``ValueError``: the JAX
package's plane shift pads by ``d`` and raises on a negative width, so the
reference supports none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereo_match_tpu_torch.ops.census import census_transform, popcount32

# Cost where the right-image sample at x - d falls off the frame. Finite, so
# SGM arithmetic stays NaN-free; the same values as the JAX package. The
# int16 value keeps 8-path sums well inside the int16 range (8 * (1024+P2)).
INVALID_COST = 1e4
INVALID_COST_I16 = 1024

VOLUME_DTYPES = {"float32": torch.float32, "int16": torch.int16}
COST_FAMILIES = ("census", "sad", "ssd", "bt")

# Planes built at once by the box-filtered families: bounds the temporaries
# to a few times 16 planes.
_CHUNK = 16


def volume_dtype(dtype) -> torch.dtype:
    """float32 or int16, given as a torch dtype or its name; else raises."""
    dt = VOLUME_DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.int16):
        raise ValueError(f"census volumes are float32 or int16, not {dtype!r}")
    return dt


def check_min_disparity(min_disparity: int) -> None:
    """Raise ``ValueError`` on a negative ``min_disparity``.

    The reference does not support one: its plane shift (``jnp.pad`` by
    ``d``) raises for every cost family, and so do its matchers.
    """
    if min_disparity < 0:
        raise ValueError(f"min_disparity={min_disparity}: the reference "
                         "(stereo_match_tpu) does not support a negative "
                         "min_disparity")


def _shift_plane(arr: torch.Tensor, d: int) -> torch.Tensor:
    """(..., W) plane sampled at x - d: out[..., x] = arr[..., x - d].

    The x - d < 0 region holds the edge replica (it is overwritten by
    INVALID_COST downstream). ``d < 0`` raises, as in the reference.
    """
    check_min_disparity(d)
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


def _stack_over_disparities(plane_fn, num_disparities: int,
                            min_disparity: int, like: torch.Tensor,
                            invalid: float = INVALID_COST) -> torch.Tensor:
    """(H, W)-plane builder -> (D, H, W) float32 volume, ``invalid`` at
    x < d.

    ``plane_fn(ds)`` returns the (len(ds), H, W) planes of the shifts
    ``ds``; it is called on chunks of ``_CHUNK`` shifts.
    """
    H, W = like.shape[-2:]
    out = torch.empty((num_disparities, H, W), dtype=torch.float32,
                      device=like.device)
    ds = [min_disparity + i for i in range(num_disparities)]
    for i in range(0, num_disparities, _CHUNK):
        out[i:i + _CHUNK] = plane_fn(ds[i:i + _CHUNK])
    mask = _invalid_mask(W, num_disparities, min_disparity, like.device)
    return out.masked_fill_(mask, invalid)


def _shifted(arr: torch.Tensor, ds) -> torch.Tensor:
    """(H, W) -> (len(ds), H, W): the plane shifted by each d of ``ds``."""
    return torch.stack([_shift_plane(arr, d) for d in ds])


def _window_sums(x: torch.Tensor, size: int, before: int) -> torch.Tensor:
    """Sums over ``size``-wide windows along the two trailing axes.

    Zero padding of ``before`` + 1 cells ahead and ``size - 1 - before``
    behind, then the difference of float32 cumulative sums: the window of
    x covers [x - before, x + size - 1 - before].
    """
    after = size - 1 - before

    def along(a: torch.Tensor, dim: int) -> torch.Tensor:
        pad = (before + 1, after) if dim == -1 else (0, 0, before + 1, after)
        c = torch.cumsum(F.pad(a, pad), dim=dim, dtype=torch.float32)
        n = c.shape[dim] - size
        return c.narrow(dim, size, n) - c.narrow(dim, 0, n)

    return along(along(x.to(torch.float32), -2), -1)


def _box_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter over a size x size window on the trailing (H, W) axes.

    Separable running sum via float32 cumsum, as the JAX package's; the
    edges divide by the true in-frame window area.
    """
    if size <= 1:
        return x
    r = size // 2
    ones = torch.ones(x.shape[-2:], dtype=torch.float32, device=x.device)
    return _window_sums(x, size, r) / _window_sums(ones, size, r)


def sad_cost_volume(left: torch.Tensor, right: torch.Tensor,
                    num_disparities: int, min_disparity: int = 0,
                    block_size: int = 5, squared: bool = False
                    ) -> torch.Tensor:
    """(D, H, W) block SAD (or SSD) cost: the StereoBM capability."""
    l = torch.as_tensor(left).to(torch.float32)
    r = torch.as_tensor(right).to(torch.float32)

    def planes(ds):
        diff = l - _shifted(r, ds)
        return _box_filter(diff * diff if squared else diff.abs(),
                           block_size)

    return _stack_over_disparities(planes, num_disparities, min_disparity, l)


def sobel_x_clipped(image: torch.Tensor,
                    pre_filter_cap: int = 63) -> torch.Tensor:
    """Horizontal Sobel response / 4, clipped to [-cap, cap], shifted to
    [0, 2 cap]: the SGBM prefilter that ``pre_filter_cap`` controls."""
    img = torch.as_tensor(image).to(torch.float32)
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2]) / 4.0
    cap = float(pre_filter_cap)
    return gx.clamp(-cap, cap) + cap


def _half_sample_envelope(sig: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Min/max of a signal and its half-sample interpolants along x."""
    prev = torch.cat([sig[:, :1], sig[:, :-1]], dim=1)
    nxt = torch.cat([sig[:, 1:], sig[:, -1:]], dim=1)
    a, b = (sig + prev) / 2, (sig + nxt) / 2
    lo = torch.minimum(torch.minimum(a, b), sig)
    hi = torch.maximum(torch.maximum(a, b), sig)
    return lo, hi


def bt_cost_volume(left: torch.Tensor, right: torch.Tensor,
                   num_disparities: int, min_disparity: int = 0,
                   pre_filter_cap: int = 63,
                   block_size: int = 5) -> torch.Tensor:
    """(D, H, W) Birchfield–Tomasi cost on x-Sobel prefiltered images.

    Each left pixel against the interval of the right pixel's half-sample
    neighbours (and symmetrically), then a block_size box mean.
    """
    ls = sobel_x_clipped(left, pre_filter_cap)
    rs = sobel_x_clipped(right, pre_filter_cap)
    l_lo, l_hi = _half_sample_envelope(ls)
    r_lo, r_hi = _half_sample_envelope(rs)

    def planes(ds):
        rsd, rlod, rhid = (_shifted(a, ds) for a in (rs, r_lo, r_hi))
        d_lr = torch.maximum(ls - rhid, rlod - ls).clamp(min=0.0)
        d_rl = torch.maximum(rsd - l_hi, l_lo - rsd).clamp(min=0.0)
        return _box_filter(torch.minimum(d_lr, d_rl), block_size)

    return _stack_over_disparities(planes, num_disparities, min_disparity, ls)


def build_cost_volume(left: torch.Tensor, right: torch.Tensor,
                      num_disparities: int, min_disparity: int = 0,
                      cost: str = "census", block_size: int = 5,
                      window: tuple[int, int] = (5, 5),
                      pre_filter_cap: int = 63,
                      dtype="float32") -> torch.Tensor:
    """Dispatch to the named cost family (census | sad | ssd | bt).

    Returns the (D, H, W) planes-layout volume. ``dtype`` (float32 or
    int16) is the census volume's; the other families are float32, as in
    the JAX package.
    """
    check_min_disparity(min_disparity)
    if cost == "census":
        return census_cost_volume(left, right, num_disparities, min_disparity,
                                  window, dtype)
    if cost in ("sad", "ssd"):
        return sad_cost_volume(left, right, num_disparities, min_disparity,
                               block_size, squared=cost == "ssd")
    if cost == "bt":
        return bt_cost_volume(left, right, num_disparities, min_disparity,
                              pre_filter_cap, block_size)
    raise ValueError(f"unknown cost family: {cost}")
