"""True StereoBM semantics (PyTorch): prefilter + SAD WTA, no aggregation.

Counterpart of ``stereo_match_tpu/pipeline/block_matching.py``: OpenCV's
``StereoBM`` as the reference runs it (``cv2.StereoBM_create(numDisparities,
blockSize)`` with BM's defaults): the x-Sobel prefilter clamped at
``preFilterCap=31``, plain block-SAD winner-take-all, ``textureThreshold=10``
low-texture rejection, ``uniquenessRatio=15`` and parabola subpixel.

The prefilter and the box sums are plain torch (XLA in the JAX package,
where BM has no Pallas kernel). The winner-take-all, subpixel, uniqueness
and disp12 steps run on K4 ``wta_lr``, which computes exactly
``block_match``'s function of the volume: the first argmin, the parabola
clamped to ±0.5 with the integer kept at the D-range edges, uniqueness as
``100 * second > (100 + ratio) * best`` over the costs outside idx ± 1 (the
same test as "no such cost with ``100 * cost <= (100 + ratio) * best``"),
and the disp12 check against the right-view argmin over in-frame d. The
texture and border masks follow in torch. ``BlockMatcher`` then runs the
speckle filter (K5, K6) and the WLS smoother (K7) when the config turns
them on.
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops.cost_volume import (INVALID_COST,
                                                    _shifted,
                                                    _stack_over_disparities,
                                                    _window_sums,
                                                    check_min_disparity)
from stereo_match_tpu_torch.ops.cuda_kernels import wta_lr
from stereo_match_tpu_torch.ops.speckle import speckle_filter
from stereo_match_tpu_torch.ops.wls import wls_filter_disparity
from stereo_match_tpu_torch.utils.backend import entry_device

def bm_prefilter_xsobel(image: torch.Tensor, cap: int = 31) -> torch.Tensor:
    """OpenCV ``prefilterXSobel``: clamp(sobel_x + cap, 0, 2 cap).

    The undivided 3x3 Sobel response (unlike ``sobel_x_clipped``, the
    SGBM variant); rows replicate at top and bottom, the first and last
    column take the neutral value ``cap``.
    """
    img = torch.as_tensor(image).to(torch.float32)
    p = torch.cat([img[:1], img, img[-1:]], dim=0)
    gx = (p[:-2, 2:] + 2.0 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2.0 * p[1:-1, :-2] - p[2:, :-2])
    capf = float(cap)
    core = (gx + capf).clamp(0.0, 2.0 * capf)
    edge = torch.full((img.shape[0], 1), capf, dtype=torch.float32,
                      device=img.device)
    return torch.cat([edge, core, edge], dim=1)


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Windowed SUM (zero-padded) over the trailing (H, W) axes: float32
    cumulative sums, as the JAX package's."""
    if size <= 1:
        return x
    return _window_sums(x, size, size // 2)


def sad_volume(lp: torch.Tensor, rp: torch.Tensor, num_disparities: int,
               min_disparity: int, block_size: int) -> torch.Tensor:
    """(D, H, W) block SAD sums of the prefiltered views, with
    ``INVALID_COST * block_size**2`` where x < d."""
    def planes(ds):
        return _box_sum((lp - _shifted(rp, ds)).abs(), block_size)

    return _stack_over_disparities(planes, num_disparities, min_disparity, lp,
                                   INVALID_COST * block_size * block_size)


def block_match(left: torch.Tensor, right: torch.Tensor,
                num_disparities: int, min_disparity: int = 0,
                block_size: int = 21, pre_filter_cap: int = 31,
                texture_threshold: int = 10, uniqueness_ratio: int = 15,
                disp12_max_diff: int = -1,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """StereoBM on one grayscale pair -> float32 (H, W) disparity.

    Invalid pixels (border, low texture, uniqueness or LR failure, no
    in-frame right sample) are NaN. Runs on the card (K4) unless the
    caller passes ``device="cpu"`` (K4's plain version).
    """
    check_min_disparity(min_disparity)
    dev = entry_device(device)
    lp = bm_prefilter_xsobel(torch.as_tensor(left, device=dev),
                             pre_filter_cap)
    rp = bm_prefilter_xsobel(torch.as_tensor(right, device=dev),
                             pre_filter_cap)
    H, W = lp.shape
    vol = sad_volume(lp, rp, num_disparities, min_disparity, block_size)
    disp, _ = wta_lr(vol, min_disparity, uniqueness_ratio, disp12_max_diff,
                     subpixel=True)
    del vol
    # texture: sum |prefiltered - cap| over the SAD window on the left view
    tex = _box_sum((lp - float(pre_filter_cap)).abs(), block_size)
    ok = tex >= texture_threshold
    # border: OpenCV leaves blockSize//2 rows/cols plus the left search
    # band invalid
    r = block_size // 2
    ys = torch.arange(H, device=lp.device)[:, None]
    xs = torch.arange(W, device=lp.device)[None, :]
    ok &= (ys >= r) & (ys < H - r) & (xs < W - r) & \
        (xs >= min_disparity + num_disparities + r - 1)
    return torch.where(ok, disp, torch.nan)


class BlockMatcher:
    """StereoBM with the ``StereoMatcher`` calling convention.

    >>> raw, filtered = BlockMatcher(cfg, device="cuda")(left, right)

    ``raw`` is ``block_match``'s map; ``filtered`` is it after the speckle
    filter (when ``speckle_window_size > 0``) and then the WLS smoother
    (when ``cfg.wls``), as the reference filters its BM branch. Runs on
    the card unless the caller passes ``device="cpu"``.
    """

    def __init__(self, config: DisparityConfig | None = None,
                 device: torch.device | str = "cuda"):
        self.config = config or DisparityConfig()
        check_min_disparity(self.config.min_disparity)
        self.device = entry_device(device)

    def __call__(self, left_gray, right_gray):
        cfg = self.config
        l = torch.as_tensor(left_gray, dtype=torch.float32,
                            device=self.device)
        r = torch.as_tensor(right_gray, dtype=torch.float32,
                            device=self.device)
        disp = block_match(
            l, r, num_disparities=cfg.num_disparities,
            min_disparity=cfg.min_disparity, block_size=cfg.block_size,
            pre_filter_cap=cfg.bm_pre_filter_cap,
            texture_threshold=cfg.texture_threshold,
            uniqueness_ratio=cfg.uniqueness_ratio,
            disp12_max_diff=cfg.disp12_max_diff, device=self.device)
        filtered = disp
        if cfg.speckle_window_size > 0:
            filtered = speckle_filter(disp, cfg.speckle_window_size,
                                      cfg.speckle_range)
        if cfg.wls:
            filtered = wls_filter_disparity(filtered, l, cfg.lmbda, cfg.sigma,
                                            cfg.wls_iters)
        return disp, filtered
