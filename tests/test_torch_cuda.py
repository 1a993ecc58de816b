"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one. On the
card (no JAX there, so without the JAX test configuration):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and its plain version take the same CUDA tensors. K1, K2 and K3
must be bit-equal (integer census arithmetic; K3 repeats the plain scan's
float operations in the same order, so even non-integer costs agree); K4
must give the same NaN mask and values within 1e-6.
"""

import numpy as np
import pytest
import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
from stereo_match_tpu_torch.utils.backend import require_hopper

pytestmark = pytest.mark.cuda

KITTI = (375, 1242)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    return require_hopper(0)


def _images(H, W, dev, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    return torch.from_numpy(imgs).to(dev)


def _assert_same_disparity(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert float((got - want).abs().nan_to_num(0.0).max()) <= 1e-6


@pytest.mark.parametrize("H,W,window", [(37, 150, (5, 5)), (24, 140, (3, 3)),
                                        (16, 130, (5, 3)), (20, 70, (3, 11)),
                                        (*KITTI, (5, 5))])
def test_census_words_kernel(dev, H, W, window):
    imgs = _images(H, W, dev)
    got = K.census_words(imgs, window)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, K.census_words_plain(imgs, window))


@pytest.mark.parametrize("H,W,D,min_d", [(36, 150, 64, 0), (24, 160, 128, 4),
                                         (20, 320, 160, 0), (*KITTI, 128, 0)])
def test_census_volume_kernel(dev, H, W, D, min_d):
    words = K.census_words(_images(H, W, dev, seed=1))
    got = K.census_volume(words[0], words[1], D, min_d)
    torch.cuda.synchronize()
    assert torch.equal(got, K.census_volume_plain(words[0], words[1], D,
                                                  min_d))


@pytest.mark.parametrize("D", [20, 64, 160])
@pytest.mark.parametrize("direction", PATH_DIRECTIONS_8)
def test_sgm_path_scan_kernel(dev, direction, D):
    """Non-integer costs and a nonzero starting total: every rounding of
    the recurrence and of the accumulation must agree."""
    rng = np.random.default_rng(2)
    cost = torch.from_numpy(rng.uniform(0, 24, (D, 37, 150)).astype(
        np.float32)).to(dev)
    start = torch.from_numpy(rng.uniform(0, 99, (D, 37, 150)).astype(
        np.float32)).to(dev)
    for accumulate in (False, True):
        got = K.sgm_path_scan(cost, start.clone(), *direction, 5.0, 40.0,
                              accumulate)
        want = K.sgm_path_scan_plain(cost, start.clone(), *direction, 5.0,
                                     40.0, accumulate)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_sgm_path_scan_kitti_totals(dev):
    words = K.census_words(_images(*KITTI, dev, seed=3))
    vol = K.census_volume(words[0], words[1], 128)
    got = K.aggregate_paths(vol, 8.0, 96.0)
    assert torch.equal(got, K.aggregate_paths(vol, 8.0, 96.0,
                                              scan=K.sgm_path_scan_plain))


@pytest.mark.parametrize("kw", [dict(), dict(min_disparity=4),
                                dict(subpixel=False),
                                dict(uniqueness_ratio=0, disp12_max_diff=-1),
                                dict(disp12_max_diff=2, uniqueness_ratio=5)])
def test_wta_lr_kernel(dev, kw):
    """Small integer costs: many ties, so many exact-.5 disparities."""
    rng = np.random.default_rng(4)
    total = torch.from_numpy(rng.integers(0, 12, (16, 20, 90)).astype(
        np.float32)).to(dev)
    args = (kw.get("min_disparity", 0), kw.get("uniqueness_ratio", 15),
            kw.get("disp12_max_diff", 1), kw.get("subpixel", True))
    disp, right = K.wta_lr(total, *args)
    want, want_right = K.wta_lr_plain(total, *args)
    torch.cuda.synchronize()
    _assert_same_disparity(disp, want)
    assert torch.equal(right, want_right)


def test_wta_lr_kitti(dev):
    words = K.census_words(_images(*KITTI, dev, seed=5))
    total = K.aggregate_paths(K.census_volume(words[0], words[1], 128),
                              8.0, 96.0)
    disp, right = K.wta_lr(total)
    want, want_right = K.wta_lr_plain(total)
    _assert_same_disparity(disp, want)
    assert torch.equal(right, want_right)


def test_main_path_on_card_matches_cpu(dev):
    rng = np.random.default_rng(6)
    left, right = rng.uniform(0, 255, (2, 48, 160)).astype(np.float32)
    cfg = DisparityConfig(num_disparities=64, uniqueness_ratio=15,
                          disp12_max_diff=1, wls=False,
                          speckle_window_size=0)
    K.reset_launches()
    raw, filtered = StereoMatcher(cfg, device=dev)(left, right)
    assert raw.is_cuda
    assert K.launches == {"census_words": 1, "census_volume": 1,
                          "sgm_path_scan": 8, "wta_lr": 1}
    want, _ = StereoMatcher(cfg, device="cpu")(left, right)
    _assert_same_disparity(raw.cpu(), want)


def test_kernels_reject_bad_cuda_inputs(dev):
    imgs = _images(8, 40, dev)
    with pytest.raises(ValueError):
        K.census_words(imgs.transpose(1, 2))
    with pytest.raises(ValueError):
        K.wta_lr(torch.zeros(4, 8, 16, device=dev).transpose(1, 2))
    with pytest.raises(ValueError):
        K.census_volume(torch.zeros(8, 16, dtype=torch.int32, device=dev),
                        torch.zeros(8, 16, dtype=torch.int32), 16)
