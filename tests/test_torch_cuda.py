"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one. On the
card (no JAX there, so without the JAX test configuration):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and its plain version take the same CUDA tensors. K1, K2 and K3
must be bit-equal (integer census arithmetic; K3 repeats the plain scan's
float operations in the same order, so even non-integer costs agree); K4
must give the same NaN mask and values within 1e-6. K5 is integer label
arithmetic and a copy, so the speckle filter must be bit-equal to its plain
version, with the same sweeps and unconverged flag, in one launch. K7
splits each line into segments and takes its pivots from a side of ones,
so it must equal that algorithm's plain model
(``fgs_solve_partitioned_plain``, the same rounded operations) bit for bit,
and against a float64 solve be off at most twice the sequential float32
solve; the whole filter likewise, and within 1e-3 px beyond the
sequential path's own float64 error of it. K8 (a tower layer; 3xTF32 on the tensor cores for C_in > 1) and K9
(the MC-CNN volume; 3xTF32 Gram band) sum in another order than cuDNN and
the plain channel sum: K8 within 1e-5 of the plain layer (cuDNN in full
float32), K9 within 1e-4 (times the product of the views' largest feature
norms where they are not unit vectors) with the 1e4 mask exactly equal,
and K3, K10 and K8 raise ValueError past their card limits (D > 1024,
F > 128); the MC-CNN matcher must agree with
its plain path on at least 99.5 % of the pixels, since a rounding
difference can flip a WTA decision. The int16 volumes (K2, K3, K4), the
transposed K2, K3's carries, K4's wta_stats, right_wta and lr_mask entries
and K10 (census-fused scan) are integer or K3-ordered float arithmetic and
must be bit-equal; so must the row-sharded exact total and the 4-stage
stream on one card against the single-card path, K1 and K2 on 2, 3 and 4
census words and K4's lr_mask at fractional tolerances. K1 (a staged tile,
4 pixels a lane) is bit-equal at the frame's edges too: one pixel, one
row, odd widths (every store alignment), windows of one row or column and
of up to 8 words, NaN pixels. K8's bfloat16 mode sums in another order
than its plain bfloat16 layer: without the norm at least 99.9 % of the
outputs are bit-equal, each within one bfloat16 ulp of the sum plus one of
the result, also on the bfloat16 channels-last tensors the module passes
between layers; the shipped towers in bfloat16 within 1e-2 of their plain
towers, and a CUDA graph of the tower equal to the eager tower. The sad, ssd and
bt volumes, StereoBM's sums and ELAS's dense stage are plain torch on both
devices, whose float32 cumulative sums may round apart, so those matchers
must agree with their CPU run on at least 99.5 % of the pixels.
"""

import numpy as np
import pytest
import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.costs import MCCNNCost
from stereo_match_tpu_torch.data.speckle_maps import (noisy_ramp,
                                                      serpentine, speckled)
from stereo_match_tpu_torch.data.synthetic import random_dot_pair, slanted_scene
from stereo_match_tpu_torch.models.mccnn import (MCCNNFeatures,
                                                 from_flax_params,
                                                 load_default_params,
                                                 mccnn_cost_volume,
                                                 normalize_image)
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import wls
from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
from stereo_match_tpu_torch.ops.speckle import speckle_filter
from stereo_match_tpu_torch.models import mccnn
from stereo_match_tpu_torch.models.optim import Adam
from stereo_match_tpu_torch.parallel import (StreamingPipeline, make_mesh,
                                             make_stage_mesh,
                                             sgm_aggregate_sharded)
from stereo_match_tpu_torch.parallel.dsharding import (make_disp_mesh,
                                                       match_dsharded,
                                                       wta_dsharded)
from stereo_match_tpu_torch.parallel.mesh import named_mesh
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher, _match_core
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


@pytest.mark.parametrize("H,W,window", [
    (1, 1, (1, 3)), (1, 2, (3, 1)), (1, 1243, (5, 5)), (5, 1241, (5, 5)),
    (6, 1243, (7, 9)), (3, 1242, (7, 9)), (20, 257, (3, 11)),
    (*KITTI, (3, 11)), (37, 150, (9, 9)), (20, 257, (15, 15)),
    (10, 150, (3, 17)), (5, 70, (1, 33)), (9, 1243, (15, 17)),
    (7, 3, (5, 5))])
def test_census_words_kernel_edges(dev, H, W, window):
    """K1's staged tile at the frame's edges: one pixel, one row, widths
    one off the 128-column tile, odd widths (rows at every 16-byte
    alignment, so 16-, 8- and 4-byte stores and scalar row ends), windows
    of one row or one column, of 33 pixels (bit 31 set), of 3, 7 and 8
    words and wider than a 16-column pass; small integer levels (equal
    neighbours) and NaN pixels. One launch, bit-equal."""
    rng = np.random.default_rng(H + W)
    imgs = rng.integers(0, 8, (2, H, W)).astype(np.float32)
    imgs[rng.random((2, H, W)) < 0.02] = np.nan
    imgs = torch.from_numpy(imgs).to(dev)
    K.reset_launches()
    got = K.census_words(imgs, window)
    assert K.launches["census_words"] == 1
    want = K.census_words_plain(imgs, window)
    torch.cuda.synchronize()
    assert got.shape == (2, K.n_census_words(window), H, W)
    assert torch.equal(got, want)


def test_census_words_kernel_rejects_a_window_past_shared_memory(dev):
    imgs = _images(8, 40, dev)
    K.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        K.census_words(imgs, (177, 177))
    assert K.launches["census_words"] == 0
    got = K.census_words(imgs, (175, 3))
    assert torch.equal(got, K.census_words_plain(imgs, (175, 3)))


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


def _scan_inputs(D, H, W, dtype, dev, seed):
    """Costs and a starting total: non-integer float32 costs, or int16
    census-range costs (the int16 sums stay far below 2^15)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int16:
        cost = rng.integers(0, 61, (D, H, W)).astype(np.int16)
        start = rng.integers(0, 999, (D, H, W)).astype(np.int16)
    else:
        cost = rng.uniform(0, 24, (D, H, W)).astype(np.float32)
        start = rng.uniform(0, 99, (D, H, W)).astype(np.float32)
    return torch.from_numpy(cost).to(dev), torch.from_numpy(start).to(dev)


@pytest.mark.parametrize("H,W", [(37, 150), (83, 29)])
@pytest.mark.parametrize("D", [16, 48, 128, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("direction", PATH_DIRECTIONS_8)
def test_sgm_path_scan_warp_lines(dev, direction, dtype, D, H, W):
    """The warp-per-line K3: D not a multiple of 32 (16, 48, 160: idle
    lanes hold big), W not a multiple of 8 or 32, W > H and H > W (the
    diagonal strips enter from the side and leave on the other)."""
    cost, start = _scan_inputs(D, H, W, dtype, dev, seed=D + H)
    for accumulate in (False, True):
        got = K.sgm_path_scan(cost, start.clone(), *direction, 8 / 3, 40.0,
                              accumulate)
        want = K.sgm_path_scan_plain(cost, start.clone(), *direction, 8 / 3,
                                     40.0, accumulate)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("D", [300, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("direction", [(0, 1), (1, 0), (-1, 1)])
def test_sgm_path_scan_deep_disparities(dev, direction, dtype, D):
    """Up to 1024 disparities: 10 or 32 registers a lane, the shallowest
    ring of staged steps."""
    cost, start = _scan_inputs(D, 21, 45, dtype, dev, seed=D)
    got = K.sgm_path_scan(cost, start.clone(), *direction, 5.0, 40.0, True)
    want = K.sgm_path_scan_plain(cost, start.clone(), *direction, 5.0, 40.0,
                                 True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("direction", PATH_DIRECTIONS_8)
def test_sgm_path_scan_int16_views_off_a_word(dev, direction):
    """int16 cost and total views starting 2 bytes past a 4-byte boundary:
    K3 stages whole words, so it shifts its segments by the element."""
    D, H, W = 32, 19, 47
    cost, start = _scan_inputs(D, H, W, torch.int16, dev, seed=5)
    n = D * H * W
    cbuf = torch.zeros(n + 1, dtype=torch.int16, device=dev)
    tbuf = torch.zeros(n + 3, dtype=torch.int16, device=dev)
    cv = cbuf[1:].view(D, H, W)
    tv = tbuf[1:n + 1].view(D, H, W)
    cv.copy_(cost)
    tv.copy_(start)
    got = K.sgm_path_scan(cv, tv, *direction, 8.0, 32.0, True)
    want = K.sgm_path_scan_plain(cost, start.clone(), *direction, 8.0, 32.0,
                                 True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(tbuf[0]) == 0 and not tbuf[n + 1:].any()   # nothing around


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
    assert K.launches == {**{name: 0 for name in K.launches},
                          "census_words": 1, "census_volume": 1,
                          "sgm_path_scan": 8, "wta_lr": 1}
    want, _ = StereoMatcher(cfg, device="cpu")(left, right)
    _assert_same_disparity(raw.cpu(), want)


def test_entry_spans_hold_their_launches_and_count_uploads(dev, tmp_path):
    """On the card the entry counts the float32 bytes it copies from host
    memory (none for tensors already there), and each kernel's launch (the
    runtime call of its correlation id) lies in its layer's span alone:
    the spans share the device trace's clock."""
    import json
    from torch.profiler import ProfilerActivity, profile

    from stereo_match_tpu_torch.utils import profiling
    rng = np.random.default_rng(8)
    left, right = rng.integers(0, 256, (2, 48, 160)).astype(np.uint8)
    cfg = DisparityConfig(num_disparities=64, wls=False,
                          speckle_window_size=0)
    matcher = StereoMatcher(cfg, device=dev)
    matcher(left, right)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        matcher(left, right)
        torch.cuda.synchronize()
    nbytes = 2 * 48 * 160 * 4       # both views, cast to float32 on the host
    assert profiling.counters == {"frames": 1, "upload_bytes": nbytes}
    matcher(torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev))
    assert profiling.counters["upload_bytes"] == nbytes
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("smt.")]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    layer_of = {"census_words": "smt.cost", "census_volume": "smt.cost",
                "sgm_path_scan": "smt.sgm", "wta_walk": "smt.wta"}
    seen = {}
    for k in (e for e in events if e.get("cat") == "kernel"):
        want = [v for n, v in layer_of.items() if n in k["name"]]
        if not want:
            continue
        c = calls[k["args"]["correlation"]]
        inside = [s["name"] for s in spans if s["ts"] <= c["ts"]
                  and c["ts"] + c["dur"] <= s["ts"] + s["dur"]]
        assert inside == want, (k["name"], inside)
        seen[want[0]] = seen.get(want[0], 0) + 1
    assert seen == {"smt.cost": 2, "smt.sgm": 8, "smt.wta": 1}
    profiling.reset()


def test_card_limits_raise_and_name_the_limit(dev):
    """D > 1024 in K3 and K10 and F > 128 in K8 raise ValueError on the
    card (the CPU takes both, tests/test_torch_limits.py)."""
    K.reset_launches()
    cost = torch.zeros(1040, 3, 20, device=dev)
    with pytest.raises(ValueError, match="1024"):
        K.sgm_path_scan(cost, torch.empty_like(cost), 0, 1, 8.0, 96.0, False)
    words = torch.zeros(3, 20, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="1024"):
        K.census_scan(words, words, cost, 0, 8.0, 96.0)
    x = torch.zeros(2, 1, 6, 9, device=dev)
    with pytest.raises(ValueError, match="128"):
        K.mccnn_conv3x3(x, torch.zeros(130, 1, 3, 3, device=dev),
                        torch.zeros(130, device=dev), True, False)
    wide = MCCNNFeatures(features=160, num_layers=2).to(dev)
    with pytest.raises(ValueError, match="128"):
        wide(torch.zeros(2, 6, 9, device=dev))
    assert sum(K.launches.values()) == 0


def test_kernels_reject_bad_cuda_inputs(dev):
    imgs = _images(8, 40, dev)
    with pytest.raises(ValueError):
        K.census_words(imgs.transpose(1, 2))
    with pytest.raises(ValueError):
        K.wta_lr(torch.zeros(4, 8, 16, device=dev).transpose(1, 2))
    with pytest.raises(ValueError):
        K.census_volume(torch.zeros(8, 16, dtype=torch.int32, device=dev),
                        torch.zeros(8, 16, dtype=torch.int32), 16)


# ----------------------------------------------------------- K5 speckle ----

def _speckled_map(H, W, dev, seed=7):
    return torch.from_numpy(noisy_ramp(H, W, seed)).to(dev)


def _plane_map(H, W, d_max, dev):
    """A slanted plane with 5 % holes and a 2x2 or 4x4 outlier blob for
    every 800 pixels: it converges in tens of sweeps."""
    gt = torch.from_numpy(slanted_scene(H, W, 5.0, d_max))
    holes = np.random.default_rng(H).uniform(size=(H, W)) < 0.05
    gt[torch.from_numpy(holes)] = float("nan")
    return speckled(gt, seed=H, blobs=H * W // 800).to(dev)


def _assert_bit_equal_maps(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


def _speckle_kernel_vs_plain(d, T, max_diff, max_iters=64):
    """One launch, and the map, sweeps and unconverged flag of the plain
    filter bit for bit; returns (sweeps, unconverged)."""
    K.reset_launches()
    got, stats = K.speckle_filter(d, T, max_diff, max_iters)
    assert K.launches["speckle_filter"] == 1
    assert sum(K.launches.values()) == 1
    want, sweeps, unconverged = K.speckle_fixpoint_plain(d, T, max_diff,
                                                         max_iters)
    _assert_bit_equal_maps(got, want)
    assert got.device == d.device
    assert stats.tolist() == [sweeps, int(unconverged)]
    return sweeps, unconverged


@pytest.mark.parametrize("H,W,T,max_diff", [(37, 150, 10, 1.0),
                                            (64, 33, 30, 2.0),
                                            (1, 200, 5, 2.0),
                                            (120, 1, 5, 2.0),
                                            (*KITTI, 100, 2.0),
                                            (720, 1280, 100, 2.0),
                                            (1700, 96, 20, 2.0)])
def test_speckle_filter_kernel(dev, H, W, T, max_diff):
    """Noisy ramps up to 720p and, at 1700 rows, columns scanned in two
    bands. They need tens of sweeps; the 720p one is still lowering labels
    at sweep 64, so there every valid pixel stays and the sizes are
    checked by test_speckle_filter_kernel_converged."""
    d = _speckled_map(H, W, dev)
    sweeps, unconverged = _speckle_kernel_vs_plain(d, T, max_diff)
    assert sweeps >= 1 and unconverged == (sweeps == 64)
    K.reset_launches()
    _assert_bit_equal_maps(speckle_filter(d, T, max_diff),
                           K.speckle_fixpoint_plain(d, T, max_diff, 64)[0])
    assert K.launches["speckle_filter"] == 1


@pytest.mark.parametrize("H,W,d_max", [(*KITTI, 90.0), (720, 1280, 110.0),
                                       (1700, 96, 40.0)])
def test_speckle_filter_kernel_converged(dev, H, W, d_max):
    """Maps that converge, up to 720p and over two column bands: the
    component sizes and the threshold decide, so the blobs go and the
    plane stays."""
    d = _plane_map(H, W, d_max, dev)
    sweeps, unconverged = _speckle_kernel_vs_plain(d, 100, 2.0)
    assert sweeps >= 2 and not unconverged
    out, _ = K.speckle_filter(d, 100, 2.0)
    valid = int(torch.isfinite(d).sum())
    removed = int((torch.isfinite(d) & torch.isnan(out)).sum())
    assert 0 < removed < 0.05 * valid


@pytest.mark.parametrize("case", ["all_nan", "one_pixel", "infinities",
                                  "ties", "inf_max_diff", "no_sweeps"])
def test_speckle_filter_kernel_edges(dev, case):
    rng = np.random.default_rng(11)
    d = _speckled_map(48, 96, dev, seed=3)
    max_diff, max_iters = 2.0, 64
    if case == "all_nan":
        d = torch.full((9, 40), float("nan"), device=dev)
    elif case == "one_pixel":
        d = torch.full((1, 1), 3.0, device=dev)
    elif case == "infinities":
        d[torch.from_numpy(rng.uniform(size=d.shape) < 0.1).to(dev)] = \
            float("inf")
        d[torch.from_numpy(rng.uniform(size=d.shape) < 0.1).to(dev)] = \
            -float("inf")
    elif case == "ties":                 # neighbours exactly max_diff apart
        d = torch.from_numpy((rng.integers(0, 4, (48, 96)) * 0.5 + 10).astype(
            np.float32)).to(dev)
        max_diff = 0.5
    elif case == "inf_max_diff":         # invalid pixels take labels
        max_diff = float("inf")
    else:
        max_iters = 0                    # no sweep: keep every valid pixel
    for T in (1, 3, 12):
        sweeps, unconverged = _speckle_kernel_vs_plain(d, T, max_diff,
                                                       max_iters)
        assert (sweeps, unconverged) == ((0, True) if max_iters == 0 else
                                         (sweeps, False))


@pytest.mark.parametrize("H,W,transpose", [(16, 33, False),
                                            (75, 1242, False),
                                            (16, 1700, True)])
def test_speckle_filter_serpentine_cap(dev, H, W, transpose):
    """The serpentine converges after k sweeps: at max_iters = k it is one
    component and T removes it; at k - 1 every pixel stays. Transposed, its
    columns run over two bands."""
    d = torch.from_numpy(serpentine(H, W)).to(dev)
    if transpose:
        d = d.T.contiguous()
    k, unconverged = _speckle_kernel_vs_plain(d, 10 ** 6, 1.0)
    assert k >= 3 and not unconverged
    assert _speckle_kernel_vs_plain(d, 10 ** 6, 1.0, k) == (k, False)
    assert _speckle_kernel_vs_plain(d, 10 ** 6, 1.0, k - 1) == (k - 1, True)
    kept, _ = K.speckle_filter(d, 10 ** 6, 1.0, k - 1)
    assert torch.equal(torch.isfinite(kept), torch.isfinite(d))
    assert torch.isnan(K.speckle_filter(d, 10 ** 6, 1.0, k)[0]).all()


def test_speckle_filter_in_a_cuda_graph(dev):
    """With no host read, the filter can be captured in a CUDA graph;
    each replay recomputes it from the input."""
    d = _speckled_map(*KITTI, dev, seed=5)
    K.speckle_filter(d, 100, 2.0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, stats = K.speckle_filter(d, 100, 2.0)
    for seed in (5, 6):
        d.copy_(_speckled_map(*KITTI, dev, seed=seed))
        graph.replay()
        want, sweeps, unconverged = K.speckle_fixpoint_plain(d, 100, 2.0)
        _assert_bit_equal_maps(got, want)
        assert stats.tolist() == [sweeps, int(unconverged)]


def test_speckle_filter_makes_no_host_sync(dev):
    d = _speckled_map(*KITTI, dev, seed=9)
    want = speckle_filter(d, 100, 2.0)      # builds and sizes the grid
    torch.cuda.synchronize()
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = speckle_filter(d, 100, 2.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert K.launches["speckle_filter"] == 1
    _assert_bit_equal_maps(got, want)


# -------------------------------------------------------------- K7 WLS ----

def _solve64(f, wp, wn, lam, axis):
    return K.fgs_solve_plain(f.double(), wp.double(), wn.double(), lam, axis)


def _max_err(u, ref):
    return float((u.double() - ref.double()).abs().max())


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("H,W", [KITTI, (720, 1280), (37, 149), (1, 7),
                                 (5, 1), (2, 33)])
@pytest.mark.parametrize("axis", [0, 1])
def test_fgs_solve_kernel(dev, C, H, W, axis):
    """Rows (axis 1) and columns (axis 0) of the slab as it lies: equal to
    the partitioned model, and against float64 within twice the
    sequential float32 solve's error."""
    rng = np.random.default_rng(8)
    f = torch.from_numpy(rng.uniform(0, 60, (C, H, W)).astype(np.float32))
    guide = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    f, guide = f.to(dev), guide.to(dev)
    wp, wn = wls._scan_weights(wls._edge_weights(guide, axis, 8.0), axis)
    for lam in wls._lambda_schedule(80000.0, 3):
        got = K.fgs_solve(f, wp, wn, lam, axis)
        torch.cuda.synchronize()
        assert torch.equal(got, K.fgs_solve_partitioned_plain(f, wp, wn, lam,
                                                              axis))
        u64 = _solve64(f, wp, wn, lam, axis)
        plain = _max_err(K.fgs_solve_plain(f, wp, wn, lam, axis), u64)
        assert _max_err(got, u64) <= 2 * plain


def test_wls_filter_on_card_matches_plain(dev):
    d = _speckled_map(*KITTI, dev, seed=9)
    guide = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, KITTI).astype(np.float32)).to(dev)
    K.reset_launches()
    got = wls.wls_filter_disparity(d, guide, 80000.0, 1.2, 3)
    assert K.launches["fgs_solve"] == 6
    assert torch.equal(got, wls.wls_filter_disparity(
        d, guide, 80000.0, 1.2, 3, solve=K.fgs_solve_partitioned_plain))
    plain = wls.wls_filter_disparity(d, guide, 80000.0, 1.2, 3,
                                     solve=K.fgs_solve_plain)
    f64 = wls.wls_filter_disparity(d, guide, 80000.0, 1.2, 3, solve=_solve64)
    e_plain = _max_err(plain, f64)
    assert torch.isfinite(got).all()
    assert _max_err(got, f64) <= 2 * e_plain
    assert _max_err(got, plain) <= 1e-3 + e_plain


@pytest.mark.parametrize("kw", [dict(), dict(speckle_window_size=100,
                                             num_disparities=64),
                                dict(speckle_window_size=100,
                                     num_disparities=64,
                                     wls_lr_confidence=True)])
def test_post_stack_on_card_matches_cpu(dev, kw):
    """Small size, so the CPU run stays short. Filtered maps within the
    smoother's bound (the card's and the CPU's exp round the guide weights
    differently, by an ulp, and the lambda ladder amplifies it)."""
    gt = slanted_scene(40, 192, 4.0, 30.0)
    left, right = random_dot_pair(40, 192, gt, blur=1.0, seed=10)
    cfg = DisparityConfig(**kw)
    K.reset_launches()
    raw, filtered = StereoMatcher(cfg, device=dev)(left, right)
    counts = dict(K.launches)
    assert counts["fgs_solve"] == 2 * cfg.wls_iters
    if cfg.speckle_window_size > 0:
        assert counts["speckle_filter"] == 1
    want_raw, want_filtered = StereoMatcher(cfg, device="cpu")(left, right)
    _assert_same_disparity(raw.cpu(), want_raw)
    assert torch.isfinite(filtered).all()
    torch.testing.assert_close(filtered.cpu(), want_filtered, rtol=1e-3,
                               atol=2e-4)


# ------------------------------------------------------- K8, K9 MC-CNN ----

@pytest.mark.parametrize("H,W", [(17, 129), (33, 70), KITTI])
@pytest.mark.parametrize("relu,normalize", [(True, False), (False, True),
                                            (False, False)])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("F", [32, 64, 112, 128])
def test_mccnn_conv3x3_kernel(dev, F, first, relu, normalize, H, W):
    """C_in = 1 (the first layer, FP32 body) and C_in = F (3xTF32 tensor
    cores), unit-scale activations; the norm of the last layer."""
    rng = np.random.default_rng(F + H)
    C_in = 1 if first else F
    x = rng.normal(size=(2, C_in, H, W)).astype(np.float32)
    w = (rng.normal(size=(F, C_in, 3, 3)) / np.sqrt(9 * C_in)).astype(
        np.float32)
    b = rng.normal(0, 0.1, F).astype(np.float32)
    x, w, b = (torch.from_numpy(a).to(dev) for a in (x, w, b))
    got = K.mccnn_conv3x3(x, w, b, relu, normalize)
    want = K.mccnn_conv3x3_plain(x, w, b, relu, normalize)
    torch.cuda.synchronize()
    assert got.shape == (2, F, H, W)
    assert float((got - want).abs().max()) <= 1e-5


def _bf16_ulp(v):
    """The spacing of bfloat16 values at |v| (0 at 0)."""
    _, e = torch.frexp(v.abs())
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.ldexp(torch.ones_like(v), e - 8))


@pytest.mark.parametrize("H,W", [(33, 131), (19, 1243)])
@pytest.mark.parametrize("relu,normalize", [(True, False), (False, True),
                                            (False, False)])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("F", [7, 64, 112, 128])
def test_mccnn_conv3x3_bf16_kernel(dev, F, first, relu, normalize, H, W):
    """K8's bfloat16 mode against the plain bfloat16 layer (cuDNN in full
    float32 on the rounded operands) on the same input, which is not
    bfloat16-exact, so both round it. Only the order of the float32 sums
    differs, which flips a rounding where a sum lies on a boundary: without
    the norm at least 99.9 % of the outputs are bit-equal and each is
    within one bfloat16 ulp of the sum before the bias plus one of the
    result (a flip of the sum survives a bias that cancels it); with the
    norm, each pixel's sum of squares is added in another order too, so no
    bit-equality, and each output is within those ulps over the pixel's
    norm plus 1e-6."""
    rng = np.random.default_rng(F + H + 7)
    C_in = 1 if first else F
    x = rng.normal(size=(2, C_in, H, W)).astype(np.float32)
    w = (rng.normal(size=(F, C_in, 3, 3)) / np.sqrt(9 * C_in)).astype(
        np.float32)
    b = rng.normal(0, 0.1, F).astype(np.float32)
    x, w, b = (torch.from_numpy(a).to(dev) for a in (x, w, b))
    K.reset_launches()
    got = K.mccnn_conv3x3(x, w, b, relu, normalize, bf16=True)
    assert K.launches["mccnn_conv3x3"] == 1
    want = K.mccnn_conv3x3_plain(x, w, b, relu, normalize, bf16=True)
    with K.fp32_cudnn():
        pre = torch.nn.functional.conv2d(K.bf16_round(x), K.bf16_round(w),
                                         padding=1)
    raw = K.mccnn_conv3x3_plain(x, w, b, False, False, bf16=True)
    torch.cuda.synchronize()
    assert got.shape == (2, F, H, W)
    tol = _bf16_ulp(pre) + _bf16_ulp(raw)
    diff = (got - want).abs()
    if normalize:
        norm = torch.sqrt((raw * raw).sum(1, keepdim=True) + 1e-12)
        assert bool((diff <= tol / norm + 1e-6).all())
    else:
        assert float((got == want).float().mean()) >= 0.999
        assert bool((diff <= tol).all())
    f32 = K.mccnn_conv3x3_plain(x, w, b, relu, normalize)
    assert not torch.equal(want, f32)      # the mode did round


@pytest.mark.parametrize("arch", ["fast", "accurate"])
def test_mccnn_bf16_tower_on_card_matches_plain(dev, arch):
    """The shipped towers with compute_dtype bfloat16: K8's bfloat16 mode a
    layer against the plain bfloat16 layers, within JAX's bfloat16
    contract of 1e-2 on the unit features; one K8 launch a layer."""
    model = from_flax_params(load_default_params(arch), arch,
                             torch.bfloat16).to(dev)
    gt = slanted_scene(64, 257, 4.0, 40.0)
    left, right = random_dot_pair(64, 257, gt, blur=1.0, seed=12)
    imgs = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                        for im in (left, right)])
    K.reset_launches()
    got = model(imgs)
    assert K.launches["mccnn_conv3x3"] == model.num_layers
    h = imgs[:, None]
    for i in range(model.num_layers):
        last = i == model.num_layers - 1
        h = K.mccnn_conv3x3_plain(h, model.weights[i], model.biases[i],
                                  not last, last, bf16=True)
    torch.cuda.synchronize()
    err = float((got - h).abs().max())
    print(f"MC-CNN {arch} bfloat16 tower on the card: max |kernel - plain| "
          f"= {err}")
    assert err <= 1e-2


def test_mccnn_use_bf16_twin_on_card(dev):
    """``use_bf16=True`` on a float32 model runs its ``bf16_twin`` on K8's
    bfloat16 mode: the bfloat16 model's volume bit for bit, one K8 launch a
    layer; the twin is made once, and anew after the model moves device."""
    params = load_default_params("fast")
    model = from_flax_params(params, "fast")
    cpu_twin = model.bf16_twin()
    model.to(dev)
    model16 = from_flax_params(params, "fast", torch.bfloat16).to(dev)
    gt = slanted_scene(40, 203, 4.0, 30.0)
    left, right = (torch.from_numpy(im).to(dev)
                   for im in random_dot_pair(40, 203, gt, blur=1.0, seed=4))
    want = mccnn_cost_volume(model16, left, right, 48)
    K.reset_launches()
    got = mccnn_cost_volume(model, left, right, 48, use_bf16=True)
    torch.cuda.synchronize()
    assert K.launches["mccnn_conv3x3"] == model.num_layers
    assert torch.equal(got, want)
    twin = model.bf16_twin()
    assert twin is not cpu_twin and twin.layout1.device == want.device
    assert model.bf16_twin() is twin


def _bf16_layer_check(got, want, pre, raw, normalize):
    """K8 bf16 against its plain layer: the bounds of
    ``test_mccnn_conv3x3_bf16_kernel``."""
    fmt = torch.channels_last if got.dtype == torch.bfloat16 else \
        torch.contiguous_format
    assert got.dtype == want.dtype and got.is_contiguous(memory_format=fmt)
    tol = _bf16_ulp(pre) + _bf16_ulp(raw)
    diff = (got.float() - want.float()).abs()
    if normalize:
        norm = torch.sqrt((raw * raw).sum(1, keepdim=True) + 1e-12)
        assert bool((diff <= tol / norm + 1e-6).all())
    else:
        assert float((got == want).float().mean()) >= 0.999
        assert bool((diff <= tol).all())


def _bf16_layer_inputs(dev, V, F, C_in, H, W, seed):
    """x as the module passes it (the float32 image for C_in = 1, bfloat16
    channels-last else), weights, bias, and the operands' float32 sums
    before the bias (``pre``) and the plain layer's raw output."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(V, C_in, H, W)).astype(
        np.float32)).to(dev)
    if C_in > 1:
        x = x.to(torch.bfloat16, memory_format=torch.channels_last)
    w = torch.from_numpy((rng.normal(size=(F, C_in, 3, 3)) /
                          np.sqrt(9 * C_in)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0, 0.1, F).astype(np.float32)).to(dev)
    with K.fp32_cudnn():
        pre = torch.nn.functional.conv2d(K.bf16_round(x.float()),
                                         K.bf16_round(w), padding=1)
    raw = K.mccnn_conv3x3_plain(x, w, b, False, False, bf16=True)
    return x, w, b, pre, raw


@pytest.mark.parametrize("V,H,W", [(1, 1, 1), (2, 7, 1242), (2, 375, 7),
                                   (1, 375, 1242)])
@pytest.mark.parametrize("C_in", [1, 16, 64, 112])
@pytest.mark.parametrize("F", [16, 32, 64, 112, 128])
def test_mccnn_conv3x3_bf16_channels_last(dev, F, C_in, V, H, W):
    """A layer before the last as the module runs it: bfloat16
    channels-last in (C_in > 1) and out, against the plain layer on the
    same tensors within the bounds of ``test_mccnn_conv3x3_bf16_kernel``;
    one launch."""
    x, w, b, pre, raw = _bf16_layer_inputs(dev, V, F, C_in, H, W,
                                           F + C_in + H)
    K.reset_launches()
    got = K.mccnn_conv3x3(x, w, b, True, False, bf16=True, bf16_out=True)
    assert K.launches["mccnn_conv3x3"] == 1
    want = K.mccnn_conv3x3_plain(x, w, b, True, False, bf16=True,
                                 bf16_out=True)
    torch.cuda.synchronize()
    assert got.shape == (V, F, H, W) and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    _bf16_layer_check(got, want, pre, raw, False)


@pytest.mark.parametrize("H,W", [(1, 1), (7, 1242), KITTI])
@pytest.mark.parametrize("F", [16, 64, 112, 128])
def test_mccnn_conv3x3_bf16_last_layer(dev, F, H, W):
    """The last layer: bfloat16 channels-last in, the float32 norm out as
    (V, F, H, W), within the bounds of ``test_mccnn_conv3x3_bf16_kernel``."""
    x, w, b, pre, raw = _bf16_layer_inputs(dev, 2, F, F, H, W, F + W)
    got = K.mccnn_conv3x3(x, w, b, False, True, bf16=True)
    want = K.mccnn_conv3x3_plain(x, w, b, False, True, bf16=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.is_contiguous()
    _bf16_layer_check(got, want, pre, raw, True)


@pytest.mark.parametrize("arch", ["fast", "accurate"])
def test_mccnn_bf16_tower_at_kitti(dev, arch):
    """The shipped towers in bfloat16 at KITTI on the card (bfloat16
    channels-last between layers) within 1e-2 of the plain bfloat16
    tower; float32 (V, F, H, W) features; one launch a layer."""
    model = from_flax_params(load_default_params(arch), arch,
                             torch.bfloat16).to(dev)
    gt = slanted_scene(*KITTI, 5.0, 90.0)
    left, right = random_dot_pair(*KITTI, gt, blur=1.0, seed=1)
    imgs = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                        for im in (left, right)])
    K.reset_launches()
    got = model(imgs)
    assert K.launches["mccnn_conv3x3"] == model.num_layers
    h = imgs[:, None]
    for i in range(model.num_layers):
        last = i == model.num_layers - 1
        h = K.mccnn_conv3x3_plain(h, model.weights[i], model.biases[i],
                                  not last, last, bf16=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert float((got - h).abs().max()) <= 1e-2


def test_mccnn_bf16_tower_in_a_cuda_graph(dev):
    """The bfloat16 tower captured in a CUDA graph: a replay gives the
    eager features bit for bit."""
    model = from_flax_params(load_default_params("fast"), "fast",
                             torch.bfloat16).to(dev)
    gt = slanted_scene(64, 257, 4.0, 40.0)
    left, right = random_dot_pair(64, 257, gt, blur=1.0, seed=12)
    imgs = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                        for im in (left, right)])
    want = model(imgs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = model(imgs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_mccnn_bf16_card_limit(dev):
    """F > 128 raises in the bfloat16 mode too, before any launch."""
    K.reset_launches()
    x = torch.zeros(2, 130, 6, 9, device=dev)
    with pytest.raises(ValueError, match="128"):
        K.mccnn_conv3x3(x, torch.zeros(130, 130, 3, 3, device=dev),
                        torch.zeros(130, device=dev), True, False, bf16=True)
    wide = MCCNNFeatures(features=160, num_layers=2,
                         compute_dtype=torch.bfloat16).to(dev)
    with pytest.raises(ValueError, match="128"):
        wide(torch.zeros(2, 6, 9, device=dev))
    assert sum(K.launches.values()) == 0


@pytest.mark.parametrize("F,H,W,D,min_d,norm", [
    (64, 20, 150, 32, 0, 1), (64, 20, 150, 32, 4, 1),
    (64, 24, 300, 128, 0, 1), (64, 24, 300, 128, 7, 1),
    (64, 16, 330, 160, 0, 1), (64, 16, 330, 160, 4, 1),
    (64, 12, 100, 160, 7, 1), (64, *KITTI, 128, 0, 1),
    (1, 17, 129, 33, 5, 1), (7, 21, 77, 96, 0, 1), (100, 23, 301, 96, 5, 1),
    (100, 377, 1243, 96, 3, 1), (112, *KITTI, 128, 0, 1),
    (128, 19, 257, 160, 0, 1), (200, 15, 333, 33, 5, 1),
    (200, 11, 1001, 400, 3, 1), (64, 9, 1100, 1040, 0, 1),
    (64, 13, 97, 1, 0, 1), (64, 13, 97, 1, 5, 1), (112, 31, 515, 160, 5, 4)])
def test_mccnn_volume_kernel(dev, F, H, W, D, min_d, norm):
    """Features of unit norm, or (norm=4) of norms drawn from [1/4, 4];
    D not a multiple of the kernel's plane chunk (33, 96, 160, and 400 and
    1040 in several chunks), W < D (whole rows of the planes invalid), odd
    H and W. The 1e4 mask must be equal; the values within 1e-4 times the
    largest product of the two views' norms (1 for unit features: a dot
    product's rounding error grows with sum |fl * fr| <= |fl| |fr|)."""
    rng = np.random.default_rng(F + D + min_d)
    f = rng.normal(size=(2, F, H, W))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    if norm != 1:
        f *= np.exp(rng.uniform(-np.log(norm), np.log(norm), (2, 1, H, W)))
    fl, fr = torch.from_numpy(f.astype(np.float32)).to(dev)
    tol = 1e-4 * float(fl.norm(dim=0).max() * fr.norm(dim=0).max())
    K.reset_launches()
    got = K.mccnn_volume(fl, fr, D, min_d)
    assert K.launches["mccnn_volume"] == 1
    assert sum(K.launches.values()) == 1
    want = K.mccnn_volume_plain(fl, fr, D, min_d)
    torch.cuda.synchronize()
    assert got.shape == (D, H, W)
    assert torch.equal(got == 1e4, want == 1e4)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("arch", ["fast", "accurate"])
def test_mccnn_matcher_on_card_matches_plain(dev, arch):
    gt = slanted_scene(64, 256, 4.0, 40.0)
    left, right = random_dot_pair(64, 256, gt, blur=1.0, seed=11)
    cfg = DisparityConfig(num_disparities=64, cost="mccnn",
                          uniqueness_ratio=15, disp12_max_diff=1, wls=False,
                          speckle_window_size=0)
    model = from_flax_params(load_default_params(arch), arch)
    K.reset_launches()
    raw, _ = StereoMatcher(cfg, cost_fn=MCCNNCost(model.to(dev), cfg),
                           device=dev)(left, right)
    assert raw.is_cuda
    assert K.launches["mccnn_conv3x3"] == model.num_layers
    assert K.launches["mccnn_volume"] == 1
    assert K.launches["census_words"] == K.launches["census_volume"] == 0
    imgs = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                        for im in (left, right)])[:, None]
    for i in range(model.num_layers):
        last = i == model.num_layers - 1
        imgs = K.mccnn_conv3x3_plain(imgs, model.weights[i], model.biases[i],
                                     not last, last)
    vol = K.mccnn_volume_plain(imgs[0], imgs[1], 64)
    total = K.aggregate_paths(vol, cfg.P1, cfg.P2, 8, K.sgm_path_scan_plain)
    want = K.wta_lr_plain(total, 0, 15, 1)[0]
    same_nan = torch.isnan(raw) == torch.isnan(want)
    close = (raw - want).abs().nan_to_num(0.0) <= 0.01
    share = float((same_nan & (close | torch.isnan(raw) |
                               torch.isnan(want))).float().mean())
    print(f"MC-CNN {arch} on the card: {share} of the pixels agree with "
          "the plain path")
    assert share >= 0.995


# ---------------------------------------------------------------- K11 ----

def _bf16_ulp(v):
    _, e = torch.frexp(v.abs())
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.ldexp(torch.ones_like(v), e - 8))


def _band_sums(pairs, D):
    """(D, H, W): for each plane d, the sum over the (a, b) pairs of
    sum_f a[f, y, x] b[f, y, x - d] where x >= d (0 elsewhere)."""
    F, H, W = pairs[0][0].shape
    out = torch.zeros((D, H, W), device=pairs[0][0].device)
    for d in range(min(D, W)):
        for a, b in pairs:
            out[d, :, d:] += (a[:, :, d:] * b[:, :, :W - d]).sum(0)
    return out


def _k11_check(model, imgs, D, what, scale=24.0):
    """K11 on the last layer's input of ``model``'s tower against K8's
    last launch then K9 and against its plain version, each cell within
    its bar (the module docstring; ``chip_smoke.py``'s ``k11_check``);
    returns the bit-equal share."""
    bf16 = model.compute_dtype == torch.bfloat16
    i = model.num_layers - 1
    x, w, b = model.hidden(imgs), model.weights[i], model.biases[i]
    layout = getattr(model, f"layout{i}")
    # K11's input as the one-kernel path hands it (K8's launch before the
    # last writes it channels-last) and K11's copy of the weights
    x_cl = model.hidden(imgs, channels_last=True)
    assert torch.equal(x_cl, x)
    assert x_cl.is_contiguous(memory_format=torch.channels_last)
    K.reset_launches()
    got = K.mccnn_fused_volume(x_cl, w, b, D, scale, model.layout_fused, bf16)
    torch.cuda.synchronize()
    assert K.launches["mccnn_fused_volume"] == 1
    # K8's copy of the weights and an NCHW input give the same volume
    assert torch.equal(K.mccnn_fused_volume(x, w, b, D, scale, layout, bf16),
                       got)
    f = K.mccnn_conv3x3(x, w, b, False, True, layout=layout, bf16=bf16)
    two = K.mccnn_volume(f[0], f[1], D, 0, scale)
    p = K.mccnn_conv3x3_plain(x, w, b, False, True, bf16)
    want = K.mccnn_volume_plain(p[0], p[1], D, 0, scale)
    bar_two = torch.full_like(got, 1e-4)
    if bf16:
        with K.fp32_cudnn():
            pre = torch.nn.functional.conv2d(K.bf16_round(x.float()),
                                             K.bf16_round(w), padding=1)
        raw = K.mccnn_conv3x3_plain(x, w, b, False, False, bf16=True)
        u = 2 * ((_bf16_ulp(pre) + _bf16_ulp(raw)) / torch.sqrt(
            (raw * raw).sum(1, keepdim=True) + 1e-12) + 1e-6)
        bar_two += scale / 2 * _band_sums(
            [(u[0], f[1].abs()), (f[0].abs(), u[1]), (u[0], u[1])], D)
    e = (f - p).abs()
    bar_plain = bar_two + 1e-4 + scale / 2 * _band_sums(
        [(e[0], p[1].abs()), (p[0].abs(), e[1]), (e[0], e[1])], D)
    assert torch.equal(got == 1e4, two == 1e4)
    assert torch.equal(got == 1e4, want == 1e4)
    d_two, d_plain = (got - two).abs(), (got - want).abs()
    equal = float((got == two).float().mean())
    print(f"K11 {what}: max |K11 - (K8 -> K9)| = {float(d_two.max())}, "
          f"{equal} bit-equal; max |K11 - plain| = {float(d_plain.max())}, "
          f"at most {float((d_plain / bar_plain).max())} of its bar")
    assert bool((d_two <= bar_two).all())
    assert bool((d_plain <= bar_plain).all())
    return equal


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("arch", ["fast", "accurate"])
def test_mccnn_fused_volume_kernel(dev, arch, bf16):
    """K11 at KITTI (1242x375, D = 128) on the shipped tower's last-layer
    input."""
    model = from_flax_params(load_default_params(arch), arch,
                             torch.bfloat16 if bf16 else torch.float32)
    model = model.to(dev)
    gt = slanted_scene(*KITTI, 5.0, 90.0)
    imgs = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                        for im in random_dot_pair(*KITTI, gt, blur=1.0,
                                                  seed=1)])
    _k11_check(model, imgs, 128, f"{arch} bf16={bf16}")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("F,L,H,W,D", [(64, 2, 53, 301, 256),
                                       (112, 3, 7, 129, 128),
                                       (32, 2, 3, 1000, 384),
                                       (128, 2, 9, 77, 128)])
def test_mccnn_fused_volume_kernel_shapes(dev, F, L, H, W, D, bf16):
    """Odd widths (a partial last step, a frame narrower than a step),
    several chunks of 128 planes, every F8 of K8 (32, 64, 112, 128), on a
    tower from a seed."""
    model = mccnn.make_model((F, L), torch.bfloat16 if bf16 else
                             torch.float32, seed=F + L).to(dev)
    imgs = torch.stack([normalize_image(im)
                        for im in _images(H, W, dev, seed=F + W)])
    _k11_check(model, imgs, D, f"F={F} L={L} {W}x{H} D={D} bf16={bf16}")


@pytest.mark.parametrize("bf16", [False, True])
def test_mccnn_fused_matcher_on_card(dev, bf16):
    """At D = 128 and min_d 0 the matcher launches K8 for the layers but
    the last and K11 once, no K9, and agrees with its plain path (K8's
    plain layers, the plain volume) on at least 99.5 % of the pixels (99 %
    in bfloat16, as phase 4d's bars)."""
    gt = slanted_scene(64, 300, 4.0, 60.0)
    left, right = random_dot_pair(64, 300, gt, blur=1.0, seed=13)
    cfg = DisparityConfig(num_disparities=128, cost="mccnn",
                          uniqueness_ratio=15, disp12_max_diff=1, wls=False,
                          speckle_window_size=0)
    model = from_flax_params(load_default_params("fast"), "fast",
                             torch.bfloat16 if bf16 else torch.float32)
    K.reset_launches()
    raw, _ = StereoMatcher(cfg, cost_fn=MCCNNCost(model.to(dev), cfg),
                           device=dev)(left, right)
    counts = {k: v for k, v in K.launches.items() if v}
    assert counts == {"mccnn_conv3x3": 3, "mccnn_fused_volume": 1,
                      "sgm_path_scan": 8, "wta_lr": 1}
    h = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                     for im in (left, right)])[:, None]
    for i in range(4):
        h = K.mccnn_conv3x3_plain(h, model.weights[i], model.biases[i],
                                  i < 3, i == 3, bf16)
    vol = K.mccnn_volume_plain(h[0], h[1], 128)
    total = K.aggregate_paths(vol, cfg.P1, cfg.P2, 8, K.sgm_path_scan_plain)
    want = K.wta_lr_plain(total, 0, 15, 1)[0]
    same_nan = torch.isnan(raw) == torch.isnan(want)
    close = (raw - want).abs().nan_to_num(0.0) <= 0.01
    share = float((same_nan & (close | torch.isnan(raw) |
                               torch.isnan(want))).float().mean())
    print(f"MC-CNN fast bf16={bf16} at D=128 on the card: {share} of the "
          "pixels agree with the plain path")
    assert share >= (0.99 if bf16 else 0.995)


# ------------------------------- int16, transposed K2, carries, K4 entries --

@pytest.mark.parametrize("H,W,D,min_d", [(36, 150, 64, 0), (24, 160, 128, 4),
                                         (*KITTI, 128, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("transposed", [False, True])
def test_census_volume_int16_and_transposed(dev, H, W, D, min_d, dtype,
                                            transposed):
    words = K.census_words(_images(H, W, dev, seed=1))
    if transposed:
        words = words.transpose(2, 3).contiguous()
    got = K.census_volume(words[0], words[1], D, min_d, dtype, transposed)
    want = K.census_volume_plain(words[0], words[1], D, min_d, dtype,
                                 transposed)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("direction", PATH_DIRECTIONS_8)
def test_sgm_path_scan_int16(dev, direction):
    """int16 storage: P1 = 8/3 is truncated to 2, as the XLA path does."""
    words = K.census_words(_images(37, 150, dev, seed=8), (3, 3))
    vol = K.census_volume(words[0], words[1], 64, 0, torch.int16)
    start = torch.from_numpy(np.random.default_rng(9).integers(
        0, 999, vol.shape).astype(np.int16)).to(dev)
    for accumulate in (False, True):
        got = K.sgm_path_scan(vol, start.clone(), *direction, 8 / 3, 32.0,
                              accumulate)
        want = K.sgm_path_scan_plain(vol, start.clone(), *direction, 8 / 3,
                                     32.0, accumulate)
        torch.cuda.synchronize()
        assert got.dtype == torch.int16 and torch.equal(got, want)


@pytest.mark.parametrize("D", [20, 48, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("direction", [d for d in PATH_DIRECTIONS_8 if d[0]])
def test_sgm_path_scan_carry_chain(dev, direction, dtype, D):
    """Shards of 16/16/5 rows chained through the carries equal the whole
    frame, on the card and in the plain version."""
    rng = np.random.default_rng(10)
    cost = torch.from_numpy(rng.uniform(0, 24, (D, 37, 150)).astype(
        np.float32)).to(dev)
    if dtype == torch.int16:
        cost = cost.to(torch.int16)
    whole = K.sgm_path_scan(cost, torch.empty_like(cost), *direction, 5.0,
                            40.0, False)
    bounds = [(0, 16), (16, 32), (32, 37)]
    if direction[0] < 0:
        bounds = bounds[::-1]
    for scan in (K.sgm_path_scan, K.sgm_path_scan_plain):
        carry, parts = None, {}
        for lo, hi in bounds:
            part = cost[:, lo:hi].contiguous()
            parts[lo], carry = scan(part, torch.empty_like(part), *direction,
                                    5.0, 40.0, False, init_carry=carry,
                                    return_carry=True)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([parts[lo] for lo in sorted(parts)], 1),
                           whole)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("invalid", [1e4, 1024.0])
@pytest.mark.parametrize("min_d", [0, 5])
@pytest.mark.parametrize("shape", [(37, 150, 64), (*KITTI, 128),
                                   (29, 151, 160), (*KITTI, 160),
                                   (21, 97, 256), (*KITTI, 256)])
def test_census_scan_kernel(dev, reverse, invalid, min_d, shape):
    """D = 128, 160 and 256 hold 4, 5 and 8 disparities a lane; odd W."""
    H, W, D = shape
    words = K.census_words(_images(H, W, dev, seed=11))
    start = torch.from_numpy(np.random.default_rng(12).uniform(
        0, 99, (D, H, W)).astype(np.float32)).to(dev)
    for accumulate in (False, True):
        got = K.census_scan(words[0], words[1], start.clone(), min_d, 8.0,
                            96.0, reverse, invalid, accumulate)
        want = K.census_scan_plain(words[0], words[1], start.clone(), min_d,
                                   8.0, 96.0, reverse, invalid, accumulate)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    if invalid == 1e4:          # equal to K2's volume scanned by K3
        vol = K.census_volume(words[0], words[1], D, min_d)
        want = K.sgm_path_scan(vol, start.clone(), 0, -1 if reverse else 1,
                               8.0, 96.0, True)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_wta_entries_and_int16(dev, dtype):
    rng = np.random.default_rng(13)
    total = torch.from_numpy(rng.integers(0, 12, (16, 20, 90)).astype(
        np.float32)).to(dev).to(dtype)
    for got, want in zip(K.wta_stats(total), K.wta_stats_plain(total)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(K.right_wta(total), K.right_wta_plain(total))
    disp, right = K.wta_lr(total)
    want, want_right = K.wta_lr_plain(total)
    torch.cuda.synchronize()
    _assert_same_disparity(disp, want)
    assert torch.equal(right, want_right)
    K.reset_launches()
    _assert_same_disparity(K.extract_disparity_fast(total), want)
    assert (K.launches["wta_stats"], K.launches["right_wta"],
            K.launches["lr_mask"]) == (1, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("D", [64, 100, 128, 160])
@pytest.mark.parametrize("W", [1242, 1243, 45])
def test_wta_entries_on_tie_heavy_totals(dev, W, D, dtype):
    """K4's walk (tiles of 64 columns, the left statistics in phases, the
    right view along diagonals; right_wta in blocks of 32 planes, so D =
    100 ends on a partial one) on totals made of ties: constant planes,
    minima at d = 0 and D - 1, equal minima over idx -+ 1, equal right-view
    diagonals; at KITTI's width, an odd width and W < D."""
    total = torch.from_numpy(K.tie_heavy_total(D, 12, W, seed=D + W)).to(
        dev).to(dtype)
    for got, want in zip(K.wta_stats(total), K.wta_stats_plain(total)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(K.right_wta(total), K.right_wta_plain(total))
    for args in ((0, 15, 1, True), (3, 5, 2, True), (0, 0, -1, False)):
        disp, right = K.wta_lr(total, *args)
        want, want_right = K.wta_lr_plain(total, *args)
        _assert_same_disparity(disp, want)
        assert torch.equal(right, want_right)
    torch.cuda.synchronize()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("D,min_d", [(1, 0), (1, 5), (128, 0), (128, 5),
                                     (160, 0), (160, 5)])
@pytest.mark.parametrize("W,window", [(1243, (5, 5)), (1243, (7, 9)),
                                      (101, (5, 5)), (101, (7, 9)),
                                      (1242, (5, 5)), (1280, (7, 9))])
def test_census_volume_kernel_shapes(dev, W, window, D, min_d, dtype,
                                     transposed):
    """K2 (a row block of vector stores; 32 x 16 blocks transposed) at one
    and two words, D = 1 (ELAS's plane a launch), 128 and 160, min_d 0
    and 5, odd W (scalar stores), W < D, and the widths whose rows take
    2- and 4-cell stores."""
    words = K.census_words(_images(9, W, dev, seed=W), window)
    if transposed:
        words = words.transpose(2, 3).contiguous()
    got = K.census_volume(words[0], words[1], D, min_d, dtype, transposed)
    want = K.census_volume_plain(words[0], words[1], D, min_d, dtype,
                                 transposed)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


def test_census_volume_rejects_too_many_words(dev):
    words = torch.zeros((9, 4, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most 8 words"):
        K.census_volume(words, words, 8)


@pytest.mark.parametrize("tol", [1, 0, 3, -1])
@pytest.mark.parametrize("H,W", [(20, 90), KITTI])
def test_lr_mask_kernel(dev, H, W, tol):
    rng = np.random.default_rng(15)
    dl = rng.integers(0, 256, (H, W)) / 2.0          # halves: round to even
    dl[rng.random((H, W)) < 0.1] = np.nan
    dr = rng.integers(0, 128, (H, W)).astype(np.float32)
    dl = torch.from_numpy(dl.astype(np.float32)).to(dev)
    dr = torch.from_numpy(dr).to(dev)
    got = K.lr_mask(dl, dr, tol)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool
    assert torch.equal(got, K.lr_mask_plain(dl, dr, tol))


@pytest.mark.parametrize("tol", [1.0, 1.5, 2.0, 0.25])
@pytest.mark.parametrize("H,W", [(20, 90), KITTI])
def test_lr_mask_kernel_float_tolerance(dev, H, W, tol):
    """ELAS's lr_tol is a float: quarter-pixel maps make |dl - dr| land on
    and between the fractional tolerances."""
    rng = np.random.default_rng(16)
    dl = rng.integers(0, 512, (H, W)) / 4.0
    dl[rng.random((H, W)) < 0.1] = np.nan
    dr = rng.integers(0, 512, (H, W)) / 4.0
    dl = torch.from_numpy(dl.astype(np.float32)).to(dev)
    dr = torch.from_numpy(dr.astype(np.float32)).to(dev)
    got = K.lr_mask(dl, dr, tol)
    torch.cuda.synchronize()
    want = K.lr_mask_plain(dl, dr, tol)
    assert torch.equal(got, want)
    assert not torch.equal(want, K.lr_mask_plain(dl, dr, int(tol))) \
        or tol == int(tol)


@pytest.mark.parametrize("window,nw", [((7, 9), 2), ((9, 9), 3),
                                       ((9, 11), 4)])
@pytest.mark.parametrize("H,W", [(37, 150), KITTI])
def test_census_words_kernel_multiword(dev, H, W, window, nw):
    imgs = _images(H, W, dev, seed=2)
    got = K.census_words(imgs, window)
    torch.cuda.synchronize()
    assert got.shape == (2, nw, H, W)
    assert torch.equal(got, K.census_words_plain(imgs, window))


@pytest.mark.parametrize("window", [(7, 9), (9, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("H,W,D,min_d", [(36, 150, 64, 3), (*KITTI, 128, 0)])
def test_census_volume_kernel_multiword(dev, H, W, D, min_d, window, dtype,
                                        transposed):
    words = K.census_words(_images(H, W, dev, seed=3), window)
    if transposed:
        words = words.transpose(2, 3).contiguous()
    got = K.census_volume(words[0], words[1], D, min_d, dtype, transposed)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, K.census_volume_plain(words[0], words[1], D,
                                                  min_d, dtype, transposed))


@pytest.mark.parametrize("kw", [dict(cost="bt"), dict(cost="sad"),
                                dict(cost="ssd"), dict(census_window=(7, 9)),
                                dict(census_window=(7, 9), dtype="int16")])
def test_other_costs_on_card(dev, kw):
    """The sad, ssd and bt volumes are plain torch on both devices (their
    cumulative sums may round differently), the 7x9 census is K1/K2."""
    gt = slanted_scene(48, 160, 3.0, 30.0)
    left, right = random_dot_pair(48, 160, gt, blur=1.0, seed=1)
    cfg = DisparityConfig(num_disparities=32, wls=False,
                          speckle_window_size=0, **kw)
    raw, _ = StereoMatcher(cfg, device=dev)(left, right)
    want, _ = StereoMatcher(cfg, device="cpu")(left, right)
    got = raw.cpu()
    same = torch.isnan(got) == torch.isnan(want)
    close = (got - want).abs().nan_to_num(0.0) <= 0.01
    assert float((same & close).float().mean()) >= 0.995
    if "census_window" in kw:
        _assert_same_disparity(got, want)


def test_block_matcher_and_elas_on_card(dev):
    from stereo_match_tpu_torch.pipeline.block_matching import BlockMatcher
    from stereo_match_tpu_torch.pipeline.elas import elas_match
    gt = slanted_scene(64, 192, 3.0, 30.0)
    left, right = random_dot_pair(64, 192, gt, blur=1.0, seed=1)
    cfg = DisparityConfig(num_disparities=32, block_size=9, wls=False,
                          speckle_window_size=0)
    for got, want in ((BlockMatcher(cfg, device=dev)(left, right)[0].cpu(),
                       BlockMatcher(cfg, device="cpu")(left, right)[0]),
                      (torch.from_numpy(elas_match(left, right, 32,
                                                   device=dev)),
                       torch.from_numpy(elas_match(left, right, 32,
                                                   device="cpu")))):
        same = torch.isnan(got) == torch.isnan(want)
        close = (got - want).abs().nan_to_num(0.0) <= 0.01
        assert float((same & close).float().mean()) >= 0.995


def test_int16_matcher_on_card(dev):
    gt = slanted_scene(48, 160, 3.0, 40.0)
    left, right = random_dot_pair(48, 160, gt, blur=1.0, seed=1)
    cfg = DisparityConfig(num_disparities=64, dtype="int16", wls=False,
                          speckle_window_size=0)
    raw, _ = StereoMatcher(cfg, device=dev)(left, right)
    want, _ = StereoMatcher(cfg, device="cpu")(left, right)
    _assert_same_disparity(raw.cpu(), want)


@pytest.mark.parametrize("mode", ["exact", "halo"])
def test_sharded_sgm_on_one_card(dev, mode):
    words = K.census_words(_images(53, 150, dev, seed=14))
    vol = K.census_volume(words[0], words[1], 64)
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    got = sgm_aggregate_sharded(vol, 8.0, 96.0, mesh, 8, mode, halo=8)
    want = sgm_aggregate_sharded(vol.cpu(), 8.0, 96.0,
                                 make_mesh(1, 4, devices=["cpu"] * 4), 8,
                                 mode, halo=8)
    assert torch.equal(got.cpu(), want)
    if mode == "exact":
        assert torch.equal(got, K.aggregate_paths(vol, 8.0, 96.0))


@pytest.mark.parametrize("mode", ["volume", "census"])
@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_stream_on_one_card(dev, mode, wire):
    cfg = DisparityConfig(num_disparities=32, wls=False,
                          speckle_window_size=0)
    frames = []
    for seed in range(5):
        gt = slanted_scene(40, 120, 3.0, 20.0 + seed)
        frames.append(random_dot_pair(40, 120, gt, blur=1.0, seed=seed))
    pipe = StreamingPipeline(cfg, make_stage_mesh(4, devices=[dev] * 4),
                             (40, 120), payload_mode=mode,
                             payload_dtype=wire)
    got = pipe.run(frames)
    assert len(got) == len(frames)
    if wire == "float32":
        for (raw, _), (l, r) in zip(got, frames):
            want, _ = _match_core(torch.from_numpy(l).to(dev),
                                  torch.from_numpy(r).to(dev), cfg)
            _assert_same_disparity(raw, want)
    else:
        ref = StreamingPipeline(cfg, make_stage_mesh(4, devices=[dev] * 4),
                                (40, 120), payload_mode=mode,
                                _invalid_clamp=1024.0).run(frames)
        for (raw, _), (want, _) in zip(got, ref):
            _assert_same_disparity(raw, want)


@pytest.mark.parametrize("mode", ["exact", "halo"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_match_dsharded_on_one_card(dev, dtype, mode):
    """4 D-shards on one card (K1, K2 at shifted minima, K3 row blocks, K4
    a block) equal the same shards on the CPU; so does the sharded WTA."""
    gt = slanted_scene(53, 150, 3.0, 40.0)
    left, right = random_dot_pair(53, 150, gt, blur=1.0, seed=3)
    cfg = DisparityConfig(num_disparities=64, dtype=dtype, wls=False,
                          speckle_window_size=0)
    got = match_dsharded(left, right, cfg, make_disp_mesh(devices=[dev] * 4),
                         mode, 8)
    want = match_dsharded(left, right, cfg,
                          make_disp_mesh(devices=["cpu"] * 4), mode, 8)
    _assert_same_disparity(got.cpu(), want)
    imgs = torch.from_numpy(np.stack([left, right]).astype(np.float32))
    total = K.aggregate_paths(K.census_volume(
        *K.census_words(imgs.to(dev))[:, 0], 64), 8.0, 96.0)
    wta = wta_dsharded(total, make_disp_mesh(devices=[dev] * 4), cfg)
    _assert_same_disparity(wta, K.wta_lr(
        total, cfg.min_disparity, cfg.uniqueness_ratio, cfg.disp12_max_diff,
        cfg.subpixel)[0])


# ------------------------------------------------------ several cards ----

@pytest.fixture(scope="module")
def cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards, {n} visible: a kernel's "
                    "shared-memory size is set on each card it runs on")
    return [require_hopper(i) for i in range(n)]


def test_kernels_on_every_card(cards):
    """K3 (every direction takes more than 48 KB of shared memory at D =
    128), both bodies of K8, K5 (its grid is sized per card) and K9 (more
    than 48 KB at D = 128) on each card in turn, against their plain
    versions on that card."""
    rng = np.random.default_rng(16)
    cost = rng.uniform(0, 24, (128, 37, 150)).astype(np.float32)
    x = rng.normal(size=(2, 112, 17, 70)).astype(np.float32)
    w = (rng.normal(size=(112, 112, 3, 3)) / np.sqrt(9 * 112)).astype(
        np.float32)
    b = rng.normal(0, 0.1, 112).astype(np.float32)
    for card in cards:
        c = torch.from_numpy(cost).to(card)
        for dtype in (torch.float32, torch.int16):
            for direction in PATH_DIRECTIONS_8:
                got = K.sgm_path_scan(c.to(dtype), torch.empty_like(
                    c, dtype=dtype), *direction, 8.0, 96.0, False)
                want = K.sgm_path_scan_plain(c.to(dtype), torch.empty_like(
                    c, dtype=dtype), *direction, 8.0, 96.0, False)
                assert got.device == card and torch.equal(got, want)
        for F, C_in in ((64, 1), (64, 64), (112, 112)):
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
                    for a in (x[:, :C_in], w[:F, :C_in], b[:F])]
            got = K.mccnn_conv3x3(*args, True, False)
            want = K.mccnn_conv3x3_plain(*args, True, False)
            assert got.device == card
            assert float((got - want).abs().max()) <= 1e-5
        _speckle_kernel_vs_plain(_speckled_map(*KITTI, card), 100, 2.0)
        f = rng.normal(size=(2, 64, 24, 300))
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        fl, fr = torch.from_numpy(f.astype(np.float32)).to(card)
        got = K.mccnn_volume(fl, fr, 128, 3)        # K9: 68 KB of shared
        want = K.mccnn_volume_plain(fl, fr, 128, 3)
        assert got.device == card and torch.equal(got == 1e4, want == 1e4)
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("mode", ["exact", "halo"])
def test_sharded_sgm_over_cards(cards, mode):
    """The row shards on distinct cards (the mesh's default device list)
    equal the same shards on one card."""
    n = len(cards)
    words = K.census_words(_images(53, 150, cards[0], seed=14))
    vol = K.census_volume(words[0], words[1], 64)
    got = sgm_aggregate_sharded(vol, 8.0, 96.0, make_mesh(1, n), 8, mode,
                                halo=8)
    want = sgm_aggregate_sharded(vol, 8.0, 96.0,
                                 make_mesh(1, n, devices=[cards[0]] * n), 8,
                                 mode, halo=8)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("mode", ["volume", "census"])
def test_stream_over_cards(cards, mode):
    """The stage pipeline with a stage on each card (4, or 2 on two cards)
    equals the single-card path frame for frame."""
    stages = 4 if len(cards) >= 4 else 2
    cfg = DisparityConfig(num_disparities=32, wls=False,
                          speckle_window_size=0)
    frames = []
    for seed in range(5):
        gt = slanted_scene(40, 120, 3.0, 20.0 + seed)
        frames.append(random_dot_pair(40, 120, gt, blur=1.0, seed=seed))
    got = StreamingPipeline(cfg, make_stage_mesh(stages), (40, 120),
                            payload_mode=mode).run(frames)
    assert len(got) == len(frames)
    for (raw, _), (l, r) in zip(got, frames):
        want, _ = _match_core(torch.from_numpy(l).to(cards[0]),
                              torch.from_numpy(r).to(cards[0]), cfg)
        _assert_same_disparity(raw.to(cards[0]), want)


def test_dsharded_over_cards(cards):
    """D-shards on distinct cards (the default device list) equal the same
    shards on one card."""
    n = len(cards)
    gt = slanted_scene(53, 150, 3.0, 40.0)
    left, right = random_dot_pair(53, 150, gt, blur=1.0, seed=3)
    cfg = DisparityConfig(num_disparities=16 * n, wls=False,
                          speckle_window_size=0)
    for mode in ("exact", "halo"):
        got = match_dsharded(left, right, cfg, make_disp_mesh(), mode, 8)
        want = match_dsharded(left, right, cfg,
                              make_disp_mesh(devices=[cards[0]] * n), mode, 8)
        assert got.device == cards[0]
        _assert_same_disparity(got, want)


def test_mesh_trainer_over_cards(cards):
    """The MC-CNN mesh trainer over (data, model) = (n / 2, 2) cards: each
    slice's gradient and Adam state on its own card, the loss that of the
    single-card step."""
    rows = len(cards) // 2
    mesh = named_mesh(cards[:2 * rows], (rows, 2), ("data", "model"))
    rng = np.random.default_rng(9)
    batch = [torch.from_numpy(rng.uniform(0, 1, (4 * rows, 16, 16)).astype(
        np.float32)).to(cards[0]) for _ in range(3)]
    flax = mccnn.to_flax_params(mccnn.make_model("fast", seed=0))
    tower = mccnn.shard_params(mccnn.from_flax_params(flax, "fast"), mesh)
    opt = Adam(tower.parameters(), 1e-3)
    loss = mccnn.make_train_step(tower, opt, mesh)(*batch)
    for r in range(rows):
        for m in range(2):
            for q in (t for layer in tower.slices[r][m] for t in layer):
                assert q.device == mesh.devices[r, m]
                assert q.grad.device == q.device
                assert all(s.device == q.device
                           for s in opt.state[q].values())
    model = mccnn.from_flax_params(flax, "fast").to(cards[0])
    model.requires_grad_(True)
    want = mccnn.make_train_step(model, Adam(model.parameters(), 1e-3))(
        *batch)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
