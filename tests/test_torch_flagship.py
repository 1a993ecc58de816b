"""The port's flagship flow against the JAX package, on the CPU.

rectify from poses -> match -> WLS -> reproject -> PLY
(``pipeline/stereo.py::run_pipeline``). The host float64 parts
(``core/camera.py``, ``stereo_rectify``) and the numpy I/O are the JAX
package's code and must agree bit for bit. The per-pixel float32 parts
(rectification maps, bilinear remap, reprojection) are compared within the
tolerances stated at each test: the two packages may round or contract
their multiply-adds differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.core import camera as jcamera
from stereo_match_tpu.core import rectify as jrectify
from stereo_match_tpu.core import reproject as jreproject
from stereo_match_tpu.data import image as jimage
from stereo_match_tpu.data import ply as jply
from stereo_match_tpu.pipeline import stereo as jstereo
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.core import camera as tcamera
from stereo_match_tpu_torch.core import rectify as trectify
from stereo_match_tpu_torch.core import reproject as treproject
from stereo_match_tpu_torch.data import image as timage
from stereo_match_tpu_torch.data import ply as tply
from stereo_match_tpu_torch.data import synthetic as tsynthetic
from stereo_match_tpu_torch.pipeline import stereo as tstereo


def _K(f, W, H):
    return np.array([[f, 0.0, W / 2.0], [0.0, f * 1.01, H / 2.0 + 0.7],
                     [0.0, 0.0, 1.0]])


def _converged_poses():
    pose_l = np.eye(4)
    pose_r = np.eye(4)
    pose_r[:3, :3] = jcamera.rodrigues([0.008, -0.035, 0.005])
    pose_r[:3, 3] = [0.54, 0.015, 0.02]
    return pose_l, pose_r


def test_camera_helpers_match_jax():
    pose_l, pose_r = _converged_poses()
    for got, want in zip(tcamera.relative_pose(pose_l, pose_r),
                         jcamera.relative_pose(pose_l, pose_r)):
        np.testing.assert_array_equal(got, want)
    for r in ([0.1, -0.2, 0.3], [0.0, 0.0, 0.0], [np.pi - 1e-9, 0.0, 0.0]):
        R = jcamera.rodrigues(r)
        np.testing.assert_array_equal(tcamera.rodrigues(r), R)
        np.testing.assert_array_equal(tcamera.rotation_to_vector(R),
                                      jcamera.rotation_to_vector(R))
    K = _K(200.0, 128, 96)
    forward = np.eye(4)
    forward[:3, 3] = [0.0, 0.0, 0.5]
    for pr in (pose_r, forward):
        assert tcamera.check_epipoles(K, K, pose_l, pr, (96, 128)) == \
            jcamera.check_epipoles(K, K, pose_l, pr, (96, 128))
    assert not tcamera.check_epipoles(K, K, pose_l, forward, (96, 128))
    T = np.arange(16.0).reshape(4, 4)
    for mode in ("P", "LR", "LL"):
        np.testing.assert_array_equal(
            tcamera.arkit_to_opencv_extrinsic(T, mode),
            jcamera.arkit_to_opencv_extrinsic(T, mode))
    np.testing.assert_array_equal(tcamera.portrait_swap_principal_point(K),
                                  jcamera.portrait_swap_principal_point(K))
    np.testing.assert_array_equal(tcamera.intrinsic_from_params(1, 2, 3, 4),
                                  jcamera.intrinsic_from_params(1, 2, 3, 4))


@pytest.mark.parametrize("alpha", [-1.0, 0.0, 1.0])
@pytest.mark.parametrize("distorted", [False, True])
def test_stereo_rectify_bit_equal(alpha, distorted):
    pose_l, pose_r = _converged_poses()
    R, t = tcamera.relative_pose(pose_l, pose_r)
    K = _K(210.0, 160, 120)
    dist = np.array([-0.12, 0.03, 0.001, -0.002, 0.0]) if distorted else None
    got = trectify.stereo_rectify(K, K, (160, 120), R, t, dist, dist, alpha)
    want = jrectify.stereo_rectify(K, K, (160, 120), R, t, dist, dist, alpha)
    for name in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.baseline == want.baseline


@pytest.mark.parametrize("distorted", [False, True])
def test_rectification_maps_match_jax(distorted):
    """float32 per-pixel warp from the same float64 inverse: within 2e-3
    px, the rounding of a few float32 multiply-adds at coordinates of a
    few hundred pixels."""
    pose_l, pose_r = _converged_poses()
    R, t = tcamera.relative_pose(pose_l, pose_r)
    K = _K(210.0, 160, 120)
    dist = np.array([-0.12, 0.03, 0.001, -0.002, 0.0]) if distorted else None
    res = trectify.stereo_rectify(K, K, (160, 120), R, t, dist, dist, 0.0)
    for Rk, Pk in ((res.R1, res.P1), (res.R2, res.P2)):
        got = trectify.rectification_maps(K, Rk, Pk, (160, 120), dist,
                                           device="cpu")
        want = jrectify.rectification_maps(K, Rk, Pk, (160, 120), dist)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (120, 160)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=2e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_remap_bilinear_matches_jax(dtype):
    """Same maps into both: float images within 1e-3 (the order of the
    bilinear sum's float32 roundings), uint8 images within one level (a
    value that lands on .5 may round either way)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (30, 40, 3)).astype(dtype)
    mx = rng.uniform(-3, 43, (25, 35)).astype(np.float32)
    my = rng.uniform(-3, 33, (25, 35)).astype(np.float32)
    for im in (img, img[..., 0]):
        got = trectify.remap_bilinear(torch.from_numpy(np.ascontiguousarray(
            im)), torch.from_numpy(mx), torch.from_numpy(my)).numpy()
        want = np.asarray(jrectify.remap_bilinear(jnp.asarray(im),
                                                  jnp.asarray(mx),
                                                  jnp.asarray(my)))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=0,
                                   atol=1e-3 if dtype == np.float32 else 1)
        outside = (mx < -1) | (mx > 40) | (my < -1) | (my > 30)
        assert (got[outside] == 0).all()


def test_reproject_matches_jax():
    """float32 broadcast arithmetic: within 1e-5 relative."""
    rng = np.random.default_rng(1)
    d = rng.uniform(1, 40, (20, 30)).astype(np.float32)
    d[3, 4] = np.nan
    d[5, 6] = 0.0
    Q = jreproject.make_q_matrix(200.0, 15.2, 9.7, -0.12, cx_prime=16.0)
    np.testing.assert_array_equal(
        treproject.make_q_matrix(200.0, 15.2, 9.7, -0.12, cx_prime=16.0), Q)
    got = treproject.reproject_image_to_3d(torch.from_numpy(d), Q).numpy()
    want = np.asarray(jreproject.reproject_image_to_3d(jnp.asarray(d), Q))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[3, 4] == 10000.0).all()
    np.testing.assert_allclose(
        treproject.disparity_to_depth(torch.from_numpy(d), 200.0, 0.1),
        np.asarray(jreproject.disparity_to_depth(jnp.asarray(d), 200.0, 0.1)),
        rtol=1e-6)


@pytest.mark.parametrize("binary", [False, True])
def test_ply_round_trip_and_bytes_match_jax(tmp_path, binary):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[3] = np.nan
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    assert tply.write_ply(str(a), pts, cols, binary=binary) == 50
    jply.write_ply(str(b), pts, cols, binary=binary)
    assert a.read_bytes() == b.read_bytes()
    got_pts, got_cols = tply.read_ply(str(a))
    want = np.where(np.isfinite(pts), pts, 0.0)
    np.testing.assert_allclose(got_pts, want, atol=1e-6 if not binary else 0)
    np.testing.assert_array_equal(got_cols, cols)


def test_to_grayscale_matches_jax():
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (8, 9, 3)).astype(np.uint8),
                rng.uniform(0, 255, (8, 9, 3)).astype(np.float32),
                rng.uniform(0, 255, (8, 9)).astype(np.float32)):
        got, want = timage.to_grayscale(img), jimage.to_grayscale(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _lateral_pair(H=48, W=160, f=120.0, B=0.1, seed=1):
    """A slanted plane seen by two cameras a pure lateral baseline apart;
    the images are random-dot renders of its disparity f*B/Z."""
    gt = tsynthetic.slanted_scene(H, W, 6.0, 20.0)
    left, right = tsynthetic.random_dot_pair(H, W, gt, blur=1.0, seed=seed)
    K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])
    pose_l, pose_r = np.eye(4), np.eye(4)
    pose_r[:3, 3] = [B, 0.0, 0.0]
    return pose_l, pose_r, K, left, right, gt


def test_run_pipeline_matches_jax(tmp_path):
    """End to end with WLS on: Q equal, raw NaN masks agreeing on >= 99.9 %
    of the pixels, points within 1e-3 relative where both are finite and
    depth that of the scene."""
    pose_l, pose_r, K, left, right, gt = _lateral_pair()
    cfg = DisparityConfig(num_disparities=32, lmbda=8000.0, wls_iters=2,
                          speckle_window_size=20)
    rgb_l = np.stack([left] * 3, -1).astype(np.uint8)
    rgb_r = np.stack([right] * 3, -1).astype(np.uint8)
    want = jstereo.run_pipeline(pose_l, pose_r, K, K, rgb_l, rgb_r,
                                config=cfg,
                                ply_path=str(tmp_path / "jax.ply"))
    got = tstereo.run_pipeline(pose_l, pose_r, K, K, rgb_l, rgb_r,
                               config=cfg,
                               ply_path=str(tmp_path / "port.ply"),
                               device="cpu")
    assert isinstance(got.disparity, np.ndarray)
    np.testing.assert_array_equal(got.rectification.Q, want.rectification.Q)
    np.testing.assert_array_equal(got.rect_left, np.asarray(want.rect_left))
    agree = np.isnan(got.disparity) == np.isnan(np.asarray(want.disparity))
    assert agree.mean() >= 0.999
    both = np.isfinite(got.points) & np.isfinite(want.points)
    np.testing.assert_allclose(got.points[both], want.points[both],
                               rtol=1e-3, atol=1e-4)
    pts, cols = tply.read_ply(str(tmp_path / "port.ply"))
    assert len(pts) == got.meta["ply_vertices"] == \
        int(np.isfinite(got.disparity).sum())
    valid = np.isfinite(got.disparity)
    z_true = 120.0 * 0.1 / gt[valid]
    z = got.points[..., 2][valid]
    assert np.median(np.abs(z - z_true) / z_true) < 0.02


def test_run_pipeline_q_override_band_and_matcher(tmp_path):
    pose_l, pose_r, K, left, right, _ = _lateral_pair(32, 96)
    Q = np.array([[1, 0, 0, -48], [0, 1, 0, -16],
                  [0, 0, 0, 120.0], [0, 0, 1 / 22.0, 0]])
    cfg = DisparityConfig(num_disparities=32, wls_iters=1)
    res = tstereo.run_pipeline(pose_l, pose_r, K, K, left, right,
                               config=cfg, q_override=Q, device="cpu",
                               ply_path=str(tmp_path / "band.ply"),
                               disparity_band=(10.0, 20.0))
    band = (res.disparity_filtered > 10) & (res.disparity_filtered < 20)
    assert res.meta["ply_vertices"] == band.sum() > 0
    np.testing.assert_allclose(
        res.points, treproject.reproject_image_to_3d(
            torch.from_numpy(res.disparity_filtered), Q).numpy())
    calls = []

    def matcher(l, r):
        calls.append(l.shape)
        return tstereo.StereoMatcher(cfg, device="cpu")(l, r)

    res2 = tstereo.run_pipeline(pose_l, pose_r, K, K, left, right,
                                matcher=matcher, reproject=False,
                                device="cpu")
    assert calls == [(32, 96)] and res2.points is None
    np.testing.assert_array_equal(res2.disparity, res.disparity)


def test_rectify_pair_rejects_forward_motion():
    K = _K(100.0, 64, 48)
    pose_r = np.eye(4)
    pose_r[:3, 3] = [0.0, 0.0, 0.5]
    img = np.zeros((48, 64), np.float32)
    with pytest.raises(ValueError, match="epipole"):
        trectify.rectify_pair(np.eye(4), pose_r, K, K, img, img,
                              device="cpu")
