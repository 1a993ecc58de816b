"""The port's Zhang calibration against the JAX package's, on the CPU.

The calibration math is float64 host numpy in both packages, the same
code: every result is held bit-equal to JAX's on the synthetic views of
``tests/test_calibration.py``, and to that file's own bars against the
ground truth and cv2. ``undistort_image`` resamples in float32 (JAX's
``remap_bilinear`` and the port's): within UNDISTORT_TOL gray levels of
JAX's, and within ``tests/test_calibration.py``'s 1e-2 of the image where
the distortion is zero.
"""

import numpy as np
import pytest
import torch

from stereo_match_tpu.core import calibration as jcal
from stereo_match_tpu_torch.core import calibration as tcal
from test_calibration import _render_views

UNDISTORT_TOL = 1e-3    # gray levels of a [0, 255] image


def _same(got: tcal.CalibrationResult, want: jcal.CalibrationResult):
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_array_equal(got.dist, want.dist)
    for g, w in zip(got.rvecs + got.tvecs, want.rvecs + want.tvecs):
        np.testing.assert_array_equal(g, w)
    assert got.rms == want.rms


def test_homography_and_object_points_are_bit_equal(rng):
    H_true = np.array([[1.2, 0.1, 5.0], [-0.05, 0.9, -3.0],
                       [1e-4, -2e-4, 1.0]])
    src = rng.uniform(0, 100, (20, 2))
    proj = (H_true @ np.concatenate([src, np.ones((20, 1))], 1).T).T
    dst = proj[:, :2] / proj[:, 2:3]
    H = tcal.homography_dlt(src, dst)
    np.testing.assert_array_equal(H, jcal.homography_dlt(src, dst))
    np.testing.assert_allclose(H, H_true / H_true[2, 2], atol=1e-8)
    np.testing.assert_array_equal(tcal.chessboard_object_points(7, 5, 0.03),
                                  jcal.chessboard_object_points(7, 5, 0.03))


@pytest.mark.parametrize("K, dist, n_views, seed, refine", [
    ([[800.0, 0, 320], [0, 790.0, 240]], (0.0, 0.0), 6, 0, True),
    ([[600.0, 0, 310], [0, 600.0, 230]], (-0.15, 0.05), 8, 3, True),
    ([[700.0, 0, 330], [0, 710.0, 250]], (-0.1, 0.02), 8, 5, True),
    ([[800.0, 0, 320], [0, 790.0, 240]], (0.0, 0.0), 6, 0, False),
], ids=["intrinsics", "distortion", "opencv_case", "closed_form"])
def test_calibrate_camera_is_bit_equal(K, dist, n_views, seed, refine):
    K = np.array(K + [[0, 0, 1]])
    obj, views, _, _ = _render_views(K, dist, n_views=n_views, seed=seed)
    got = tcal.calibrate_camera(obj, views, refine=refine)
    _same(got, jcal.calibrate_camera(obj, views, refine=refine))
    if refine:    # tests/test_calibration.py's bars
        np.testing.assert_allclose(got.K[0, 0], K[0, 0], rtol=5e-3)
        np.testing.assert_allclose(got.dist[0], dist[0], atol=0.02)
        assert got.rms < 0.1


def test_calibrate_matches_opencv():
    import cv2
    K_true = np.array([[700.0, 0, 330], [0, 710.0, 250], [0, 0, 1]])
    obj, views, _, _ = _render_views(K_true, (-0.1, 0.02), n_views=8, seed=5)
    res = tcal.calibrate_camera(obj, views)
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], axis=1).astype(
        np.float32)
    rms_cv, K_cv, _, _, _ = cv2.calibrateCamera(
        [obj3] * len(views), [v.astype(np.float32) for v in views],
        (640, 480), None, None)
    np.testing.assert_allclose(res.K[0, 0], K_cv[0, 0], rtol=1e-2)
    np.testing.assert_allclose(res.K[:2, 2], K_cv[:2, 2], atol=3.0)
    assert res.rms <= rms_cv + 0.05


def test_calibrate_needs_three_views():
    obj = tcal.chessboard_object_points(4, 3)
    with pytest.raises(ValueError, match="3 views"):
        tcal.calibrate_camera(obj, [obj.copy(), obj.copy()])


@pytest.mark.parametrize("shape, dist", [((48, 64), (0.0, 0.0)),
                                         ((48, 64), (-0.2, 0.05)),
                                         ((37, 53, 3), (0.1, -0.02))])
def test_undistort_image_matches_jax(rng, shape, dist):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    K = np.array([[100.0, 0, shape[1] / 2], [0, 100.0, shape[0] / 2],
                  [0, 0, 1]])
    want = jcal.undistort_image(img, K, np.array(dist))
    got = tcal.undistort_image(img, K, np.array(dist), device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=UNDISTORT_TOL)
    if not any(dist):
        np.testing.assert_allclose(got.numpy(), img, atol=1e-2)


def test_undistort_image_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.zeros((8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.undistort_image(img, np.eye(3), np.zeros(2))


def test_find_chessboard_corners_matches_jax():
    """A rendered board: both packages find the same corners (cv2)."""
    img = np.full((240, 320), 255, np.uint8)
    for r in range(6):
        for c in range(8):
            if (r + c) % 2 == 0:
                img[40 + 25 * r:65 + 25 * r, 60 + 25 * c:85 + 25 * c] = 0
    got = tcal.find_chessboard_corners(img, (7, 5))
    want = jcal.find_chessboard_corners(img, (7, 5))
    assert got is not None and got.shape == (35, 2)
    np.testing.assert_array_equal(got, want)
    assert tcal.find_chessboard_corners(np.full((64, 64), 128, np.uint8),
                                        (7, 5)) is None
