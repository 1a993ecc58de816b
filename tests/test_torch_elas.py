"""The port's ELAS-style matcher and its host library against the JAX
package's, on the CPU.

Both packages run the same C++ source (``native/smt_native.cpp``, the
port's copy held byte-equal to the JAX package's), each built by its own
loader: ELAS support points lie on a regular grid, where scipy's Delaunay
may choose other diagonals, so the comparisons need both libraries built.
The same numpy scene, made from a seed, goes through both packages: the
support statistics, support points, prior, nearest-valid scans, prior
extension, gap interpolation and median are bit-equal; the dense stage
(JAX's prior into both) and ``elas_match`` end to end must agree on at
least 99.5 % of the pixels (same NaN state, within 0.01) and give the same
support points.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu import native as jnative
from stereo_match_tpu.data.synthetic import (box_scene, random_dot_pair,
                                             slanted_scene)
from stereo_match_tpu.ops import filters as jfilters
from stereo_match_tpu.pipeline import elas as jelas
from stereo_match_tpu_torch import native as tnative
from stereo_match_tpu_torch.ops import filters as tfilters
from stereo_match_tpu_torch.pipeline import elas as telas

REPO = Path(__file__).resolve().parents[1]
H, W, D = 96, 128, 32
AGREE = 0.995


@pytest.fixture(scope="module")
def scene():
    gt = box_scene(H, W, 4, 12)
    left, right = random_dot_pair(H, W, gt, blur=0.8)
    return left, right, gt


def _agreement(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    close = np.abs(np.nan_to_num(got) - np.nan_to_num(want)) <= 0.01
    return float(((nan_g == nan_w) & (close | nan_g | nan_w)).mean())


def _holey(seed, shape=(30, 70)):
    """A disparity map with NaN runs of many widths and a few empty rows."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(2, 30, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.4] = np.nan
    d[:, 10:35] = np.nan
    d[5] = np.nan
    d[7, 20:] = np.nan
    return d


# ------------------------------------------------------------ native --

def test_native_source_is_the_jax_packages():
    port = REPO / "stereo_match_tpu_torch" / "native" / "smt_native.cpp"
    jax_src = REPO / "stereo_match_tpu" / "native" / "smt_native.cpp"
    assert port.read_bytes() == jax_src.read_bytes()


def test_native_library_builds_outside_the_package():
    assert tnative.available() and jnative.available()
    lib = tnative.build()
    assert lib.is_file() and tnative.BUILD_ROOT in lib.parents
    assert not list((REPO / "stereo_match_tpu_torch").rglob("*.so"))


def test_delaunay_and_rasterize_match_jax_on_a_grid():
    """Grid points (co-circular quadruples): both libraries pick the same
    diagonals, since they run the same source."""
    ys, xs = np.mgrid[5:60:5, 5:90:5]
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
    d = np.random.default_rng(1).uniform(2, 30, len(pts))
    tris = tnative.delaunay(pts)
    np.testing.assert_array_equal(tris, jnative.delaunay(pts))
    sup = np.concatenate([pts, d[:, None]], 1)
    np.testing.assert_array_equal(
        tnative.rasterize_planes(tris, sup, 64, 96),
        jnative.rasterize_planes(tris, sup, 64, 96))


# ------------------------------------------------------- the stages --

def test_support_scores_and_points_match_jax(scene):
    left, right, _ = scene
    got = telas._support_scores(torch.from_numpy(left),
                                torch.from_numpy(right), D, 2)
    want = jelas._support_scores(jnp.asarray(left), jnp.asarray(right), D, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cfg = telas.ElasConfig()
    np.testing.assert_array_equal(
        telas.extract_support_points(left, right, cfg, D),
        jelas.extract_support_points(left, right, jelas.ElasConfig(), D))


@pytest.mark.parametrize("seed", [0, 1])
def test_scans_prior_and_gap_fill_bit_equal(seed):
    d = _holey(seed)
    t, j = torch.from_numpy(d), jnp.asarray(d)
    for got, want in zip(telas._nearest_valid_scan(t),
                         jelas._nearest_valid_scan(j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(telas._extend_prior(t).numpy(),
                                  np.asarray(jelas._extend_prior(j)))
    rng = np.random.default_rng(seed + 10)
    il, ir = rng.uniform(0, 255, (2, *d.shape)).astype(np.float32)
    for gap_max, images in ((80, None), (12, (il, ir)), (80, (il, ir))):
        got = telas.gap_interpolate(
            t, gap_max, 5.0, None if images is None else
            tuple(torch.from_numpy(im) for im in images), 60.0)
        want = jelas.gap_interpolate(j, gap_max, 5.0, images, 60.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tfilters.median_filter(t, 3).numpy(),
        np.asarray(jfilters.median_filter(j, 3)))


@pytest.mark.parametrize("lr_tol", [2.0, 1.5])
def test_dense_banded_matches_jax(scene, lr_tol):
    """JAX's prior into both dense stages; ``lr_tol`` 1.5 runs K4
    ``lr_mask``'s float tolerance."""
    left, right, _ = scene
    cfg = jelas.ElasConfig()
    sup = jelas.extract_support_points(left, right, cfg, D)
    mu = np.array(jelas._extend_prior(jnp.asarray(jnative.rasterize_planes(
        jnative.delaunay(sup[:, :2]), sup, H, W))))
    mu[:, :6] = np.nan                        # pixels without a prior too
    want = np.asarray(jelas._dense_banded(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(mu), D,
        lr_tol=lr_tol))
    got = telas._dense_banded(torch.from_numpy(left),
                              torch.from_numpy(right), mu, D,
                              lr_tol=lr_tol).numpy()
    assert _agreement(got, want) >= AGREE
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- end to end --

def test_elas_match_matches_jax(scene):
    left, right, gt = scene
    disp, support, matched = telas.elas_match(
        left, right, D, return_support=True, return_matched=True,
        device="cpu")
    jdisp, jsupport, jmatched = jelas.elas_match(
        left, right, D, return_support=True, return_matched=True)
    np.testing.assert_array_equal(support, jsupport)
    assert len(support) > 50
    for got, want in ((matched, jmatched), (disp, jdisp)):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert _agreement(got, want) >= AGREE
    np.testing.assert_array_equal(disp, jdisp)
    # the maps are equal, so is their quality: the gap fill leaves the
    # left border band (x < d) unfilled
    bad = np.abs(disp - gt) > 3.0
    assert float(np.mean(bad | ~np.isfinite(disp))) < 0.1


def test_elas_prior_matches_jax_with_a_slanted_scene():
    """The same support points give the same prior: rasterised, then
    extended past the support hull to the frame."""
    gt = slanted_scene(H, W, 3.0, 15.0)
    left, right = random_dot_pair(H, W, gt, blur=1.5, seed=5)
    cfg = telas.ElasConfig()
    sup = telas.extract_support_points(left, right, cfg, D)
    np.testing.assert_array_equal(
        sup, jelas.extract_support_points(left, right, jelas.ElasConfig(),
                                          D))
    tris = tnative.delaunay(sup[:, :2])
    mu = telas._extend_prior(torch.from_numpy(
        tnative.rasterize_planes(tris, sup, H, W)))
    want = jelas._extend_prior(jnp.asarray(jnative.rasterize_planes(
        jnative.delaunay(sup[:, :2]), sup, H, W)))
    np.testing.assert_array_equal(mu.numpy(), np.asarray(want))
    assert np.isfinite(mu.numpy()).all()


def test_elas_without_support_falls_back():
    flat = np.full((40, 60), 128.0, np.float32)
    got = telas.elas_match(flat, flat, 16, device="cpu")
    np.testing.assert_array_equal(got, jelas.elas_match(flat, flat, 16))
