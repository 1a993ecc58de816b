"""The port's post stack (speckle, WLS) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (its
XLA path, or a Pallas kernel in interpret mode) and the port's, which runs
the plain versions of K5 and K7 on the CPU. The speckle filter is compared
bit for bit. The WLS solves are compared within the JAX tests' own bounds
(``tests/test_refine.py``): 2e-6 for one solve, rtol 1e-3 / atol 2e-4 for
the composed smoother. The two packages round ``exp`` in the guide weights
and contract multiply-adds differently, by an ulp, and the ill-conditioned
lambda ladder amplifies that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereo_match_tpu.pipeline.stereo as jstereo
from stereo_match_tpu.ops import speckle as jspeckle
from stereo_match_tpu.ops import wls as jwls
from stereo_match_tpu.ops.pallas_speckle import speckle_filter_pallas
from stereo_match_tpu.ops.pallas_wls import fast_global_smoother_pallas
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.data import synthetic as tsynthetic
from stereo_match_tpu_torch.data.speckle_maps import serpentine
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import speckle as tspeckle
from stereo_match_tpu_torch.ops import wls as twls
from stereo_match_tpu_torch.pipeline import stereo as tstereo

FGS_TOL = dict(rtol=1e-3, atol=2e-4)       # tests/test_refine.py:214


def _assert_same_disparity(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def _noisy_map(H, W, seed=11):
    rng = np.random.default_rng(seed)
    d = rng.normal(10, 0.2, (H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.25] = np.nan
    d[rng.uniform(size=d.shape) < 0.1] += 50
    return d


# ------------------------------------------------------------- speckle ----

@pytest.mark.parametrize("H,W", [(40, 130), (17, 33), (23, 257)])
def test_speckle_filter_matches_jax(H, W):
    """tests/test_refine.py:234-251: the XLA path and the Pallas kernel."""
    d = _noisy_map(H, W)
    for T in (5, 30):
        got = tspeckle.speckle_filter(torch.from_numpy(d), T, 1.0)
        _assert_same_disparity(got, jspeckle.speckle_filter(jnp.asarray(d),
                                                            T, 1.0))
    _assert_same_disparity(got, speckle_filter_pallas(
        jnp.asarray(d), 30, 1.0, interpret=True))


def test_speckle_cyclic_blobs_match_jax():
    """tests/test_refine.py:253-267: blobs with cycles and a hole."""
    d = np.full((24, 140), np.nan, np.float32)
    d[2:4, 2:4] = 7.0
    d[8:13, 8:13] = 7.0
    d[10, 10] = np.nan
    d[16:22, 100:120] = 7.0
    for T in (5, 25, 100):
        got = tspeckle.speckle_filter(torch.from_numpy(d), T, 1.0)
        _assert_same_disparity(got, jspeckle.speckle_filter(jnp.asarray(d),
                                                            T, 1.0))
        if T == 25:           # removes the 2x2 block and the 24-pixel ring
            assert np.isnan(got.numpy()[:14, :14]).all()
            _assert_same_disparity(got, speckle_filter_pallas(
                jnp.asarray(d), T, 1.0, interpret=True))


@pytest.mark.parametrize("max_iters", [1, 2, 3, 64])
def test_speckle_sweep_cap_matches_jax(max_iters):
    """The serpentine needs many sweeps: the sweep count and the
    keep-all-when-unconverged rule must be the reference's
    (tests/test_refine.py:158-172 is max_iters=1)."""
    d = serpentine(16, 33)
    got = tspeckle.speckle_filter(torch.from_numpy(d), 10 ** 6, 1.0,
                                  max_iters=max_iters)
    _assert_same_disparity(got, jspeckle.speckle_filter(
        jnp.asarray(d), 10 ** 6, 1.0, max_iters=max_iters))
    if max_iters == 1:
        np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                      np.isfinite(d))
    if max_iters == 64:
        assert torch.isnan(got).all()           # converged: one component


def test_speckle_sweeps_until_converged():
    """A spiral converges after several sweeps; each sweep lowers labels,
    the last one none."""
    d = serpentine(12, 20)
    labels = torch.where(torch.isfinite(torch.from_numpy(d)),
                         torch.arange(240, dtype=torch.int32).view(12, 20),
                         241).to(torch.int32)
    conn = K.connectivity(torch.from_numpy(d), 1.0)
    flags = []
    while not flags or flags[-1]:
        flags.append(bool(K.speckle_sweep_plain(labels, conn)))
    assert len(flags) >= 3 and not flags[-1]
    assert int(labels[torch.isfinite(torch.from_numpy(d))].max()) == 0


def test_speckle_removes_small_blob_keeps_large():
    d = np.full((30, 40), 10.0, np.float32)
    d[5:7, 5:7] = 50.0
    out = tspeckle.speckle_filter(torch.from_numpy(d), 20, 2.0).numpy()
    assert np.isnan(out[5:7, 5:7]).all()
    assert np.isfinite(out[15:, 15:]).all()


def test_speckle_disabled_and_infinities():
    d = torch.full((8, 8), 3.0)
    assert tspeckle.speckle_filter(d, 0, 2.0) is d
    e = np.full((10, 12), 4.0, np.float32)
    e[2, 3], e[5, 5], e[7, 1] = np.inf, -np.inf, np.nan
    got = tspeckle.speckle_filter(torch.from_numpy(e), 3, 1.0)
    _assert_same_disparity(got, jspeckle.speckle_filter(jnp.asarray(e), 3,
                                                        1.0))


def test_speckle_connectivity_matches_reference_masks():
    d = _noisy_map(9, 14, seed=3)
    got = K.connectivity(torch.from_numpy(d), 1.0)
    valid = jnp.isfinite(d)
    dval = jnp.where(valid, d, jnp.inf)
    for bit, (dy, dx) in ((K.CONN_LEFT, (0, 1)), (K.CONN_UP, (1, 0))):
        want = valid & (jnp.abs(jspeckle._neighbor_shift(
            dval, dy, dx, jnp.float32(jnp.inf)) - dval) <= 1.0)
        np.testing.assert_array_equal((got & bit).numpy() != 0,
                                      np.asarray(want))
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        np.testing.assert_array_equal(
            K._neighbor_shift(torch.from_numpy(d), dy, dx, -1.0),
            np.asarray(jspeckle._neighbor_shift(jnp.asarray(d), dy, dx,
                                                -1.0)))


def test_speckle_count_keep_plain():
    d = torch.tensor([[1.0, 2.0, float("nan")], [3.0, 4.0, 5.0]])
    labels = torch.tensor([[0, 0, 7], [3, 3, 3]], dtype=torch.int32)
    out = K.speckle_count_keep_plain(d, labels, 3, False)
    assert torch.isnan(out[0]).all() and torch.equal(out[1], d[1])
    out = K.speckle_count_keep_plain(d, labels, 3, True)
    assert torch.equal(out[:, :2], d[:, :2]) and torch.isnan(out[0, 2])


# ----------------------------------------------------------------- WLS ----

def test_tridiagonal_smooth_rows_matches_jax():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(21, 45)).astype(np.float32)
    w = rng.uniform(0, 1, (21, 44)).astype(np.float32)
    lam = np.float32(190.476)
    got = twls._tridiagonal_smooth_rows(torch.from_numpy(f),
                                        torch.from_numpy(w), float(lam))
    want = jwls._tridiagonal_smooth_rows(jnp.asarray(f), jnp.asarray(w),
                                         jnp.float32(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    # and it solves the system (tests/test_refine.py:20-35)
    for y in range(3):
        A = np.diag(np.r_[0.0, w[y]] + np.r_[w[y], 0.0]) \
            - np.diag(w[y], 1) - np.diag(w[y], -1)
        np.testing.assert_allclose(
            got[y].numpy(), np.linalg.solve(np.eye(45) + float(lam) * A,
                                             f[y]), rtol=1e-4, atol=1e-4)


def test_fgs_solve_shares_elimination_exactly():
    """Two right-hand sides in one solve equal two solves of their own."""
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.normal(size=(2, 30, 17)).astype(np.float32))
    wp, wn = twls._scan_weights(torch.from_numpy(
        rng.uniform(0, 1, (29, 17)).astype(np.float32)), 0)
    lam = twls._lambda_schedule(80000.0, 3)[0]
    both = K.fgs_solve(f, wp, wn, lam, 0)
    for c in range(2):
        assert torch.equal(both[c], K.fgs_solve(f[c:c + 1].contiguous(), wp,
                                                wn, lam, 0)[0])
    with pytest.raises(ValueError):
        K.fgs_solve(f, wp[:-1].contiguous(), wn, lam, 0)
    with pytest.raises(ValueError):
        K.fgs_solve(torch.cat([f, f[:1]]), wp, wn, lam, 0)


@pytest.mark.parametrize("lmbda,num_iter", [(80000.0, 3), (500.0, 2),
                                            (1234.5678, 4)])
def test_lambda_schedule_is_float32(lmbda, num_iter):
    base = jnp.float32(1.5) * jnp.float32(lmbda) / (4.0 ** num_iter - 1.0)
    want = [float(base * (4.0 ** (num_iter - t - 1)))
            for t in range(num_iter)]
    assert twls._lambda_schedule(lmbda, num_iter) == want


@pytest.mark.parametrize("H,W,num_iter", [(21, 45, 3), (8, 128, 2),
                                          (9, 130, 2), (16, 127, 2)])
def test_fast_global_smoother_matches_jax(H, W, num_iter):
    """Against the XLA smoother and the Pallas one (interpret mode);
    tests/test_refine.py:196-231."""
    rng = np.random.default_rng(3)
    guide = rng.uniform(0, 255, (H, W)).astype(np.float32)
    a = rng.normal(size=(H, W)).astype(np.float32)
    got = twls.fast_global_smoother(torch.from_numpy(a),
                                    torch.from_numpy(guide), 8000.0, 8.0,
                                    num_iter).numpy()
    want = jwls.fast_global_smoother(jnp.asarray(a), jnp.asarray(guide),
                                     8000.0, 8.0, num_iter)
    np.testing.assert_allclose(got, np.asarray(want), **FGS_TOL)
    if num_iter == 3:
        pallas = fast_global_smoother_pallas(
            jnp.asarray(a)[None], jnp.asarray(guide), 8000.0, 8.0,
            num_iter=num_iter, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas)[0], **FGS_TOL)


def test_edge_weights_match_jax():
    rng = np.random.default_rng(5)
    g = rng.uniform(0, 255, (13, 19)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_allclose(
            twls._edge_weights(torch.from_numpy(g), axis, 1.2).numpy(),
            np.asarray(jwls._edge_weights(jnp.asarray(g), axis, 1.2)),
            # exp rounds differently by an ulp, and XLA flushes subnormal
            # results to zero
            rtol=1e-6, atol=1.2e-38)


@pytest.mark.parametrize("with_confidence", [False, True])
def test_wls_filter_disparity_matches_jax(with_confidence):
    rng = np.random.default_rng(7)
    H, W = 24, 56
    d = (8.0 + rng.normal(0, 0.5, (H, W))).astype(np.float32)
    d[:, 30:] += 12.0
    d[rng.uniform(size=d.shape) < 0.2] = np.nan
    guide = rng.uniform(0, 255, (H, W)).astype(np.float32)
    guide[:, 30:] += 100.0
    conf = rng.uniform(0, 1, (H, W)).astype(np.float32) \
        if with_confidence else None
    got = twls.wls_filter_disparity(
        torch.from_numpy(d), torch.from_numpy(guide), 80000.0, 1.2, 3,
        confidence=None if conf is None else torch.from_numpy(conf))
    want = jwls.wls_filter_disparity(
        jnp.asarray(d), jnp.asarray(guide), lmbda=80000.0, sigma_color=1.2,
        num_iter=3, confidence=None if conf is None else jnp.asarray(conf))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FGS_TOL)


def test_wls_fills_invalids():
    d = np.full((20, 30), 8.0, np.float32)
    d[5:10, 5:15] = np.nan
    out = twls.wls_filter_disparity(torch.from_numpy(d),
                                    torch.full((20, 30), 100.0), 100.0, 5.0)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), 8.0, atol=0.2)


def _step_views(H=40, W=120):
    dl = np.full((H, W), 10.0, np.float32)
    dl[:, 60:] = 30.0
    dr = np.full((H, W), 10.0, np.float32)
    dr[:, 30:] = 30.0
    return dl, dr


@pytest.mark.parametrize("case", ["step", "lrc_broken", "noisy"])
def test_wls_confidence_cv2_matches_jax(case):
    """tests/test_refine.py:270-307, and a noisy map with NaNs."""
    dl, dr = _step_views()
    if case == "lrc_broken":
        dr[:, :20] = 22.0
        dl[5, 30] = np.nan
    elif case == "noisy":
        rng = np.random.default_rng(9)
        dl = rng.uniform(0, 40, (30, 70)).astype(np.float32)
        dr = rng.uniform(0, 40, (30, 70)).astype(np.float32)
        dl[rng.uniform(size=dl.shape) < 0.3] = np.nan
        dr[rng.uniform(size=dr.shape) < 0.1] = np.nan
    for radius in (3, 7):
        got = twls.wls_confidence_cv2(torch.from_numpy(dl),
                                      torch.from_numpy(dr),
                                      discontinuity_radius=radius)
        want = jwls.wls_confidence_cv2(jnp.asarray(dl), jnp.asarray(dr),
                                       discontinuity_radius=radius)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "step":
        got = twls.wls_confidence_cv2(torch.from_numpy(dl),
                                      torch.from_numpy(dr),
                                      discontinuity_radius=3).numpy()
        assert got[:, :35].min() == 1.0 and got[:, 70:].min() == 1.0
        assert got[:, 42:58].max() == 0.0 and got[:, 58:62].max() == 0.0


def test_wls_confidence_even_count_median():
    """An even count of valid pixels whose two middle values differ: the
    fill is their mean (jnp.nanmedian), which decides the discontinuity
    test here; torch.nanmedian would take the lower one."""
    H, W = 6, 20
    dl = np.full((H, W), np.nan, np.float32)
    dl[:3, :10] = 2.0                   # 30 valid at 2, 30 valid at 14
    dl[3:, 10:] = 14.0
    dr = np.full((H, W), 2.0, np.float32)
    dr[3:, :6] = 14.0                   # both regions LR-consistent
    assert float(twls._nanmedian(torch.from_numpy(dl))) == 8.0
    assert float(torch.nanmedian(torch.from_numpy(dl))) == 2.0
    got = twls.wls_confidence_cv2(torch.from_numpy(dl), torch.from_numpy(dr),
                                  discontinuity_radius=1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jwls.wls_confidence_cv2(
            jnp.asarray(dl), jnp.asarray(dr), discontinuity_radius=1)))
    assert got[3, 12] == 1.0      # 14 beside the fill 8: smooth; beside 2: not
    assert torch.isnan(twls._nanmedian(torch.full((3, 3), float("nan"))))


def test_lr_confidence_and_window_extrema_match_jax():
    rng = np.random.default_rng(4)
    dl = rng.uniform(0, 8, (12, 40)).astype(np.float32)
    dr = rng.uniform(0, 8, (12, 40)).astype(np.float32)
    np.testing.assert_allclose(
        twls.lr_confidence(torch.from_numpy(dl), torch.from_numpy(dr),
                           1.0).numpy(),
        np.asarray(jwls.lr_confidence(jnp.asarray(dl), jnp.asarray(dr), 1.0)),
        rtol=0, atol=1e-6)
    for r in (0, 1, 4):
        for got, want in zip(twls._window_extrema(torch.from_numpy(dl), r),
                             jwls._window_extrema(jnp.asarray(dl), r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- the matcher ----

def _scene(H, W, d_max, seed=1):
    gt = tsynthetic.slanted_scene(H, W, 2.0, d_max)
    left, right = tsynthetic.random_dot_pair(H, W, gt, blur=1.0, seed=seed)
    return left.astype(np.float32), right.astype(np.float32), gt


@pytest.mark.parametrize("kw", [
    dict(speckle_window_size=30, speckle_range=2),
    dict(speckle_window_size=30, speckle_range=2, wls_lr_confidence=True,
         wls_iters=2, lmbda=8000.0)])
def test_post_stack_matches_jax(kw):
    """The headline path with speckle and WLS on: raw bit-equal, filtered
    within the smoother's bound."""
    left, right, _ = _scene(40, 128, 30.0)
    left[10:14, 40:44] = 255.0        # a patch that matches as a speckle
    cfg = DisparityConfig(num_disparities=48, wls=True, **kw)
    want_raw, want_f = jstereo._match_core(jnp.asarray(left),
                                           jnp.asarray(right), cfg)
    raw, filtered = tstereo._match_core(torch.from_numpy(left),
                                        torch.from_numpy(right), cfg)
    _assert_same_disparity(raw, want_raw)
    assert torch.isfinite(filtered).all()
    np.testing.assert_allclose(filtered.numpy(), np.asarray(want_f),
                               **FGS_TOL)
    assert float((filtered - raw).abs().nanmedian()) < 0.5


def test_default_config_matches_jax():
    """DisparityConfig() as it stands: settings.ini's D=160 with WLS at
    lambda 80000, sigma 1.2, three iterations. int16 raw equal, filtered
    within one sixteenth of a pixel."""
    left, right, _ = _scene(24, 192, 40.0, seed=2)
    want = jstereo.compute_disparity(left, right)
    got = tstereo.compute_disparity(left, right, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == np.int16
    assert np.abs(got[1].astype(int) - want[1].astype(int)).max() <= 1
    raw, filtered = tstereo.StereoMatcher(device="cpu")(left, right)
    assert (tstereo.StereoMatcher(device="cpu").config == DisparityConfig()
            and DisparityConfig().wls)
    np.testing.assert_array_equal(raw.isnan().numpy(), got[0] == -16)
    assert torch.isfinite(filtered).all()


def test_batched_with_post_stack():
    left, right, _ = _scene(32, 96, 20.0)
    cfg = DisparityConfig(num_disparities=32, speckle_window_size=20,
                          wls_iters=2)
    matcher = tstereo.StereoMatcher(cfg, device="cpu")
    raw, filtered = matcher.batched(np.stack([left, left]),
                                    np.stack([right, right]))
    one_raw, one_filtered = matcher(left, right)
    assert torch.equal(filtered[1], one_filtered)
    _assert_same_disparity(raw[0], one_raw)
