"""K7's partitioned tridiagonal solve, held on the CPU before a card sees it.

The card's K7 (``csrc/wls.cu``) splits each line of the WLS smoother into
segments and takes every pivot from a right-hand side of ones; its plain
torch model, ``fgs_solve_partitioned_plain``, does the same operations in
the same order, and the kernel is held to it bit for bit on the card
(``tests/test_torch_cuda.py``). Here the model is held to the JAX package
(``stereo_match_tpu/ops/wls.py``) at the tolerances its own tests use for
the Pallas solve, and to a float64 solve at the first lambda of
settings.ini's schedule: its error there may be at most twice the
sequential float32 solve's. The sequential plain solve along the rows and
the transpose-free ``_fgs_stack`` must equal the transposed calls they
replaced, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.ops import wls as jwls
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import wls as twls

FGS_TOL = dict(rtol=1e-3, atol=2e-4)       # tests/test_refine.py:214
LAM0 = twls._lambda_schedule(80000.0, 3)[0]   # 30476.19, settings.ini


def _solve64(f, wp, wn, lam, axis):
    return K.fgs_solve_plain(f.double(), wp.double(), wn.double(), lam, axis)


def _max_err(u, ref):
    return float((u.double() - ref).abs().max())


def _refine_rows(seed):
    """tests/test_refine.py:175-193's inputs: 21 rows of 45, lambda 190.476."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(21, 45)).astype(np.float32)
    w = rng.uniform(0, 1, (21, 44)).astype(np.float32)
    return f, w, np.float32(190.476)


@pytest.mark.parametrize("segments", [1, 3, 4, 5, 16, 32])
@pytest.mark.parametrize("axis", [0, 1])
def test_partitioned_matches_jax(axis, segments):
    """As tests/test_refine.py holds the Pallas solve to the lax.scan one."""
    f, w, lam = _refine_rows(0)
    want = np.asarray(jwls._tridiagonal_smooth_rows(
        jnp.asarray(f), jnp.asarray(w), jnp.float32(lam)))
    wp, wn = twls._scan_weights(torch.from_numpy(w), 1)
    slab = torch.from_numpy(f)[None]
    if axis == 0:   # the same lines as columns
        slab, wp, wn = (t.transpose(-1, -2).contiguous()
                        for t in (slab, wp, wn))
    got = K.fgs_solve_partitioned_plain(slab, wp, wn, float(lam), axis,
                                        segments)[0]
    if axis == 0:
        got = got.T
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("seed", range(5))
def test_partitioned_is_closer_to_float64_than_jax(seed):
    """Both against a float64 solve: the model's pivots do not cancel, so
    its error is below the JAX package's float32 Thomas solve's."""
    f, w, lam = _refine_rows(seed)
    jax_u = torch.from_numpy(np.array(jwls._tridiagonal_smooth_rows(
        jnp.asarray(f), jnp.asarray(w), jnp.float32(lam))))[None]
    wp, wn = twls._scan_weights(torch.from_numpy(w), 1)
    slab = torch.from_numpy(f)[None]
    u64 = _solve64(slab, wp, wn, float(lam), 1)
    for segments in (1, 4, 32):
        got = K.fgs_solve_partitioned_plain(slab, wp, wn, float(lam), 1,
                                            segments)
        assert _max_err(got, u64) <= _max_err(jax_u, u64)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("S,segments", [
    (1, 16), (1, 32),          # one unknown a line: padding only
    (2, 16), (3, 32), (5, 16),  # fewer unknowns than segments
    (7, 4), (33, 16), (100, 7),  # segments that do not divide S
    (64, 32), (375, 16), (1242, 32)])
def test_partitioned_float64_bound(axis, C, S, segments):
    """At lambda_0 of settings.ini the error against a float64 solve is at
    most twice the sequential float32 solve's, along both axes."""
    rng = np.random.default_rng(S * 100 + segments)
    N = 13
    shape = (S, N) if axis == 0 else (N, S)
    f = torch.from_numpy(rng.uniform(0, 60, (C, *shape)).astype(np.float32))
    guide = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    wp, wn = twls._scan_weights(twls._edge_weights(guide, axis, 8.0), axis)
    u64 = _solve64(f, wp, wn, LAM0, axis)
    plain = _max_err(K.fgs_solve_plain(f, wp, wn, LAM0, axis), u64)
    got = K.fgs_solve_partitioned_plain(f, wp, wn, LAM0, axis, segments)
    assert got.shape == f.shape and torch.isfinite(got).all()
    assert _max_err(got, u64) <= 2 * plain


def test_partitioned_shares_elimination_exactly():
    """C = 2 right-hand sides give what two solves of their own give."""
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.uniform(0, 60, (2, 23, 71)).astype(np.float32))
    wp, wn = twls._scan_weights(torch.from_numpy(
        rng.uniform(0, 1, (23, 70)).astype(np.float32)), 1)
    both = K.fgs_solve_partitioned_plain(f, wp, wn, LAM0, 1)
    for c in range(2):
        one = K.fgs_solve_partitioned_plain(f[c:c + 1], wp, wn, LAM0, 1)
        assert torch.equal(both[c], one[0])


@pytest.mark.parametrize("with_confidence", [False, True])
def test_wls_filter_with_partitioned_solve_matches_jax(with_confidence):
    """The whole filter on the model, against JAX's (tests/test_torch_post's
    inputs and tolerance, that of a composed schedule)."""
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
        confidence=None if conf is None else torch.from_numpy(conf),
        solve=K.fgs_solve_partitioned_plain)
    want = jwls.wls_filter_disparity(
        jnp.asarray(d), jnp.asarray(guide), lmbda=80000.0, sigma_color=1.2,
        num_iter=3, confidence=None if conf is None else jnp.asarray(conf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FGS_TOL)


@pytest.mark.parametrize("H,W,num_iter", [(21, 45, 3), (9, 130, 2)])
def test_fgs_stack_with_partitioned_solve_matches_jax(H, W, num_iter):
    rng = np.random.default_rng(3)
    guide = rng.uniform(0, 255, (H, W)).astype(np.float32)
    a = rng.normal(size=(H, W)).astype(np.float32)
    got = twls._fgs_stack(torch.from_numpy(a)[None], torch.from_numpy(guide),
                          8000.0, 8.0, num_iter,
                          solve=K.fgs_solve_partitioned_plain)[0]
    want = jwls.fast_global_smoother(jnp.asarray(a), jnp.asarray(guide),
                                     8000.0, 8.0, num_iter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FGS_TOL)


def _transposed_scan_weights(w):
    """The (S-1, N) -> (S, N) weights of the transposed layout."""
    z = torch.zeros_like(w[:1])
    return torch.cat([z, w]).contiguous(), torch.cat([w, z]).contiguous()


def test_plain_rows_equal_the_transposed_call():
    """fgs_solve_plain along axis 1 is the column solve of the transpose,
    with the transposed weights, bit for bit."""
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.uniform(0, 60, (2, 17, 90)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 1, (17, 89)).astype(np.float32))
    wp, wn = twls._scan_weights(w, 1)
    got = K.fgs_solve_plain(f, wp, wn, LAM0, 1)
    twp, twn = _transposed_scan_weights(w.T)
    want = K.fgs_solve_plain(f.transpose(1, 2).contiguous(), twp, twn, LAM0,
                             0).transpose(1, 2)
    assert torch.equal(got, want)
    assert torch.equal(wp, twp.T) and torch.equal(wn, twn.T)


@pytest.mark.parametrize("num_iter", [1, 3])
def test_fgs_stack_equals_the_transposed_stack(num_iter):
    """The transpose-free smoother equals the one that solved the rows on
    a (C, W, H) transpose (the layout of the TPU kernel), on the CPU."""
    rng = np.random.default_rng(5)
    H, W = 19, 61
    guide = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    srcs = torch.from_numpy(rng.uniform(0, 60, (2, H, W)).astype(np.float32))
    got = twls._fgs_stack(srcs, guide, 80000.0, 1.2, num_iter)
    wxp, wxn = _transposed_scan_weights(twls._edge_weights(guide, 1, 1.2).T)
    wyp, wyn = _transposed_scan_weights(twls._edge_weights(guide, 0, 1.2))
    u = srcs
    for lam in twls._lambda_schedule(80000.0, num_iter):
        u = K.fgs_solve_plain(u.transpose(1, 2).contiguous(), wxp, wxn, lam,
                              0)
        u = K.fgs_solve_plain(u.transpose(1, 2).contiguous(), wyp, wyn, lam,
                              0)
    assert torch.equal(got, u)


def test_solve_arguments_are_checked():
    f = torch.zeros((1, 4, 6))
    wp, wn = twls._scan_weights(torch.zeros((4, 5)), 1)
    with pytest.raises(ValueError):
        K.fgs_solve(f, wp, wn, 1.0, 2)
    with pytest.raises(ValueError):
        K.fgs_solve_partitioned_plain(f, wp, wn, 1.0, 1, 0)
    assert torch.equal(K.fgs_solve(f, wp, wn, 1.0, 1), f)
