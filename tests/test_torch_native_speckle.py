"""The port's host speckle filter against the JAX package's, on the CPU.

``native.speckle_filter_host`` runs the C++ union-find of
``native/smt_native.cpp`` (a byte copy of the JAX package's source) and,
without the library, the plain speckle filter on the CPU, as JAX's falls
back to its XLA filter. Each path is held to its JAX counterpart bit for
bit: the same NaN pixels and the same bits elsewhere, on JAX's own map
(``tests/test_elas.py::test_host_speckle_filter``), random speckled maps,
maps with NaN and +-inf, and at ``max_diff`` = inf.
"""

import numpy as np
import pytest

from stereo_match_tpu import native as jnative
from stereo_match_tpu_torch import native as tnative


def _maps():
    """(name, map, max_speckle_size, max_diff) cases."""
    d = np.full((30, 40), 10.0, np.float32)
    d[5:7, 5:7] = 50.0                          # JAX's own map
    yield "jax", d, 20, 2.0
    rng = np.random.default_rng(7)
    for k in range(3):
        ramp = np.linspace(0.0, 60.0, 64, dtype=np.float32)[None, :]
        m = np.repeat(ramp, 48, axis=0) + rng.normal(0, 0.3, (48, 64)) \
            .astype(np.float32)
        for _ in range(25):                     # blobs of 1 to 12 pixels
            y, x = rng.integers(0, 46), rng.integers(0, 62)
            h, w = rng.integers(1, 4), rng.integers(1, 5)
            m[y:y + h, x:x + w] = rng.uniform(0, 90)
        m[rng.random((48, 64)) < 0.05] = np.nan
        yield f"speckled{k}", m.astype(np.float32), 10 + 5 * k, 1.0 + k
    m = np.full((30, 40), 5.0, np.float32)
    m[2:4, 2:5] = np.inf
    m[10:12, 20:22] = -np.inf
    m[15, :] = np.nan
    m[20:22, 3:6] = 40.0
    yield "inf", m, 8, 2.0
    yield "inf max_diff=inf", m, 8, np.inf
    yield "jax max_diff=inf", d, 20, np.inf


CASES = list(_maps())


def _assert_same(got: np.ndarray, want: np.ndarray) -> None:
    """The same NaN pixels and the same bits everywhere else."""
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("name,d,size,max_diff", CASES,
                         ids=[c[0] for c in CASES])
def test_speckle_filter_host_matches_jax(name, d, size, max_diff):
    """With the C++ library in both packages."""
    assert tnative.available() and jnative.available()
    before = d.copy()
    got = tnative.speckle_filter_host(d, size, max_diff)
    _assert_same(got, jnative.speckle_filter_host(d, size, max_diff))
    np.testing.assert_array_equal(d.view(np.uint32), before.view(np.uint32))
    if name == "jax":                           # JAX's own assertions
        assert np.isnan(got[5:7, 5:7]).all()
        assert np.isfinite(got[15:, 15:]).all()


@pytest.mark.parametrize("name,d,size,max_diff", CASES,
                         ids=[c[0] for c in CASES])
def test_speckle_filter_host_without_the_library(monkeypatch, name, d, size,
                                                 max_diff):
    """With the library forced unavailable: the port's plain filter on the
    CPU against JAX's XLA filter."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    got = tnative.speckle_filter_host(d, size, max_diff)
    assert isinstance(got, np.ndarray)
    _assert_same(got, jnative.speckle_filter_host(d, size, max_diff))
