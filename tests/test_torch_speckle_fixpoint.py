"""K5's plain model, ``speckle_fixpoint_plain``, against the JAX package.

The one-launch speckle filter (``csrc/speckle.cu``) reports its output, the
sweeps it ran and whether the last one still lowered a label. Its plain
model reports the same three. Here, on the CPU, the model's output is held
bit for bit to JAX's XLA ``speckle_filter`` and to ``speckle_filter_pallas``
in interpret mode, its sweep count to a serial walk written out in numpy,
and the kernel's decomposition of a sweep (a line in 32 segments folded
and fixed up, columns in bands with a carry) to the plain sweep.
Min is exact, so every comparison is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.ops import speckle as jspeckle
from stereo_match_tpu.ops.pallas_speckle import speckle_filter_pallas
from stereo_match_tpu_torch.data.speckle_maps import serpentine
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import speckle as tspeckle


def _assert_same_map(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def _speckled(H, W, seed):
    """A smooth slanted map with 2x2 and 4x4 outlier blobs and holes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:H, :W]
    d = (8.0 + 0.05 * x + 0.02 * y).astype(np.float32)
    for _ in range(max(1, H * W // 40)):
        s = int(rng.choice([2, 4]))
        y0, x0 = rng.integers(0, max(1, H - s + 1)), rng.integers(
            0, max(1, W - s + 1))
        d[y0:y0 + s, x0:x0 + s] = rng.uniform(0, 60)
    d[rng.uniform(size=d.shape) < 0.05] = np.nan
    return d


def _numpy_fixpoint(d, max_diff, max_iters):
    """The reference's sweeps as serial loops: (labels, sweeps, changed)."""
    H, W = d.shape
    valid = np.isfinite(d)
    dv = np.where(valid, d, np.float32(np.inf)).astype(np.float32)
    tol = np.float32(max_diff)
    with np.errstate(invalid="ignore"):
        cx = np.zeros((H, W), bool)
        cx[:, 1:] = np.abs(dv[:, :-1] - dv[:, 1:]) <= tol
        cy = np.zeros((H, W), bool)
        cy[1:, :] = np.abs(dv[:-1, :] - dv[1:, :]) <= tol
    cx &= valid
    cy &= valid
    lab = np.where(valid, np.arange(H * W).reshape(H, W), H * W + 1)
    changed, sweeps = True, 0
    while changed and sweeps < max_iters:
        old = lab.copy()
        for x in range(1, W):
            lab[:, x] = np.where(cx[:, x], np.minimum(lab[:, x],
                                                      lab[:, x - 1]),
                                 lab[:, x])
        for x in range(W - 2, -1, -1):
            lab[:, x] = np.where(cx[:, x + 1], np.minimum(lab[:, x],
                                                          lab[:, x + 1]),
                                 lab[:, x])
        for y in range(1, H):
            lab[y] = np.where(cy[y], np.minimum(lab[y], lab[y - 1]), lab[y])
        for y in range(H - 2, -1, -1):
            lab[y] = np.where(cy[y + 1], np.minimum(lab[y], lab[y + 1]),
                              lab[y])
        changed = bool((lab != old).any())
        sweeps += 1
    return lab, sweeps, changed


def _check_fixpoint(d, T, max_diff, max_iters=64, pallas=True):
    """The model against XLA, Pallas (interpret) and the serial sweeps;
    returns (sweeps, unconverged)."""
    out, sweeps, unconverged = K.speckle_fixpoint_plain(
        torch.from_numpy(d), T, max_diff, max_iters)
    _assert_same_map(out, jspeckle.speckle_filter(
        jnp.asarray(d), T, max_diff, max_iters=max_iters))
    if pallas:
        _assert_same_map(out, speckle_filter_pallas(
            jnp.asarray(d), T, max_diff, max_iters=max_iters,
            interpret=True))
    _, n, changed = _numpy_fixpoint(d, max_diff, max_iters)
    assert (sweeps, unconverged) == (n, changed)
    got, stats = K.speckle_filter(torch.from_numpy(d), T, max_diff,
                                  max_iters)
    _assert_same_map(got, out)
    assert stats.tolist() == [sweeps, int(unconverged)]
    return sweeps, unconverged


@pytest.mark.parametrize("H,W,seed", [(2, 2, 0), (4, 4, 1), (24, 70, 2),
                                      (37, 33, 3), (16, 129, 4)])
@pytest.mark.parametrize("T", [3, 20])
def test_fixpoint_random_speckles(H, W, seed, T):
    _check_fixpoint(_speckled(H, W, seed), T, 2.0)


@pytest.mark.parametrize("H,W", [(12, 20), (16, 33)])
def test_fixpoint_serpentine_cap(H, W):
    """At max_iters = k the serpentine converges into one component,
    which T removes; at k - 1 the last sweep still lowered a label and the
    filter keeps every valid pixel."""
    d = serpentine(H, W)
    k, unconverged = _check_fixpoint(d, 10 ** 6, 1.0)
    assert k >= 3 and not unconverged
    assert _check_fixpoint(d, 10 ** 6, 1.0, max_iters=k) == (k, False)
    assert _check_fixpoint(d, 10 ** 6, 1.0, max_iters=k - 1) == (k - 1, True)
    kept = K.speckle_fixpoint_plain(torch.from_numpy(d), 10 ** 6, 1.0,
                                    k - 1)[0]
    np.testing.assert_array_equal(np.isfinite(kept.numpy()), np.isfinite(d))
    assert torch.isnan(K.speckle_fixpoint_plain(
        torch.from_numpy(d), 10 ** 6, 1.0, k)[0]).all()


@pytest.mark.parametrize("case", ["all_nan", "row", "column", "infinities",
                                  "one_pixel"])
def test_fixpoint_edge_maps(case):
    rng = np.random.default_rng(5)
    d = {"all_nan": np.full((9, 13), np.nan, np.float32),
         "row": _speckled(1, 150, 6),
         "column": _speckled(90, 1, 7),
         "infinities": _speckled(12, 40, 8),
         "one_pixel": np.full((1, 1), 3.0, np.float32)}[case]
    if case == "infinities":
        d[rng.uniform(size=d.shape) < 0.1] = np.inf
        d[rng.uniform(size=d.shape) < 0.1] = -np.inf
    for T in (1, 2, 5):
        sweeps, unconverged = _check_fixpoint(d, T, 2.0, pallas=T == 2)
        assert sweeps >= 1 and not unconverged
    if case == "all_nan":
        assert _check_fixpoint(d, 3, 2.0, pallas=False) == (1, False)


@pytest.mark.parametrize("seed", [0, 1])
def test_fixpoint_exact_ties(seed):
    """Disparities on a 0.5 grid with max_diff 0.5: neighbours exactly
    0.5 apart are connected (<=), 1.0 apart not."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 4, (20, 36)) * 0.5 + 10).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.1] = np.nan
    for T in (2, 6, 15):
        _check_fixpoint(d, T, 0.5, pallas=T == 6)


def test_fixpoint_infinite_max_diff_counts_valid_pixels():
    """With max_diff = inf an invalid pixel compares as inf <= inf and can
    take a component's label; the reference counts valid pixels only
    (segment_sum of valid), and so do the plain count and K5's."""
    rng = np.random.default_rng(0)
    for _ in range(10):
        d = rng.normal(10, 3, (6, 7)).astype(np.float32)
        d[rng.uniform(size=d.shape) < 0.4] = np.nan
        for T in (2, 4, 6):
            _check_fixpoint(d, T, float("inf"), pallas=False)


def test_filter_plain_flag_and_disabled():
    d = _speckled(20, 40, 9)
    t = torch.from_numpy(d)
    assert tspeckle.speckle_filter(t, 0, 2.0) is t
    _assert_same_map(tspeckle.speckle_filter(t, 10, 2.0),
                     K.speckle_fixpoint_plain(t, 10, 2.0, 64)[0])
    _assert_same_map(tspeckle.speckle_filter(t.double(), 10, 2.0),
                     jspeckle.speckle_filter(jnp.asarray(d), 10, 2.0))


# ------------------------------------- the kernel's decomposition of a sweep

BIG = np.iinfo(np.int32).max


def _line_scan(vals, joins, forward, lanes, carry, tail_join=False):
    """One direction of K5's scan of a line (a list of labels, in place):
    ``lanes`` segments of odd length scanned alone, their ends folded in
    scan order from ``carry``, and each segment's head fixed up until the
    fold stops lowering a label. ``joins[i]``: element i joins i - 1; in
    reverse, element n - 1 joins the carry when ``tail_join``."""
    n = len(vals)
    seg = -(-n // lanes) | 1

    def elems(lane):
        a = min(n, lane * seg)
        b = min(n, a + seg)
        return range(a, b) if forward else range(b - 1, a - 1, -1)

    def join(i):
        if forward:
            return joins[i]
        return joins[i + 1] if i + 1 < n else tail_join

    ends = []
    for lane in range(lanes):                # each segment alone
        run, cut = BIG, False
        for i in elems(lane):
            if join(i):
                vals[i] = min(vals[i], run)
            else:
                cut = True
            run = vals[i]
        ends.append((run, cut))
    c = carry
    for lane in (range(lanes) if forward else reversed(range(lanes))):
        for i in elems(lane):                # the fold into the head
            if not join(i) or c >= vals[i]:
                break
            vals[i] = c
        end, cut = ends[lane]
        c = end if cut else min(c, end)


def _kernel_sweep(lab, conn, lanes, band):
    """A sweep as K5 runs it: each row forward then reverse; each column
    in bands of ``band`` rows, forward top band first with the carry from
    the band above, then reverse bottom band first."""
    H, W = lab.shape
    left = (conn & K.CONN_LEFT) != 0
    up = (conn & K.CONN_UP) != 0
    for y in range(H):
        row = list(lab[y])
        _line_scan(row, left[y], True, lanes, BIG)
        _line_scan(row, left[y], False, lanes, BIG)
        lab[y] = row
    bands = [(b0, min(band, H - b0)) for b0 in range(0, H, band)]
    for x in range(W):
        col = list(lab[:, x])
        carry = BIG
        for b0, n in bands:
            part = col[b0:b0 + n]
            _line_scan(part, up[b0:b0 + n, x], True, lanes, carry)
            if len(bands) == 1:
                _line_scan(part, up[:, x], False, lanes, BIG)
            col[b0:b0 + n] = part
            carry = part[-1]
        if len(bands) > 1:
            carry = BIG
            for b0, n in reversed(bands):
                part = col[b0:b0 + n]
                tail = b0 + n < H and bool(up[b0 + n, x])
                _line_scan(part, up[b0:b0 + n, x], False, lanes, carry,
                           tail)
                col[b0:b0 + n] = part
                carry = part[0]
        lab[:, x] = col


@pytest.mark.parametrize("H,W,lanes,band", [
    (24, 70, 32, 1551), (37, 33, 4, 7), (5, 100, 32, 1551),
    (1, 65, 32, 1551), (64, 1, 32, 1551), (50, 17, 4, 8), (12, 20, 4, 5),
    (40, 9, 3, 6)])
def test_kernel_decomposition_matches_plain_sweep(H, W, lanes, band):
    """The carries K5 passes between a line's segments and a column's bands
    give the plain sweep's labels, sweep after sweep (the serpentine turns
    at both ends of its rows; the speckled map has breaks everywhere)."""
    for d in (_speckled(H, W, H + W), serpentine(H, W),
              serpentine(W, H).T.copy()):
        t = torch.from_numpy(d)
        conn = K.connectivity(t, 2.0)
        lin = torch.arange(H * W, dtype=torch.int32).view(H, W)
        plain = torch.where(torch.isfinite(t), lin, H * W + 1).to(
            torch.int32)
        model = plain.numpy().astype(np.int64)
        changed = True
        while changed:
            changed = bool(K.speckle_sweep_plain(plain, conn))
            _kernel_sweep(model, conn.numpy(), lanes, band)
            np.testing.assert_array_equal(model, plain.numpy())
