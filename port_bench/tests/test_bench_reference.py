"""The plain reference against numpy loops written from the equations."""

import numpy as np
import pytest
import torch

from port_bench import manifest
from port_bench.reference import disparity_maps, maps_for
from port_bench.reference.census import INVALID, census_volume
from port_bench.reference.mccnn import (features, load_tower, mccnn_volume,
                                        tf32)
from port_bench.reference.sgm import DIRECTIONS, sgm_total
from port_bench.reference.wta import winner_take_all

WEIGHTS = manifest.ROOT / "stereo_match_tpu/models/weights/mccnn_accurate.npz"


def loop_census(left, right, D, window=(5, 5)):
    H, W = left.shape
    ry, rx = window[0] // 2, window[1] // 2

    def bits(img, y, x):
        out = []
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                if dy or dx:
                    yy = min(max(y + dy, 0), H - 1)
                    xx = min(max(x + dx, 0), W - 1)
                    out.append(img[yy, xx] < img[y, x])
        return np.array(out)

    vol = np.full((D, H, W), INVALID)
    for y in range(H):
        for x in range(W):
            for d in range(min(D, x + 1)):
                vol[d, y, x] = np.sum(bits(left, y, x)
                                      != bits(right, y, x - d))
    return vol


def loop_sgm(cost, p1, p2):
    D, H, W = cost.shape
    total = np.zeros_like(cost)
    for dy, dx in DIRECTIONS:
        L = np.zeros_like(cost)
        ys = range(H) if dy >= 0 else range(H - 1, -1, -1)
        xs = list(range(W) if dx >= 0 else range(W - 1, -1, -1))
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if 0 <= py < H and 0 <= px < W:
                    prev = L[:, py, px]
                else:
                    prev = np.zeros(D)
                m = prev.min()
                best = np.empty(D)
                for d in range(D):
                    cands = [prev[d], m + p2]
                    if d > 0:
                        cands.append(prev[d - 1] + p1)
                    if d < D - 1:
                        cands.append(prev[d + 1] + p1)
                    best[d] = min(cands)
                L[:, y, x] = cost[:, y, x] + best - m
        total += L
    return total


def loop_wta(total, uniqueness, disp12):
    D, H, W = total.shape
    right = np.empty((H, W))
    for y in range(H):
        for xr in range(W):
            ds = [d for d in range(D) if xr + d < W]
            costs = [total[d, y, xr + d] for d in ds]
            right[y, xr] = ds[int(np.argmin(costs))]
    out = np.full((H, W), np.nan)
    for y in range(H):
        for x in range(W):
            c = total[:, y, x]
            i = int(np.argmin(c))
            disp = float(i)
            if 0 < i < D - 1:
                den = c[i - 1] - 2 * c[i] + c[i + 1]
                if den > 1e-9:
                    disp += float(np.clip((c[i - 1] - c[i + 1]) / (2 * den),
                                          -0.5, 0.5))
            others = [c[d] for d in range(D) if abs(d - i) > 1]
            if others and not min(others) * 100 > c[i] * (100 + uniqueness):
                continue
            xr = int(np.round(x - disp))
            if 0 <= xr < W and abs(disp - right[y, xr]) <= disp12:
                out[y, x] = disp
    return out


@pytest.fixture
def pair():
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (6, 11)).astype(np.float32)
    right = np.roll(left, -2, axis=1)
    right[:, -2:] = rng.integers(0, 256, (6, 2))
    return left, right


def test_census_volume(pair):
    left, right = pair
    got = census_volume(torch.from_numpy(left)[None],
                        torch.from_numpy(right)[None], 5, 0, (5, 5),
                        torch.float32)[0].numpy()
    np.testing.assert_array_equal(got, loop_census(left, right, 5))


def test_sgm_total(pair):
    vol = loop_census(*pair, 5)
    got = sgm_total(torch.from_numpy(vol).float()[None], 8.0, 96.0)[0]
    np.testing.assert_array_equal(got.numpy(), loop_sgm(vol, 8.0, 96.0))


def test_winner_take_all(pair):
    total = loop_sgm(loop_census(*pair, 5), 8.0, 96.0)
    got = winner_take_all(torch.from_numpy(total).float()[None], 0, 15, 1,
                          True)[0].numpy()
    want = loop_wta(total, 15, 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               atol=1e-5)


def test_census_maps_end_to_end(pair):
    left, right = pair
    cfg = {"cost": "census", "num_disparities": 5, "min_disparity": 0,
           "census_window": [5, 5], "num_paths": 8, "p1": None, "p2": None,
           "uniqueness_ratio": 15, "disp12_max_diff": 1, "subpixel": True}
    got = disparity_maps(left[None], right[None], cfg, "cpu")[0]
    want = loop_wta(loop_sgm(loop_census(left, right, 5), 8.0, 96.0), 15, 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               atol=1e-5)


def loop_tower(img, layers):
    x = ((img - img.mean()) / (img.std() + 1e-6))[None].astype(np.float64)
    for i, (w, b) in enumerate(layers):
        w, b = w.numpy().astype(np.float64), b.numpy().astype(np.float64)
        C, H, W = x.shape
        pad = np.zeros((C, H + 2, W + 2))
        pad[:, 1:-1, 1:-1] = x
        y = np.empty((w.shape[0], H, W))
        for r in range(H):
            for c in range(W):
                y[:, r, c] = np.einsum("fcij,cij->f", w,
                                       pad[:, r:r + 3, c:c + 3]) + b
        x = np.maximum(y, 0) if i < len(layers) - 1 else y
    return x / np.sqrt((x * x).sum(0, keepdims=True) + 1e-12)


def test_mccnn_tower_and_band(pair):
    left, right = (a[:4, :7] for a in pair)
    layers = load_tower(WEIGHTS, "cpu")
    assert [tuple(w.shape) for w, _ in layers] == \
        [(112, 1, 3, 3)] + [(112, 112, 3, 3)] * 4
    fl = loop_tower(left, layers)
    fr = loop_tower(right, layers)
    got = features(torch.from_numpy(left)[None], layers, False)[0].numpy()
    np.testing.assert_allclose(got, fl, atol=2e-5)
    vol = mccnn_volume(torch.from_numpy(left)[None],
                       torch.from_numpy(right)[None], layers, 4, 0, 24.0,
                       False)[0].numpy()
    for d in range(4):
        want = 24.0 * (1 - (fl[:, :, d:] * fr[:, :, :7 - d]).sum(0)) * 0.5
        np.testing.assert_allclose(vol[d, :, d:], want, atol=1e-4)
        assert (vol[d, :, :d] == INVALID).all()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.0 - 2 ** -12])
    np.testing.assert_array_equal(
        tf32(x).numpy(), [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -3.0])


def test_match_refuses_what_it_does_not_compute(pair):
    """The raw map is speckle-filtered when the configuration asks: the
    ``match`` reference has no filter and refuses rather than differ."""
    left, right = pair
    cfg = {"cost": "census", "num_disparities": 5, "min_disparity": 0,
           "census_window": [5, 5], "num_paths": 8, "p1": None, "p2": None,
           "uniqueness_ratio": 15, "disp12_max_diff": 1, "subpixel": True,
           "speckle_window_size": 100}
    with pytest.raises(ValueError, match="speckle"):
        disparity_maps(left[None], right[None], cfg, "cpu")
    assert maps_for({"reference": "match"}) is disparity_maps
