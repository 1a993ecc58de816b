"""ELAS-style matching (PyTorch): support points -> triangulated prior ->
banded dense matching.

Counterpart of ``stereo_match_tpu/pipeline/elas.py``, the JAX package's
replacement of the reference's libelas. A sparse set of confidently matched
support points on a grid is triangulated (Delaunay, on the host in C++:
``native/``), the piecewise-planar disparity prior that the triangles
induce restricts dense matching to a band around it, and rejected pixels
are refilled by ELAS's gap interpolation and a 3x3 median.

On the card: the census words of both views come from K1 (once, for both
stages); the support stage's row-strided volume (every ``grid_step``-th
row) from K2, its WTA statistics, right-view argmin and disp12 check from
K4's ``wta_stats``, ``right_wta`` and ``lr_mask``. The dense stage streams
the D planes as the JAX package does, with no (D, H, W) array: each plane's
Hamming cost is K2 at one disparity, the band-masked, prior-penalised
running WTA is plain torch on (H, W) maps, and its disp12 check is K4's
``lr_mask`` at the float ``lr_tol``. The prior's extension, the gap
interpolation and the median are plain torch. On the CPU every kernel runs
its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stereo_match_tpu_torch.native import delaunay, rasterize_planes
from stereo_match_tpu_torch.ops.cost_volume import check_min_disparity
from stereo_match_tpu_torch.ops.cuda_kernels import (census_volume,
                                                     census_words, lr_mask,
                                                     right_wta, wta_stats)
from stereo_match_tpu_torch.ops.filters import median_filter
from stereo_match_tpu_torch.ops.wls import _window_extrema
from stereo_match_tpu_torch.utils.backend import entry_device

_BIG = 1e9


@dataclass
class ElasConfig:
    grid_step: int = 5            # support-point candidate spacing
    support_ratio: float = 0.75   # best/2nd-best cost ratio for a support pt
    support_lr_tol: float = 1.0   # LR agreement required at support pts
    band_radius: int = 6          # dense search restricted to mu +- this
    band_pool_radius: int = 10    # widen the band by the local mu extrema
    prior_sigma: float = 2.0      # Gaussian width of the plane prior
    prior_weight: float = 6.0     # prior strength vs data cost (census bits)
    prior_trunc: float = 18.0     # truncation of the prior penalty
    min_support: int = 16         # fall back to plain WTA below this
    lr_tol: float = 2.0           # dense-stage LR consistency tolerance
    gap_max: int = 80             # widest gap the interpolation fills
    discont_jump: float = 5.0     # |dl-dr| above which fill = min (occlusion)
    visibility_thresh: float = 25.0  # gray levels: fg wins a discont. fill


def _census_pair(left: torch.Tensor, right: torch.Tensor,
                 window) -> torch.Tensor:
    """(2, nw, H, W) int32 census words of both views (K1)."""
    return census_words(torch.stack([left, right]).to(torch.float32)
                        .contiguous(), window)


def _support_scores(left, right, num_disparities: int, min_disparity: int = 0,
                    window=(5, 5), grid_step: int = 5, words=None):
    """Row-strided WTA and robustness statistics for support selection.

    The census words are full-resolution (``words``, or K1 on the images);
    the volume covers every ``grid_step``-th row only (K2). Returns
    ``(disp, ratio, lr_ok)`` on the strided rows g, 2g, ...: the WTA
    disparity, (best + 1) / (second + 1) with the second-best cost outside
    idx ± 1, and the disp12 check at tolerance 1 (K4).
    """
    check_min_disparity(min_disparity)
    if words is None:
        words = _census_pair(left, right, window)
    strided = words[:, :, grid_step::grid_step].contiguous()
    vol = census_volume(strided[0], strided[1], num_disparities,
                        min_disparity)
    best, idx, _, _, second = wta_stats(vol)
    ratio = (best + 1.0) / (second + 1.0)
    disp = (idx + min_disparity).to(torch.float32)
    disp_r = (right_wta(vol) + min_disparity).to(torch.float32)
    return disp, ratio, lr_mask(disp, disp_r, 1)


def extract_support_points(left, right, cfg: ElasConfig,
                           num_disparities: int, min_disparity: int = 0,
                           scores=None) -> np.ndarray:
    """Robust grid matches -> (n, 3) float64 array of (x, y, d) (host)."""
    if scores is None:
        scores = _support_scores(
            torch.as_tensor(left, dtype=torch.float32),
            torch.as_tensor(right, dtype=torch.float32), num_disparities,
            min_disparity, grid_step=cfg.grid_step)
    disp, ratio, lr_ok = (a.cpu().numpy() if torch.is_tensor(a)
                          else np.asarray(a) for a in scores)
    H, W = tuple(left.shape)
    g = cfg.grid_step
    rows = np.arange(disp.shape[0])          # strided row r -> y = (r+1)*g
    ys_full = (rows + 1) * g
    keep_r = ys_full < H - g
    xs = np.arange(g, W - g, g)
    rr, cc = np.meshgrid(rows[keep_r], xs, indexing="ij")
    ok = (ratio[rr, cc] < cfg.support_ratio) & lr_ok[rr, cc]
    return np.stack([cc[ok], (rr[ok] + 1) * g, disp[rr[ok], cc[ok]]],
                    axis=-1).astype(np.float64)


def _dense_banded(left, right, mu, num_disparities: int,
                  min_disparity: int = 0, window=(5, 5),
                  band_radius: int = 6, band_pool_radius: int = 10,
                  prior_weight: float = 6.0, prior_sigma: float = 2.0,
                  prior_trunc: float = 18.0, lr_tol: float = 2.0,
                  words=None) -> torch.Tensor:
    """Streaming band-masked prior WTA: no (D, H, W) volume.

    One pass over the disparity planes: each plane's Hamming cost (K2 at
    one disparity, 1e4 where x < d), the prior band mask and truncated
    quadratic penalty, and running (H, W) maps of the best, second and
    argmin of the banded total, its neighbours for the parabola, and the
    plain-cost argmin of the right view (read at x + d). Then the disp12
    check at ``lr_tol`` (K4 ``lr_mask``). ``mu`` is the (H, W) prior, NaN
    where there is none. Returns (H, W) float32, NaN where rejected.
    """
    check_min_disparity(min_disparity)
    if words is None:
        words = _census_pair(left, right, window)
    cl, cr = words[0], words[1]
    H, W = cl.shape[-2:]
    dev = cl.device
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    x = torch.arange(W, device=dev)[None, :]
    has_prior = torch.isfinite(mu)
    mu_s = torch.where(has_prior, mu, 0.0)
    # libelas widens each pixel's candidates by the disparities of its
    # support cell: at a discontinuity the interpolated plane passes
    # between the two surfaces, so the band takes the local mu extrema
    mu_lo, mu_hi = _window_extrema(mu_s, band_pool_radius)
    band_lo, band_hi = mu_lo - band_radius, mu_hi + band_radius
    sigma, weight, trunc = (torch.tensor(v, dtype=torch.float32, device=dev)
                            for v in (prior_sigma, prior_weight, prior_trunc))

    def full(value):
        return torch.full((H, W), value, dtype=torch.float32, device=dev)

    best, second, c0, c2, prev, best_r = (full(_BIG) for _ in range(6))
    idx = torch.zeros((H, W), dtype=torch.int32, device=dev)
    idx_r = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for i in range(num_disparities):
        d = min_disparity + i
        cost = census_volume(cl, cr, 1, d)[0]
        dd = float(d)
        pen = torch.minimum(((dd - mu_s) / sigma) ** 2, trunc)
        in_band = (~has_prior) | ((dd >= band_lo) & (dd <= band_hi))
        tot = torch.where(in_band,
                          cost + torch.where(has_prior, weight * pen, 0.0),
                          _BIG)
        improve = tot < best
        second = torch.where(improve, best, torch.minimum(second, tot))
        c0 = torch.where(improve, prev, c0)
        c2 = torch.where(improve, _BIG,
                         torch.where(idx + 1 == d, tot, c2))
        best = torch.where(improve, tot, best)
        idx = torch.where(improve, d, idx)
        prev = tot
        # right view: C_R(x, d) = C_L(x + d, d), the plain data cost
        cost_r = torch.where(x + d >= W, _BIG, torch.roll(cost, -d, -1))
        improve_r = cost_r < best_r
        best_r = torch.where(improve_r, cost_r, best_r)
        idx_r = torch.where(improve_r, d, idx_r)

    # parabola subpixel on the banded totals, only with two finite sides
    denom = c0 + c2 - 2.0 * best
    off = torch.where(denom > 1e-6, (c0 - c2) / (2.0 * denom), 0.0)
    off = off.clamp(-0.5, 0.5)
    off = torch.where((c0 < _BIG) & (c2 < _BIG), off, 0.0)
    disp = idx.to(torch.float32) + off
    ok = lr_mask(disp, idx_r.to(torch.float32), lr_tol) & (best < _BIG)
    return torch.where(ok, disp, torch.nan)


def _nearest_valid_scan(disp: torch.Tensor):
    """Per row, the nearest valid value at or left of every pixel and its
    distance: ``(value, dist)``, NaN and inf where the row has none yet."""
    valid = torch.isfinite(disp)
    W = disp.shape[-1]
    x = torch.arange(W, device=disp.device).expand_as(disp)
    last = torch.cummax(torch.where(valid, x, -1), dim=-1).values
    has = last >= 0
    value = disp.gather(-1, last.clamp(min=0))
    dist = torch.where(has, (x - last).to(torch.float32), torch.inf)
    return torch.where(has, value, torch.nan), dist


def _both_sides(d: torch.Tensor):
    """(vl, kl, vr, kr): the nearest valid value and its distance to the
    left and to the right of every pixel, along rows."""
    vl, kl = _nearest_valid_scan(d)
    vr, kr = _nearest_valid_scan(d.flip(-1))
    return vl, kl, vr.flip(-1), kr.flip(-1)


def _extend_prior(mu: torch.Tensor) -> torch.Tensor:
    """Fill NaN prior cells (outside the support hull) from the nearest
    rasterised values: linear between row neighbours where both exist,
    nearest otherwise; then the same down the columns."""
    def fill_axis(m):
        vl, kl, vr, kr = _both_sides(m)
        both = torch.isfinite(vl) & torch.isfinite(vr)
        lin = torch.where(both,
                          vl + (vr - vl) * kl / torch.clamp(kl + kr, min=1.0),
                          torch.where(torch.isfinite(vl), vl, vr))
        return torch.where(torch.isfinite(m), m, lin)

    mu = fill_axis(torch.as_tensor(mu, dtype=torch.float32))
    return fill_axis(mu.T).T.contiguous()


def gap_interpolate(disp, gap_max: int = 80, discont_jump: float = 5.0,
                    images=None, visibility_thresh: float = 25.0):
    """ELAS gap filling along rows (libelas ``gapInterpolation``).

    Invalid runs up to ``gap_max`` wide between two valid neighbours are
    filled: across a discontinuity (neighbours more than ``discont_jump``
    apart) with the smaller value, the background, else linearly. With
    ``images`` (the left and right grayscale views), a discontinuity fill
    takes the foreground value where the pixel still matches the right
    view there: a vertical 5-tap mean absolute difference at most
    ``visibility_thresh`` and 5 below the background's.
    """
    d = torch.as_tensor(disp, dtype=torch.float32)
    vl, kl, vr, kr = _both_sides(d)
    width = kl + kr - 1.0
    can = ~torch.isfinite(d) & torch.isfinite(vl) & torch.isfinite(vr) & \
        (width <= gap_max)
    occl = (vl - vr).abs() > discont_jump
    lin = vl + (vr - vl) * kl / torch.clamp(kl + kr, min=1.0)
    fill = torch.where(occl, torch.minimum(vl, vr), lin)
    if images is not None:
        il, ir = (torch.as_tensor(im, dtype=torch.float32, device=d.device)
                  for im in images)
        W = d.shape[1]
        x = torch.arange(W, device=d.device, dtype=torch.float32)[None, :]

        def vad(cand):
            """Vertical 5-tap mean AD at the candidate disparity."""
            xr = torch.round(x - cand)
            ok = (xr >= 0) & (xr < W)
            ir_s = ir.gather(1, xr.clamp(0, W - 1).long())
            ad = (il - ir_s).abs()
            c = torch.zeros_like(ad)
            for dy in (-2, -1, 0, 1, 2):
                c = c + torch.roll(ad, dy, 0)
            return torch.where(ok, c / 5.0, torch.inf)

        fin_l, fin_r = torch.isfinite(vl), torch.isfinite(vr)
        hi = torch.maximum(torch.where(fin_l, vl, -1.0),
                           torch.where(fin_r, vr, -1.0))
        mn2 = torch.minimum(torch.where(fin_l, vl, 1e6),
                            torch.where(fin_r, vr, 1e6))
        cost_hi, cost_mn = vad(hi), vad(mn2)
        visible = (cost_hi <= visibility_thresh) & (cost_hi + 5.0 < cost_mn)
        fill = torch.where(occl & visible, hi, fill)
    return torch.where(can, fill, d)


def elas_match(left, right, num_disparities: int = 64,
               min_disparity: int = 0, cfg: ElasConfig | None = None,
               return_support: bool = False, return_matched: bool = False,
               device: torch.device | str = "cuda"):
    """The ELAS-style pipeline on one rectified grayscale pair.

    Returns the (H, W) float32 disparity as a numpy array (dense inside
    fillable gaps), as the JAX package does; ``return_support`` adds the
    (n, 3) support points, ``return_matched`` the map before the gap fill
    (NaN where the dense stage rejected). Runs on the card unless the
    caller passes ``device="cpu"``.
    """
    cfg = cfg or ElasConfig()
    check_min_disparity(min_disparity)
    dev = entry_device(device)
    left = torch.as_tensor(np.asarray(left), dtype=torch.float32, device=dev)
    right = torch.as_tensor(np.asarray(right), dtype=torch.float32,
                            device=dev)
    H, W = left.shape
    words = _census_pair(left, right, (5, 5))
    scores = _support_scores(left, right, num_disparities, min_disparity,
                             grid_step=cfg.grid_step, words=words)
    support = extract_support_points(left, right, cfg, num_disparities,
                                     min_disparity, scores=scores)
    if len(support) < cfg.min_support:
        mu = torch.full((H, W), torch.nan, device=dev)
    else:
        tris = delaunay(support[:, :2])
        mu = _extend_prior(torch.from_numpy(
            rasterize_planes(tris, support, H, W)).to(dev))
    disp = _dense_banded(
        left, right, mu, num_disparities, min_disparity,
        band_radius=cfg.band_radius, band_pool_radius=cfg.band_pool_radius,
        prior_weight=cfg.prior_weight, prior_sigma=cfg.prior_sigma,
        prior_trunc=cfg.prior_trunc, lr_tol=cfg.lr_tol, words=words)
    matched = disp
    disp = gap_interpolate(disp, gap_max=cfg.gap_max,
                           discont_jump=cfg.discont_jump,
                           images=(left, right),
                           visibility_thresh=cfg.visibility_thresh)
    outs = (median_filter(disp, 3).cpu().numpy(),)
    if return_support:
        outs = outs + (support,)
    if return_matched:
        outs = outs + (matched.cpu().numpy(),)
    return outs if len(outs) > 1 else outs[0]
