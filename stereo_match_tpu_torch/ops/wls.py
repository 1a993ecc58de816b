"""Edge-aware weighted-least-squares disparity refinement (PyTorch).

Counterpart of ``stereo_match_tpu/ops/wls.py``: the fast global smoother
minimises

    E(u) = sum_p (u_p - f_p)^2 + lambda * sum_{q in N(p)} w_pq (u_p - u_q)^2

by alternating exact 1-D tridiagonal solves along rows and columns, with
guide weights w = exp(-|I_p - I_q| / sigma) and a per-pass lambda
lambda_t = 1.5 * lambda * 4^(T-t-1) / (4^T - 1), computed in float32 as the
reference does. Every solve is K7 (``ops/cuda_kernels.fgs_solve``; its plain
version on CPU tensors), along the rows (axis 1) or the columns (axis 0) of
the (C, H, W) slab as it lies. The confidence-weighted filter runs both of its
right-hand sides (c*d and c) through one solve, as the JAX package's
accelerator path does: they share the elimination, and each is computed as
a solve of its own would compute it.

Also here: the confidence maps (``lr_confidence``, ``wls_confidence_cv2``,
OpenCV ``DisparityWLSFilter`` semantics), plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_match_tpu_torch.ops.cuda_kernels import fgs_solve


def _edge_weights(guide: torch.Tensor, axis: int,
                  sigma_color: float) -> torch.Tensor:
    """w[i] = exp(-|I[i+1] - I[i]| / sigma) along ``axis`` (length N-1)."""
    g = guide.to(torch.float32)
    sigma = torch.tensor(sigma_color, dtype=torch.float32, device=g.device)
    return torch.exp(-torch.diff(g, dim=axis).abs() / sigma)


def _scan_weights(w: torch.Tensor,
                  axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge weights between neighbours along ``axis`` -> wp and wn.

    ``w`` is (H-1, W) along axis 0 or (H, W-1) along axis 1; ``wp[i]``
    weighs the edge to unknown i - 1 of the line and ``wn[i]`` the edge to
    unknown i + 1, both (H, W), zero at each line's two ends (the Neumann
    boundary).
    """
    shape = list(w.shape)
    shape[axis] = 1
    z = w.new_zeros(shape)
    return (torch.cat([z, w], axis).contiguous(),
            torch.cat([w, z], axis).contiguous())


def _tridiagonal_smooth_rows(f: torch.Tensor, w: torch.Tensor,
                             lam: float) -> torch.Tensor:
    """Solve (I + lam*A) u = f row-wise; A is the weighted 1-D Laplacian.

    ``f``: (H, W); ``w``: (H, W-1) edge weights between columns x and x+1.
    """
    wp, wn = _scan_weights(w, 1)
    return fgs_solve(f[None].contiguous(), wp, wn, lam, 1)[0]


def _lambda_schedule(lmbda: float, num_iter: int) -> list[float]:
    """lambda_t for t = 0 .. num_iter-1, each rounded as float32 math gives."""
    f32 = np.float32
    base = f32(1.5) * f32(lmbda) / f32(4.0 ** num_iter - 1.0)
    return [float(base * f32(4.0 ** (num_iter - t - 1)))
            for t in range(num_iter)]


def _fgs_stack(srcs: torch.Tensor, guide: torch.Tensor, lmbda: float,
               sigma_color: float, num_iter: int,
               solve=fgs_solve) -> torch.Tensor:
    """Smooth C stacked (C, H, W) maps sharing one guide: rows then columns
    per iteration, each solve on the slab as it lies."""
    u = srcs.to(torch.float32).contiguous()
    wxp, wxn = _scan_weights(_edge_weights(guide, 1, sigma_color), 1)
    wyp, wyn = _scan_weights(_edge_weights(guide, 0, sigma_color), 0)
    for lam in _lambda_schedule(lmbda, num_iter):
        u = solve(u, wxp, wxn, lam, 1)
        u = solve(u, wyp, wyn, lam, 0)
    return u


def fast_global_smoother(src: torch.Tensor, guide: torch.Tensor,
                         lmbda: float, sigma_color: float,
                         num_iter: int = 3) -> torch.Tensor:
    """Edge-aware smoothing of ``src`` guided by ``guide`` (both (H, W))."""
    return _fgs_stack(src[None], guide, lmbda, sigma_color, num_iter)[0]


def wls_filter_disparity(disparity: torch.Tensor, guide: torch.Tensor,
                         lmbda: float = 8000.0, sigma_color: float = 1.2,
                         num_iter: int = 3,
                         confidence: torch.Tensor | None = None,
                         solve=fgs_solve) -> torch.Tensor:
    """Confidence-weighted WLS refinement of a disparity map.

    ``disparity``: (H, W) float with NaN invalids; ``guide``: the left
    image; ``confidence``: optional [0, 1] weights, times validity. The
    output is dense: u = FGS(c * d) / max(FGS(c), 1e-6). ``solve`` is K7 by
    default; ``fgs_solve_plain`` gives the plain version on any device,
    ``fgs_solve_partitioned_plain`` the kernel's algorithm.
    """
    d = disparity.to(torch.float32)
    valid = torch.isfinite(d)
    conf = valid.to(torch.float32)
    if confidence is not None:
        conf = conf * confidence.to(torch.float32)
    d0 = torch.where(valid, d, 0.0)
    nd = _fgs_stack(torch.stack([conf * d0, conf]), guide, lmbda,
                    sigma_color, num_iter, solve)
    return nd[0] / torch.clamp(nd[1], min=1e-6)


def lr_confidence(disp_left: torch.Tensor, disp_right: torch.Tensor,
                  max_diff: float = 1.0) -> torch.Tensor:
    """Soft LR-consistency confidence in [0, 1] (the reference's stand-in,
    kept for API parity; the matcher wires :func:`wls_confidence_cv2`)."""
    W = disp_left.shape[1]
    x = torch.arange(W, dtype=torch.float32, device=disp_left.device)[None]
    xr = torch.clamp(torch.round(x - disp_left), 0, W - 1).to(torch.int64)
    d_r = torch.gather(disp_right, 1, xr)
    err = (disp_left - d_r).abs()
    conf = torch.clamp(1.0 - (err - max_diff) / max(max_diff, 1e-6), 0.0, 1.0)
    return torch.where(torch.isfinite(conf), conf, 0.0)


def _window_extrema(d: torch.Tensor, radius: int):
    """Separable (2r+1)^2 min/max pooling via iterated 1-px shifts, with
    the edge rows/columns replicated."""
    lo = hi = d
    for axis in (0, 1):
        cur_lo, cur_hi = lo, hi
        n = d.shape[axis]
        idx = torch.arange(n, device=d.device)
        first = (idx == 0)[:, None] if axis == 0 else (idx == 0)[None]
        last = (idx == n - 1)[:, None] if axis == 0 else (idx == n - 1)[None]
        for _ in range(radius):
            up_lo = torch.where(first, cur_lo, torch.roll(cur_lo, 1, axis))
            dn_lo = torch.where(last, cur_lo, torch.roll(cur_lo, -1, axis))
            up_hi = torch.where(first, cur_hi, torch.roll(cur_hi, 1, axis))
            dn_hi = torch.where(last, cur_hi, torch.roll(cur_hi, -1, axis))
            cur_lo = torch.minimum(cur_lo, torch.minimum(up_lo, dn_lo))
            cur_hi = torch.maximum(cur_hi, torch.maximum(up_hi, dn_hi))
        lo, hi = cur_lo, cur_hi
    return lo, hi


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN values, the mean of the two middle ones on an
    even count (``jnp.nanmedian``; ``torch.nanmedian`` takes the lower)."""
    v = torch.sort(x[~torch.isnan(x)]).values
    n = v.numel()
    if n == 0:
        return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def wls_confidence_cv2(disp_left: torch.Tensor, disp_right: torch.Tensor,
                       lrc_thresh: float = 1.5,
                       discontinuity_radius: int = 7,
                       discontinuity_jump: float = 6.0,
                       roi_mask: torch.Tensor | None = None) -> torch.Tensor:
    """OpenCV ``DisparityWLSFilter`` confidence semantics (in [0, 1]).

    The product of two binary terms: the left disparity round-trips through
    the right view within ``lrc_thresh``, and the (2r+1)^2 window around the
    pixel spans at most ``discontinuity_jump``; invalid pixels and pixels
    outside ``roi_mask`` get 0.
    """
    W = disp_left.shape[1]
    x = torch.arange(W, dtype=torch.float32, device=disp_left.device)[None]
    valid = torch.isfinite(disp_left)
    dl = torch.where(valid, disp_left, 0.0)
    xr = torch.clamp(torch.round(x - dl), 0, W - 1).to(torch.int64)
    d_r = torch.gather(torch.where(torch.isfinite(disp_right), disp_right,
                                   -1e6), 1, xr)
    lrc_ok = (dl - d_r).abs() <= lrc_thresh
    # discontinuity term on a validity-neutral fill (NaN would poison the
    # pooled extrema)
    med = _nanmedian(torch.where(valid, dl, torch.nan))
    lo, hi = _window_extrema(torch.where(valid, dl, med),
                             discontinuity_radius)
    smooth = (hi - lo) <= discontinuity_jump
    conf = (valid & lrc_ok & smooth).to(torch.float32)
    if roi_mask is not None:
        conf = conf * roi_mask.to(torch.float32)
    return conf
