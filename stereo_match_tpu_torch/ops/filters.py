"""Image pre- and post-filters (plain PyTorch).

Counterpart of ``stereo_match_tpu/ops/filters.py``: gaussian blur and
unsharp masking (the reference's ``image_measure`` enhancement, sharpen
alpha 30), a windowed bilateral filter, a patchwise non-local means
(``fastNlMeansDenoising``'s capability) and the median that ELAS runs on
its output. XLA in the JAX package, so plain torch here, on the CPU and on
the card alike. The operations follow the JAX package's in order, so the
results agree to float32 rounding (``nl_means_denoise``'s box subtracts
float32 cumulative sums, which the two frameworks add in other orders).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) -> (H + 2r, W + 2r), edge-replicated."""
    return F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]


def gaussian_blur(image: torch.Tensor, sigma: float = 1.0,
                  radius: int | None = None) -> torch.Tensor:
    """Separable gaussian blur on (H, W) or (H, W, C), edge-replicated."""
    img = torch.as_tensor(image).to(torch.float32)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    k = _gaussian_kernel1d(sigma, radius)
    r = (k.shape[0] - 1) // 2

    def conv_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
        idx = torch.arange(-r, x.shape[axis] + r, device=x.device)
        xp = x.index_select(axis, idx.clamp(0, x.shape[axis] - 1))
        out = torch.zeros_like(x)
        for i in range(2 * r + 1):
            out = out + float(k[i]) * xp.narrow(axis, i, x.shape[axis])
        return out

    out = conv_axis(conv_axis(img, 0), 1)
    return out[..., 0] if squeeze else out


def unsharp_mask(image: torch.Tensor, sigma: float = 1.0,
                 alpha: float = 30.0) -> torch.Tensor:
    """Sharpen: img + alpha * (img - blur(img)), clipped to [0, 255]."""
    img = torch.as_tensor(image).to(torch.float32)
    blurred = gaussian_blur(img, sigma)
    return (img + alpha * (img - blurred)).clamp(0.0, 255.0)


def bilateral_filter(image: torch.Tensor, radius: int = 3,
                     sigma_space: float = 2.0,
                     sigma_color: float = 25.0) -> torch.Tensor:
    """Brute-force windowed bilateral filter on (H, W), edge-replicated."""
    img = torch.as_tensor(image).to(torch.float32)
    H, W = img.shape
    padded = _pad_edge(img, radius)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    inv2ss = 0.5 / (sigma_space * sigma_space)
    inv2sc = 0.5 / (sigma_color * sigma_color)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = padded[dy + radius:dy + radius + H, dx + radius:dx + radius + W]
            w_s = float(np.exp(-(dy * dy + dx * dx) * inv2ss))
            w = w_s * torch.exp(-(nb - img) ** 2 * inv2sc)
            num = num + w * nb
            den = den + w
    return num / den


def nl_means_denoise(image: torch.Tensor, h: float = 10.0,
                     template_radius: int = 1,
                     search_radius: int = 5) -> torch.Tensor:
    """Windowed non-local means (``fastNlMeansDenoising``'s capability).

    For each search offset the patch SSD is a box mean of the shifted
    squared difference; the weight is exp(-mean SSD / h^2).
    """
    img = torch.as_tensor(image).to(torch.float32)
    H, W = img.shape
    tw = 2 * template_radius + 1
    pad = search_radius + template_radius
    padded = _pad_edge(img, pad)
    inv_h2 = 1.0 / (h * h)

    def box(x: torch.Tensor) -> torch.Tensor:
        xp = F.pad(_pad_edge(x, template_radius)[None, None],
                   (1, 0, 1, 0))[0, 0]
        c = torch.cumsum(torch.cumsum(xp, 0), 1)
        s = c[tw:, tw:] - c[:-tw, tw:] - c[tw:, :-tw] + c[:-tw, :-tw]
        return s / (tw * tw)

    side = 2 * search_radius + 1
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for k in range(side * side):
        oy, ox = k // side + template_radius, k % side + template_radius
        nb = padded[oy:oy + H, ox:ox + W]
        w = torch.exp(-box((img - nb) ** 2) * inv_h2)
        num = num + w * nb
        den = den + w
    return num / den


def median_filter(image: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Windowed median on (H, W), edge-replicated. NaNs count as +inf and
    win only in all-NaN windows; a non-finite median becomes NaN."""
    img = torch.as_tensor(image).to(torch.float32)
    H, W = img.shape
    padded = _pad_edge(img, size // 2)
    stack = torch.stack([padded[dy:dy + H, dx:dx + W]
                         for dy in range(size) for dx in range(size)])
    filled = torch.where(torch.isnan(stack), torch.inf, stack)
    med = filled.sort(dim=0).values[(size * size) // 2]
    return torch.where(torch.isfinite(med), med, torch.nan)


def image_measure(image: torch.Tensor, sigma: float = 1.0,
                  alpha: float = 30.0) -> torch.Tensor:
    """Gaussian blur + unsharp sharpen: the reference's pre-matching
    enhancement (``disparity_calculation.py:213-224``)."""
    return unsharp_mask(gaussian_blur(image, sigma), sigma, alpha)
