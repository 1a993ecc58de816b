"""Census transform and Hamming distance (plain PyTorch).

Counterpart of ``stereo_match_tpu/ops/census.py``: the same bit order
(row-major over the window, centre skipped), strict less-than, and edge
replication, with windows above 33 pixels packed into several int32 words.

PyTorch has no popcount operator, so :func:`popcount32` is a SWAR popcount.
Bits are assembled in int64: ``>>`` on int32 is arithmetic and a 33-pixel
window sets bit 31.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same 32 bits."""
    wrapped = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return wrapped.to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits in each 32-bit word of an integer tensor (int32)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def census_transform(image: torch.Tensor,
                     window: tuple[int, int] = (5, 5)) -> torch.Tensor:
    """Census descriptor per pixel, packed into int32 words.

    ``image``: (H, W) float or uint8. Returns (H, W, n_words) int32 where
    bit k of word w is 1 when the k-th neighbour (row-major order over the
    window, centre excluded) is strictly darker than the centre pixel.
    Borders compare against edge-replicated pixels.
    """
    wh, ww = window
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError("census window must be odd in both dimensions")
    img = torch.as_tensor(image).to(torch.float32)
    H, W = img.shape
    ry, rx = wh // 2, ww // 2
    padded = F.pad(img[None, None], (rx, rx, ry, ry), mode="replicate")[0, 0]

    n_words = (wh * ww - 1 + 31) // 32
    words = [torch.zeros((H, W), dtype=torch.int64, device=img.device)
             for _ in range(n_words)]
    bit = 0
    for dy in range(wh):
        for dx in range(ww):
            if dy == ry and dx == rx:
                continue
            darker = padded[dy:dy + H, dx:dx + W] < img
            words[bit // 32] |= darker.to(torch.int64) << (bit % 32)
            bit += 1
    return torch.stack([_to_int32(w) for w in words], dim=-1)


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount(xor) summed over descriptor words; shapes broadcast."""
    return popcount32(torch.bitwise_xor(a, b)).sum(dim=-1, dtype=torch.int32)
