"""MC-CNN feature tower and its cost volume (plain PyTorch).

The siamese tower of Zbontar & LeCun (JMLR 17(65), 2016) as the repo's
``make_model`` defines it: 3x3 convolutions with one pixel of zero padding
and a bias, ReLU after every layer but the last, each pixel's last-layer
vector divided by sqrt(sum of squares + 1e-12). The cost of d is
``scale * (1 - <f_L(y, x), f_R(y, x - d)>) / 2`` (the fast net's
normalised dot product), ``INVALID`` where x < d. Images are normalised to
zero mean and unit population std (+ 1e-6) first.

The weights are read from the flax-layout ``.npz`` with numpy:
``params/conv{i}/kernel`` (3, 3, C_in, F) and ``params/conv{i}/bias``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.census import INVALID


def load_tower(path: str | Path, device) -> list[tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """The (weight OIHW, bias) float32 pairs of every layer, in order."""
    with np.load(path) as data:
        layers = []
        i = 0
        while f"params/conv{i}/kernel" in data.files:
            k = np.asarray(data[f"params/conv{i}/kernel"], np.float32)
            b = np.asarray(data[f"params/conv{i}/bias"], np.float32)
            w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            layers.append((w.to(device), torch.from_numpy(b).to(device)))
            i += 1
    if not layers:
        raise ValueError(f"{path}: no params/conv0/kernel")
    return layers


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as a float32 whose low 13 bits are zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and matmuls in float32, TF32 off."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def normalise(imgs: torch.Tensor) -> torch.Tensor:
    """Each (H, W) image of (N, H, W) to zero mean, unit population std."""
    mean = imgs.mean(dim=(1, 2), keepdim=True)
    std = imgs.std(dim=(1, 2), correction=0, keepdim=True)
    return (imgs - mean) / (std + 1e-6)


def features(imgs: torch.Tensor, layers, use_tf32: bool) -> torch.Tensor:
    """(N, H, W) float32 images -> (N, F, H, W) unit features."""
    h = normalise(imgs)[:, None]
    last = len(layers) - 1
    with full_float32():
        for i, (w, b) in enumerate(layers):
            if use_tf32:
                h, w = tf32(h), tf32(w)
            h = F.conv2d(h, w, b, padding=1)
            if i < last:
                h = torch.relu(h)
    return h / torch.sqrt(torch.sum(h * h, dim=1, keepdim=True) + 1e-12)


def mccnn_volume(lefts: torch.Tensor, rights: torch.Tensor, layers,
                 num_disparities: int, min_disparity: int, scale: float,
                 use_tf32: bool) -> torch.Tensor:
    """(N, H, W) float32 views -> the (N, D, H, W) float32 cost."""
    fl = features(lefts, layers, use_tf32)
    fr = features(rights, layers, use_tf32)
    if use_tf32:
        fl, fr = tf32(fl), tf32(fr)
    N, _, H, W = fl.shape
    out = torch.full((N, num_disparities, H, W), INVALID,
                     dtype=torch.float32, device=fl.device)
    for i in range(num_disparities):
        d = min_disparity + i
        if d >= W:
            continue
        sim = torch.sum(fl[..., d:] * fr[..., :W - d], dim=1)
        out[:, i, :, d:] = scale * (1.0 - sim) * 0.5
    return out
