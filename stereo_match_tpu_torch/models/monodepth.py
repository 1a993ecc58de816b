"""Monocular depth estimation, inference (PyTorch).

Counterpart of ``stereo_match_tpu/models/monodepth.py``: the encoder-decoder
that predicts disparity from a single image (the reference's single-image
path, ``monodepth/script.py:8-10``), the weight carrier that reads the JAX
package's flax checkpoints (``monodepth_*.npz``) with numpy alone, and
``predict_disparity``. The network is cuDNN convolutions on the card: flax
computes it on XLA, with no Pallas kernel to port. TF32 is off inside the
forward pass, as flax on a CPU computes in float32.

Training (``monodepth_loss``, ``distillation_loss``, the trainers) is not
ported (ROADMAP.md, queue 1 item 6).
"""

from __future__ import annotations

import contextlib
import math
import re
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stereo_match_tpu_torch.models.mccnn import load_params_npz
from stereo_match_tpu_torch.ops.cuda_kernels import fp32_cudnn
from stereo_match_tpu_torch.utils.backend import entry_device

ARCHS = {"full": (32, 64, 128, 256), "small": (16, 32, 64, 128)}
MAX_DISPARITY_FRAC = 0.3   # sigmoid outputs scaled to this share of W
N_BLOCKS = 12        # 2 encoder blocks a width, then 4 decoder blocks
DOWNSAMPLE = 2 ** 4  # the native path pads to a multiple of this


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """flax's "SAME" padding of one axis of length n: (low, high).

    A stride-2 3x3 conv on an even length pads (0, 1), not (1, 1).
    """
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with padding 0) with flax's "SAME" padding."""
    k, s = conv.kernel_size[0], conv.stride[0]
    top, bottom = same_pads(x.shape[-2], k, s)
    left, right = same_pads(x.shape[-1], k, s)
    return conv(F.pad(x, (left, right, top, bottom)))


class ConvBlock(nn.Module):
    """3x3 conv ("SAME", stride 1 or 2), then ELU."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, features, 3, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(conv_same(self.conv, x))


class MonodepthNet(nn.Module):
    """Compact VGG-style encoder-decoder with skip connections.

    ``blocks[0..7]`` are the encoder (a stride-1 then a stride-2 block a
    width), ``blocks[8..11]`` the decoder, deepest first; ``disp1`` and
    ``disp0`` emit sigmoid disparity at half and full resolution, scaled to
    ``MAX_DISPARITY_FRAC`` of the image width. Input (B, 3, H, W) in
    [0, 1], H and W multiples of 16; output [(B, 2, H, W), (B, 2, H/2,
    W/2)], finest first, channel 0 the left view's disparity.
    """

    def __init__(self, encoder_features: Sequence[int] = ARCHS["full"]):
        super().__init__()
        feats = tuple(encoder_features)
        self.encoder_features = feats
        blocks, c = [], 3
        for f in feats:
            blocks += [ConvBlock(c, f), ConvBlock(f, f, stride=2)]
            c = f
        for i in reversed(range(len(feats))):
            blocks.append(ConvBlock(c + feats[i], feats[i]))
            c = feats[i]
        self.blocks = nn.ModuleList(blocks)
        self.disp0 = nn.Conv2d(feats[0], 2, 3, padding=0)
        self.disp1 = nn.Conv2d(feats[1], 2, 3, padding=0)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        with fp32_cudnn() if x.is_cuda else contextlib.nullcontext():
            n = len(self.encoder_features)
            skips, h = [], x
            for i in range(n):
                h = self.blocks[2 * i](h)
                skips.append(h)
                h = self.blocks[2 * i + 1](h)
            disps = []
            for j, i in enumerate(reversed(range(n))):
                h = h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
                h = self.blocks[2 * n + j](torch.cat([h, skips[i]], dim=1))
                if i < 2:     # the two finest scales emit disparity
                    head = self.disp0 if i == 0 else self.disp1
                    disps.append(MAX_DISPARITY_FRAC *
                                 torch.sigmoid(conv_same(head, h)))
            return disps[::-1]


def _lecun_normal(shape: tuple[int, ...],
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel distribution (truncated at two std) for OIHW
    weights, drawn from ``generator``."""
    std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / 0.87962566
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std,
                                 b=2.0 * std, generator=generator)


def make_model(arch: str = "full", seed: int = 0) -> MonodepthNet:
    """`full` (32-256 features) or `small` (16-128, the shipped
    checkpoint's arch), on the CPU.

    The weights are random: flax's distribution (truncated lecun-normal
    kernels, zero biases) drawn from a ``torch.Generator`` seeded with
    ``seed``. That is not flax's random stream, so the same seed gives
    other weights than ``init_params`` of the JAX package; load a
    checkpoint (:func:`from_flax_params`) to compare the two.
    """
    if arch not in ARCHS:
        raise ValueError(f"unknown arch: {arch}")
    model = MonodepthNet(ARCHS[arch])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in _convs(model):
            conv.weight.copy_(_lecun_normal(tuple(conv.weight.shape), gen))
            conv.bias.zero_()
    return model.requires_grad_(False).eval()


def _convs(model: MonodepthNet) -> list[nn.Conv2d]:
    return [b.conv for b in model.blocks] + [model.disp0, model.disp1]


def _flax_tree(params: Any) -> Mapping:
    try:
        return params["params"]
    except (KeyError, TypeError):
        raise ValueError("not a flax parameter tree") from None


def _block_names(tree: Mapping) -> list[str]:
    """The ConvBlock_<i> keys, ordered by i (as strings ConvBlock_10 sorts
    before ConvBlock_2)."""
    names = [k for k in tree if re.fullmatch(r"ConvBlock_\d+", k)]
    return sorted(names, key=lambda k: int(k.split("_")[1]))


def infer_arch(params: Any) -> str:
    """"full" or "small", read off a checkpoint's first-encoder width (a
    numpy or JAX tree, as ``load_params_npz`` gives)."""
    tree = _flax_tree(params)
    try:
        kernel = tree["ConvBlock_0"]["Conv_0"]["kernel"]
    except (KeyError, TypeError):
        raise ValueError("cannot infer monodepth arch from checkpoint "
                         "params") from None
    return "small" if np.shape(kernel)[-1] == 16 else "full"


def from_flax_params(params: Any, arch: str | None = None) -> MonodepthNet:
    """A flax parameter tree (numpy or JAX arrays) -> ``MonodepthNet`` on
    the CPU.

    ``arch`` defaults to :func:`infer_arch`. Kernels are HWIO (3, 3, C_in,
    F) in flax and OIHW in torch: ``permute(3, 2, 0, 1)``. Raises
    ValueError when the tree's blocks or shapes do not fit ``arch``.
    """
    tree = _flax_tree(params)
    arch = arch or infer_arch(params)
    model = make_model(arch)
    names = _block_names(tree)
    if names != [f"ConvBlock_{i}" for i in range(N_BLOCKS)] or \
            not {"disp0", "disp1"} <= set(tree):
        raise ValueError(f"checkpoint holds {names} and "
                         f"{sorted(set(tree) - set(names))}; a monodepth "
                         f"net has ConvBlock_0..{N_BLOCKS - 1}, disp0 and "
                         "disp1")
    layers = [tree[n]["Conv_0"] for n in names] + [tree["disp0"],
                                                   tree["disp1"]]
    for conv, layer, name in zip(_convs(model), layers,
                                 names + ["disp0", "disp1"]):
        kernel = torch.from_numpy(np.array(layer["kernel"], np.float32))
        weight = kernel.permute(3, 2, 0, 1)
        bias = torch.from_numpy(np.array(layer["bias"], np.float32))
        if weight.shape != conv.weight.shape or bias.shape != conv.bias.shape:
            raise ValueError(f"{name}: checkpoint kernel "
                             f"{tuple(kernel.shape)}, arch {arch!r} wants "
                             f"{tuple(conv.weight.permute(2, 3, 1, 0).shape)}")
        with torch.no_grad():
            conv.weight.copy_(weight)
            conv.bias.copy_(bias)
    return model


def default_checkpoint_path(arch: str = "small") -> Path:
    """The checkpoint the JAX package ships (``tools/train_monodepth.py``).

    Found on disk beside this package (``stereo_match_tpu/models/weights``);
    the ``stereo_match_tpu.models`` package imports flax and JAX, so it is
    not imported.
    """
    return Path(__file__).resolve().parents[2] / "stereo_match_tpu" / \
        "models" / "weights" / f"monodepth_{arch}.npz"


def load_default(name: str = "small",
                 device: torch.device | str = "cuda") -> MonodepthNet:
    """The shipped checkpoint ``name`` on ``device`` (the card unless the
    caller asks for the CPU), its arch inferred from the weights;
    FileNotFoundError if the file is absent."""
    device = entry_device(device)
    params = load_params_npz(default_checkpoint_path(name))
    return from_flax_params(params).to(device)


def _resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of (B, C, H, W): half-pixel
    centres, a triangle kernel widened by the scale when downsizing."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


@torch.no_grad()
def predict_disparity(model: MonodepthNet, image,
                      internal_size: tuple[int, int] | None = (96, 160)
                      ) -> torch.Tensor:
    """Single RGB image (H, W, 3) uint8/float -> (H, W) disparity in px, a
    float32 tensor on the model's device.

    ``internal_size``: the resolution the network sees; the image is
    resized there and the predicted width-fraction disparity resized back
    and scaled by the original width (the monodepth protocol, as in the JAX
    package). ``None`` runs at native resolution, padded with the edge
    value to a multiple of 16.
    """
    dev = next(model.parameters()).device
    img = torch.as_tensor(image).to(dev, torch.float32)
    if img.max() > 1.5:
        img = img / 255.0
    H, W = img.shape[:2]
    x = img.permute(2, 0, 1)[None]
    if internal_size is not None and (H, W) != tuple(internal_size):
        frac = model(_resize(x, tuple(internal_size)))[0][:, :1]
        return _resize(frac, (H, W))[0, 0] * W
    s = DOWNSAMPLE
    Hp, Wp = -(-H // s) * s, -(-W // s) * s
    padded = F.pad(x, (0, Wp - W, 0, Hp - H), mode="replicate")
    return model(padded)[0][0, 0, :H, :W] * W
