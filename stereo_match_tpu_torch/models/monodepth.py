"""Monocular depth estimation (PyTorch): inference and training.

Counterpart of ``stereo_match_tpu/models/monodepth.py``: the encoder-decoder
that predicts disparity from a single image (the reference's single-image
path, ``monodepth/script.py:8-10``), the weight carrier that reads and
writes the JAX package's flax checkpoints (``monodepth_*.npz``) with numpy
alone, ``predict_disparity``, and the trainers: the self-supervised
monodepth objective (``monodepth_loss``) and the distillation from the
port's own stereo matcher (``distillation_loss``), under autograd and
optax's Adam (``models/optim.py``). The network is cuDNN convolutions on
the card: flax computes it on XLA, with no Pallas kernel to port. TF32 is
off inside the forward pass, and around a whole train step (forward,
backward and update), as flax on a CPU computes in float32.

Layout: the JAX package is NHWC, the port NCHW, so a disparity map is
(B, 2, H, W), channel 0 the left view's. The trainers take the JAX
package's (N, H, W, 3) scene arrays and permute them once on the device.
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

from stereo_match_tpu_torch.models.mccnn import (load_params_npz,
                                                 save_flax_npz)
from stereo_match_tpu_torch.models.optim import (Adam, LearningRate,
                                                 make_step)
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


# ----------------------------------------------------------- checkpoints ----

def to_flax_params(model: MonodepthNet) -> dict:
    """``model`` -> its flax parameter tree of numpy float32 arrays, the
    inverse of :func:`from_flax_params`: blocks[i] under
    ``params/ConvBlock_{i}/Conv_0``, the heads under ``params/disp0`` and
    ``params/disp1``, kernels HWIO (``permute(2, 3, 1, 0)``)."""
    names = [f"ConvBlock_{i}" for i in range(len(model.blocks))]

    def layer(conv: nn.Conv2d) -> dict:
        return {"kernel": conv.weight.detach().permute(2, 3, 1, 0).cpu()
                .numpy(), "bias": conv.bias.detach().cpu().numpy()}

    tree = {name: {"Conv_0": layer(block.conv)}
            for name, block in zip(names, model.blocks)}
    tree["disp0"], tree["disp1"] = layer(model.disp0), layer(model.disp1)
    return {"params": tree}


def save_params_npz(path: str | Path, model: MonodepthNet) -> Path:
    """``model``'s weights as a flax ``.npz`` that :func:`load_params_npz`
    and the JAX package's ``load_params_npz`` read (its ``infer_arch``
    finds the arch); returns the path written."""
    return save_flax_npz(path, to_flax_params(model))


# -------------------------------------------------------------- training ----

def _warp_horizontal(img: torch.Tensor, disp_frac: torch.Tensor,
                     direction: float) -> torch.Tensor:
    """Bilinear warp of (B, C, H, W) along x by a (B, 1, H, W) per-pixel
    disparity in width fractions, clamped at the borders."""
    B, C, H, W = img.shape
    x = torch.arange(W, dtype=torch.float32, device=img.device)
    xs = x + direction * disp_frac[:, 0] * W
    x0 = torch.floor(xs)
    f = (xs - x0)[:, None]
    x0i = torch.clamp(x0.long(), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    g0 = torch.gather(img, 3, x0i[:, None].expand(B, C, H, W))
    g1 = torch.gather(img, 3, x1i[:, None].expand(B, C, H, W))
    return g0 * (1 - f) + g1 * f


def _ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Simplified 3x3 mean-pooled SSIM (monodepth's appearance term), as a
    dissimilarity in [0, 1]; VALID pooling."""
    def pool(x):
        return F.avg_pool2d(x, 3, 1)
    mu_a, mu_b = pool(a), pool(b)
    sa = pool(a * a) - mu_a ** 2
    sb = pool(b * b) - mu_b ** 2
    sab = pool(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2))
    return torch.clamp((1 - ssim) / 2, 0, 1)


def _smoothness(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness of a (B, 1, H, W) disparity on its (B, C, H,
    W) image."""
    dx_d = torch.abs(disp[..., 1:] - disp[..., :-1])
    dy_d = torch.abs(disp[..., 1:, :] - disp[..., :-1, :])
    dx_i = torch.mean(torch.abs(img[..., 1:] - img[..., :-1]), 1,
                      keepdim=True)
    dy_i = torch.mean(torch.abs(img[..., 1:, :] - img[..., :-1, :]), 1,
                      keepdim=True)
    return (torch.mean(dx_d * torch.exp(-dx_i))
            + torch.mean(dy_d * torch.exp(-dy_i)))


def monodepth_loss(model: MonodepthNet, left: torch.Tensor,
                   right: torch.Tensor, alpha_ssim: float = 0.85,
                   w_smooth: float = 0.1, w_lr: float = 1.0) -> torch.Tensor:
    """The monodepth self-supervised objective on a rectified pair.

    left/right: (B, 3, H, W) in [0, 1]. At each scale: SSIM + L1 of each
    view rebuilt from the other by its disparity, edge-aware smoothness of
    the left disparity, and the left-right consistency of the two maps.
    """
    total = 0.0
    for scale, d in enumerate(model(left)):
        factor = 2 ** scale
        l = left[..., ::factor, ::factor]
        r = right[..., ::factor, ::factor]
        dl, dr = d[:, :1], d[:, 1:]
        # rebuild left from right by sampling at x - d (d = x_l - x_r)
        recon_l = _warp_horizontal(r, dl, -1.0)
        recon_r = _warp_horizontal(l, dr, +1.0)
        ap_l = alpha_ssim * torch.mean(_ssim(recon_l, l)) \
            + (1 - alpha_ssim) * torch.mean(torch.abs(recon_l - l))
        ap_r = alpha_ssim * torch.mean(_ssim(recon_r, r)) \
            + (1 - alpha_ssim) * torch.mean(torch.abs(recon_r - r))
        dr_warped = _warp_horizontal(dr, dl, -1.0)
        lr = torch.mean(torch.abs(dl - dr_warped))
        sm = _smoothness(dl, l) / factor
        total = total + ap_l + ap_r + w_smooth * sm + w_lr * lr
    return total


def distillation_loss(model: MonodepthNet, left: torch.Tensor,
                      target_frac: torch.Tensor, valid: torch.Tensor,
                      w_smooth: float = 0.05) -> torch.Tensor:
    """Stereo distillation: L1 to a stereo matcher's disparity.

    ``left`` (B, 3, H, W) in [0, 1]; ``target_frac`` (B, H, W) pseudo-label
    disparity in width fractions from the port's own stereo matcher (no
    ground truth); ``valid`` (B, H, W), where the label exists. Both decoder
    scales are supervised; edge-aware smoothness fills in where the label
    is missing.
    """
    total = 0.0
    for scale, d in enumerate(model(left)):
        f = 2 ** scale
        l = left[..., ::f, ::f]
        t = target_frac[..., ::f, ::f]
        v = valid[..., ::f, ::f].to(torch.float32)
        l1 = torch.sum(torch.abs(d[:, 0] - t) * v) / torch.clamp_min(
            torch.sum(v), 1.0)
        sm = _smoothness(d[:, :1], l) / f
        total = total + l1 + w_smooth * sm
    return total


def make_train_step(model: MonodepthNet, optimizer: torch.optim.Optimizer,
                    loss=monodepth_loss):
    """``(*batch) -> loss``: one step of ``optimizer`` (over ``model``'s
    parameters, which must take gradients) on ``loss(model, *batch)``
    (:func:`monodepth_loss` on (left, right), or :func:`distillation_loss`
    on (left, target, valid)), in full float32 (``optim.make_step``)."""
    return make_step(lambda *batch: loss(model, *batch), optimizer)


@contextlib.contextmanager
def _training(model: MonodepthNet, device):
    """``model`` on ``device`` with gradients on, off again afterwards (the
    inference state of :func:`make_model`)."""
    dev = entry_device(device)
    model.to(dev).requires_grad_(True)
    try:
        yield dev
    finally:
        model.requires_grad_(False)


def _nchw(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, C) array or tensor -> (N, C, H, W) on ``dev``, one copy."""
    return torch.as_tensor(x).to(dev, dtype).permute(0, 3, 1, 2) \
        .contiguous()


def train(model: MonodepthNet, pairs, learning_rate: LearningRate = 1e-4,
          device: torch.device | str = "cuda"
          ) -> tuple[MonodepthNet, list[float]]:
    """Adam on :func:`monodepth_loss` over an iterable of (left, right)
    batches, (B, H, W, 3) in [0, 1] as the JAX trainer takes them; returns
    ``(model, losses)``, the model moved to ``device`` (the card unless the
    caller asks for the CPU) and trained in place."""
    with _training(model, device) as dev:
        step = make_train_step(model, Adam(model.parameters(),
                                           learning_rate))
        losses = [step(_nchw(left, dev), _nchw(right, dev))
                  for left, right in pairs]
    return model, torch.stack(losses).tolist() if losses else []


def _run_chunks(step, batch_at, steps: int, chunk: int) -> list[float]:
    """``step(*batch_at(i))`` for i < steps - steps % chunk (the JAX
    trainers run whole chunks only, so the trailing steps are dropped);
    the losses are read once a chunk."""
    losses = []
    for s0 in range(0, steps - steps % chunk, chunk):
        out = [step(*batch_at(i)) for i in range(s0, s0 + chunk)]
        losses.extend(torch.stack(out).tolist())
    return losses


def train_on_device(model: MonodepthNet, lefts, rights, picks,
                    learning_rate: LearningRate = 1e-4, chunk: int = 100,
                    device: torch.device | str = "cuda"
                    ) -> tuple[MonodepthNet, list[float]]:
    """Device-resident training on :func:`monodepth_loss`: the scene pool
    ``lefts``/``rights`` ((N, H, W, 3) float32 in [0, 1]) is uploaded once
    and each step's batch gathered on the device by ``picks`` ((steps,
    batch) scene indices). As in the JAX trainer, ``steps - steps % chunk``
    steps run, ``chunk`` steps between host reads of the losses."""
    with _training(model, device) as dev:
        lefts, rights = _nchw(lefts, dev), _nchw(rights, dev)
        picks = torch.as_tensor(picks).to(dev, torch.long)
        step = make_train_step(model, Adam(model.parameters(),
                                           learning_rate))
        losses = _run_chunks(step, lambda i: (lefts[picks[i]],
                                              rights[picks[i]]),
                             picks.shape[0], chunk)
    return model, losses


def train_distilled_on_device(model: MonodepthNet, lefts, targets_frac,
                              valids, picks,
                              learning_rate: LearningRate = 1e-4,
                              chunk: int = 100, flips=None,
                              device: torch.device | str = "cuda"
                              ) -> tuple[MonodepthNet, list[float]]:
    """Device-resident training on :func:`distillation_loss` (see
    :func:`train_on_device`): ``lefts`` (N, H, W, 3), ``targets_frac`` and
    ``valids`` (N, H, W). ``flips``: optional (steps, batch) bools that
    mirror those samples and their labels horizontally (augmentation; the
    image -> disparity map is flip-equivariant)."""
    with _training(model, device) as dev:
        lefts = _nchw(lefts, dev)
        targets = torch.as_tensor(targets_frac).to(dev, torch.float32)
        valids = torch.as_tensor(valids).to(dev, torch.bool)
        picks = torch.as_tensor(picks).to(dev, torch.long)
        flips = torch.zeros(picks.shape, dtype=torch.bool, device=dev) \
            if flips is None else torch.as_tensor(flips).to(dev, torch.bool)

        def batch_at(i: int):
            idx, flip = picks[i], flips[i][:, None, None]
            l, t, v = lefts[idx], targets[idx], valids[idx]
            return (torch.where(flip[:, None], l.flip(3), l),
                    torch.where(flip, t.flip(2), t),
                    torch.where(flip, v.flip(2), v))

        step = make_train_step(model, Adam(model.parameters(),
                                           learning_rate),
                               distillation_loss)
        losses = _run_chunks(step, batch_at, picks.shape[0], chunk)
    return model, losses
