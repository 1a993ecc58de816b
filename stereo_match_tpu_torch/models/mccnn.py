"""MC-CNN learned matching cost (PyTorch): inference and training.

Counterpart of ``stereo_match_tpu/models/mccnn.py``: the siamese feature
tower, its cost volume, the patch-pair hinge-loss trainer, and the weight
carrier that reads and writes the JAX package's flax checkpoints
(``stereo_match_tpu/models/weights/mccnn_*.npz``) with numpy alone. In
inference each tower layer runs on K8 and the volume on K9
(``ops/cuda_kernels.py``) for CUDA tensors, on their plain versions for CPU
tensors, or, on the one-kernel path below, the last layer and the volume
on K11. :func:`mccnn_cost_volume_fused` is the JAX package's one-kernel
path: the tower's layers but the last on K8, then one launch of K11
(``mccnn_fused_volume``), which computes the last layer, its norm and the
volume without the features in device memory; :func:`mccnn_cost_volume`
takes it on the card at min_disparity 0 and D a multiple of 128, as JAX
takes it on the TPU. The train step is the plain differentiable tower
(``F.conv2d``, the float32 body of ``mccnn_conv3x3_plain``) under autograd
and :class:`~stereo_match_tpu_torch.models.optim.Adam`, as flax's
``model.apply`` is XLA convolutions under ``jax.value_and_grad`` and
``optax.adam``; no Pallas kernel has a backward to port.

The TPU's weight stacks (``_tower_weight_stacks``) are its MXU layout:
K8 and K11 read their own copies of the weights (``layout{i}``). The
sharding rules
(:data:`PARTITION_RULES`, :func:`match_partition_rules`,
:func:`shard_params`) and the ``mesh=`` trainer (data parallel over
"data", conv output channels over "model") run in one process over a
device mesh, autograd carrying the backward across its devices. The
checkpoints are the flax-layout ``.npz`` the JAX package reads; its orbax
``save_params`` / ``load_params`` are not ported (orbax is not on the
card's machine).
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import torch
from torch import nn

from stereo_match_tpu_torch.models.optim import (Adam, LearningRate,
                                                 float32_scope, make_step)
from stereo_match_tpu_torch.ops.cost_volume import check_min_disparity
from stereo_match_tpu_torch.ops.cuda_kernels import (
    MCCNN_FUSED_TW, MCCNN_MAX_FEATURES, fused_from_k8_layout, mccnn_conv3x3,
    mccnn_conv3x3_plain, mccnn_fused_volume, mccnn_volume,
    mccnn_weight_layout)
from stereo_match_tpu_torch.utils.backend import entry_device

if TYPE_CHECKING:   # parallel/ imports the pipeline, which imports this
    from stereo_match_tpu_torch.parallel.mesh import DeviceMesh

ARCHS = {"fast": (64, 4), "accurate": (112, 5)}   # arch -> (F, layers)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _lecun_normal(shape: tuple[int, ...],
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default kernel initialisation (truncated at two std), drawn
    from ``generator`` (torch's default one if None)."""
    std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / 0.87962566
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std,
                                 b=2.0 * std, generator=generator)


class MCCNNFeatures(nn.Module):
    """Siamese feature tower: ``num_layers`` 3x3 convs, L2-normalized.

    Weights ``weights[i]`` (F, C_in, 3, 3) and biases ``biases[i]`` (F,)
    are float32 parameters, whatever ``compute_dtype`` is (flax's
    ``param_dtype``); they take no gradients but while :func:`train`
    runs, which differentiates the plain tower (:func:`tower_plain`), not
    K8. ``compute_dtype``, as
    flax's: float32, or bfloat16, where each layer rounds its input and
    weights to bfloat16, sums in float32 and rounds its output (K8's
    ``bf16`` mode, ``mccnn_conv3x3_plain``); the L2 norm is float32 either
    way, and so are the features; between layers bfloat16 activations are
    bfloat16 channels-last tensors (:meth:`forward`). ``layout{i}`` is the
    copy of layer i's weights that K8 reads (``mccnn_weight_layout`` for
    ``compute_dtype``: the (3, 3, 1, F) taps of the first layer, the packed
    taps of the others), made when the weights are set (construction,
    ``load_state_dict``) and moved with the module; ``layout_fused`` is
    K11's copy of the last layer's (``mccnn_fused_weight_layout``; None
    for a tower of one layer). Whoever changes a
    weight in place (an optimizer step, ``copy_``) must call
    :meth:`relayout` after it, or K8 on the card goes on reading the old
    weights while the CPU's plain path reads the new ones; :func:`train`
    does. :meth:`bf16_twin` is the same
    tower computing in bfloat16 (``mccnn_cost_volume(use_bf16=True)``).
    A tower wider than K8 takes
    (``MCCNN_MAX_FEATURES``) keeps no copy: it builds, loads and runs on
    the CPU at any F, as flax does, and raises on the card.
    """

    def __init__(self, features: int = 64, num_layers: int = 4,
                 kernel: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 seed: int | None = None):
        super().__init__()
        if kernel != 3:
            raise ValueError("the MC-CNN tower takes 3x3 kernels (K8)")
        _check_compute_dtype(compute_dtype)
        self.features, self.num_layers, self.kernel = (features, num_layers,
                                                       kernel)
        self.compute_dtype = compute_dtype
        shapes = [(features, 1 if i == 0 else features, 3, 3)
                  for i in range(num_layers)]
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        self.weights = nn.ParameterList(
            nn.Parameter(_lecun_normal(s, gen), requires_grad=False)
            for s in shapes)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(features), requires_grad=False)
            for _ in range(num_layers))
        for i in range(num_layers):
            self.register_buffer(f"layout{i}", torch.empty(0),
                                 persistent=False)
        self.register_buffer("layout_fused", torch.empty(0),
                             persistent=False)
        self.relayout()
        self.register_load_state_dict_post_hook(
            lambda module, _: module.relayout())

    def relayout(self) -> None:
        """Rebuild K8's copy of each layer's weights (None where F is wider
        than K8 takes), and drop the twins, which hold copies of their
        own."""
        bf16 = self.compute_dtype == torch.bfloat16
        for i, w in enumerate(self.weights):
            setattr(self, f"layout{i}",
                    mccnn_weight_layout(w.detach(), bf16)
                    if self.features <= MCCNN_MAX_FEATURES else None)
        last = getattr(self, f"layout{self.num_layers - 1}")
        self.layout_fused = None if last is None or self.num_layers < 2 \
            else fused_from_k8_layout(last, bf16)
        self.__dict__.pop("_twins", None)

    def twin(self, compute_dtype: torch.dtype) -> MCCNNFeatures:
        """This tower computing in ``compute_dtype``: ``self`` where it
        does already, else a tower that shares this one's parameters, made
        once and kept (outside the module's state) with K8's copies of the
        weights for that dtype, and made anew when the weights are set
        again or have moved device."""
        _check_compute_dtype(compute_dtype)
        if self.compute_dtype == compute_dtype:
            return self
        twins = self.__dict__.setdefault("_twins", {})
        twin = twins.get(compute_dtype)
        if twin is None or (twin.layout0 is not None and
                            twin.layout0.device != self.weights[0].device):
            twin = MCCNNFeatures(self.features, self.num_layers, self.kernel,
                                 compute_dtype)
            twin.weights, twin.biases = self.weights, self.biases
            twin.relayout()
            twins[compute_dtype] = twin
        return twin

    def bf16_twin(self) -> MCCNNFeatures:
        """This tower computing in bfloat16, as the twin JAX builds for
        ``use_bf16=True`` (:meth:`twin`)."""
        return self.twin(torch.bfloat16)

    def hidden(self, x: torch.Tensor,
               channels_last: bool = False) -> torch.Tensor:
        """(V, H, W) normalized images -> the last layer's input: every
        layer but the last on K8, (V, F, H, W) float32, or in bfloat16 a
        bfloat16 tensor in ``torch.channels_last`` (flax's NHWC; exact,
        the values are bfloat16), which K8 reads and writes as it is; the
        (V, 1, H, W) images for a tower of one layer. ``channels_last``:
        in float32 too in ``torch.channels_last`` (the same values), as K11
        reads it; K8's launch before the last writes it so."""
        h = x[:, None].contiguous()
        bf16 = self.compute_dtype == torch.bfloat16
        for i in range(self.num_layers - 1):
            h = mccnn_conv3x3(h, self.weights[i], self.biases[i], relu=True,
                              normalize=False,
                              layout=getattr(self, f"layout{i}"),
                              bf16=bf16, bf16_out=bf16,
                              channels_last=channels_last and not bf16 and
                              i == self.num_layers - 2)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(V, H, W) normalized images -> (V, F, H, W) unit features,
        float32: :meth:`hidden`, then the last layer and its norm."""
        i = self.num_layers - 1
        return mccnn_conv3x3(self.hidden(x), self.weights[i], self.biases[i],
                             relu=False, normalize=True,
                             layout=getattr(self, f"layout{i}"),
                             bf16=self.compute_dtype == torch.bfloat16,
                             bf16_out=False)


def _check_compute_dtype(dtype: torch.dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {dtype}: the tower computes in "
                         "torch.float32 or torch.bfloat16")


def make_model(arch: str | tuple[int, int] = "fast",
               compute_dtype: torch.dtype = torch.float32,
               seed: int | None = None) -> MCCNNFeatures:
    """`fast` (4x64, the KITTI-fast analog), `accurate` (5x112), or any
    (features, num_layers) pair, as the flax module takes; computing in
    ``compute_dtype``. The weights are flax's distribution drawn from a
    ``torch.Generator`` seeded with ``seed`` (torch's default generator if
    None): not flax's random stream, so carry flax's weights across with
    :func:`from_flax_params` to compare the two."""
    if isinstance(arch, tuple):
        features, num_layers = arch
    elif arch in ARCHS:
        features, num_layers = ARCHS[arch]
    else:
        raise ValueError(f"unknown arch: {arch}")
    return MCCNNFeatures(features=features, num_layers=num_layers,
                         compute_dtype=compute_dtype, seed=seed)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit population std (``jnp.std``'s ddof=0), float32."""
    img = torch.as_tensor(img, dtype=torch.float32)
    return (img - torch.mean(img)) / (torch.std(img, correction=0) + 1e-6)


def fused_path_applies(model: MCCNNFeatures, num_disparities: int,
                       min_disparity: int) -> bool:
    """Whether :func:`mccnn_cost_volume` takes the one-kernel path on the
    card: JAX's condition for its fused TPU path (min_disparity 0, D a
    multiple of 128, 3x3 kernels), for a tower K11 takes (at least two
    layers, F a multiple of 16 up to ``MCCNN_MAX_FEATURES``)."""
    return (min_disparity == 0 and num_disparities % MCCNN_FUSED_TW == 0
            and model.kernel == 3 and model.num_layers >= 2
            and model.features % 16 == 0
            and model.features <= MCCNN_MAX_FEATURES)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def mccnn_cost_volume(model: MCCNNFeatures, left: torch.Tensor,
                      right: torch.Tensor, num_disparities: int,
                      min_disparity: int = 0, scale: float = 24.0,
                      use_bf16: bool | None = None) -> torch.Tensor:
    """(D, H, W) learned cost: scale * (1 - <f_L(x), f_R(x-d)>) / 2.

    ``scale`` puts the cost in the range of the census Hamming cost, so
    the SGM P1/P2 defaults carry over. The images and ``model`` must be on
    one device. ``use_bf16``: True computes the tower in bfloat16 on any
    device, with the model's weights (``model.bf16_twin()``, as JAX builds
    a bfloat16 twin of a float32 model); None or False keep the model's
    own ``compute_dtype`` (what the JAX package does off the TPU). The
    features and the volume are float32 either way. On the card, where
    :func:`fused_path_applies` (as JAX takes its fused path on the TPU),
    the volume is :func:`mccnn_cost_volume_fused`'s one-kernel path (K8
    for the layers but the last, then K11); otherwise the tower on K8 and
    the volume on K9.
    """
    check_min_disparity(min_disparity)
    tower = model.bf16_twin() if use_bf16 else model
    if _on_card(left) and fused_path_applies(tower, num_disparities,
                                             min_disparity):
        return mccnn_cost_volume_fused(tower, left, right, num_disparities,
                                       scale, tower.compute_dtype)
    imgs = torch.stack([normalize_image(left), normalize_image(right)])
    feats = tower(imgs)
    return mccnn_volume(feats[0], feats[1], num_disparities, min_disparity,
                        scale)


def mccnn_cost_volume_fused(model: MCCNNFeatures, left: torch.Tensor,
                            right: torch.Tensor, num_disparities: int,
                            scale: float = 24.0,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            single_kernel: bool = True) -> torch.Tensor:
    """The one-kernel path: images -> the (D, H, W) volume at
    min_disparity 0, the features of the last layer never in device memory.

    JAX's ``mccnn_cost_volume_fused`` with the port's model carrying its
    weights (no ``params``). ``compute_dtype`` picks the tower's mode:
    ``model`` where it computes in it, else its twin (``model.twin``).
    ``single_kernel`` (the default): the layers but the last on K8, the
    last of them writing channels-last (``hidden(channels_last=True)``),
    then K11 (``mccnn_fused_volume``, on the tower's ``layout_fused``): the
    last layer, its norm and the Gram band in one launch.
    ``single_kernel=False`` is the two-kernel semantics reference, K8 for
    every layer then K9; on the card K11 is held to it within K9's
    tolerance a cell (and in bfloat16 what K8's rounding moves), and on
    the CPU both run the same plain layers and volume. ValueError, as JAX
    raises, for num_disparities not a multiple of 128, a kernel that is not
    3x3 and F not a multiple of 16 (its Pallas kernel's sublane tile), and
    for a tower of one layer.
    """
    if num_disparities % MCCNN_FUSED_TW or num_disparities < 1:
        raise ValueError(f"the fused MC-CNN volume needs num_disparities % "
                         f"{MCCNN_FUSED_TW} == 0, got {num_disparities}")
    if model.kernel != 3:
        raise ValueError("the fused tower takes 3x3 kernels")
    if model.features % 16:
        raise ValueError(f"the fused tower needs features a multiple of 16, "
                         f"got {model.features}")
    if model.num_layers < 2:
        raise ValueError("the fused tower needs at least two layers")
    tower = model.twin(compute_dtype)
    imgs = torch.stack([normalize_image(left), normalize_image(right)])
    i = tower.num_layers - 1
    w, b = tower.weights[i], tower.biases[i]
    bf16 = compute_dtype == torch.bfloat16
    if single_kernel:
        return mccnn_fused_volume(tower.hidden(imgs, channels_last=True), w,
                                  b, num_disparities, scale,
                                  layout=tower.layout_fused, bf16=bf16)
    feats = mccnn_conv3x3(tower.hidden(imgs), w, b, relu=False,
                          normalize=True, layout=getattr(tower, f"layout{i}"),
                          bf16=bf16)
    return mccnn_volume(feats[0], feats[1], num_disparities, 0, scale)


# ------------------------------------------------------------- training ----

def sample_training_patches(left: np.ndarray, right: np.ndarray,
                            gt_disparity: np.ndarray, n: int,
                            patch: int = 16,
                            neg_offset: tuple[int, int] = (4, 9),
                            seed: int = 0):
    """Host-side patch miner: (anchor, positive, negative) float32 stacks
    (n, patch, patch), the JAX package's numpy code as it is.

    Anchors are sampled where GT is valid and the matching patch fits;
    negatives shift the right patch by a random offset in +-[lo, hi) --
    the MC-CNN training recipe.
    """
    rng = np.random.default_rng(seed)
    H, W = left.shape
    r = patch // 2
    ys, xs = np.where(np.isfinite(gt_disparity))
    keep = (ys >= r) & (ys < H - r) & (xs >= r) & (xs < W - r)
    ys, xs = ys[keep], xs[keep]
    d = gt_disparity[ys, xs]
    xr = np.round(xs - d).astype(int)
    lo, hi = neg_offset
    off = rng.integers(lo, hi, size=len(ys)) * rng.choice([-1, 1],
                                                          size=len(ys))
    xn = xr + off
    ok = (xr >= r) & (xr < W - r) & (xn >= r) & (xn < W - r)
    ys, xs, xr, xn = ys[ok], xs[ok], xr[ok], xn[ok]
    if len(ys) == 0:
        raise ValueError("no valid training anchors")
    pick = rng.choice(len(ys), size=min(n, len(ys)), replace=len(ys) < n)
    ys, xs, xr, xn = ys[pick], xs[pick], xr[pick], xn[pick]

    def crop(img, yy, xx):
        out = np.empty((len(yy), patch, patch), np.float32)
        for i, (y, x) in enumerate(zip(yy, xx)):
            out[i] = img[y - r:y + r, x - r:x + r]
        return out

    return crop(left, ys, xs), crop(right, ys, xr), crop(right, ys, xn)


def tower_plain(model: MCCNNFeatures, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, F, H, W): the tower as ``mccnn_conv3x3_plain``
    layers (``F.conv2d``, ReLU, the L2 norm) on ``model``'s weights, which
    autograd differentiates, in the model's compute dtype. What flax's
    ``model.apply`` is in the JAX package's train step."""
    bf16 = model.compute_dtype == torch.bfloat16
    h = x[:, None]
    for i in range(model.num_layers):
        last = i == model.num_layers - 1
        h = mccnn_conv3x3_plain(h, model.weights[i], model.biases[i],
                                relu=not last, normalize=last, bf16=bf16)
    return h


def hinge_loss(model: MCCNNFeatures, anchor: torch.Tensor,
               positive: torch.Tensor, negative: torch.Tensor,
               margin: float = 0.2) -> torch.Tensor:
    """mean(max(0, margin + s_neg - s_pos)) on the centre pixel's feature
    similarity of (N, P, P) patch stacks; the three stacks go through the
    tower as one batch."""
    f = tower_plain(model, torch.cat([anchor, positive, negative]))
    return _centre_hinge(f, anchor.shape[0], margin)


def _centre_hinge(f: torch.Tensor, n: int, margin: float) -> torch.Tensor:
    """The hinge loss from the (3n, F, P, P) features of the anchors,
    positives and negatives, in that order."""
    c = f.shape[2] // 2
    centre = f[:, :, c, c]
    fa, fp, fn = centre[:n], centre[n:2 * n], centre[2 * n:]
    s_pos = torch.sum(fa * fp, dim=-1)
    s_neg = torch.sum(fa * fn, dim=-1)
    return torch.mean(torch.clamp_min(margin + s_neg - s_pos, 0.0))


# ------------------------------------------------------------ sharding ----

# Regex on a parameter's flax path -> its spec, an axis name or None per
# dimension of the flax array (() replicated): the JAX package's rules,
# its PartitionSpecs as tuples.
PARTITION_RULES = (
    # conv kernels (kh, kw, in, out): shard output channels over "model"
    (r"conv\d+/kernel", (None, None, None, "model")),
    (r"conv\d+/bias", ("model",)),
    (r".*", ()),
)
FLAX_TO_OIHW = (3, 2, 0, 1)   # torch's dim j is flax's kernel dim [j]


def match_partition_rules(rules, params: Mapping) -> dict:
    """A flax-named parameter tree (``params/conv{i}/kernel|bias``, as
    :func:`to_flax_params` gives) -> the same tree of specs: for each leaf
    the spec of the first rule whose regex ``re.search``-es its path joined
    by "/", () where none does."""

    def walk(node, path: str):
        if isinstance(node, Mapping):
            return {key: walk(value, f"{path}/{key}" if path else str(key))
                    for key, value in node.items()}
        return next((spec for rule, spec in rules if re.search(rule, path)),
                    ())

    return walk(params, "")


class ShardedTower:
    """An MC-CNN tower's parameters on a ("data", "model") mesh, placed by
    :data:`PARTITION_RULES` (:func:`shard_params`).

    ``slices[r][m]`` is the list of layer (weight, bias) pairs that device
    ``mesh.devices[r, m]`` holds: each layer's output channels
    ``[m F / M, (m + 1) F / M)`` (dim 0 of torch's (F, C_in, 3, 3), the
    last of flax's kernel) for M "model" devices, the same slices on every
    "data" row. Each slice is a leaf tensor of its own that takes
    gradients. :meth:`features` runs row r's tower: each "model" device
    computes its output channels of a layer from the row's full input
    (``mccnn_conv3x3_plain``), and the channels are joined on the row's
    first device for the next layer; autograd carries the backward across
    the devices.
    """

    def __init__(self, model: MCCNNFeatures, mesh: DeviceMesh):
        if mesh.axis_names != ("data", "model"):
            raise ValueError(f"the tower shards over a ('data', 'model') "
                             f"mesh, not {mesh.axis_names}")
        self.mesh = mesh
        self.num_layers = model.num_layers
        self.compute_dtype = model.compute_dtype
        specs = match_partition_rules(PARTITION_RULES, to_flax_params(model))
        rows, cols = mesh.devices.shape
        self.slices = [[[] for _ in range(cols)] for _ in range(rows)]
        for i in range(model.num_layers):
            spec = specs["params"][f"conv{i}"]
            kernel = tuple(spec["kernel"]) or (None,) * 4
            layer = ((model.weights[i],
                      tuple(kernel[j] for j in FLAX_TO_OIHW)),
                     (model.biases[i], tuple(spec["bias"]) or (None,)))
            for r in range(rows):
                for m in range(cols):
                    self.slices[r][m].append(tuple(
                        self._place(t, s, r, m) for t, s in layer))

    def _place(self, t: torch.Tensor, spec, r: int, m: int) -> torch.Tensor:
        """``t``'s block of device (r, m) by ``spec``, a leaf of its own."""
        at = {"data": r, "model": m}
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(f"{t.shape[dim]} channels do not split "
                                 f"over the {n} devices of {axis!r}")
            size = t.shape[dim] // n
            t = t.narrow(dim, at[axis] * size, size)
        return t.detach().to(self.mesh.devices[r, m], copy=True) \
            .requires_grad_(True)

    def parameters(self) -> list[torch.Tensor]:
        return [t for row in self.slices for col in row for layer in col
                for t in layer]

    def features(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """(N, P, P) patches -> (N, F, P, P) unit features, on data row
        ``r``'s first device."""
        devs = list(self.mesh.devices[r])
        bf16 = self.compute_dtype == torch.bfloat16
        h = x[:, None].to(devs[0])
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            parts = [mccnn_conv3x3_plain(h.to(dev), *self.slices[r][m][i],
                                         relu=not last, normalize=False,
                                         bf16=bf16)
                     for m, dev in enumerate(devs)]
            h = torch.cat([p.to(devs[0]) for p in parts], dim=1)
        return h / torch.sqrt(torch.sum(h * h, dim=1, keepdim=True) + 1e-12)

    def reduce_gradients(self) -> None:
        """Each slice's gradient summed over the "data" rows (on row 0's
        device) and handed to every row's copy of the slice."""
        rows, cols = self.mesh.devices.shape
        for m in range(cols):
            for i in range(self.num_layers):
                for k in range(2):
                    grads = [self.slices[r][m][i][k].grad for r in range(rows)]
                    total = grads[0]
                    for g in grads[1:]:
                        total = total + g.to(total.device)
                    for r in range(rows):
                        self.slices[r][m][i][k].grad = total.to(
                            self.mesh.devices[r, m], copy=True)

    def gather_into(self, model: MCCNNFeatures) -> None:
        """Write row 0's slices into ``model``'s weights and biases (on the
        model's device) and rebuild its K8 copies."""
        with torch.no_grad():
            for i in range(self.num_layers):
                for k, full in enumerate((model.weights[i], model.biases[i])):
                    full.copy_(torch.cat([col[i][k].to(full.device)
                                          for col in self.slices[0]]))
        model.relayout()


def shard_params(model: MCCNNFeatures, mesh: DeviceMesh) -> ShardedTower:
    """``model``'s parameters placed on a ("data", "model") mesh by
    :data:`PARTITION_RULES`: each conv layer's output channels split over
    "model", replicated over "data" (:class:`ShardedTower`)."""
    return ShardedTower(model, mesh)


def _mesh_step(tower: ShardedTower, optimizer: torch.optim.Optimizer,
               margin: float):
    rows = tower.mesh.shape["data"]

    def loss(a, p, n):
        if a.shape[0] % rows:
            raise ValueError(f"a batch of {a.shape[0]} does not split over "
                             f"the {rows} rows of 'data'")
        per = a.shape[0] // rows
        total = None
        for r in range(rows):
            part = slice(r * per, (r + 1) * per)
            f = tower.features(torch.cat([a[part], p[part], n[part]]), r)
            share = _centre_hinge(f, per, margin) / rows
            total = share if total is None else total + share.to(total.device)
        return total

    def step(a, p, n):
        with float32_scope(tower.parameters()[0]):
            optimizer.zero_grad(set_to_none=True)
            value = loss(a, p, n)
            value.backward()
            tower.reduce_gradients()
            optimizer.step()
        return value.detach()

    return step


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    mesh: DeviceMesh | None = None, margin: float = 0.2):
    """``(anchor, positive, negative) -> loss``: one step of ``optimizer``
    on the hinge loss of the batch, in full float32 (``optim.make_step``).

    Without ``mesh``, ``model`` is an :class:`MCCNNFeatures` whose
    parameters take gradients and over which ``optimizer`` runs; the
    caller calls ``model.relayout()`` after its last step (:func:`train`
    does). With a ("data", "model") ``mesh``, ``model`` is the tower's
    :func:`shard_params` on that mesh and ``optimizer`` runs over its
    ``parameters()``: data row r takes rows ``[r N / R, (r + 1) N / R)``
    of the N triplets (N must split evenly), its loss counts 1 / R of the
    step's, so the gradients summed over the rows are those of the mean
    over the whole batch, and every row's copy of a slice takes that sum;
    the optimizer then updates each slice on its own device.
    """
    if mesh is None:
        return make_step(lambda a, p, n: hinge_loss(model, a, p, n, margin),
                         optimizer)
    if not isinstance(model, ShardedTower) or model.mesh is not mesh:
        raise ValueError("with a mesh, the step takes shard_params(model, "
                         "mesh)")
    return _mesh_step(model, optimizer, margin)


def train(model: MCCNNFeatures, batches, learning_rate: LearningRate = 3e-3,
          device: torch.device | str = "cuda", mesh: DeviceMesh | None = None
          ) -> tuple[MCCNNFeatures, list[float]]:
    """Adam (optax's) over an iterable of (anchor, positive, negative)
    batches (arrays or tensors); returns ``(model, losses)``, the model
    moved to ``device`` (the card unless the caller asks for the CPU) and
    trained in place, its K8 copies rebuilt. A batch already on ``device``
    is not copied.

    With a ("data", "model") ``mesh`` the steps run on the mesh
    (:func:`make_train_step`): the parameters are sharded there
    (:func:`shard_params`), Adam updates each slice on its device, and
    the trained slices are gathered into ``model`` at the end.
    """
    dev = entry_device(device)
    if mesh is not None:
        tower = shard_params(model, mesh)
        step = make_train_step(tower, Adam(tower.parameters(),
                                           learning_rate), mesh)
        losses = [step(*(torch.as_tensor(x).to(torch.float32)
                         for x in batch)) for batch in batches]
        model.to(dev)
        tower.gather_into(model)
        return model, torch.stack(losses).tolist() if losses else []
    model.to(dev).requires_grad_(True)
    try:
        step = make_train_step(model, Adam(model.parameters(), learning_rate))
        losses = [step(*(torch.as_tensor(x).to(dev, torch.float32)
                         for x in batch)) for batch in batches]
    finally:
        model.requires_grad_(False)
        model.relayout()
    return model, torch.stack(losses).tolist() if losses else []


def make_training_pool(n_scenes: int, seed: int = 1,
                       height: int = 96, width: int = 160,
                       patches_per_scene: int = 1500, patch: int = 16,
                       num_disparities: int = 32,
                       families: tuple = ("dots", "shaded", "adversarial")):
    """Multi-renderer synthetic (anchor, positive, negative) patch pool,
    host numpy, the JAX package's recipe draw for draw.

    Scenes cycle the renderer families ``dots`` (random-dot stereograms
    over box / slanted / rough GT, sensor noise, blur), ``shaded``
    (``data/synthetic.shaded_shapes_pair``) and ``adversarial`` (right-view
    photometric asymmetry, ``data/synthetic.adversarial_pair``); ``raytrace``
    is available but held out of the default mix, for the out-of-renderer
    evaluation. A random third of the scenes get salt-and-pepper noise.
    Patches are mined from :func:`normalize_image`'s frames (within 1e-6
    of JAX's: its float32 reductions run in another order), as inference
    normalizes.
    """
    from stereo_match_tpu_torch.data.synthetic import (adversarial_pair,
                                                       box_scene,
                                                       random_dot_pair,
                                                       rough_scene,
                                                       shaded_shapes_pair,
                                                       slanted_scene)
    rng = np.random.default_rng(seed)
    d_hi = num_disparities - 2
    A, Ps, N = [], [], []
    for i in range(n_scenes):
        fam = families[i % len(families)]
        kind = (i // len(families)) % 3
        if kind == 0:
            gt = box_scene(height, width, rng.uniform(2, 8),
                           rng.uniform(10, d_hi * 0.8))
        elif kind == 1:
            gt = slanted_scene(height, width, rng.uniform(1, 4),
                               rng.uniform(12, d_hi))
        else:
            gt = rough_scene(height, width, seed * 100 + i, 2.0, d_hi)
        blur = float(rng.choice([0.6, 1.0, 1.5]))
        if fam == "raytrace":
            from stereo_match_tpu_torch.data.raytrace import render_stereo
            left, right, gt = render_stereo(
                height, width, seed=seed * 100 + i,
                noise=float(rng.choice([0.0, 3.0, 6.0])),
                gain_right=float(rng.choice([1.0, 1.1, 1.2])))
        elif fam == "shaded":
            left, right = shaded_shapes_pair(
                height, width, gt, seed=seed * 100 + i,
                noise_saltpepper=float(rng.choice([0.0, 0.01, 0.02])),
                gain_right=float(rng.choice([1.0, 1.1, 1.15])))
        elif fam == "adversarial":
            left, right = adversarial_pair(
                height, width, gt, blur=blur, seed=seed * 100 + i,
                gain=float(rng.uniform(0.9, 1.25)),
                bias=float(rng.uniform(-10.0, 10.0)),
                vignette=float(rng.uniform(0.0, 0.4)),
                noise_left=float(rng.uniform(0.0, 8.0)),
                noise_right=float(rng.uniform(0.0, 8.0)))
        else:
            noise = float(rng.choice([0.0, 5.0, 10.0, 20.0]))
            left, right = random_dot_pair(height, width, gt, blur=blur,
                                          seed=seed * 100 + i, noise=noise)
        if rng.uniform() < 1.0 / 3.0:
            frac = float(rng.uniform(0.005, 0.03))
            for img in (left, right):
                m = rng.uniform(size=img.shape)
                img[m < frac / 2] = 0.0
                img[m > 1 - frac / 2] = 255.0
        ln = normalize_image(left).numpy()
        rn = normalize_image(right).numpy()
        a, p, n = sample_training_patches(ln, rn, gt, patches_per_scene,
                                          patch=patch, seed=seed * 100 + i)
        A.append(a)
        Ps.append(p)
        N.append(n)
    A, Ps, N = map(np.concatenate, (A, Ps, N))
    perm = rng.permutation(len(A))
    return A[perm], Ps[perm], N[perm]


# ------------------------------------------------------ weight carrier ----

def load_params_npz(path: str | Path) -> dict:
    """A flax checkpoint (``save_params_npz``) -> its nested dict of numpy
    arrays, e.g. ``params["params"]["conv0"]["kernel"]``."""
    with np.load(path) as data:
        params: dict = {}
        for key in data.files:
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return params


def from_flax_params(params: Any, arch: str | tuple[int, int] = "fast",
                     compute_dtype: torch.dtype = torch.float32
                     ) -> MCCNNFeatures:
    """A flax parameter tree (numpy or JAX arrays) -> ``MCCNNFeatures``.

    ``arch``: a name of ``ARCHS`` or a (features, num_layers) pair
    (``make_model``); ``compute_dtype`` as the module's (the parameters are
    float32 in both). Kernels are HWIO (3, 3, C_in, F) in flax and OIHW in
    torch: ``permute(3, 2, 0, 1)``. Raises ValueError when a shape does
    not fit ``arch``.
    """
    model = make_model(arch, compute_dtype)
    tree = params["params"]
    if len(tree) != model.num_layers:
        raise ValueError(f"{len(tree)} layers in the checkpoint; arch "
                         f"{arch!r} has {model.num_layers}")
    state = {}
    for i in range(model.num_layers):
        kernel = torch.from_numpy(np.array(tree[f"conv{i}"]["kernel"],
                                           np.float32))
        state[f"weights.{i}"] = kernel.permute(3, 2, 0, 1).contiguous()
        state[f"biases.{i}"] = torch.from_numpy(
            np.array(tree[f"conv{i}"]["bias"], np.float32))
    own = model.state_dict()
    for name, value in state.items():
        if value.shape != own[name].shape:
            raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}"
                             f", arch {arch!r} wants "
                             f"{tuple(own[name].shape)}")
    model.load_state_dict(state)
    return model


def to_flax_params(model: MCCNNFeatures) -> dict:
    """``model`` -> its flax parameter tree of numpy float32 arrays, the
    inverse of :func:`from_flax_params`: OIHW -> HWIO is ``permute(2, 3,
    1, 0)``, under ``params/conv{i}/kernel|bias``."""
    return {"params": {
        f"conv{i}": {"kernel": w.detach().permute(2, 3, 1, 0).cpu().numpy(),
                     "bias": b.detach().cpu().numpy()}
        for i, (w, b) in enumerate(zip(model.weights, model.biases))}}


def save_flax_npz(path: str | Path, params: Mapping) -> Path:
    """A flax parameter tree -> one ``.npz``, its keys the tree's paths
    joined by "/" (what the JAX package's ``save_params_npz`` writes and
    its ``load_params_npz`` reads). Returns the path written:
    ``np.savez_compressed`` appends ``.npz`` to a name without it. Refuses
    to write among the JAX package's shipped checkpoints."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    if path.resolve().parent == default_checkpoint_path().parent:
        raise ValueError(f"{path}: the port does not write the JAX "
                         "package's shipped checkpoints")
    flat = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, name)
            else:
                flat[name] = np.asarray(value)

    walk(params, "")
    np.savez_compressed(path, **flat)
    return path


def save_params_npz(path: str | Path, model: MCCNNFeatures) -> Path:
    """``model``'s weights as a flax ``.npz`` (:func:`save_flax_npz`), which
    :func:`load_params_npz` and the JAX package's ``load_params_npz``
    read; returns the path written."""
    return save_flax_npz(path, to_flax_params(model))


def default_checkpoint_path(arch: str = "fast") -> Path:
    """The checkpoint the JAX package ships for ``arch``.

    Found on disk beside this package (``stereo_match_tpu/models/weights``);
    the ``stereo_match_tpu.models`` package imports flax and JAX, so it is
    not imported.
    """
    return Path(__file__).resolve().parents[2] / "stereo_match_tpu" / \
        "models" / "weights" / f"mccnn_{arch}.npz"


def load_default_params(arch: str = "fast") -> dict:
    """The shipped weights as a numpy tree; FileNotFoundError if absent."""
    return load_params_npz(default_checkpoint_path(arch))
