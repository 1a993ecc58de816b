"""MC-CNN learned matching cost, inference (PyTorch).

Counterpart of ``stereo_match_tpu/models/mccnn.py``: the siamese feature
tower, its cost volume and the weight carrier that reads the JAX package's
flax checkpoints (``stereo_match_tpu/models/weights/mccnn_*.npz``) with
numpy alone. Each tower layer runs on K8 and the volume on K9
(``ops/cuda_kernels.py``) for CUDA tensors, on their plain versions for CPU
tensors.

The TPU's weight stacks (``_tower_weight_stacks``) and its fused
tower + volume kernel (``mccnn_cost_volume_fused``) are MXU layout and
fusion; K8 then K9 compute what they compute. Training, the sharding
rules and the orbax checkpoints are not ported (ROADMAP.md, queue 1 item
6).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from stereo_match_tpu_torch.ops.cost_volume import check_min_disparity
from stereo_match_tpu_torch.ops.cuda_kernels import (MCCNN_MAX_FEATURES,
                                                     mccnn_conv3x3,
                                                     mccnn_volume,
                                                     mccnn_weight_layout)

ARCHS = {"fast": (64, 4), "accurate": (112, 5)}   # arch -> (F, layers)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _lecun_normal(shape: tuple[int, ...]) -> torch.Tensor:
    """flax's default kernel initialisation (truncated at two std)."""
    std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / 0.87962566
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std,
                                 b=2.0 * std)


class MCCNNFeatures(nn.Module):
    """Siamese feature tower: ``num_layers`` 3x3 convs, L2-normalized.

    Weights ``weights[i]`` (F, C_in, 3, 3) and biases ``biases[i]`` (F,)
    are float32 parameters without gradients (inference only), whatever
    ``compute_dtype`` is (flax's ``param_dtype``). ``compute_dtype``, as
    flax's: float32, or bfloat16, where each layer rounds its input and
    weights to bfloat16, sums in float32 and rounds its output (K8's
    ``bf16`` mode, ``mccnn_conv3x3_plain``); the L2 norm is float32 either
    way, and so are the activations' tensors. ``layout{i}`` is the copy of
    layer i's weights that K8 reads (``mccnn_weight_layout`` for
    ``compute_dtype``: the (3, 3, 1, F) taps of the first layer, the packed
    taps of the others), made when the weights are set (construction,
    ``load_state_dict``) and moved with the module; after changing a
    weight in place, call :meth:`relayout`. :meth:`bf16_twin` is the same
    tower computing in bfloat16 (``mccnn_cost_volume(use_bf16=True)``).
    A tower wider than K8 takes
    (``MCCNN_MAX_FEATURES``) keeps no copy: it builds, loads and runs on
    the CPU at any F, as flax does, and raises on the card.
    """

    def __init__(self, features: int = 64, num_layers: int = 4,
                 kernel: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel != 3:
            raise ValueError("the MC-CNN tower takes 3x3 kernels (K8)")
        _check_compute_dtype(compute_dtype)
        self.features, self.num_layers, self.kernel = (features, num_layers,
                                                       kernel)
        self.compute_dtype = compute_dtype
        shapes = [(features, 1 if i == 0 else features, 3, 3)
                  for i in range(num_layers)]
        self.weights = nn.ParameterList(
            nn.Parameter(_lecun_normal(s), requires_grad=False)
            for s in shapes)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(features), requires_grad=False)
            for _ in range(num_layers))
        for i in range(num_layers):
            self.register_buffer(f"layout{i}", torch.empty(0),
                                 persistent=False)
        self.relayout()
        self.register_load_state_dict_post_hook(
            lambda module, _: module.relayout())

    def relayout(self) -> None:
        """Rebuild K8's copy of each layer's weights (None where F is wider
        than K8 takes), and drop the bfloat16 twin, which holds copies of
        its own."""
        bf16 = self.compute_dtype == torch.bfloat16
        for i, w in enumerate(self.weights):
            setattr(self, f"layout{i}",
                    mccnn_weight_layout(w.detach(), bf16)
                    if self.features <= MCCNN_MAX_FEATURES else None)
        self.__dict__.pop("_twin", None)

    def bf16_twin(self) -> MCCNNFeatures:
        """This tower computing in bfloat16, as the twin JAX builds for
        ``use_bf16=True``: ``self`` where it does already, else a tower that
        shares this one's parameters, made once and kept (outside the
        module's state) with K8's bfloat16 copies of the weights, and made
        anew when the weights are set again or have moved device."""
        if self.compute_dtype == torch.bfloat16:
            return self
        twin = self.__dict__.get("_twin")
        if twin is None or (twin.layout0 is not None and
                            twin.layout0.device != self.weights[0].device):
            twin = MCCNNFeatures(self.features, self.num_layers, self.kernel,
                                 torch.bfloat16)
            twin.weights, twin.biases = self.weights, self.biases
            twin.relayout()
            self.__dict__["_twin"] = twin
        return twin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(V, H, W) normalized images -> (V, F, H, W) unit features."""
        h = x[:, None].contiguous()
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            h = mccnn_conv3x3(h, self.weights[i], self.biases[i],
                              relu=not last, normalize=last,
                              layout=getattr(self, f"layout{i}"),
                              bf16=self.compute_dtype == torch.bfloat16)
        return h


def _check_compute_dtype(dtype: torch.dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {dtype}: the tower computes in "
                         "torch.float32 or torch.bfloat16")


def make_model(arch: str | tuple[int, int] = "fast",
               compute_dtype: torch.dtype = torch.float32) -> MCCNNFeatures:
    """`fast` (4x64, the KITTI-fast analog), `accurate` (5x112), or any
    (features, num_layers) pair, as the flax module takes; computing in
    ``compute_dtype``."""
    if isinstance(arch, tuple):
        features, num_layers = arch
    elif arch in ARCHS:
        features, num_layers = ARCHS[arch]
    else:
        raise ValueError(f"unknown arch: {arch}")
    return MCCNNFeatures(features=features, num_layers=num_layers,
                         compute_dtype=compute_dtype)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit population std (``jnp.std``'s ddof=0), float32."""
    img = torch.as_tensor(img, dtype=torch.float32)
    return (img - torch.mean(img)) / (torch.std(img, correction=0) + 1e-6)


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
    features and the volume are float32 either way.
    """
    check_min_disparity(min_disparity)
    imgs = torch.stack([normalize_image(left), normalize_image(right)])
    feats = (model.bf16_twin() if use_bf16 else model)(imgs)
    return mccnn_volume(feats[0], feats[1], num_disparities, min_disparity,
                        scale)


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
