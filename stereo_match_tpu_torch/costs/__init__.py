"""Cost providers: one interface over the matching-cost families (PyTorch).

Counterpart of ``stereo_match_tpu/costs/__init__.py``. A provider is a
callable ``(left, right) -> (D, H, W)`` float32 volume on the images'
device, which ``pipeline/stereo.py::StereoMatcher`` takes as ``cost_fn``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.models.mccnn import (MCCNNFeatures,
                                                 mccnn_cost_volume)
from stereo_match_tpu_torch.ops.cost_volume import (build_cost_volume,
                                                    check_min_disparity)
from stereo_match_tpu_torch.ops.cuda_kernels import (census_volume,
                                                     census_words)


class CostProvider(Protocol):
    def __call__(self, left: torch.Tensor,
                 right: torch.Tensor) -> torch.Tensor:
        """Grayscale pair -> (D, H, W) cost volume."""


def census_cost(left: torch.Tensor, right: torch.Tensor,
                config: DisparityConfig, dtype="float32") -> torch.Tensor:
    """Census words of both views (K1), then the Hamming volume (K2), any
    odd window (``ceil((wh * ww - 1) / 32)`` words), float32 or int16."""
    check_min_disparity(config.min_disparity)
    imgs = torch.stack([left, right]).to(torch.float32).contiguous()
    words = census_words(imgs, config.census_window)
    return census_volume(words[0], words[1], config.num_disparities,
                         config.min_disparity, dtype=dtype)


@dataclass(frozen=True)
class ClassicCost:
    """census | sad | ssd | bt, as the JAX provider: always float32.

    Census runs on K1 and K2; sad, ssd and bt are plain torch
    (``ops/cost_volume.py``), as they are XLA in the JAX package.
    """
    config: DisparityConfig

    def __call__(self, left: torch.Tensor,
                 right: torch.Tensor) -> torch.Tensor:
        c = self.config
        if c.cost == "census":
            return census_cost(left, right, c)
        return build_cost_volume(
            left, right, num_disparities=c.num_disparities,
            min_disparity=c.min_disparity, cost=c.cost,
            block_size=c.block_size, window=c.census_window,
            pre_filter_cap=c.pre_filter_cap)


@dataclass(frozen=True)
class MCCNNCost:
    """Learned cost from an MC-CNN tower (``mccnn_cost_volume``).

    On the card at min_disparity 0 and D a multiple of 128 (JAX's
    condition for its fused TPU kernel) the layers but the last run on K8
    and the last layer, its norm and the volume on K11 in one launch;
    otherwise the tower on K8 and the volume on K9. The port's
    ``MCCNNFeatures`` carries its weights, so there is no separate
    ``params`` as in the JAX provider; the model must be on the images'
    device.
    """
    model: MCCNNFeatures
    config: DisparityConfig
    scale: float = 24.0

    def __call__(self, left: torch.Tensor,
                 right: torch.Tensor) -> torch.Tensor:
        c = self.config
        return mccnn_cost_volume(self.model, left, right,
                                 num_disparities=c.num_disparities,
                                 min_disparity=c.min_disparity,
                                 scale=self.scale)


def make_cost_provider(config: DisparityConfig,
                       model: MCCNNFeatures | None = None) -> Callable:
    if config.cost == "mccnn":
        if model is None:
            raise ValueError("cost='mccnn' needs a model")
        return MCCNNCost(model, config)
    return ClassicCost(config)
