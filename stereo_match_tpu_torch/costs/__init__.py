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
from stereo_match_tpu_torch.ops.cuda_kernels import (census_volume,
                                                     census_words)


class CostProvider(Protocol):
    def __call__(self, left: torch.Tensor,
                 right: torch.Tensor) -> torch.Tensor:
        """Grayscale pair -> (D, H, W) cost volume."""


@dataclass(frozen=True)
class ClassicCost:
    """Census words of both views (K1), then the Hamming volume (K2).

    The volume is float32, or int16 with ``config.dtype == "int16"``. The
    other classic families (sad, ssd, bt) are not ported.
    """
    config: DisparityConfig

    def __call__(self, left: torch.Tensor,
                 right: torch.Tensor) -> torch.Tensor:
        c = self.config
        if c.cost != "census":
            raise NotImplementedError(
                f"cost={c.cost!r} is not ported yet (ROADMAP.md, queue 1 "
                "item 9: other costs and matchers)")
        imgs = torch.stack([left, right]).to(torch.float32).contiguous()
        words = census_words(imgs, c.census_window)
        return census_volume(words[0], words[1], c.num_disparities,
                             c.min_disparity, dtype=c.dtype)


@dataclass(frozen=True)
class MCCNNCost:
    """Learned cost from an MC-CNN tower (tower on K8, volume on K9).

    The port's ``MCCNNFeatures`` carries its weights, so there is no
    separate ``params`` as in the JAX provider; the model must be on the
    images' device.
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
