"""Adam and the cosine decay schedule, as optax computes them.

The JAX package trains with ``optax.adam(learning_rate)``, where
``learning_rate`` is a float or a schedule ``count -> lr``
(``optax.cosine_decay_schedule`` in ``tools/train_monodepth.py``). The
trainers of the port use :class:`Adam`, ``torch.optim.Adam`` (fused),
which computes optax's ``scale_by_adam`` then ``scale_by_learning_rate``:

    m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2,   t <- t + 1
    p <- p - lr(t - 1) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with b1 = 0.9, b2 = 0.999, eps = 1e-8 and eps_root = 0: the bias
correction at the incremented count, the schedule read at the count
before it (optax's ``scale_by_schedule`` reads its own count, which
starts at 0). torch orders the operations otherwise (``m`` by ``lerp``,
``sqrt(v) / sqrt(1 - b2^t)``), a few float32 ulps apart. The schedule's
count stays on the host and torch's own on the parameters' device, so a
step makes no host sync. :func:`make_step` is the trainers' step, in
:func:`float32_scope`.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable, Iterable

import torch

from stereo_match_tpu_torch.ops.cuda_kernels import fp32_cudnn

LearningRate = float | Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``count -> init_value * ((1 - alpha)
    * (0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps)))
    ** exponent + alpha)``, for the 0-based count of steps taken."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


class Adam(torch.optim.Adam):
    """``optax.adam(learning_rate)`` over torch parameters:
    ``torch.optim.Adam`` (fused: a few launches a step for all tensors),
    its ``lr`` set before each step from ``learning_rate``, a float or a
    callable of the 0-based step count, at the count before the increment.
    :attr:`count` is the number of steps taken (optax's ``count``).
    """

    def __init__(self, params: Iterable[torch.Tensor],
                 learning_rate: LearningRate = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.count = 0
        super().__init__(params, lr=self.lr(0), betas=(b1, b2), eps=eps,
                         fused=True)

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            group["lr"] = self.lr(self.count)
        self.count += 1
        return super().step()


@contextlib.contextmanager
def float32_scope(x: torch.Tensor):
    """Float32 gradients as exact as flax's, around a whole train step
    (forward, backward and update): on the card cuDNN and matmuls without
    TF32 (``fp32_cudnn``; cuDNN's backward is TF32 by default, and a
    layer's own scope closes before its backward runs). On the CPU
    nothing changes."""
    with fp32_cudnn() if x.is_cuda else contextlib.nullcontext():
        yield


def make_step(loss: Callable[..., torch.Tensor],
              optimizer: torch.optim.Optimizer):
    """``(*batch) -> loss``: one step of ``optimizer`` on ``loss(*batch)``
    in :func:`float32_scope`; the loss is returned on the batch's device,
    with no host sync."""

    def step(*batch: torch.Tensor) -> torch.Tensor:
        with float32_scope(batch[0]):
            optimizer.zero_grad(set_to_none=True)
            value = loss(*batch)
            value.backward()
            optimizer.step()
        return value.detach()

    return step
