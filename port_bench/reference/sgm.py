"""Semi-global matching over 8 paths (Hirschmueller, TPAMI 2008; plain
PyTorch).

Along a path direction r:

    L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d -+ 1) + P1,
                              min_k L_r(p-r, k) + P2) - min_k L_r(p-r, k)

with L beyond the disparity range at 1e9 and a zero L before a path
enters the frame (so a path's first pixel gets L = C). The total is the
sum of the directions' L, added in the order of ``DIRECTIONS``. All
arithmetic runs in the volume's dtype (float32, or bfloat16 for the
check's control).
"""

from __future__ import annotations

import torch

DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))
BIG = 1e9


def _step(c: torch.Tensor, carry: torch.Tensor, p1: float,
          p2: float) -> torch.Tensor:
    """One step on (N, D, S) slabs."""
    prev_min = carry.amin(dim=1, keepdim=True)
    edge = torch.full_like(carry[:, :1], BIG)
    up = torch.cat([edge, carry[:, :-1]], dim=1)
    down = torch.cat([carry[:, 1:], edge], dim=1)
    m = torch.minimum(torch.minimum(carry, prev_min + p2),
                      torch.minimum(up, down) + p1)
    return c + m - prev_min


def _shift(carry: torch.Tensor, dx: int) -> torch.Tensor:
    """out[..., x] = carry[..., x - dx], zero where x - dx leaves the
    frame."""
    zero = torch.zeros_like(carry[..., :1])
    if dx > 0:
        return torch.cat([zero, carry[..., :-1]], dim=-1)
    return torch.cat([carry[..., 1:], zero], dim=-1)


def sgm_total(cost: torch.Tensor, p1: float, p2: float,
              num_paths: int = 8) -> torch.Tensor:
    """(N, D, H, W) cost -> the (N, D, H, W) total over ``num_paths``."""
    N, D, H, W = cost.shape
    total = torch.zeros_like(cost)
    for dy, dx in DIRECTIONS[:num_paths]:
        carry = torch.zeros_like(cost[:, :, 0] if dy else cost[..., 0])
        if dy == 0:
            xs = range(W) if dx > 0 else range(W - 1, -1, -1)
            for x in xs:
                carry = _step(cost[..., x], carry, p1, p2)
                total[..., x] += carry
            continue
        ys = range(H) if dy > 0 else range(H - 1, -1, -1)
        for y in ys:
            if dx:
                carry = _shift(carry, dx)
            carry = _step(cost[:, :, y], carry, p1, p2)
            total[:, :, y] += carry
    return total
