"""Semi-global matching path aggregation (plain PyTorch, the exact oracle).

Counterpart of ``stereo_match_tpu/ops/sgm.py``. The recurrence along a path
direction r is

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

summed over ``num_paths`` directions (8, 4 or 2) on (D, H, W) volumes.
The arithmetic is the JAX package's, operation for operation and in the
same order (``1e9`` at the d-edges, ``(C + m) - min``), and the direction
totals are summed in ``PATH_DIRECTIONS_8`` order, so the totals are
bit-identical to the reference's for any P1, P2 >= 0.

int16 volumes follow the XLA int16 path: P1 and P2 are truncated to
integers, the d-edges hold 30000, L and the total are int16. The values are
computed in int32 and stored as int16, which is the same arithmetic: the
config bounds every value below 2^15 (``num_paths * (1024 + P2)``).

Diagonal paths carry the previous row's L shifted by one column, with zeros
shifted in at the frame edge. That equals the reference's shear: there,
out-of-frame cells hold cost 0 and carry 0, so every diagonal path starts
from a zero carry where it enters the frame.
"""

from __future__ import annotations

import torch

# (dy, dx) path directions, grouped so num_paths in {2, 4, 8} takes a prefix.
# A path runs through p, p + (dy, dx), p + 2 (dy, dx), ...
PATH_DIRECTIONS_8 = (
    (0, 1), (0, -1),            # horizontal (along the epipolar line)
    (1, 0), (-1, 0),            # vertical
    (1, 1), (-1, -1),           # main diagonal
    (1, -1), (-1, 1),           # anti diagonal
)

BIG = 1e9   # L(d-1) / L(d+1) beyond the disparity range
BIG_I16 = 30000   # the same for int16 volumes


def _step(c: torch.Tensor, carry: torch.Tensor, p1: torch.Tensor,
          p2: torch.Tensor, big: float) -> torch.Tensor:
    """One SGM step on a (D, N) slab: the recurrence of the module doc."""
    prev_min = carry.amin(dim=0, keepdim=True)
    edge = torch.full_like(carry[:1], big)
    up = torch.cat([edge, carry[:-1]], dim=0)       # L(d-1)
    down = torch.cat([carry[1:], edge], dim=0)      # L(d+1)
    m = torch.minimum(torch.minimum(carry, prev_min + p2),
                      torch.minimum(up, down) + p1)
    return c + m - prev_min


def _shift_columns(carry: torch.Tensor, dx: int) -> torch.Tensor:
    """out[:, n] = carry[:, n - dx], zero where n - dx leaves the frame."""
    zero = torch.zeros_like(carry[:, :1])
    if dx > 0:
        return torch.cat([zero, carry[:, :-1]], dim=1)
    return torch.cat([carry[:, 1:], zero], dim=1)


def _scan(cost: torch.Tensor, p1: float, p2: float,
          init_carry: torch.Tensor | None = None, dx: int = 0) -> torch.Tensor:
    """Scan along axis 1 of (D, S, N), moving the carry ``dx`` along N.

    ``init_carry`` (D, N) is the predecessor row's L, unshifted: the first
    row's step shifts it by ``dx`` like every other carry. The output keeps
    an int16 volume's dtype (computed in int32); anything else is float32.
    """
    if cost.dtype == torch.int16:
        work, big, p1, p2 = torch.int32, BIG_I16, int(p1), int(p2)
    else:
        cost, work, big = cost.to(torch.float32), torch.float32, BIG
    p1 = torch.tensor(p1, dtype=work, device=cost.device)
    p2 = torch.tensor(p2, dtype=work, device=cost.device)
    carry = torch.zeros(cost[:, 0].shape, dtype=work, device=cost.device) \
        if init_carry is None else init_carry.to(work)
    out = torch.empty_like(cost)
    for s in range(cost.shape[1]):
        if dx:
            carry = _shift_columns(carry, dx)
        carry = _step(cost[:, s].to(work), carry, p1, p2, big)
        out[:, s] = carry
    return out


def scan_direction(cost: torch.Tensor, p1: float, p2: float,
                   init_carry: torch.Tensor | None = None) -> torch.Tensor:
    """The canonical SGM scan: accumulate along axis 1 of (D, S, N).

    Returns L of the same shape. ``init_carry`` (D, N) overrides the zero
    initial carry (a zero carry behaves as "no predecessor": the first
    slab gets L = C).
    """
    return _scan(cost, p1, p2, init_carry)


def aggregate_direction(cost: torch.Tensor, dy: int, dx: int, p1: float,
                        p2: float, init_carry: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """L for one path direction over a (D, H, W) volume.

    ``init_carry`` (D, W), for dy != 0 only: L of the row before the
    volume's first row in scan order (the previous row shard's last row,
    unshifted), so a path starting on that row at column x continues from
    ``init_carry[:, x - dx]`` (zero off the frame). The carry to hand to
    the next shard is the returned L's last row in scan order.
    """
    if init_carry is not None and dy == 0:
        raise ValueError("horizontal directions take no carry")
    if dy < 0:        # flip y: a (-1, dx) path becomes a (1, dx) path
        return aggregate_direction(cost.flip(1), -dy, dx, p1, p2,
                                   init_carry).flip(1)
    if dy == 0:       # horizontal: scan over x of the (D, W, H) view
        vol = cost.transpose(1, 2)
        if dx < 0:
            vol = vol.flip(1)
        out = scan_direction(vol, p1, p2)
        if dx < 0:
            out = out.flip(1)
        return out.transpose(1, 2)
    return _scan(cost, p1, p2, init_carry, dx)   # vertical or diagonal


def sgm_aggregate(cost: torch.Tensor, p1: float, p2: float,
                  num_paths: int = 8) -> torch.Tensor:
    """Sum of per-direction aggregations, S(p, d) = sum_r L_r(p, d).

    ``num_paths``: 8 (full), 4 (horizontal + vertical) or 2 (horizontal).
    The total is int16 for an int16 volume, else float32.
    """
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    dt = torch.int16 if cost.dtype == torch.int16 else torch.float32
    total = torch.zeros(cost.shape, dtype=dt, device=cost.device)
    for dy, dx in PATH_DIRECTIONS_8[:num_paths]:
        total = total + aggregate_direction(cost, dy, dx, p1, p2)
    return total
