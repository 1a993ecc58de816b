"""Time K3 (``sgm_path_scan``) per direction as the frame widens, on the card.

Holds a KITTI frame's height (375 rows) and D = 128 and widens the frame
from 310 to 4968 columns, in float32 and int16. A walk bound by the card's
bandwidth takes time in proportion to its bytes at every width; a walk set
by one block's latency keeps its time while the blocks fit in one wave of
the SMs and steps up with each further wave. Each line of output is one
(dtype, direction, width): ms (CUDA events, mean of 10 after 2 warm-up
launches), the path lines and the blocks they make, GB/s over the bytes
(cost read, total read, total write) and the share of their bound at
3.35 TB/s.

    python -m stereo_match_tpu_torch.tools.k3_probe [--out FILE]

``--out`` also writes the rows as JSON. Needs one Hopper card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.utils.backend import require_hopper

HBM_BYTES_PER_S = 3.35e12
H, D = 375, 128
WIDTHS = (310, 621, 1242, 2484, 4968)
DIRECTIONS = {"horizontal": (0, 1), "vertical": (1, 0), "diagonal": (1, 1)}


def _blocks(dy: int, dx: int, W: int) -> tuple[int, int]:
    """(path lines, blocks) of one launch at D = 128 (``csrc/sgm.cu``:
    16 line warps a strip block, one a row block)."""
    if dy == 0:
        return H, H
    lines = W if dx == 0 else W + H - 1
    return lines, -(-lines // 16)


def _ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the rows as JSON here")
    args = parser.parse_args()
    dev = require_hopper(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.int16):
        for W in WIDTHS:
            cost = (torch.rand((D, H, W), generator=gen, device=dev) * 60)
            cost = cost.to(dtype)
            total = torch.zeros_like(cost)
            nbytes = 3 * cost.numel() * cost.element_size()
            for name, (dy, dx) in DIRECTIONS.items():
                ms = _ms(lambda: K.sgm_path_scan(cost, total, dy, dx, 8.0,
                                                 96.0, True))
                lines, blocks = _blocks(dy, dx, W)
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                row = dict(dtype=str(dtype).split(".")[1], direction=name,
                           W=W, H=H, D=D, ms=ms, lines=lines, blocks=blocks,
                           gb_per_s=nbytes / ms / 1e6, bound_ms=bound_ms,
                           share_of_bound=bound_ms / ms)
                rows.append(row)
                print(json.dumps(row))
            del cost, total
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
