"""Readings that the limits of ``checks/<config>.json`` are set from.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed: the cell's pool through the cell's entry once (every pair),
the program's maps against the reference (the sound readings); the
control, the reference in the configuration's lower precision (the check
file's ``control``), against the reference; and, where the program has a
lower-precision path of its own (census: int16 volumes; MC-CNN: the
bfloat16 tower), that path against the reference. Prints one JSON line a
seed with ``mismatch_pct`` at the check's tolerance and at 1e-5 to 0.5
px. The benchmark's runs never call this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worst(got, want, tol):
    from port_bench.check import mismatch_pct
    return max(mismatch_pct(g, w, tol) for g, w in zip(got, want))


def readings(cell, cfg: dict, devices: list, seeds, tols):
    """Per seed, ``mismatch_pct`` at each of ``tols`` of the program, the
    control and the program's lower-precision path, against the reference,
    over the cell's pool through the cell's entry (one dict a seed)."""
    import numpy as np

    from port_bench import scenes, system
    from port_bench.reference import maps_for
    tr, checks = cell.traffic, cell.checks
    disparity_maps = maps_for(checks)
    weights = ROOT / cfg["weights"] if "weights" in cfg else None
    lower = dict(cfg, dtype="int16") if cfg["cost"] == "census" \
        else dict(cfg, compute_dtype="bfloat16")
    fns = {"program": system.build(cfg, tr, devices, ROOT),
           "program_lower": system.build(lower, tr, devices, ROOT)}
    B, P = tr["frames_per_call"], tr["pool"]
    for seed in seeds:
        lefts, rights = scenes.make_pool(
            seed, P, cfg["height"], cfg["width"],
            tr["max_disparity_share"] * cfg["num_disparities"],
            tr["noise"], tr["boxes"])
        got = {key: np.concatenate([fn(lefts[s:s + B],
                                       rights[s:s + B]).cpu().numpy()
                                    for s in range(0, P, B)])
               for key, fn in fns.items()}
        t = time.perf_counter()
        ref = disparity_maps(lefts, rights, cfg, devices[0],
                             block=checks["block"], weights=weights)
        line = {"seed": seed, "reference_s": time.perf_counter() - t,
                "valid_share": float(np.mean(~np.isnan(ref)))}
        got["control"] = disparity_maps(
            lefts, rights, cfg, devices[0], precision=checks["control"],
            block=checks["block"], weights=weights)
        for key in ("program", "control", "program_lower"):
            line[key] = {str(t): worst(got[key], ref, t) for t in tols}
        yield line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from port_bench import manifest
    cell = manifest.load_cell(args.workload, ROOT)
    tols = sorted({cell.checks["tol_px"], 1e-5, 1e-4, 1e-3, 0.01, 0.5})
    for line in readings(cell, cell.config,
                         [f"cuda:{i}" for i in range(cell.chips)],
                         args.seeds, tols):
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
