"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check`` (each
number compared beside its limit). Without the cards the cell asks for,
or if JAX or the JAX package was loaded, it exits non-zero and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_match_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench import manifest
    cell = manifest.load_cell(args.workload, ROOT)
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s), "
              f"found {count}", file=sys.stderr)
        return 2

    from port_bench.core import run_cell

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, root=ROOT, log=log)
    found = forbidden_modules()
    if found:
        log(f"refusing to report: loaded {found}")
        return 3
    log(f"card: {power_limit()}")
    for name, n in result["check"].items():
        log(f"check {name} {n['value']} limit {n['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
