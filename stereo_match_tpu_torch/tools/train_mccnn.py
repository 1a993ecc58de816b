"""The MC-CNN recipe on the port: train, save, evaluate held out.

Counterpart of ``tools/train_mccnn.py`` with its arguments and defaults:
trains the feature tower (``--arch``, default ``fast``) by Adam on the
hinge loss over the multi-renderer synthetic patch pool
(``models.mccnn.make_training_pool``: 27 scenes, 8 epochs of 512-triplet
batches of 16x16 patches, lr 2e-3), writes a flax-layout ``.npz`` that the
JAX package's ``load_params_npz`` and the port's read, then evaluates the
tower against the census cost through the same SGM matcher on held-out
random-dot scenes (noise 0, 10, 25) and on ray-traced scenes, a renderer
the pool leaves out. The last line of standard output is the same JSON
object as the JAX tool's.

    python -m stereo_match_tpu_torch.tools.train_mccnn [--device cpu]

``--device`` defaults to the card. The pool is uploaded once and batches
are slices of it on the device. The weights start from flax's distribution
drawn from a ``torch.Generator`` seeded with 0 (not flax's stream).
``--output`` defaults to ``build/stereo_match_tpu_torch/checkpoints/
mccnn_<arch>.npz``; the port never writes the JAX package's shipped
checkpoints.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from stereo_match_tpu_torch.models import mccnn
from stereo_match_tpu_torch.utils.backend import entry_device

CHECKPOINTS = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch" / "checkpoints"


def train_recipe(arch: str = "fast", scenes: int = 27, epochs: int = 8,
                 batch: int = 512, lr: float = 2e-3, seed: int = 1,
                 device: torch.device | str = "cuda"):
    """The recipe's pool and training: ``(model, losses, pool size)``."""
    dev = entry_device(device)
    pool = mccnn.make_training_pool(scenes, seed=seed)
    A, P, N = (torch.from_numpy(x).to(dev) for x in pool)
    model = mccnn.make_model(arch, seed=0)
    batches = [(A[i:i + batch], P[i:i + batch], N[i:i + batch])
               for _ in range(epochs)
               for i in range(0, len(A) - batch + 1, batch)]
    model, losses = mccnn.train(model, batches, learning_rate=lr,
                                device=dev)
    return model, losses, len(A)


def held_out(model: mccnn.MCCNNFeatures, device: torch.device | str = "cuda",
             log=None) -> tuple[dict, dict]:
    """bad-3px of census and of ``model``'s cost through the same SGM
    matcher (D = 32, uniqueness 15, disp12 1, no WLS): 4 held-out
    random-dot scenes a noise level, and 3 ray-traced scenes clean and with
    noise and right-view gain. Returns (held_out_bad3, out_of_renderer)
    as the JAX tool reports them; ``log`` gets a line a row."""
    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.costs import MCCNNCost
    from stereo_match_tpu_torch.data.raytrace import render_stereo
    from stereo_match_tpu_torch.data.synthetic import (box_scene,
                                                       random_dot_pair,
                                                       rough_scene)
    from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
    dev = entry_device(device)
    cfg_c = DisparityConfig(num_disparities=32, cost="census",
                            uniqueness_ratio=15, disp12_max_diff=1,
                            wls=False)
    cfg_m = cfg_c.replace(cost="mccnn")
    m_census = StereoMatcher(cfg_c, device=dev)
    m_mccnn = StereoMatcher(cfg_m, cost_fn=MCCNNCost(model.to(dev), cfg_m),
                            device=dev)
    log = log or (lambda line: None)

    def bad3(l, r, gt) -> tuple[float, float]:
        return tuple(float(bad_pixel_rate(m(l, r)[0], gt, 3.0, 0.0))
                     for m in (m_census, m_mccnn))

    report = {}
    for noise in (0.0, 10.0, 25.0):
        rows = []
        for s in range(4):
            gt = rough_scene(96, 160, 999 + s, 2, 24) if s % 2 else \
                box_scene(96, 160, 3 + s, 14 + s)
            l, r = random_dot_pair(96, 160, gt, blur=1.0, seed=555 + s,
                                   noise=noise)
            rows.append(bad3(l, r, gt))
        bc, bm = np.mean(rows, axis=0)
        report[f"noise_{noise:g}"] = {"census_bad3": round(float(bc), 4),
                                      "mccnn_bad3": round(float(bm), 4)}
        log(f"noise={noise:5.1f} census={bc:.4f} mccnn={bm:.4f}")
    oor = {}
    for tag, kw in (("clean", {}),
                    ("noise_gain", {"noise": 6.0, "gain_right": 1.2})):
        rows = []
        for s in range(3):
            l, r, gt = render_stereo(96, 160, seed=808 + s, **kw)
            rows.append(bad3(l, r, gt))
        bc, bm = np.mean(rows, axis=0)
        oor[tag] = {"census_bad3": round(float(bc), 4),
                    "mccnn_bad3": round(float(bm), 4)}
        log(f"out_of_renderer {tag:16s} census={bc:.4f} mccnn={bm:.4f}")
    return report, oor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fast", choices=["fast", "accurate"])
    ap.add_argument("--scenes", type=int, default=27)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--output", default=None,
                    help="default: build/stereo_match_tpu_torch/checkpoints/"
                         "mccnn_<arch>.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    model, losses, n = train_recipe(args.arch, args.scenes, args.epochs,
                                    args.batch, args.lr, args.seed,
                                    args.device)
    log(f"pool: {n} triplets")
    log(f"hinge loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    out = Path(args.output) if args.output else \
        CHECKPOINTS / f"mccnn_{args.arch}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    out = mccnn.save_params_npz(out, model)
    log(f"wrote {out}")
    report, oor = held_out(model, args.device, log)
    print(json.dumps({"checkpoint": str(out), "held_out_bad3": report,
                      "out_of_renderer": oor}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
