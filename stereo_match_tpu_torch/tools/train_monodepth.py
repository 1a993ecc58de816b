"""The monodepth recipe on the port: distil, save, evaluate held out.

Counterpart of ``tools/train_monodepth.py`` with its arguments and
defaults: renders ``--scenes`` scenes (240) at the network's 96x160,
labels them with the port's own census + SGM matcher (no ground truth in
the loss: mono-from-stereo distillation), trains ``--arch`` (``small``)
for ``--steps`` (6000) Adam steps of ``--batch`` (16) with horizontal
flips, under optax's cosine schedule from ``--lr`` (3e-4) to 5 % of it
(``models.monodepth.train_distilled_on_device``), writes a flax-layout
``.npz`` that the JAX package's ``load_params_npz`` and ``infer_arch``
read, then evaluates through ``predict_disparity`` at 375x1242 on held-out
scenes: the affine-calibrated EPE against the best constant predictor.
The last line of standard output is the same JSON object as the JAX
tool's.

    python -m stereo_match_tpu_torch.tools.train_monodepth [--device cpu]

``--device`` defaults to the card; the scenes and labels are uploaded
once. The weights start from flax's distribution drawn from a
``torch.Generator`` seeded with 0 (not flax's stream). ``--output``
defaults to ``build/stereo_match_tpu_torch/checkpoints/
monodepth_<arch>[_shaded].npz``; the port never writes the JAX package's
shipped checkpoints.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from stereo_match_tpu_torch.models import monodepth as md
from stereo_match_tpu_torch.models.optim import cosine_decay_schedule
from stereo_match_tpu_torch.utils.backend import entry_device

H, W = 96, 160            # canonical internal resolution
HF, WF = 375, 1242        # full render resolution (the eval resolution)
CHECKPOINTS = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch" / "checkpoints"


def scene_native(seed: int, domain: str = "mixed"):
    """One canonical-resolution scene -> (left3, right3, gt), the JAX
    tool's ``_scene_native`` draw for draw: ``mixed`` cycles the
    shaded-shapes renderer, shaded random dots and ray-traced scenes;
    ``raytrace`` uses ray-traced scenes only. Disparities span 2..24 px."""
    from stereo_match_tpu_torch.data.synthetic import (multi_box_scene,
                                                       random_dot_pair,
                                                       rough_scene,
                                                       shaded_shapes_pair)
    rng = np.random.default_rng(seed)
    kind = 0 if domain == "raytrace" else (seed % 3)
    if domain == "raytrace" or (kind == 0 and seed % 6 == 0):
        from stereo_match_tpu_torch.data.raytrace import render_stereo
        l, r, gt = render_stereo(H, W, seed=seed,
                                 noise=float(rng.choice([0.0, 3.0])))
        gt = np.where(np.isfinite(gt), gt, np.nanmedian(gt))
    else:
        cell = int(rng.choice([12, 16, 24]))
        gt = rough_scene(H, W, seed, 2.0, 24.0, cell=cell)
        if seed % 3 == 2:   # drop a box onto the terrain (occlusion cue)
            box = multi_box_scene(H, W, background=0.0,
                                  boxes=((rng.uniform(0.1, 0.3),
                                          rng.uniform(0.1, 0.4),
                                          rng.uniform(0.5, 0.8),
                                          rng.uniform(0.5, 0.9),
                                          rng.uniform(6.0, 12.0)),))
            gt = np.minimum(gt + box, 24.0).astype(np.float32)
        if kind == 1:
            l, r = random_dot_pair(H, W, gt, blur=1.2, seed=seed,
                                   noise=float(rng.choice([0.0, 5.0])),
                                   shading=0.8)
        else:
            l, r = shaded_shapes_pair(H, W, gt, seed=seed)

    def to3(im):
        return np.repeat(np.clip(im, 0, 255)[..., None], 3,
                         -1).astype(np.float32) / 255.0

    return to3(l), to3(r), gt


def stereo_labels(lefts: np.ndarray, rights: np.ndarray,
                  device: torch.device | str = "cuda"):
    """Pseudo-labels from the port's census + SGM matcher (D = 32,
    uniqueness 15, disp12 1, no WLS) on (N, H, W, 3) pairs in [0, 1]:
    (targets in width fractions, valid) as (N, H, W) tensors on the
    device."""
    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
    dev = entry_device(device)
    matcher = StereoMatcher(DisparityConfig(num_disparities=32,
                                            uniqueness_ratio=15,
                                            disp12_max_diff=1, wls=False),
                            device=dev)
    gray_l = torch.from_numpy(lefts[..., 0]).to(dev) * 255.0
    gray_r = torch.from_numpy(rights[..., 0]).to(dev) * 255.0
    d = torch.stack([matcher(gray_l[i], gray_r[i])[0]
                     for i in range(len(lefts))])
    valid = torch.isfinite(d)
    return torch.where(valid, d, 0.0) / lefts.shape[2], valid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="small")
    ap.add_argument("--domain", default="raytrace",
                    choices=["mixed", "raytrace"],
                    help="raytrace = the primary checkpoint's scenes; "
                         "mixed = the second domain (shaded/dot warp "
                         "renderers)")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--scenes", type=int, default=240)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    model = md.make_model(args.arch, seed=0)
    log(f"rendering {args.scenes} native-res scenes...")
    scenes = [scene_native(s, args.domain) for s in range(args.scenes)]
    rng = np.random.default_rng(0)
    lefts = np.stack([s[0] for s in scenes])
    rights = np.stack([s[1] for s in scenes])
    picks = rng.choice(args.scenes, (args.steps, args.batch))
    log("labeling scenes with the stereo matcher...")
    targets, valids = stereo_labels(lefts, rights, dev)
    sched = cosine_decay_schedule(args.lr, args.steps, 0.05)
    flips = rng.uniform(size=picks.shape) < 0.5
    model, losses = md.train_distilled_on_device(
        model, lefts, targets, valids, picks, sched, flips=flips, device=dev)
    log(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    suffix = "" if args.domain == "raytrace" else "_shaded"
    out = Path(args.output) if args.output else \
        CHECKPOINTS / f"monodepth_{args.arch}{suffix}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    out = md.save_params_npz(out, model)
    log(f"wrote {out}")

    # held-out eval at full resolution through the internal resize
    from stereo_match_tpu_torch.data.synthetic import (rough_scene,
                                                       shaded_shapes_pair)
    corrs, cal_epes, const_epes = [], [], []
    for s in range(900, 906):
        gt = rough_scene(HF, WF, s, 4.0, 80.0, cell=128)
        if args.domain == "raytrace":
            from stereo_match_tpu_torch.data.raytrace import render_stereo
            l, _, gt = render_stereo(HF, WF, seed=s)
        else:
            l, _ = shaded_shapes_pair(HF, WF, gt, seed=s, tex_scale=WF / W)
        img = np.repeat(l[..., None], 3, -1)
        pred = md.predict_disparity(model, img, (H, W)).cpu().numpy()
        # GT is undefined in right-view occlusions (NaN): left out
        m = np.isfinite(gt)
        corrs.append(float(np.corrcoef(pred[m], gt[m])[0, 1]))
        a, b = np.polyfit(pred[m], gt[m], 1)
        cal_epes.append(float(np.mean(np.abs(a * pred[m] + b - gt[m]))))
        const_epes.append(float(np.mean(np.abs(np.median(gt[m]) - gt[m]))))
        log(f"seed {s}: r={corrs[-1]:.3f} cal_epe={cal_epes[-1]:.3f} "
            f"const={const_epes[-1]:.3f}")
    print(json.dumps({
        "checkpoint": str(out), "domain": args.domain,
        "pearson_r": round(float(np.mean(corrs)), 4),
        "affine_calibrated_epe": round(float(np.mean(cal_epes)), 3),
        "constant_predictor_epe": round(float(np.mean(const_epes)), 3),
        "ratio": round(float(np.mean(cal_epes) / np.mean(const_epes)), 3)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
