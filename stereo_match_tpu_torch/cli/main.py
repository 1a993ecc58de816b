"""`smt-torch` — the port's CLI.

The subcommands and flags of ``smt`` (``stereo_match_tpu/cli/main.py``),
each run on the port, plus ``--device`` on every subcommand that computes
(default ``cuda``: without a card it raises rather than run on the CPU;
``--device cpu`` runs the plain versions):

* ``build-dataset``  <- build_npz.py (ARKit session -> tmp.npz)
* ``rectify``        <- rectified_img_cal.py (npz pair -> rectified PNGs)
* ``match``          <- disparity_calculation.py / disparity_test.py
* ``reproject``      <- mapTo3D.py (disparity/depth image -> PLY)
* ``eval``           — disparity metrics vs ground truth
* ``costbin``        <- mapTo3D_mc_cnn.py (external cost .bin -> PLY)
* ``mono``           <- monodepth/script.py (single-image depth)
* ``stream``         — frame sequence through the stage pipeline
* ``train-mccnn``    — not ported yet (ROADMAP.md, queue 1 item 6): exits 2
* ``benchmark``      — the port has no benchmark yet: exits 2

Outputs are written as the JAX CLI writes them; device tensors become
numpy arrays at this boundary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from stereo_match_tpu_torch.utils.backend import entry_device


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; 'cpu' runs the "
                        "kernels' plain versions)")


def _add_settings_args(p):
    p.add_argument("--settings_file", default=None,
                   help="INI file with a [disparity] section (settings.ini names)")
    p.add_argument("--num_disparities", type=int, default=None)
    p.add_argument("--block_size", type=int, default=None)
    p.add_argument("--cost", default=None,
                   help="census | sad | ssd | bt")
    p.add_argument("--num_paths", type=int, default=None)


def _config_from(args):
    from stereo_match_tpu_torch.config import load_settings
    overrides = {k: getattr(args, k, None)
                 for k in ("num_disparities", "block_size", "cost", "num_paths")}
    return load_settings(args.settings_file, overrides)


def _load_npz_checkpoint(path: str, flag: str):
    """A flax ``.npz`` checkpoint as a numpy tree, or None after printing
    why another format is refused."""
    if not path.endswith(".npz"):
        print(f"error: {flag} {path}: the port reads .npz checkpoints "
              "(save_params_npz); an orbax checkpoint directory is the JAX "
              "package's format and needs JAX to read", file=sys.stderr)
        return None
    from stereo_match_tpu_torch.models.mccnn import load_params_npz
    return load_params_npz(path)


def cmd_build_dataset(args) -> int:
    from stereo_match_tpu_torch.data.arkit import build_npz
    path, n = build_npz(args.json_file, args.image_dir,
                        out_path=args.output, mode=args.mode)
    print(f"wrote {n} frames to {path}")
    return 0


def cmd_rectify(args) -> int:
    from stereo_match_tpu_torch.core.camera import \
        portrait_swap_principal_point
    from stereo_match_tpu_torch.core.rectify import rectify_pair
    from stereo_match_tpu_torch.data.arkit import load_npz_frames
    from stereo_match_tpu_torch.data.image import image_save
    device = entry_device(args.device)
    frames = load_npz_frames(args.npz_file)
    f1, f2 = frames[args.id1], frames[args.id2]
    K1, K2 = f1["intrinsic"], f2["intrinsic"]
    if args.portrait:
        K1 = portrait_swap_principal_point(K1)
        K2 = portrait_swap_principal_point(K2)
    rect_l, rect_r, res = rectify_pair(
        f1["extrinsic"], f2["extrinsic"], K1, K2,
        f1["image_mat"], f2["image_mat"], alpha=args.alpha, device=device)
    image_save(args.left_out, _numpy(rect_l))
    image_save(args.right_out, _numpy(rect_r))
    print(f"rectified pair -> {args.left_out}, {args.right_out} "
          f"(baseline {res.baseline:.4f})")
    return 0


def _method_matcher(args, cfg, device):
    """Resolve --method to a ``(left, right) -> (raw, filtered)`` callable
    on ``device``, or None after printing why it cannot be built.

    The four matcher families mirror the reference's paths: SGBM/BM
    (``stereo_vision/stereo_vision.py:153-166``), ELAS
    (``libelas/script.py``), MC-CNN (``mc_cnn/script.py``)."""
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
    method = args.method
    if method == "bm":
        from stereo_match_tpu_torch.pipeline.block_matching import \
            BlockMatcher
        return BlockMatcher(cfg, device=device), cfg
    if method == "elas":
        from stereo_match_tpu_torch.pipeline.elas import elas_match

        def run(left, right):
            disp = elas_match(left, right,
                              num_disparities=cfg.num_disparities,
                              min_disparity=cfg.min_disparity, device=device)
            return disp, disp
        return run, cfg
    if method == "mccnn":
        from stereo_match_tpu_torch.costs import MCCNNCost
        from stereo_match_tpu_torch.models import mccnn
        if args.mccnn_checkpoint:
            params = _load_npz_checkpoint(args.mccnn_checkpoint,
                                          "--mccnn_checkpoint")
            if params is None:
                return None, cfg
            model = mccnn.from_flax_params(params, args.arch)
        else:
            try:
                model = mccnn.from_flax_params(
                    mccnn.load_default_params(args.arch), args.arch)
                print(f"using shipped checkpoint "
                      f"{mccnn.default_checkpoint_path(args.arch)}",
                      file=sys.stderr)
            except FileNotFoundError:
                model = mccnn.make_model(args.arch)
                print("warning: no shipped/--mccnn_checkpoint weights; "
                      "random init", file=sys.stderr)
        cfg = cfg.replace(cost="mccnn")
        provider = MCCNNCost(model.to(device), cfg)
        return StereoMatcher(cfg, cost_fn=provider, device=device), cfg
    return StereoMatcher(cfg, device=device), cfg


def cmd_match(args) -> int:
    from stereo_match_tpu_torch.data.image import (image_read, image_save,
                                                   to_grayscale)
    from stereo_match_tpu_torch.viz.plots import colorize_disparity
    device = entry_device(args.device)
    cfg = _config_from(args)

    if args.left and args.right:          # disparity_test.py mode
        left = to_grayscale(image_read(args.left)).astype(np.float32)
        right = to_grayscale(image_read(args.right)).astype(np.float32)
        if args.enhance:                   # gaussian+unsharp (image_measure)
            from stereo_match_tpu_torch.ops.filters import image_measure
            left = _numpy(image_measure(torch.as_tensor(left, device=device)))
            right = _numpy(image_measure(torch.as_tensor(right,
                                                         device=device)))
        if args.denoise:                   # fastNlMeansDenoising parity
            from stereo_match_tpu_torch.ops.filters import nl_means_denoise
            left = _numpy(nl_means_denoise(torch.as_tensor(left,
                                                           device=device)))
            right = _numpy(nl_means_denoise(torch.as_tensor(right,
                                                            device=device)))
        matcher, cfg = _method_matcher(args, cfg, device)
        if matcher is None:
            return 2
        raw, filtered = matcher(left, right)
        raw, filtered = _numpy(raw), _numpy(filtered)
        image_save(args.disp_out, colorize_disparity(filtered))
        np.save(args.disp_out + ".npy", filtered)
        if args.write_ply:
            from stereo_match_tpu_torch.core.reproject import (
                make_q_matrix, reproject_image_to_3d)
            from stereo_match_tpu_torch.data.ply import write_ply
            H, W = filtered.shape
            Q = make_q_matrix(args.focal, W / 2, H / 2, -args.baseline)
            pts = _numpy(reproject_image_to_3d(
                torch.as_tensor(filtered, device=device), Q))
            mask = np.isfinite(raw)
            color = image_read(args.left)[mask]
            write_ply(args.ply_out, pts[mask], color, binary=True)
        print(f"disparity -> {args.disp_out} "
              f"(density {np.isfinite(raw).mean():.2%})")
        return 0

    # npz mode (disparity_calculation.py parity)
    from stereo_match_tpu_torch.core.camera import \
        portrait_swap_principal_point
    from stereo_match_tpu_torch.data.arkit import load_npz_frames
    from stereo_match_tpu_torch.pipeline.stereo import run_pipeline
    frames = load_npz_frames(args.npz_file)
    if not (0 <= args.id1 < args.id2 < len(frames)):
        print("error: need 0 <= id1 < id2 < n_frames", file=sys.stderr)
        return 2
    f1, f2 = frames[args.id1], frames[args.id2]
    K1, K2 = f1["intrinsic"], f2["intrinsic"]
    if args.portrait:
        K1 = portrait_swap_principal_point(K1)
        K2 = portrait_swap_principal_point(K2)
    matcher, cfg = _method_matcher(args, cfg, device)
    if matcher is None:
        return 2
    res = run_pipeline(
        f1["extrinsic"], f2["extrinsic"], K1, K2,
        f1["image_mat"], f2["image_mat"], config=cfg, alpha=args.alpha,
        matcher=matcher,
        ply_path=args.ply_out if args.write_ply else None,
        disparity_band=tuple(args.disparity_band) if args.disparity_band else None,
        device=device)
    image_save(args.disp_out, colorize_disparity(res.disparity_filtered))
    print(f"disparity -> {args.disp_out}"
          + (f", cloud -> {args.ply_out} ({res.meta.get('ply_vertices', 0)} pts)"
             if args.write_ply else ""))
    return 0


def cmd_reproject(args) -> int:
    from stereo_match_tpu_torch.core.reproject import (depth_to_points,
                                                       make_q_matrix,
                                                       reproject_image_to_3d)
    from stereo_match_tpu_torch.data.image import image_read
    from stereo_match_tpu_torch.data.ply import write_ply
    device = entry_device(args.device)
    disp = image_read(args.disparity, grayscale=True).astype(np.float32)
    if args.scale != 1.0:
        disp = disp * args.scale
    color = image_read(args.color) if args.color else \
        np.stack([image_read(args.disparity, grayscale=True)] * 3, -1)
    H, W = disp.shape
    disp_t = torch.as_tensor(disp, device=device)
    if args.mode == "disparity":
        Q = make_q_matrix(args.focal, args.cx if args.cx is not None else W / 2,
                          args.cy if args.cy is not None else H / 2,
                          -args.baseline)
        pts = _numpy(reproject_image_to_3d(disp_t, Q))
        mask = disp > args.min_value
    else:                               # depth image (mapTo3D.py path)
        from stereo_match_tpu_torch.core.camera import intrinsic_from_params
        K = intrinsic_from_params(args.focal, args.focal,
                                  args.cx if args.cx is not None else W / 2,
                                  args.cy if args.cy is not None else H / 2)
        pts = _numpy(depth_to_points(disp_t, K))
        mask = disp > args.min_value
    n = write_ply(args.output, pts[mask], color[mask], binary=not args.ascii)
    print(f"wrote {n} points to {args.output}")
    return 0


def cmd_eval(args) -> int:
    from stereo_match_tpu_torch.data.kitti import read_kitti_disparity
    from stereo_match_tpu_torch.eval.metrics import compare_disparities
    device = entry_device(args.device)
    pred = np.load(args.pred) if args.pred.endswith(".npy") \
        else read_kitti_disparity(args.pred)
    gt = np.load(args.gt) if args.gt.endswith(".npy") \
        else read_kitti_disparity(args.gt)
    scores = compare_disparities(torch.as_tensor(pred, device=device),
                                 torch.as_tensor(gt, device=device))
    print(json.dumps(scores, indent=2))
    return 0


def cmd_train_mccnn(args) -> int:
    print("error: train-mccnn is not ported yet (ROADMAP.md, queue 1 item "
          "6: training); run the JAX package's `smt train-mccnn`",
          file=sys.stderr)
    return 2


def cmd_mono(args) -> int:
    """Single-image disparity via the monodepth model."""
    from stereo_match_tpu_torch.data.image import image_read, image_save
    from stereo_match_tpu_torch.models import monodepth as md
    from stereo_match_tpu_torch.viz.plots import colorize_disparity
    device = entry_device(args.device)
    if args.checkpoint:
        params = _load_npz_checkpoint(args.checkpoint, "--checkpoint")
        if params is None:
            return 2
        arch = getattr(args, "mono_arch", None) or md.infer_arch(params)
        model = md.from_flax_params(params, arch).to(device)
    else:
        try:
            model = md.load_default(device=device)
            print(f"using shipped checkpoint "
                  f"{md.default_checkpoint_path()}", file=sys.stderr)
        except FileNotFoundError:
            model = md.make_model("full").to(device)
            print("warning: no shipped/--checkpoint weights; random init "
                  "(a seeded torch.Generator, not flax's stream)",
                  file=sys.stderr)
    img = image_read(args.image)
    disp = _numpy(md.predict_disparity(model, img))
    np.save(args.output + ".npy", disp)
    image_save(args.output, colorize_disparity(disp))
    print(f"monocular disparity -> {args.output}")
    return 0


def cmd_costbin(args) -> int:
    """External cost volume (.bin) -> SGM/WLS disparity -> Q -> PLY.

    End-to-end parity with the reference's only inter-process hand-off
    (``mapTo3D_mc_cnn.py:68-159``): memmap the (1, D, W, H) float32 dump
    an external matcher wrote, aggregate/extract/WLS-refine, reproject
    through the f=1164-style Q, and write the point cloud.
    """
    from stereo_match_tpu_torch.core.reproject import (make_q_matrix,
                                                       reproject_image_to_3d)
    from stereo_match_tpu_torch.data.costbin import (
        external_volume_to_disparity, read_cost_bin)
    from stereo_match_tpu_torch.data.image import image_read, image_save, \
        to_grayscale
    from stereo_match_tpu_torch.data.ply import write_ply
    from stereo_match_tpu_torch.viz.plots import colorize_disparity
    device = entry_device(args.device)
    vol = read_cost_bin(args.bin, args.disp_max, args.width, args.height)
    guide = color = None
    if args.left:
        color = image_read(args.left)
        guide = to_grayscale(color).astype(np.float32)
    disp = external_volume_to_disparity(
        vol, p1=args.p1, p2=args.p2, num_paths=args.num_paths,
        guide=None if args.no_wls else guide,
        lmbda=args.lmbda, sigma=args.sigma, device=device)
    image_save(args.disp_out, colorize_disparity(disp))
    np.save(args.disp_out + ".npy", disp)
    H, W = disp.shape
    cx = args.cx if args.cx is not None else W / 2
    cy = args.cy if args.cy is not None else H / 2
    Q = make_q_matrix(args.focal, cx, cy, -args.baseline)
    pts = _numpy(reproject_image_to_3d(torch.as_tensor(disp, device=device),
                                       Q))
    finite = np.isfinite(disp)
    mask = finite & (disp > np.nanmin(disp))   # reference mask :150
    if color is None:
        color = np.full((H, W, 3), 200, np.uint8)
    elif color.ndim == 2:
        color = np.stack([color] * 3, axis=-1)
    n = write_ply(args.ply_out, pts[mask], color[mask], binary=True)
    print(f"disparity -> {args.disp_out}, cloud -> {args.ply_out} ({n} pts, "
          f"density {finite.mean():.2%})")
    return 0


def cmd_stream(args) -> int:
    """Stream a frame sequence through the stage pipeline.

    With ``--stages`` N >= 2 the port's ``StreamingPipeline`` holds stage
    i on card i (on the CPU, every stage on the CPU); N cards must be
    visible, or it exits 1. One stage runs the frames through the matcher
    in sequence (the same outputs).
    """
    import glob as globmod

    from stereo_match_tpu_torch.data.image import (image_read, image_save,
                                                   to_grayscale)
    from stereo_match_tpu_torch.viz.plots import colorize_disparity
    device = entry_device(args.device)
    lefts = sorted(globmod.glob(args.left_glob))
    rights = sorted(globmod.glob(args.right_glob))
    if not lefts or len(lefts) != len(rights):
        print(f"error: {len(lefts)} left vs {len(rights)} right frames",
              file=sys.stderr)
        return 1
    cfg = _config_from(args)
    frames = [(to_grayscale(image_read(l)).astype(np.float32),
               to_grayscale(image_read(r)).astype(np.float32))
              for l, r in zip(lefts, rights)]
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device] * (args.stages or 1)
    n_dev = len(devices)
    if args.stages is not None and args.stages > n_dev:
        print(f"error: --stages {args.stages} requested but only {n_dev} "
              f"device(s) available; drop --stages to auto-select",
              file=sys.stderr)
        return 1
    stages = args.stages or (4 if n_dev >= 4 else 2 if n_dev >= 2 else 1)
    if stages >= 2:
        from stereo_match_tpu_torch.parallel.pipeline_stage import (
            StreamingPipeline, make_stage_mesh)
        pipe = StreamingPipeline(cfg, make_stage_mesh(stages, devices),
                                 image_shape=frames[0][0].shape,
                                 payload_mode=args.payload_mode,
                                 payload_dtype=args.payload_dtype)
        outs = [_numpy(filt) for _, filt in pipe.run(frames)]
        print(f"streamed {len(frames)} frames over {stages} stages "
              f"(payload {args.payload_mode}/{args.payload_dtype})",
              file=sys.stderr)
    else:
        from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
        matcher = StereoMatcher(cfg, device=device)
        outs = [_numpy(matcher(l, r)[1]) for l, r in frames]
        print(f"single-device fallback: {len(frames)} frames sequentially",
              file=sys.stderr)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, disp in enumerate(outs):
        image_save(os.path.join(args.out_dir, f"disp_{i:04d}.png"),
                   colorize_disparity(disp))
        np.save(os.path.join(args.out_dir, f"disp_{i:04d}.npy"), disp)
    print(f"{len(outs)} disparities -> {args.out_dir}")
    return 0


def cmd_benchmark(args) -> int:
    print("error: the port has no benchmark yet (ROADMAP.md: the port's "
          "benchmark); bench.py is the JAX package's TPU benchmark, and "
          "chip_smoke.py times the port on the card", file=sys.stderr)
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="smt-torch",
                                description="stereo depth engine, PyTorch "
                                            "+ CUDA port")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build-dataset", help="ARKit session -> npz")
    b.add_argument("json_file")
    b.add_argument("--image_dir", default=None)
    b.add_argument("--output", default="tmp.npz")
    b.add_argument("--mode", default="P", choices=["P", "LR", "LL"])
    b.set_defaults(fn=cmd_build_dataset)

    r = sub.add_parser("rectify", help="rectify an npz frame pair")
    r.add_argument("npz_file")
    r.add_argument("id1", type=int)
    r.add_argument("id2", type=int)
    r.add_argument("--alpha", type=float, default=-1.0)
    r.add_argument("--portrait", action="store_true")
    r.add_argument("--left_out", default="rectified_l.png")
    r.add_argument("--right_out", default="rectified_r.png")
    _add_device_arg(r)
    r.set_defaults(fn=cmd_rectify)

    m = sub.add_parser("match", help="compute disparity (npz pair or images)")
    m.add_argument("--npz_file", default=None)
    m.add_argument("--id1", type=int, default=0)
    m.add_argument("--id2", type=int, default=1)
    m.add_argument("--left", default=None, help="pre-rectified left image")
    m.add_argument("--right", default=None)
    m.add_argument("--alpha", type=float, default=-1.0)
    m.add_argument("--portrait", action="store_true")
    m.add_argument("--write_ply", action="store_true")
    m.add_argument("--ply_out", default="pointcloud.ply")
    m.add_argument("--disp_out", default="disparity.png")
    m.add_argument("--disparity_band", type=float, nargs=2, default=None)
    m.add_argument("--focal", type=float, default=1164.0)
    m.add_argument("--baseline", type=float, default=22.0)
    m.add_argument("--enhance", action="store_true",
                   help="gaussian+unsharp pre-filter (image_measure parity)")
    m.add_argument("--denoise", action="store_true",
                   help="non-local-means denoise before matching")
    m.add_argument("--method", default="sgbm",
                   choices=["sgbm", "bm", "elas", "mccnn"],
                   help="matcher family (reference: SGBM/BM modes, "
                        "libelas, mc-cnn)")
    m.add_argument("--mccnn_checkpoint", default=None,
                   help="MC-CNN weights as a flax .npz checkpoint")
    m.add_argument("--arch", default="fast", choices=["fast", "accurate"],
                   help="MC-CNN tower variant")
    _add_settings_args(m)
    _add_device_arg(m)
    m.set_defaults(fn=cmd_match)

    j = sub.add_parser("reproject", help="disparity/depth image -> PLY")
    j.add_argument("disparity")
    j.add_argument("--color", default=None)
    j.add_argument("--output", default="pointcloud.ply")
    j.add_argument("--mode", choices=["disparity", "depth"], default="disparity")
    j.add_argument("--focal", type=float, default=1164.0)
    j.add_argument("--baseline", type=float, default=22.0)
    j.add_argument("--cx", type=float, default=None)
    j.add_argument("--cy", type=float, default=None)
    j.add_argument("--scale", type=float, default=1.0)
    j.add_argument("--min_value", type=float, default=0.0)
    j.add_argument("--ascii", action="store_true")
    _add_device_arg(j)
    j.set_defaults(fn=cmd_reproject)

    e = sub.add_parser("eval", help="disparity metrics vs ground truth")
    e.add_argument("pred")
    e.add_argument("gt")
    _add_device_arg(e)
    e.set_defaults(fn=cmd_eval)

    t = sub.add_parser("train-mccnn", help="train the learned matching cost "
                                           "(not ported yet: exits 2)")
    t.add_argument("--left", required=True)
    t.add_argument("--right", required=True)
    t.add_argument("--gt", required=True, help="GT disparity (.npy or KITTI png)")
    t.add_argument("--output", default="mccnn_ckpt")
    t.add_argument("--arch", default="fast", choices=["fast", "accurate"])
    t.add_argument("--samples", type=int, default=4096)
    t.add_argument("--patch", type=int, default=12)
    t.add_argument("--batch_size", type=int, default=256)
    t.add_argument("--epochs", type=int, default=4)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train_mccnn)

    o = sub.add_parser("mono", help="monocular depth (single image)")
    o.add_argument("image")
    o.add_argument("--checkpoint", default=None,
                   help="monodepth weights as a flax .npz checkpoint")
    o.add_argument("--mono-arch", default=None, choices=["full", "small"],
                   help="model architecture of --checkpoint (default: "
                        "inferred from the checkpoint's parameter shapes)")
    o.add_argument("--output", default="mono_disparity.png")
    _add_device_arg(o)
    o.set_defaults(fn=cmd_mono)

    c = sub.add_parser("costbin", help="external cost volume (.bin) -> "
                       "disparity + PLY (mapTo3D_mc_cnn parity)")
    c.add_argument("bin", help="float32 (1, D, W, H) dump, e.g. left.bin")
    c.add_argument("--disp-max", type=int, default=228,
                   help="D of the dump (mc_cnn/script.py: -disp_max 228)")
    c.add_argument("--width", type=int, default=1280)
    c.add_argument("--height", type=int, default=720)
    c.add_argument("--left", default=None,
                   help="left image: WLS guide + PLY colors")
    c.add_argument("--p1", type=float, default=8.0)
    c.add_argument("--p2", type=float, default=96.0)
    c.add_argument("--num-paths", type=int, default=8)
    c.add_argument("--no-wls", action="store_true")
    c.add_argument("--lmbda", type=float, default=80000.0)
    c.add_argument("--sigma", type=float, default=1.2)
    c.add_argument("--focal", type=float, default=1164.0)
    c.add_argument("--cx", type=float, default=None)
    c.add_argument("--cy", type=float, default=None)
    c.add_argument("--baseline", type=float, default=22.0)
    c.add_argument("--disp-out", default="costbin_disparity.png")
    c.add_argument("--ply-out", default="out4.ply")
    _add_device_arg(c)
    c.set_defaults(fn=cmd_costbin)

    st = sub.add_parser("stream", help="stream a frame sequence through "
                                       "the stage pipeline")
    st.add_argument("--left-glob", required=True,
                    help="glob of left frames (sorted)")
    st.add_argument("--right-glob", required=True)
    st.add_argument("--out-dir", default="stream_out")
    st.add_argument("--stages", type=int, default=None, choices=[1, 2, 4],
                    help="pipeline stages (default: by device count)")
    st.add_argument("--payload-mode", default="census",
                    choices=["volume", "census"],
                    help="wire contents between stages (census halves "
                         "the hop)")
    st.add_argument("--payload-dtype", default="float32",
                    choices=["float32", "int16"])
    _add_settings_args(st)
    _add_device_arg(st)
    st.set_defaults(fn=cmd_stream)

    k = sub.add_parser("benchmark", help="fps benchmark (not in the port "
                                         "yet: exits 2)")
    k.set_defaults(fn=cmd_benchmark)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
