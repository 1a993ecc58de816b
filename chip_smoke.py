#!/usr/bin/env python3
"""Drive the PyTorch port's census + 8-path SGM main path on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result lines) on failure:

1. device: the card must be a Hopper (sm_90); prints its name and power limit.
2. build: compiles the four CUDA kernels from ``stereo_match_tpu_torch/csrc``
   with nvcc and prints the ``-Xptxas -v`` report.
3. kernel parity at KITTI shape (1242x375, D=128, slanted random-dot scene,
   seed 1): each kernel against its plain PyTorch version on the same CUDA
   tensors. K1, K2 and the K3 totals must be bit-equal; K4 must give the
   same NaN mask and values within 1e-6.
4. main path: ``StereoMatcher`` with the headline config, launch counts
   reset just before the run and read just after; the result against the
   plain path on the card (same NaN mask, values within 1e-6) and against
   the scene's ground truth (bad-3px < 0.05, density > 0.8). Then the same
   comparison at 1280x720, D=160.
5. timing with CUDA events after a warm-up: frames/s of the main path with
   the kernels and with the plain versions at KITTI shape, and with the
   kernels at 720p; each kernel's time beside its plain version's; the
   peak device memory of one KITTI frame.

The last lines are the per-kernel JSON record, the card's name and power
limit from nvidia-smi, and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

KITTI = dict(H=375, W=1242, D=128, d_min=5.0, d_max=90.0, seed=1)
ARKIT_720P = dict(H=720, W=1280, D=160, d_min=5.0, d_max=110.0, seed=3)
K4_TOL = 1e-6
PALLAS = "stereo_match_tpu/ops/pallas_kernels.py"
KERNELS = {   # name -> (source, the TPU kernel(s) it replaces)
    "census_words": ("stereo_match_tpu_torch/csrc/census.cu",
                     f"{PALLAS}:750"),
    "census_volume": ("stereo_match_tpu_torch/csrc/cost_volume.cu",
                      f"{PALLAS}:892"),
    "sgm_path_scan": ("stereo_match_tpu_torch/csrc/sgm.cu",
                      f"{PALLAS}:530; {PALLAS}:1953; {PALLAS}:464"),
    "wta_lr": ("stereo_match_tpu_torch/csrc/wta.cu",
               f"{PALLAS}:825; {PALLAS}:464"),
}


def label(spec: dict) -> str:
    return f"{spec['W']}x{spec['H']} D={spec['D']}"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.data.synthetic import (random_dot_pair,
                                                       slanted_scene)
    from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate, density
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
    from stereo_match_tpu_torch.pipeline.stereo import (StereoMatcher,
                                                        _match_core)
    from stereo_match_tpu_torch.utils.backend import require_hopper

    # 1. device
    dev = require_hopper(0)
    card = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    lib, log = K.build()
    print(f"[build] {lib}")
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            print(f"[build] {line.strip()}")

    def scene(spec):
        gt = slanted_scene(spec["H"], spec["W"], spec["d_min"], spec["d_max"])
        left, right = random_dot_pair(spec["H"], spec["W"], gt, blur=1.0,
                                      seed=spec["seed"])
        return (torch.from_numpy(left).to(dev, torch.float32),
                torch.from_numpy(right).to(dev, torch.float32), gt)

    def headline(D: int) -> DisparityConfig:
        return DisparityConfig(num_disparities=D, cost="census",
                               uniqueness_ratio=15, disp12_max_diff=1,
                               wls=False, speckle_window_size=0)

    def aggregate(scan, vol, cfg):
        return K.aggregate_paths(vol, cfg.P1, cfg.P2, cfg.num_paths, scan)

    def plain_path(left, right, cfg):
        """The main path with every kernel replaced by its plain version."""
        words = K.census_words_plain(torch.stack([left, right]),
                                     cfg.census_window)
        vol = K.census_volume_plain(words[0], words[1], cfg.num_disparities,
                                    cfg.min_disparity)
        total = aggregate(K.sgm_path_scan_plain, vol, cfg)
        return K.wta_lr_plain(total, cfg.min_disparity, cfg.uniqueness_ratio,
                              cfg.disp12_max_diff, cfg.subpixel)[0]

    def same_disparity(a, b, what):
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        check(torch.equal(nan_a, nan_b), f"{what}: NaN masks differ at "
              f"{int((nan_a != nan_b).sum())} pixels")
        err = float((a - b).abs().nan_to_num(0.0).max())
        check(err <= K4_TOL, f"{what}: max |diff| {err} > {K4_TOL}")
        return err

    # 3. kernel parity at KITTI shape
    left, right, gt = scene(KITTI)
    cfg = headline(KITTI["D"])
    imgs = torch.stack([left, right]).contiguous()
    err, ms, plain_ms = {}, {}, {}

    words = K.census_words(imgs, cfg.census_window)
    words_ref = K.census_words_plain(imgs, cfg.census_window)
    err["census_words"] = int((words.long() - words_ref.long()).abs().max())
    check(torch.equal(words, words_ref), "K1 census_words bit-equal")

    vol = K.census_volume(words[0], words[1], cfg.num_disparities, 0)
    vol_ref = K.census_volume_plain(words[0], words[1], cfg.num_disparities, 0)
    err["census_volume"] = float((vol - vol_ref).abs().max())
    check(torch.equal(vol, vol_ref), "K2 census_volume bit-equal")

    total = aggregate(K.sgm_path_scan, vol, cfg)
    total_ref = aggregate(K.sgm_path_scan_plain, vol, cfg)
    err["sgm_path_scan"] = float((total - total_ref).abs().max())
    check(torch.equal(total, total_ref), "K3 sgm_path_scan totals bit-equal")

    wta_args = (cfg.min_disparity, cfg.uniqueness_ratio, cfg.disp12_max_diff,
                cfg.subpixel)
    disp, disp_right = K.wta_lr(total, *wta_args)
    disp_ref, right_ref = K.wta_lr_plain(total, *wta_args)
    err["wta_lr"] = same_disparity(disp, disp_ref, "K4 wta_lr")
    check(torch.equal(disp_right, right_ref), "K4 right-view disparities")
    for name, e in err.items():
        print(f"[parity] {name}: max_abs_err={e} ({label(KITTI)})")

    # 4. main path through the user's entry point
    matcher = StereoMatcher(cfg, device=dev)
    left_np, right_np = left.cpu().numpy(), right.cpu().numpy()
    K.reset_launches()
    raw, filtered = matcher(left_np, right_np)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"[main] launches {counts}")
    for name in KERNELS:
        check(counts[name] > 0, f"kernel {name} launched on the main path")
    check(raw.shape == (KITTI["H"], KITTI["W"]) and raw.device == dev,
          "main path output shape and device")
    main_err = same_disparity(raw, plain_path(left, right, cfg),
                              "main path vs plain path, KITTI")
    bad3 = float(bad_pixel_rate(raw, gt, 3.0, 0.0))
    dens = float(density(raw))
    print(f"[main] {label(KITTI)}: max |kernel - plain| = {main_err}, "
          f"bad-3px = {bad3}, density = {dens}")
    check(bad3 < 0.05, f"bad-3px {bad3} < 0.05")
    check(dens > 0.8, f"density {dens} > 0.8")

    left7, right7, gt7 = scene(ARKIT_720P)
    cfg7 = headline(ARKIT_720P["D"])
    raw7, _ = _match_core(left7, right7, cfg7)
    err7 = same_disparity(raw7, plain_path(left7, right7, cfg7),
                          "main path vs plain path, 720p")
    print(f"[main] {label(ARKIT_720P)}: max |kernel - plain| = {err7}, "
          f"bad-3px = {float(bad_pixel_rate(raw7, gt7, 3.0, 0.0))}, density = "
          f"{float(density(raw7))}")
    del raw7

    # 5. timing (CUDA events, after a warm-up)
    ms["census_words"] = cuda_ms(lambda: K.census_words(imgs), 50)
    plain_ms["census_words"] = cuda_ms(lambda: K.census_words_plain(imgs), 5)
    ms["census_volume"] = cuda_ms(
        lambda: K.census_volume(words[0], words[1], cfg.num_disparities), 20)
    plain_ms["census_volume"] = cuda_ms(
        lambda: K.census_volume_plain(words[0], words[1],
                                      cfg.num_disparities), 3)
    n_paths = cfg.num_paths
    ms["sgm_path_scan"] = cuda_ms(
        lambda: aggregate(K.sgm_path_scan, vol, cfg), 10) / n_paths
    plain_ms["sgm_path_scan"] = cuda_ms(
        lambda: aggregate(K.sgm_path_scan_plain, vol, cfg), 2) / n_paths
    scratch = torch.empty_like(vol)
    for dy, dx in PATH_DIRECTIONS_8:
        t = cuda_ms(lambda: K.sgm_path_scan(vol, scratch, dy, dx, cfg.P1,
                                            cfg.P2, accumulate=True), 10)
        print(f"[timing] sgm_path_scan direction {(dy, dx)}: {t} ms")
    del scratch
    ms["wta_lr"] = cuda_ms(lambda: K.wta_lr(total, *wta_args), 20)
    plain_ms["wta_lr"] = cuda_ms(lambda: K.wta_lr_plain(total, *wta_args), 3)
    del vol, vol_ref, total, total_ref

    frame_ms = cuda_ms(lambda: _match_core(left, right, cfg), 20, warmup=2)
    frame7_ms = cuda_ms(lambda: _match_core(left7, right7, cfg7), 10)
    plain_frame_ms = cuda_ms(lambda: plain_path(left, right, cfg), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _match_core(left, right, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[timing] main path {label(KITTI)}: kernels {frame_ms} ms/frame"
          f" = {1000.0 / frame_ms} frames/s; plain versions {plain_frame_ms} "
          f"ms/frame = {1000.0 / plain_frame_ms} frames/s; peak device memory "
          f"{peak} B ({card})")
    print(f"[timing] main path {label(ARKIT_720P)}: kernels {frame7_ms} "
          f"ms/frame = {1000.0 / frame7_ms} frames/s ({card})")
    for name in KERNELS:
        print(f"[timing] {name}: kernel {ms[name]} ms, plain {plain_ms[name]} "
              f"ms per launch ({card})")

    record = [{"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[name],
               "max_abs_err": err[name], "ms": ms[name],
               "plain_ms": plain_ms[name]}
              for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
