"""Full-resolution accuracy record: the port against cv2.StereoSGBM at
production settings (settings.ini defaults), KITTI resolution.

Counterpart of ``tools/accuracy_eval.py``, with its blocks in its order and
its scenes, seeds, configurations and sizes (H, W, D = 375, 1242, 128; the
reference's working point 1280x720, D=160), through the port's own API:

1. census rows (:func:`census_rows`): six scenes, two of them also with
   the speckle filter; one ``StereoMatcher`` a configuration;
2. the shipped MC-CNN fast checkpoint against census (:func:`mccnn_vs_census`),
   and 3. on ray-traced scenes, a renderer its training left out
   (:func:`mccnn_out_of_renderer`);
4. ray-traced rows (:func:`raytraced_rows`); 5. the 720p D=160 row
   (:func:`prod_720p_row`);
6. StereoBM against cv2.StereoBM (:func:`bm_vs_cv2_stereobm`); 7. ELAS
   (:func:`elas`);
8. monodepth against stereo (:func:`monodepth_vs_stereo`) and 9. its
   shaded-domain checkpoint (:func:`monodepth_shaded_domain`);
10. the MC-CNN accurate checkpoint (:func:`mccnn_accurate`); 11. the
    LR-confidence-weighted WLS (:func:`wls_lr_confidence`);
12. the totals: the worst bad-3px delta over the rows and StereoBM, the
    target (0.02, BASELINE.md) and ``pass``; the exit code is 1 unless
    ``pass`` is true.

cv2 runs on the host CPU as the oracle; the port runs on ``--device``, the
card unless the caller passes ``--device cpu`` (without a card the tool
raises). Each block is a function of ``(H, W, D, device)``, so the tests
run it small. The report has the JAX tool's keys and nesting, except that
``device`` holds ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` (or ``"cpu"``) and ``wall_s`` the seconds on the
port's device: the first call of each matcher includes the kernels' build
at first use. The report goes to ``--output`` (default
``build/stereo_match_tpu_torch/accuracy.json``), never to ``ACCURACY.json``.

    python -m stereo_match_tpu_torch.tools.accuracy_eval [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.costs import MCCNNCost
from stereo_match_tpu_torch.data.raytrace import render_stereo
from stereo_match_tpu_torch.data.synthetic import (adversarial_pair,
                                                   box_scene,
                                                   multi_box_scene,
                                                   random_dot_pair,
                                                   rough_scene,
                                                   shaded_shapes_pair,
                                                   slanted_scene)
from stereo_match_tpu_torch.eval.metrics import (bad_pixel_rate,
                                                 end_point_error)
from stereo_match_tpu_torch.eval.parity import (opencv_bm_disparity,
                                                opencv_sgbm_disparity,
                                                parity_report)
from stereo_match_tpu_torch.models import mccnn
from stereo_match_tpu_torch.models import monodepth as md
from stereo_match_tpu_torch.pipeline.block_matching import BlockMatcher
from stereo_match_tpu_torch.pipeline.elas import elas_match
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
from stereo_match_tpu_torch.utils.backend import entry_device

H, W, D = 375, 1242, 128
PROD = (720, 1280, 160)     # the reference's working point (settings.ini)
TARGET = 0.02               # bad-3px delta against cv2 (BASELINE.md)
OUTPUT = Path(__file__).resolve().parents[2] / "build" / \
    "stereo_match_tpu_torch" / "accuracy.json"


def _log(line: str) -> None:
    print(line, flush=True)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _bad3(pred, gt) -> float:
    return float(bad_pixel_rate(pred, gt, 3.0, 0.0))


def census_config(D: int) -> DisparityConfig:
    """The production settings: settings.ini's uniqueness 15 and disp12 1,
    speckle and WLS off."""
    return DisparityConfig(num_disparities=D, uniqueness_ratio=15,
                           disp12_max_diff=1, speckle_window_size=0,
                           wls=False)


def census_scenes(H: int, W: int) -> dict:
    """name -> (gt, pair_fn): the two easy round-2 scenes, then the
    adversarial ones (textureless bands, periodic texture, left-right
    photometric asymmetry, large multi-box occlusions)."""
    def dots(gt, **kw):
        return lambda: random_dot_pair(H, W, gt, blur=1.0, seed=7, **kw)

    def adv(gt, **kw):
        return lambda: adversarial_pair(H, W, gt, blur=1.0, seed=11, **kw)

    gt_slant = slanted_scene(H, W, 5.0, 90.0)
    gt_box = box_scene(H, W, background=12.0, foreground=70.0)
    gt_multi = multi_box_scene(H, W, background=10.0)
    return {
        "slanted_kitti_res": (gt_slant, dots(gt_slant)),
        "box_kitti_res": (gt_box, dots(gt_box)),
        "adv_textureless_bands": (gt_slant, adv(gt_slant, flat_bands=4,
                                                flat_width=0.07)),
        "adv_periodic_facade": (gt_box, adv(gt_box, periodic_bands=3,
                                            period=16)),
        "adv_photometric_asym": (gt_slant, adv(gt_slant, gain=1.18,
                                               bias=12.0, vignette=0.35,
                                               noise_left=4.0,
                                               noise_right=10.0)),
        "adv_occlusions_mixed": (gt_multi, adv(gt_multi, flat_bands=2,
                                               periodic_bands=1, period=12,
                                               gain=1.1, noise_left=5.0,
                                               noise_right=5.0)),
    }


def census_rows(H: int, W: int, D: int, device, names=None,
                maps: dict | None = None, log=_log) -> list[dict]:
    """Block 1: ``parity_report`` of each scene (``names``: all when None),
    the two baseline scenes also with speckle 100 range 2 on both sides,
    with ``wall_s``. ``maps``, when given, receives each row's map under
    its scene name."""
    cfg = census_config(D)
    cfg_speckle = cfg.replace(speckle_window_size=100, speckle_range=2)
    matchers = {"": StereoMatcher(cfg, device=device),
                "+speckle": StereoMatcher(cfg_speckle, device=device)}
    rows = []
    for name, (gt, pair_fn) in census_scenes(H, W).items():
        if names is not None and name not in names:
            continue
        left, right = pair_fn()
        # speckle variants only on the two baseline scenes
        variants = (("", cfg), ("+speckle", cfg_speckle)) \
            if not name.startswith("adv_") else (("", cfg),)
        for tag, c in variants:
            t0 = time.time()
            ours = _np(matchers[tag](left, right)[0])
            t_ours = time.time() - t0
            t0 = time.time()
            ref = opencv_sgbm_disparity(left, right, c, mode="hh")
            t_ref = time.time() - t0
            rep = parity_report(name + tag, gt, ours, ref)
            rep["wall_s"] = {"ours_incl_compile": round(t_ours, 2),
                             "opencv_cpu": round(t_ref, 2)}
            rows.append(rep)
            if maps is not None:
                maps[name + tag] = ours
            log(f"{name + tag:28s} ours bad3={rep['ours']['bad3']:.4f} "
                f"cv2 bad3={rep['opencv_sgbm']['bad3']:.4f} "
                f"delta={rep['bad3_delta']:+.4f}")
    return rows


def _mccnn_matcher(arch: str, D: int, device) -> StereoMatcher:
    dev = entry_device(device)
    cfg = census_config(D).replace(cost="mccnn")
    model = mccnn.from_flax_params(mccnn.load_default_params(arch), arch)
    return StereoMatcher(cfg, cost_fn=MCCNNCost(model.to(dev), cfg),
                         device=dev)


def mccnn_vs_census(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 2: the shipped fast checkpoint against census through the same
    SGM stack on gentle terrain, clean and at noise 25. ``pass``: clean
    within 0.03 of census, noisy below census."""
    m_census = StereoMatcher(census_config(D), device=device)
    m_mccnn = _mccnn_matcher("fast", D, device)
    gt = rough_scene(H, W, 999, 4.0, 80.0, cell=128)
    block = {}
    for noise in (0.0, 25.0):
        left, right = random_dot_pair(H, W, gt, blur=1.0, seed=606,
                                      noise=noise)
        b_c = _bad3(m_census(left, right)[0], gt)
        b_m = _bad3(m_mccnn(left, right)[0], gt)
        block[f"noise_{noise:g}"] = {"census_bad3": round(b_c, 4),
                                     "mccnn_bad3": round(b_m, 4)}
        log(f"mccnn_vs_census noise={noise:4.1f} census={b_c:.4f} "
            f"mccnn={b_m:.4f}")
    block["checkpoint"] = "stereo_match_tpu/models/weights/mccnn_fast.npz"
    block["pass"] = bool(
        block["noise_0"]["mccnn_bad3"]
        <= block["noise_0"]["census_bad3"] + 0.03
        and block["noise_25"]["mccnn_bad3"]
        < block["noise_25"]["census_bad3"])
    return block


def mccnn_out_of_renderer(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 3: census and the fast checkpoint on ray-traced scenes (seed
    51), a renderer family the training pool leaves out; reported, not
    gated (``tests/test_mccnn.py`` holds the gate)."""
    m_census = StereoMatcher(census_config(D), device=device)
    m_mccnn = _mccnn_matcher("fast", D, device)
    block = {}
    for tag, kw in (("clean", {}),
                    ("noise_gain", {"noise": 6.0, "gain_right": 1.2})):
        left, right, gt = render_stereo(H, W, seed=51, **kw)
        block[tag] = {
            "census_bad3": round(_bad3(m_census(left, right)[0], gt), 4),
            "mccnn_bad3": round(_bad3(m_mccnn(left, right)[0], gt), 4)}
        log(f"out_of_renderer {tag:16s} "
            f"census={block[tag]['census_bad3']:.4f} "
            f"mccnn={block[tag]['mccnn_bad3']:.4f}")
    block["note"] = ("ray-traced family held out of training (pool = dots + "
                     "shaded shapes + adversarial photometry) — transfer "
                     "evidence for the learned cost")
    return block


def raytraced_rows(H: int, W: int, D: int, device, log=_log) -> list[dict]:
    """Block 4: ``parity_report`` on ray-traced perspective stereo (seed 9),
    clean and with sensor noise and a right-view gain, with the share of
    occluded pixels."""
    cfg = census_config(D)
    matcher = StereoMatcher(cfg, device=device)
    rows = []
    for tag, kw in (("clean", {}),
                    ("sensor_noise_gain", {"noise": 6.0,
                                           "gain_right": 1.2})):
        left, right, gt = render_stereo(H, W, seed=9, **kw)
        ours = _np(matcher(left, right)[0])
        ref = opencv_sgbm_disparity(left, right, cfg, mode="hh")
        rep = parity_report("raytraced_" + tag, gt, ours, ref)
        rep["occluded_frac"] = round(float(np.isnan(gt).mean()), 4)
        rows.append(rep)
        log(f"raytraced_{tag:18s} ours bad3={rep['ours']['bad3']:.4f} "
            f"cv2 bad3={rep['opencv_sgbm']['bad3']:.4f}")
    return rows


def prod_720p_row(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 5: the reference's production working point (the tool passes
    1280x720, D=160: D is not a multiple of 128)."""
    gt = slanted_scene(H, W, 5.0, 110.0)
    left, right = random_dot_pair(H, W, gt, blur=1.0, seed=3)
    cfg = census_config(D)
    t0 = time.time()
    ours = _np(StereoMatcher(cfg, device=device)(left, right)[0])
    t_ours = time.time() - t0
    ref = opencv_sgbm_disparity(left, right, cfg, mode="hh")
    rep = parity_report("arkit_prod_720p_d160", gt, ours, ref)
    rep["wall_s"] = {"ours_incl_compile": round(t_ours, 2)}
    log(f"arkit_prod_720p_d160 ours bad3={rep['ours']['bad3']:.4f} "
        f"cv2 bad3={rep['opencv_sgbm']['bad3']:.4f} "
        f"delta={rep['bad3_delta']:+.4f}")
    return rep


def bm_vs_cv2_stereobm(H: int, W: int, D: int, device,
                       log=_log) -> tuple[dict, float]:
    """Block 6: StereoBM (block 21, disp12 off) against cv2.StereoBM on
    the slanted and multi-box scenes. Returns the block and its worst
    bad-3px delta, unrounded."""
    cfg = DisparityConfig(num_disparities=D, block_size=21,
                          speckle_window_size=0, disp12_max_diff=-1,
                          wls=False)
    matcher = BlockMatcher(cfg, device=device)
    block, worst = {}, -1.0
    for name, gt in (("slanted", slanted_scene(H, W, 5.0, 90.0)),
                     ("multi_box", multi_box_scene(H, W, background=10.0))):
        left, right = random_dot_pair(H, W, gt, blur=1.2, seed=31)
        ours = _np(matcher(left, right)[0])
        ref = opencv_bm_disparity(left, right, cfg)
        b_o, b_r = _bad3(ours, gt), _bad3(ref, gt)
        both = np.isfinite(ours) & np.isfinite(ref)
        agree = float(np.mean(np.abs(ours[both] - ref[both]) <= 1.0))
        block[name] = {
            "ours_bad3": round(b_o, 4), "cv2_bm_bad3": round(b_r, 4),
            "bad3_delta": round(b_o - b_r, 4),
            "both_valid_agree_1px": round(agree, 4),
            "mask_disagree": round(float(np.mean(np.isfinite(ours)
                                                 != np.isfinite(ref))), 4)}
        worst = max(worst, b_o - b_r)
        log(f"bm_vs_cv2 {name:12s} ours={b_o:.4f} cv2={b_r:.4f} "
            f"agree={agree:.4f}")
    return block, worst


def elas(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 7: ELAS (dense and before the gap fill) against census-SGM
    and the cv2 SGBM oracle on the slanted and multi-box scenes."""
    cfg = census_config(D)
    matcher = StereoMatcher(cfg, device=device)
    block = {}
    for name, gt in (("slanted", slanted_scene(H, W, 5.0, 90.0)),
                     ("multi_box", multi_box_scene(H, W, background=10.0))):
        left, right = random_dot_pair(H, W, gt, blur=1.0, seed=41)
        d_elas, d_matched = elas_match(left, right, num_disparities=D,
                                       return_matched=True, device=device)
        d_sgm = _np(matcher(left, right)[0])
        ref = opencv_sgbm_disparity(left, right, cfg, mode="hh")
        row = {
            "elas_bad3": round(_bad3(d_elas, gt), 4),
            "elas_matched_bad3": round(_bad3(d_matched, gt), 4),
            "elas_epe": round(float(end_point_error(d_elas, gt)), 4),
            "census_sgm_bad3": round(_bad3(d_sgm, gt), 4),
            "cv2_sgbm_bad3": round(_bad3(ref, gt), 4),
            "elas_density": round(float(np.isfinite(d_elas).mean()), 4),
            "elas_matched_density": round(float(np.isfinite(
                d_matched).mean()), 4),
            "sgm_density": round(float(np.isfinite(d_sgm).mean()), 4)}
        block[name] = row
        log(f"elas {name:12s} elas={row['elas_bad3']:.4f} "
            f"matched={row['elas_matched_bad3']:.4f} "
            f"sgm={row['census_sgm_bad3']:.4f} "
            f"cv2={row['cv2_sgbm_bad3']:.4f}")
    block["note"] = (
        "elas_bad3 scores the gap-filled dense map, which covers the "
        "occluded pixels census-SGM leaves invalid (its bad3 is over its "
        "own ~93%-density valid set); elas_matched_bad3 is the "
        "like-for-like matched-pixels comparison")
    return block


def _affine_epe(pred: np.ndarray, gt: np.ndarray) -> float:
    a, b = np.polyfit(pred, gt, 1)
    return float(np.mean(np.abs(a * pred + b - gt)))


def monodepth_vs_stereo(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 8: the shipped small checkpoint on held-out ray-traced scenes
    900-909 through the 96x160 protocol: affine-calibrated EPE over the
    valid ground truth against the best constant predictor, the stereo
    matcher's EPE beside it. ``pass_half_constant``: the mean ratio and
    scenes 904 and 905 at most 0.5."""
    try:
        model = md.load_default(device=device)
    except FileNotFoundError:
        return {"note": "no shipped checkpoint"}
    matcher = StereoMatcher(census_config(D), device=device)
    block, ratios = {}, []
    for s in range(900, 910):
        left, right, gt = render_stereo(H, W, seed=s)
        pred = _np(md.predict_disparity(model, np.stack([left] * 3,
                                                        axis=-1)))
        m = np.isfinite(gt)
        mono_epe = _affine_epe(pred[m], gt[m])
        const_epe = float(np.mean(np.abs(np.median(gt[m]) - gt[m])))
        st_epe = float(end_point_error(_np(matcher(left, right)[0]), gt))
        ratios.append(mono_epe / const_epe)
        block[f"scene_{s}"] = {
            "mono_affine_epe": round(mono_epe, 4),
            "stereo_epe": round(st_epe, 4),
            "constant_predictor_epe": round(const_epe, 4),
            "ratio": round(mono_epe / const_epe, 4)}
        log(f"monodepth scene_{s} mono={mono_epe:.3f} stereo={st_epe:.3f} "
            f"const={const_epe:.3f} ratio={ratios[-1]:.3f}")
    block["mean_ratio"] = round(float(np.mean(ratios)), 4)
    block["note"] = ("monocular: affine-calibrated EPE over valid GT; stereo "
                     "at same scenes for context — single-image depth is a "
                     "different (harder) problem, parity is not expected")
    block["pass_half_constant"] = bool(
        np.mean(ratios) <= 0.5
        and block["scene_904"]["ratio"] <= 0.5
        and block["scene_905"]["ratio"] <= 0.5)
    return block


def monodepth_shaded_domain(H: int, W: int, D: int, device,
                            log=_log) -> dict:
    """Block 9: the shaded-domain checkpoint on two shaded-shapes scenes,
    against the constant predictor (reported, near its floor)."""
    try:
        model = md.load_default("small_shaded", device=device)
    except FileNotFoundError:
        return {"note": "no shaded-domain checkpoint"}
    rows = {}
    for s in range(2):
        gt = rough_scene(H, W, 500 + s, 4.0, 80.0, cell=128)
        left, _ = shaded_shapes_pair(H, W, gt, seed=70 + s,
                                     tex_scale=W / 160.0)
        pred = _np(md.predict_disparity(model, np.stack([left] * 3,
                                                        axis=-1)))
        rows[f"scene_{s}"] = {
            "mono_affine_epe": round(_affine_epe(pred.ravel(),
                                                 gt.ravel()), 4),
            "constant_predictor_epe": round(float(np.mean(np.abs(
                np.median(gt) - gt))), 4)}
        log(f"monodepth_shaded scene_{s} {rows[f'scene_{s}']}")
    rows["note"] = ("second domain; the warp renderers carry almost no "
                    "monocular depth cue (brightness = texture x shading is "
                    "ambiguous), so this checkpoint sits near the constant "
                    "floor — reported honestly")
    return rows


def mccnn_accurate(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 10: the shipped accurate checkpoint on block 2's scenes."""
    try:
        matcher = _mccnn_matcher("accurate", D, device)
    except FileNotFoundError:
        return {"note": "no shipped checkpoint"}
    gt = rough_scene(H, W, 999, 4.0, 80.0, cell=128)
    block = {}
    for noise in (0.0, 25.0):
        left, right = random_dot_pair(H, W, gt, blur=1.0, seed=606,
                                      noise=noise)
        b_a = _bad3(matcher(left, right)[0], gt)
        block[f"noise_{noise:g}"] = {"mccnn_accurate_bad3": round(b_a, 4)}
        log(f"mccnn_accurate noise={noise:4.1f} bad3={b_a:.4f}")
    block["checkpoint"] = "stereo_match_tpu/models/weights/mccnn_accurate.npz"
    return block


def wls_lr_confidence(H: int, W: int, D: int, device, log=_log) -> dict:
    """Block 11: the WLS-filtered map (3 iterations, disp12 off) with and
    without the LR confidence, on the multi-box occlusion scene."""
    cfg = census_config(D).replace(wls=True, wls_iters=3,
                                   disp12_max_diff=-1)
    gt = multi_box_scene(H, W, background=10.0)
    left, right = random_dot_pair(H, W, gt, blur=1.0, seed=77)
    block = {}
    for tag, on in (("off", False), ("on", True)):
        matcher = StereoMatcher(cfg.replace(wls_lr_confidence=on),
                                device=device)
        f = _np(matcher(left, right)[1])
        block[f"conf_{tag}"] = {
            "bad3": round(_bad3(f, gt), 4),
            "epe": round(float(end_point_error(f, gt)), 4)}
    block["note"] = ("cv2 DisparityWLSFilter confidence semantics (hard LRC "
                     "gate x zero depth-discontinuity bands, "
                     "ops/wls.wls_confidence_cv2)")
    log(f"wls_lr_confidence off={block['conf_off']} on={block['conf_on']}")
    return block


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``"cpu"``."""
    if entry_device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def evaluate(device, log=_log) -> dict:
    """Every block at the module's sizes (``H``, ``W``, ``D``, ``PROD``),
    in the JAX tool's order, and the totals."""
    dev = entry_device(device)
    cfg = census_config(D)
    out = {"device": device_name(dev),
           "settings": {"num_disparities": D, "uniqueness_ratio": 15,
                        "disp12_max_diff": 1, "window_size": cfg.window_size,
                        "cost": cfg.cost, "dtype": cfg.dtype},
           "scenes": census_rows(H, W, D, dev, log=log)}
    mc_block = mccnn_vs_census(H, W, D, dev, log=log)
    out["mccnn_out_of_renderer"] = mccnn_out_of_renderer(H, W, D, dev,
                                                         log=log)
    out["mccnn_vs_census"] = mc_block
    out["scenes"] += raytraced_rows(H, W, D, dev, log=log)
    out["scenes"].append(prod_720p_row(*PROD, dev, log=log))
    worst = max(rep["bad3_delta"] for rep in out["scenes"])
    out["bm_vs_cv2_stereobm"], bm_worst = bm_vs_cv2_stereobm(H, W, D, dev,
                                                             log=log)
    worst = max(worst, bm_worst)
    out["elas"] = elas(H, W, D, dev, log=log)
    out["monodepth_vs_stereo"] = monodepth_vs_stereo(H, W, D, dev, log=log)
    if "pass_half_constant" in out["monodepth_vs_stereo"]:
        out["monodepth_shaded_domain"] = monodepth_shaded_domain(
            H, W, D, dev, log=log)
    out["mccnn_accurate"] = mccnn_accurate(H, W, D, dev, log=log)
    out["wls_lr_confidence"] = wls_lr_confidence(H, W, D, dev, log=log)
    out["worst_bad3_delta"] = worst
    out["target"] = f"bad3_delta <= {TARGET} (BASELINE.md)"
    out["pass"] = bool(worst <= TARGET and mc_block["pass"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--output", default=str(OUTPUT),
                    help="default: build/stereo_match_tpu_torch/"
                         "accuracy.json")
    args = ap.parse_args(argv)
    out = evaluate(args.device)
    path = Path(args.output)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print(f"worst bad3 delta: {out['worst_bad3_delta']:+.4f}  "
          f"pass={out['pass']}")
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
