"""Accuracy parity with OpenCV SGBM at production settings, on the port.

(a) The counterpart of ``tests/test_accuracy.py`` on the port's
``StereoMatcher(device="cpu")``, at its sizes (240x384, D=64; ray-traced
120x320) and with its bounds: bad-3px at most 2 points over
cv2.StereoSGBM at settings.ini's settings (uniqueness 15, disp12 1) and a
density at most 10 points under it (BASELINE.md).
(b) ``tools/accuracy_eval.py``'s census block in the port
(``stereo_match_tpu_torch/tools/accuracy_eval.py``) against the JAX
package's matcher and ``parity_report`` on the JAX package's scenes: the
maps bit-equal, every report value within 1e-6.
(c) The port tool's ``main`` at a tiny size on the CPU: the JAX tool's
keys, the pass rule and the exit code.
(d) On the card (marked ``cuda``; skips without one): (a)'s contract at
KITTI through the tool's census and ray-traced blocks:

    python -m pytest --noconftest -m cuda tests/test_torch_accuracy.py
"""

import copy
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.data.raytrace import render_stereo
from stereo_match_tpu_torch.data.synthetic import (adversarial_pair,
                                                   box_scene,
                                                   multi_box_scene,
                                                   random_dot_pair,
                                                   slanted_scene)
from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate
from stereo_match_tpu_torch.eval.parity import (opencv_sgbm_disparity,
                                                parity_report)
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
from stereo_match_tpu_torch.tools import accuracy_eval as A
from stereo_match_tpu_torch.utils.backend import require_hopper

cv2 = pytest.importorskip("cv2")

H, W, D = 240, 384, 64
# the tool's census scenes, in its order (tools/accuracy_eval.py:49-73)
SCENES = ("slanted_kitti_res", "box_kitti_res", "adv_textureless_bands",
          "adv_periodic_facade", "adv_photometric_asym",
          "adv_occlusions_mixed")
JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "accuracy_eval.py"


def _production_cfg(**kw):
    return DisparityConfig(num_disparities=D, uniqueness_ratio=15,
                           disp12_max_diff=1, speckle_window_size=0,
                           wls=False, **kw)


def _assert_contract(rep):
    assert rep["bad3_delta"] <= 0.02, rep
    assert rep["density_delta"] >= -0.10, rep


def _report(name, gt, left, right, cfg):
    ours, _ = StereoMatcher(cfg, device="cpu")(left, right)
    ref = opencv_sgbm_disparity(left, right, cfg, mode="hh")
    return parity_report(name, gt, ours.numpy(), ref)


# --------------------------------------------- (a) test_accuracy.py's cases

@pytest.mark.parametrize("scene_name,gt_fn", [
    ("slanted", lambda: slanted_scene(H, W, 4.0, 44.0)),
    ("box", lambda: box_scene(H, W, background=6.0, foreground=28.0)),
])
def test_production_settings_bad3_parity(scene_name, gt_fn):
    gt = gt_fn()
    left, right = random_dot_pair(H, W, gt, blur=1.0, seed=3)
    _assert_contract(_report(scene_name, gt, left, right, _production_cfg()))


def test_production_settings_speckle_on_parity():
    """The same contract with the speckle filter on both sides."""
    gt = box_scene(H, W, background=6.0, foreground=28.0)
    left, right = random_dot_pair(H, W, gt, blur=1.0, seed=5)
    cfg = _production_cfg().replace(speckle_window_size=100, speckle_range=2)
    _assert_contract(_report("box+speckle", gt, left, right, cfg))


@pytest.mark.parametrize("name,gt_fn,adv_kw", [
    ("textureless", lambda: slanted_scene(H, W, 4.0, 44.0),
     dict(flat_bands=4, flat_width=0.07)),
    ("periodic", lambda: box_scene(H, W, background=6.0, foreground=28.0),
     dict(periodic_bands=3, period=16)),
    ("photometric", lambda: slanted_scene(H, W, 4.0, 44.0),
     dict(gain=1.18, bias=12.0, vignette=0.35, noise_left=4.0,
          noise_right=10.0)),
    ("occl_mixed", lambda: multi_box_scene(
        H, W, background=6.0, boxes=((0.1, 0.15, 0.35, 0.45, 30.0),
                                     (0.55, 0.5, 0.85, 0.9, 44.0),
                                     (0.2, 0.6, 0.45, 0.8, 20.0))),
     dict(flat_bands=2, periodic_bands=1, period=12, gain=1.1,
          noise_left=5.0, noise_right=5.0)),
])
def test_adversarial_scenes_bad3_parity(name, gt_fn, adv_kw):
    """Textureless bands, periodic facades, photometric asymmetry and
    occlusion-heavy mixes."""
    gt = gt_fn()
    left, right = adversarial_pair(H, W, gt, blur=1.0, seed=11, **adv_kw)
    _assert_contract(_report(name, gt, left, right, _production_cfg()))


def test_raytraced_perspective_stereo():
    """Ray-traced two-camera geometry: bad-3px at most cv2's + 2 points
    and under 5 % on the pixels with a ground truth."""
    left, right, gt = render_stereo(120, 320, seed=1)
    assert np.isnan(gt).mean() > 0.01          # real occlusions exist
    cfg = _production_cfg()
    ours, _ = StereoMatcher(cfg, device="cpu")(left, right)
    b_ours = float(bad_pixel_rate(ours, gt, 3.0, 0.0))
    ref = opencv_sgbm_disparity(left, right, cfg, mode="hh")
    b_ref = float(bad_pixel_rate(ref, gt, 3.0, 0.0))
    assert b_ours <= b_ref + 0.02, (b_ours, b_ref)
    assert b_ours < 0.05, b_ours


def test_raytraced_photometric_asymmetry():
    """A right-view gain and sensor noise: bad-3px under 8 %."""
    left, right, gt = render_stereo(120, 320, seed=3, noise=6.0,
                                    gain_right=1.2)
    ours, _ = StereoMatcher(_production_cfg(), device="cpu")(left, right)
    b = float(bad_pixel_rate(ours, gt, 3.0, 0.0))
    assert b < 0.08, b


# --------------------------------------- (b) the census block against JAX

def _close(got, want, tol=1e-6):
    want = float(want)
    return abs(got - want) <= tol * max(1.0, abs(want))


def test_census_block_matches_jax():
    """Two scenes of the tool's census block (the slanted baseline, also
    with speckle, and the photometric adversary) at 96x192, D=64: the
    port's maps bit-equal to JAX's ``StereoMatcher`` on the JAX package's
    scenes, every value of the report within 1e-6 of JAX's
    ``parity_report`` (relative where it passes 1: an EPE is a float32
    mean, whose ulp at 16 px is 1.9e-6, summed in another order)."""
    from stereo_match_tpu.config import DisparityConfig as JaxConfig
    from stereo_match_tpu.data import synthetic as jsyn
    from stereo_match_tpu.eval.parity import opencv_sgbm_disparity as jax_cv2
    from stereo_match_tpu.eval.parity import parity_report as jax_report
    from stereo_match_tpu.pipeline.stereo import StereoMatcher as JaxMatcher

    h, w, d = 96, 192, 64
    maps = {}
    rows = A.census_rows(h, w, d, "cpu", maps=maps, log=lambda line: None,
                         names=("slanted_kitti_res", "adv_photometric_asym"))
    # the JAX tool's scenes and configs (tools/accuracy_eval.py:37-73)
    gt = jsyn.slanted_scene(h, w, 5.0, 90.0)
    cfg = JaxConfig(num_disparities=d, uniqueness_ratio=15,
                    disp12_max_diff=1, speckle_window_size=0, wls=False)
    cfg_speckle = cfg.replace(speckle_window_size=100, speckle_range=2)
    dots = jsyn.random_dot_pair(h, w, gt, blur=1.0, seed=7)
    adv = jsyn.adversarial_pair(h, w, gt, blur=1.0, seed=11, gain=1.18,
                                bias=12.0, vignette=0.35, noise_left=4.0,
                                noise_right=10.0)
    want = []
    for name, (left, right), c in (
            ("slanted_kitti_res", dots, cfg),
            ("slanted_kitti_res+speckle", dots, cfg_speckle),
            ("adv_photometric_asym", adv, cfg)):
        ref_map = np.asarray(JaxMatcher(c)(left, right)[0])
        np.testing.assert_array_equal(maps[name], ref_map, err_msg=name)
        want.append(jax_report(name, gt, ref_map,
                               jax_cv2(left, right, c, mode="hh")))
    assert [r["scene"] for r in rows] == [r["scene"] for r in want]
    for got, ref in zip(rows, want):
        assert set(got) == set(ref) | {"wall_s"}
        for key in ("ours", "opencv_sgbm"):
            assert got[key].keys() == ref[key].keys()
            for k, v in ref[key].items():
                assert _close(got[key][k], v), (got, ref, k)
        for key in ("bad3_delta", "epe_delta", "density_delta"):
            assert _close(got[key], ref[key]), (got, ref, key)


# ------------------------------------------- (c) the tool's main, tiny size

def _jax_tool_keys() -> list[str]:
    """The top-level keys of the JAX tool's report, from its source: the
    first literal's and every later ``out["..."] =``."""
    found = re.findall(r'out\["(\w+)"\]\s*=', JAX_TOOL.read_text())
    return list(dict.fromkeys(["device", "settings", "scenes", *found]))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(A, "H", 48)
    monkeypatch.setattr(A, "W", 160)
    monkeypatch.setattr(A, "D", 32)
    monkeypatch.setattr(A, "PROD", (48, 160, 48))


def test_main_at_a_tiny_size(tiny, tmp_path):
    """Every block runs; the report has the JAX tool's keys (with
    ``monodepth_shaded_domain``, which the JAX tool never reaches), its
    rows' keys and its pass rule, and the exit code follows ``pass``. At
    this size the scenes' disparities pass D, so the rows miss the target
    and the tool exits 1."""
    path = tmp_path / "accuracy.json"
    rc = A.main(["--device", "cpu", "--output", str(path)])
    out = json.loads(path.read_text())
    assert list(out) == _jax_tool_keys()
    assert "monodepth_shaded_domain" in out
    assert out["device"] == "cpu"
    assert [r["scene"] for r in out["scenes"]] == [
        "slanted_kitti_res", "slanted_kitti_res+speckle", "box_kitti_res",
        "box_kitti_res+speckle", *SCENES[2:], "raytraced_clean",
        "raytraced_sensor_noise_gain", "arkit_prod_720p_d160"]
    for row in out["scenes"]:
        assert {"scene", "ours", "opencv_sgbm", "bad3_delta", "epe_delta",
                "density_delta"} <= set(row)
    assert set(out["mccnn_vs_census"]) == {"noise_0", "noise_25",
                                           "checkpoint", "pass"}
    assert set(out["monodepth_vs_stereo"]) >= {
        "scene_904", "scene_905", "mean_ratio", "pass_half_constant"}
    assert set(out["elas"]) == {"slanted", "multi_box", "note"}
    assert set(out["wls_lr_confidence"]) == {"conf_off", "conf_on", "note"}
    mc = out["mccnn_vs_census"]
    assert mc["pass"] == (
        mc["noise_0"]["mccnn_bad3"] <= mc["noise_0"]["census_bad3"] + 0.03
        and mc["noise_25"]["mccnn_bad3"] < mc["noise_25"]["census_bad3"])
    deltas = [r["bad3_delta"] for r in out["scenes"]] + [
        r["bad3_delta"] for r in out["bm_vs_cv2_stereobm"].values()]
    assert abs(out["worst_bad3_delta"] - max(deltas)) <= 5e-5
    assert out["pass"] == (out["worst_bad3_delta"] <= 0.02 and mc["pass"])
    assert out["worst_bad3_delta"] > 0.02 and not out["pass"] and rc == 1


def test_main_exits_0_on_a_passing_report(tmp_path, monkeypatch):
    """The exit code is 0 exactly when the report passes; the file written
    is the report."""
    report = {"worst_bad3_delta": 0.001, "pass": True}
    monkeypatch.setattr(A, "evaluate", lambda device: copy.deepcopy(report))
    path = tmp_path / "a.json"
    assert A.main(["--device", "cpu", "--output", str(path)]) == 0
    assert json.loads(path.read_text()) == report
    report["pass"] = False
    assert A.main(["--device", "cpu", "--output", str(path)]) == 1


def test_tool_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.main(["--output", "unused.json"])


# ----------------------------------------------------- (d) on the card

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_accuracy.py")
    return require_hopper(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_census_rows_contract_at_kitti_on_card(dev, name):
    """Each census row of the tool at KITTI D=128 on the card (the
    baseline scenes also with speckle): bad-3px at most cv2's + 2 points,
    density at most 10 points under cv2's."""
    for rep in A.census_rows(A.H, A.W, A.D, dev, names=(name,)):
        _assert_contract(rep)


@pytest.mark.cuda
def test_raytraced_rows_at_kitti_on_card(dev):
    """The tool's ray-traced rows at KITTI on the card, with
    test_accuracy.py's bars: clean at most cv2's + 2 points and under
    5 %; with noise and a right-view gain under 8 %."""
    clean, noisy = A.raytraced_rows(A.H, A.W, A.D, dev)
    b_ours, b_ref = clean["ours"]["bad3"], clean["opencv_sgbm"]["bad3"]
    assert b_ours <= b_ref + 0.02, (b_ours, b_ref)
    assert b_ours < 0.05, b_ours
    assert noisy["ours"]["bad3"] < 0.08, noisy
