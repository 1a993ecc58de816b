"""The port's host I/O, scenes and utilities against the JAX package.

The numpy modules the port copies (ray tracer, synthetic scenes, ARKit,
KITTI, Middlebury, PLY, image files, artifacts, colormap) must give
bit-equal results and byte-equal files on the same inputs; the torch
reprojection helpers agree within 1e-6. The checks of the JAX package's
``tests/test_io.py`` and ``tests/test_artifacts.py`` run on both packages.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stereo_match_tpu.core import camera as jcamera
from stereo_match_tpu.core import reproject as jreproject
from stereo_match_tpu.data import arkit as jarkit
from stereo_match_tpu.data import costbin as jcostbin
from stereo_match_tpu.data import image as jimage
from stereo_match_tpu.data import kitti as jkitti
from stereo_match_tpu.data import middlebury as jmiddlebury
from stereo_match_tpu.data import ply as jply
from stereo_match_tpu.data import raytrace as jraytrace
from stereo_match_tpu.data import synthetic as jsynthetic
from stereo_match_tpu.eval import parity as jparity
from stereo_match_tpu.pipeline import artifacts as jartifacts
from stereo_match_tpu.utils import handy as jhandy
from stereo_match_tpu.viz import plots as jplots
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.core import reproject as treproject
from stereo_match_tpu_torch.data import arkit as tarkit
from stereo_match_tpu_torch.data import costbin as tcostbin
from stereo_match_tpu_torch.data import image as timage
from stereo_match_tpu_torch.data import kitti as tkitti
from stereo_match_tpu_torch.data import middlebury as tmiddlebury
from stereo_match_tpu_torch.data import ply as tply
from stereo_match_tpu_torch.data import raytrace as traytrace
from stereo_match_tpu_torch.data import synthetic as tsynthetic
from stereo_match_tpu_torch.eval import parity as tparity
from stereo_match_tpu_torch.pipeline import artifacts as tartifacts
from stereo_match_tpu_torch.utils import handy as thandy
from stereo_match_tpu_torch.viz import plots as tplots

PACKAGES = {
    "jax": SimpleNamespace(
        arkit=jarkit, image=jimage, kitti=jkitti, middlebury=jmiddlebury,
        ply=jply, artifacts=jartifacts, costbin=jcostbin,
        to_disparity=jcostbin.external_volume_to_disparity),
    "torch": SimpleNamespace(
        arkit=tarkit, image=timage, kitti=tkitti, middlebury=tmiddlebury,
        ply=tply, artifacts=tartifacts, costbin=tcostbin,
        to_disparity=lambda *a, **k: tcostbin.external_volume_to_disparity(
            *a, device="cpu", **k)),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _equal_trees(a, b):
    """Bit-equal numpy outputs (arrays, tuples, dicts, dataclasses)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        _equal_trees(vars(a), vars(b))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------- copies, bit for bit ----

@pytest.mark.parametrize("seed, kw", [
    (904, {}), (1, dict(noise=3.0, gain_right=0.9)),
    (7, dict(focal=30.0, baseline=0.3)),
])
def test_render_stereo_is_the_jax_render(seed, kw):
    _equal_trees(traytrace.render_stereo(30, 52, seed=seed, **kw),
                 jraytrace.render_stereo(30, 52, seed=seed, **kw))


def test_render_view_and_surface_distance_are_the_jax_ones():
    K = np.array([[40.0, 0, 25], [0, 40.0, 15], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = jcamera.rodrigues([0.02, -0.05, 0.01])
    pose[:3, 3] = [0.3, 0.05, 0.1]
    got = traytrace.render_view(30, 50, K, pose, seed=3, noise=2.0, gain=1.1)
    want = jraytrace.render_view(30, 50, K, pose, seed=3, noise=2.0, gain=1.1)
    _equal_trees(got, want)
    tscene, jscene = traytrace.default_scene(3), jraytrace.default_scene(3)
    _equal_trees(tscene, jscene)
    np.testing.assert_array_equal(
        traytrace.scene_surface_distance(tscene, got[1]),
        jraytrace.scene_surface_distance(jscene, want[1]))


@pytest.mark.parametrize("name, args, kw", [
    ("box_scene", (24, 40), {}),
    ("box_scene", (24, 40, 2.0, 9.0), {}),
    ("multi_box_scene", (30, 50), {}),
    ("multi_box_scene", (30, 50, 4.0, ((0.1, 0.2, 0.5, 0.6, 12.0),)), {}),
    ("slanted_scene", (20, 30), {}),
    ("rough_scene", (40, 48), dict(seed=3)),
])
def test_scenes_are_the_jax_scenes(name, args, kw):
    np.testing.assert_array_equal(getattr(tsynthetic, name)(*args, **kw),
                                  getattr(jsynthetic, name)(*args, **kw))


@pytest.mark.parametrize("name, kw", [
    ("random_dot_pair", dict(seed=4, noise=2.0, shading=0.5)),
    ("adversarial_pair", dict(seed=2)),
    ("adversarial_pair", dict(seed=5, flat_bands=2, periodic_bands=2,
                              period=8, gain=1.2, bias=-5.0, vignette=0.3,
                              noise_left=2.0, noise_right=3.0)),
    ("shaded_shapes_pair", dict(seed=1)),
    ("shaded_shapes_pair", dict(seed=6, noise_saltpepper=0.05,
                                gain_right=0.8, tex_scale=2.0)),
])
def test_pairs_are_the_jax_pairs(name, kw):
    gt = jsynthetic.multi_box_scene(32, 56, 3.0, ((0.2, 0.2, 0.6, 0.5, 9.0),))
    _equal_trees(getattr(tsynthetic, name)(32, 56, gt, **kw),
                 getattr(jsynthetic, name)(32, 56, gt, **kw))


def _files_equal(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("binary", [False, True])
def test_ply_files_are_byte_equal(tmp_path, rng, binary):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[3] = np.nan
    cols = rng.integers(0, 255, (50, 3)).astype(np.float64)
    n = [m.write_ply(str(tmp_path / f"{k}.ply"), pts, cols, binary=binary)
         for k, m in (("j", jply), ("t", tply))]
    assert n == [50, 50]
    _files_equal(tmp_path / "j.ply", tmp_path / "t.ply")
    _equal_trees(tply.read_ply(str(tmp_path / "j.ply")),
                 jply.read_ply(str(tmp_path / "j.ply")))


def test_mesh_transform_and_record_size_are_the_jax_ones(tmp_path, rng):
    verts = rng.normal(size=(6, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    cols = rng.integers(0, 300, (6, 3))
    for colors in (None, cols):
        jply.write_mesh_ply(str(tmp_path / "j.ply"), verts, faces, colors)
        tply.write_mesh_ply(str(tmp_path / "t.ply"), verts, faces, colors)
        _files_equal(tmp_path / "j.ply", tmp_path / "t.ply")
    T = rng.normal(size=(4, 4))
    jply.write_transform(str(tmp_path / "j.npz"), T)
    tply.write_transform(str(tmp_path / "t.npz"), T)
    with np.load(tmp_path / "t.npz") as d:
        np.testing.assert_array_equal(d["transform"], T)
    assert tply.struct_size() == jply.struct_size() == 15


@pytest.mark.parametrize("ext", ["png", "jpeg", "bmp"])
def test_image_files_are_the_jax_files(tmp_path, rng, ext):
    rgb = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (21, 34), dtype=np.uint8)
    flt = rng.normal(size=(21, 34)).astype(np.float32)
    for name, img in (("rgb", rgb), ("gray", gray), ("float", flt)):
        jp, tp = str(tmp_path / f"j_{name}.{ext}"), str(tmp_path /
                                                        f"t_{name}.{ext}")
        jimage.image_save(jp, img)
        timage.image_save(tp, img)
        _files_equal(jp, tp)
        for grayscale in (False, True):
            np.testing.assert_array_equal(
                timage.image_read(jp, grayscale=grayscale),
                jimage.image_read(jp, grayscale=grayscale))
    with pytest.raises(FileNotFoundError):
        timage.image_read(str(tmp_path / "missing.png"))


def test_grayscale_read_is_cv2s(tmp_path, rng):
    """``grayscale=True`` on an RGB file gives cv2's IMREAD_GRAYSCALE."""
    cv2 = pytest.importorskip("cv2")
    rgb = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    timage.image_save(p, rgb)
    np.testing.assert_array_equal(timage.image_read(p, grayscale=True),
                                  cv2.imread(p, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("x", [
    np.array([[0.0, 5.0], [10.0, 2.5]]),
    np.array([[np.nan, 1.0, 3.0, -2.0]], np.float32),
    np.full((3, 3), 7.0),
])
def test_conversions_are_the_jax_ones(x):
    np.testing.assert_array_equal(timage.normalize_to_uint8(x),
                                  jimage.normalize_to_uint8(x))
    rgb = np.random.default_rng(0).integers(0, 256, (5, 6, 3), np.uint8)
    for img in (rgb, rgb.astype(np.float32), rgb[..., 0]):
        np.testing.assert_array_equal(timage.to_grayscale(img),
                                      jimage.to_grayscale(img))


def test_kitti_disparity_files_cross_read(tmp_path, rng):
    disp = rng.uniform(0, 200, (20, 33)).astype(np.float32)
    disp[0, :3] = [np.nan, 0.0, -1.0]
    jkitti.write_kitti_disparity(str(tmp_path / "j.png"), disp)
    tkitti.write_kitti_disparity(str(tmp_path / "t.png"), disp)
    _files_equal(tmp_path / "j.png", tmp_path / "t.png")
    np.testing.assert_array_equal(
        tkitti.read_kitti_disparity(str(tmp_path / "j.png")),
        jkitti.read_kitti_disparity(str(tmp_path / "j.png")))


def test_kitti_pair_and_frame_list_are_the_jax_ones(tmp_path, rng):
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (tmp_path / sub).mkdir()
    for fid in ("000000_10", "000001_10", "000001_11"):
        for sub in ("image_2", "image_3"):
            jimage.image_save(str(tmp_path / sub / f"{fid}.png"),
                              rng.integers(0, 256, (8, 12, 3), np.uint8))
    jkitti.write_kitti_disparity(str(tmp_path / "disp_occ_0" /
                                     "000000_10.png"),
                                 rng.uniform(1, 50, (8, 12)))
    assert tkitti.list_kitti_frames(str(tmp_path)) == \
        jkitti.list_kitti_frames(str(tmp_path)) == ["000000_10", "000001_10"]
    assert tkitti.list_kitti_frames(str(tmp_path / "none")) == []
    for fid in ("000000_10", "000001_10"):
        for occ in (True, False):
            got = tkitti.load_kitti_pair(str(tmp_path), fid, occ)
            want = jkitti.load_kitti_pair(str(tmp_path), fid, occ)
            assert (got[2] is None) == (want[2] is None)
            _equal_trees(got[:2], want[:2])
            if want[2] is not None:
                np.testing.assert_array_equal(got[2], want[2])


def test_middlebury_files_are_the_jax_files(tmp_path, rng):
    for shape in ((9, 13), (9, 13, 3)):
        img = rng.uniform(0, 64, shape).astype(np.float32)
        jmiddlebury.write_pfm(str(tmp_path / "j.pfm"), img)
        tmiddlebury.write_pfm(str(tmp_path / "t.pfm"), img)
        _files_equal(tmp_path / "j.pfm", tmp_path / "t.pfm")
        np.testing.assert_array_equal(
            tmiddlebury.read_pfm(str(tmp_path / "j.pfm")),
            jmiddlebury.read_pfm(str(tmp_path / "j.pfm")))
    scene = tmp_path / "scene"
    scene.mkdir()
    for name in ("im0.png", "im1.png"):
        jimage.image_save(str(scene / name),
                          rng.integers(0, 256, (9, 13, 3), np.uint8))
    gt = rng.uniform(0, 30, (9, 13)).astype(np.float32)
    gt[1, 1] = np.inf
    jmiddlebury.write_pfm(str(scene / "disp0.pfm"), gt)
    (scene / "calib.txt").write_text(
        "cam0=[1000 0 300; 0 1000 200; 0 0 1]\nbaseline=193.001\n"
        "ndisp=280\nvmin=x\n")
    _equal_trees(tmiddlebury.load_middlebury_pair(str(scene)),
                 jmiddlebury.load_middlebury_pair(str(scene)))


def _session(tmp_path, rng, n_frames=3, missing=(), dup=()):
    """A session.json + jpegs mimicking an ARKit capture."""
    frames = []
    for i in range(n_frames):
        ts = 100.0 + i
        T = np.eye(4)
        T[:3, :3] = jcamera.rodrigues([0.01 * i, 0.02, -0.01])
        T[:3, 3] = [i * 0.1, 0, 0]
        K = np.array([[1164.0, 0, 360], [0, 1164, 640], [0, 0, 1]])
        frames.append({
            "timestamp": ts,
            "camera": {
                "transform": T.T.flatten().tolist(),   # column-major on disk
                "intrinsics": K.T.flatten().tolist(),
            },
        })
        if i not in missing:
            img = rng.integers(0, 255, size=(16, 24, 3), dtype=np.uint8)
            jimage.image_save(str(tmp_path / f"{ts}-1.000.jpeg"), img)
    for i in dup:
        frames.append(dict(frames[i]))
    path = tmp_path / "session.json"
    path.write_text(json.dumps({"frames": frames}))
    return str(path)


@pytest.mark.parametrize("mode", ["P", "LR", "LL"])
def test_arkit_session_is_the_jax_session(tmp_path, rng, mode):
    path = _session(tmp_path, rng, n_frames=4, missing={1}, dup={0})
    got = tarkit.parse_session(path, mode=mode)
    want = jarkit.parse_session(path, mode=mode)
    assert got[1] == want[1] == 2 and len(got[0]) == 3
    _equal_trees([f.to_dict() for f in got[0]],
                 [f.to_dict() for f in want[0]])
    with open(path) as f:
        session = json.load(f)
    _equal_trees([f.to_dict() for f in tarkit.parse_session(
        session, str(tmp_path), mode=mode, load_images=False)[0]],
        [f.to_dict() for f in jarkit.parse_session(
            session, str(tmp_path), mode=mode, load_images=False)[0]])
    outs = []
    for m, name in ((jarkit, "j.npz"), (tarkit, "t.npz")):
        out, n = m.build_npz(path, out_path=str(tmp_path / name), mode=mode)
        assert n == 3
        outs.append(m.load_npz_frames(out))
    _equal_trees(outs[0], outs[1])
    (tmp_path / "junk-1.000.jpeg").write_bytes(b"")
    assert tarkit.scan_image_directory(str(tmp_path), [100.2, 102.9]) == \
        jarkit.scan_image_directory(str(tmp_path), [100.2, 102.9])


def test_handy_surface_is_the_jax_surface(tmp_path, rng):
    depth = rng.uniform(0.5, 5.0, (6, 9)).astype(np.float32)
    K = np.array([[50.0, 0, 4.5], [0, 52.0, 3.1], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = jcamera.rodrigues([0.1, -0.2, 0.05])
    pose[:3, 3] = [1.0, -0.5, 0.2]
    np.testing.assert_allclose(thandy.depthTo3D(depth, K, pose),
                               jhandy.depthTo3D(depth, K, pose), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(thandy.intrinsic_cal(1, 2, 3, 4),
                                  jhandy.intrinsic_cal(1, 2, 3, 4))
    p = thandy.npz_save(str(tmp_path / "a.npz"), x=np.arange(3))
    np.testing.assert_array_equal(thandy.npz_load(p, "x"), np.arange(3))
    thandy.json_write(str(tmp_path / "a.json"), {"k": [1, 2]})
    assert thandy.json_read(str(tmp_path / "a.json")) == \
        jhandy.json_read(str(tmp_path / "a.json")) == {"k": [1, 2]}
    assert thandy.is_file(p) and thandy.is_directory(str(tmp_path))
    assert thandy.path_join("a", "b") == jhandy.path_join("a", "b")
    assert thandy.directory_current_get() == os.getcwd()
    verts = rng.normal(size=(3, 3))
    thandy.mesh_to_ply(str(tmp_path / "t.ply"), verts, [[0, 1, 2]])
    jhandy.mesh_to_ply(str(tmp_path / "j.ply"), verts, [[0, 1, 2]])
    _files_equal(tmp_path / "t.ply", tmp_path / "j.ply")


def test_cv2_oracles_are_the_jax_oracles():
    pytest.importorskip("cv2")
    gt = jsynthetic.box_scene(32, 64, 3.0, 9.0)
    left, right = jsynthetic.random_dot_pair(32, 64, gt, blur=0.8, seed=3)
    from stereo_match_tpu.config import DisparityConfig as JConfig
    for mode in ("hh", "sgbm", "3way"):
        np.testing.assert_array_equal(
            tparity.opencv_sgbm_disparity(left, right,
                                          DisparityConfig(num_disparities=16),
                                          mode),
            jparity.opencv_sgbm_disparity(left, right,
                                          JConfig(num_disparities=16), mode))
    bm = tparity.opencv_bm_disparity(left, right, DisparityConfig(
        num_disparities=16, block_size=9))
    np.testing.assert_array_equal(bm, jparity.opencv_bm_disparity(
        left, right, JConfig(num_disparities=16, block_size=9)))
    ours = np.where(np.isfinite(bm), bm + 0.25, np.nan).astype(np.float32)
    got = tparity.parity_report("box", gt, ours, bm)
    want = jparity.parity_report("box", gt, ours, bm)
    assert got.keys() == want.keys() and got["scene"] == "box"
    for k in ("bad3_delta", "epe_delta", "density_delta"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)
    for side in ("ours", "opencv_sgbm"):
        for k, v in want[side].items():
            assert got[side][k] == pytest.approx(v, abs=1e-6), (side, k)


# ------------------------------------------------------- torch, 1e-6 ----

def test_reprojection_helpers_match_jax(rng):
    depth = rng.uniform(0.5, 30.0, (11, 17)).astype(np.float32)
    for negate_x in (False, True):
        got = treproject.pinhole_backproject(torch.from_numpy(depth), 700.0,
                                             705.5, 8.3, 5.1, negate_x)
        want = jreproject.pinhole_backproject(depth, 700.0, 705.5, 8.3, 5.1,
                                              negate_x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    K = np.array([[700.0, 0, 8.5], [0, 702.0, 5.5], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = jcamera.rodrigues([0.3, -0.1, 0.2])
    pose[:3, 3] = [0.5, -1.0, 2.0]
    for p in (None, pose):
        got = treproject.depth_to_points(depth, K, p)
        assert got.dtype == torch.float32 and got.shape == (11, 17, 3)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jreproject.depth_to_points(depth, K, p)),
            rtol=1e-6, atol=1e-6)
    pts = rng.normal(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        treproject.transform_points(torch.from_numpy(pts), pose).numpy(),
        np.asarray(jreproject.transform_points(pts, pose)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("kw", [{}, dict(d_min=0.2, d_max=0.8),
                                dict(d_min=5.0, d_max=5.0)])
def test_colorize_disparity_is_bit_equal(kw):
    ramp = np.linspace(0.0, 1.0, 1001)
    ramp = np.concatenate([ramp, [0.0, 1.0, np.nan, 0.999, 0.00390625,
                                  255 / 256, np.inf]]).reshape(8, -1)
    for d in (ramp, ramp.astype(np.float32) * 50, np.full((3, 4), np.nan),
              np.full((2, 2), 3.0)):
        got = tplots.colorize_disparity(d, **kw)
        assert got.dtype == np.uint8 and got.shape == d.shape + (3,)
        np.testing.assert_array_equal(got, jplots.colorize_disparity(d, **kw))


def test_turbo_table_is_matplotlibs():
    matplotlib = pytest.importorskip("matplotlib")
    cmap = matplotlib.colormaps["turbo"]
    assert cmap.N == tplots.TURBO_N
    np.testing.assert_array_equal(
        tplots.TURBO_RGB8, (np.asarray(cmap.colors) * 255).astype(np.uint8))


def test_figures_render():
    pytest.importorskip("matplotlib")
    pair = np.random.default_rng(0).integers(0, 255, (20, 30), np.uint8)
    for fig in (tplots.show_image_pair(pair, pair, line_spacing=5),
                tplots.show_disparity(pair.astype(float), pair * 0.5),
                tplots.plot_transforms([np.eye(4), np.eye(4)], ["a", "b"])):
        assert fig.axes


# -------------------- tests/test_io.py and test_artifacts.py, on both ----

@pytest.mark.parametrize("binary", [False, True])
def test_ply_roundtrip(pkg, tmp_path, rng, binary):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.integers(0, 255, size=(100, 3), dtype=np.uint8)
    path = str(tmp_path / "cloud.ply")
    assert pkg.ply.write_ply(path, pts, cols, binary=binary) == 100
    rpts, rcols = pkg.ply.read_ply(path)
    np.testing.assert_allclose(rpts, pts, atol=1e-5)
    np.testing.assert_array_equal(rcols, cols)


def test_mesh_ply(pkg, tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    path = str(tmp_path / "mesh.ply")
    pkg.ply.write_mesh_ply(path, verts, np.array([[0, 1, 2]]))
    text = open(path).read()
    assert "element face 1" in text and "3 0 1 2" in text


def test_pfm_roundtrip(pkg, tmp_path, rng):
    disp = rng.uniform(0, 64, size=(37, 53)).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    pkg.middlebury.write_pfm(path, disp)
    np.testing.assert_allclose(pkg.middlebury.read_pfm(path), disp, rtol=1e-6)


def test_kitti_disparity_roundtrip(pkg, tmp_path, rng):
    disp = rng.uniform(1, 100, size=(40, 60)).astype(np.float32)
    disp[0, 0] = np.nan
    path = str(tmp_path / "d.png")
    pkg.kitti.write_kitti_disparity(path, disp)
    back = pkg.kitti.read_kitti_disparity(path)
    assert np.isnan(back[0, 0])
    valid = np.isfinite(disp)
    valid[0, 0] = False
    np.testing.assert_allclose(back[valid], disp[valid], atol=1 / 256.0)


def test_middlebury_calib_parse(pkg, tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "cam0=[1000 0 300; 0 1000 200; 0 0 1]\n"
        "cam1=[1000 0 320; 0 1000 200; 0 0 1]\n"
        "baseline=193.001\nndisp=280\nwidth=2964\n")
    c = pkg.middlebury.read_calib(str(calib))
    assert c["cam0"].shape == (3, 3) and c["cam0"][0, 2] == 300
    assert c["baseline"] == pytest.approx(193.001)
    assert c["ndisp"] == 280


def test_image_roundtrip(pkg, tmp_path, rng):
    img = rng.integers(0, 255, size=(32, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    pkg.image.image_save(path, img)
    np.testing.assert_array_equal(pkg.image.image_read(path), img)
    assert pkg.image.to_grayscale(img).shape == (32, 48)


def test_normalize_to_uint8(pkg):
    n = pkg.image.normalize_to_uint8(np.array([[0.0, 5.0], [10.0, 2.5]]))
    assert n.dtype == np.uint8
    assert n[0, 0] == 0 and n[1, 0] == 255


def test_parse_session_contract(pkg, tmp_path, rng):
    path = _session(tmp_path, rng, n_frames=3, missing={1}, dup={0})
    frames, skipped = pkg.arkit.parse_session(path, mode="P")
    assert len(frames) == 2 and skipped == 2   # one missing, one duplicate
    f = frames[0]
    assert f.extrinsic.shape == (4, 4) and f.intrinsic.shape == (3, 3)
    assert f.intrinsic[0, 0] == 1164.0      # transpose round-trip
    np.testing.assert_array_equal(f.extrinsic[3], [0, 0, 0, 1])
    assert f.frame_id == 0 and frames[1].frame_id == 1


def test_build_npz_contract(pkg, tmp_path, rng):
    session = _session(tmp_path, rng)
    path, n = pkg.arkit.build_npz(session, out_path=str(tmp_path / "tmp.npz"))
    assert n == 3
    data = pkg.arkit.load_npz_frames(path)
    assert set(data[0].keys()) == {"timestamp", "image_mat", "frame_id",
                                   "extrinsic", "intrinsic", "image_name"}
    assert data[0]["image_mat"].shape == (16, 24, 3)


def test_cost_bin_roundtrip(pkg, tmp_path, rng):
    vol = rng.uniform(0, 10, (8, 12, 16)).astype(np.float32)  # (D, H, W)
    p = str(tmp_path / "left.bin")
    pkg.costbin.write_cost_bin(p, vol)
    np.testing.assert_array_equal(pkg.costbin.read_cost_bin(p, 8, 16, 12),
                                  vol)
    raw = np.fromfile(p, np.float32)
    assert raw.size == 8 * 12 * 16
    np.testing.assert_allclose(raw[:12], vol[0, :, 0])  # first W-major run


def test_external_volume_to_disparity(pkg):
    D, H, W = 8, 16, 24
    vol = np.full((D, H, W), 10.0, np.float32)
    vol[3] = 0.0   # winner everywhere
    disp = pkg.to_disparity(vol)
    valid = np.isfinite(disp)
    assert (np.abs(disp[valid] - 3.0) < 0.5).all()
    disp2 = pkg.to_disparity(vol, guide=np.zeros((H, W), np.float32))
    assert np.isfinite(disp2).all()   # WLS in-fills


def test_stage_store_roundtrip_and_resume(pkg, tmp_path):
    store = pkg.artifacts.StageStore(str(tmp_path / "stages"))
    calls = []

    def compute():
        calls.append(1)
        return {"x": np.arange(5)}

    store.get_or_compute("s1", compute, frame=3)
    out2 = store.get_or_compute("s1", compute, frame=3)   # cached
    assert len(calls) == 1
    np.testing.assert_array_equal(out2["x"], np.arange(5))
    store.get_or_compute("s1", compute, frame=4)
    assert len(calls) == 2
    assert store.has("s1", frame=3) and not store.has("s1", frame=99)


def test_stage_paths_are_the_jax_paths(tmp_path):
    t = tartifacts.StageStore(str(tmp_path))
    j = jartifacts.StageStore(str(tmp_path))
    for key in ({"frame": 3}, {"pair_index": 0, "cfg": "x"}):
        assert t.path("disparity", **key) == j.path("disparity", **key)


def test_run_session_skip_and_continue(pkg):
    def process(a, b):
        if a is None:
            raise ValueError("bad frame")
        return {"sum": np.asarray(a + b)}

    pairs = [(1, 2), (None, 5), (3, 4)]
    results = pkg.artifacts.run_session(pairs, process)
    assert [r.ok for r in results] == [True, False, True]
    assert "bad frame" in results[1].error
    assert results[2].outputs["sum"] == 7
    with pytest.raises(ValueError):
        pkg.artifacts.run_session(pairs, process, continue_on_error=False)


def test_run_session_with_store(pkg, tmp_path):
    store = pkg.artifacts.StageStore(str(tmp_path))
    count = []

    def process(a, b):
        count.append(1)
        return {"v": np.asarray([a, b])}

    pairs = [(1, 2), (3, 4)]
    pkg.artifacts.run_session(pairs, process, store=store)
    pkg.artifacts.run_session(pairs, process, store=store)   # resumes
    assert len(count) == 2
