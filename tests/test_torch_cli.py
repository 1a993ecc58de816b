"""`smt-torch` against `smt`: each subcommand of ``tests/test_cli.py`` runs
through the port's ``main([..., "--device", "cpu"])`` and the JAX package's
``main`` on the same files.

Exit codes must be equal. The ``.npy`` outputs are held to the tolerances
the port's tests hold each matcher to: the census matcher's raw map is
bit-equal (``test_torch_pipeline.py``), and after the WLS smoother within
``FGS_TOL`` (``test_torch_post.py``); BM's as census's
(``test_torch_matchers.py``); ELAS and MC-CNN agree on at least 99.5 % of
the pixels, the same NaN state and |diff| <= 0.01 (``test_torch_elas.py``,
``test_torch_mccnn.py``); the stream within 5e-3 of JAX's filtered map
(``test_torch_parallel.py``); ``mono`` within 1e-6 * W px
(``test_torch_monodepth.py``). PLY files must hold the same points.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stereo_match_tpu.cli.main import main as jmain
from stereo_match_tpu.data.image import image_read, image_save
from stereo_match_tpu.data.ply import read_ply
from stereo_match_tpu.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu_torch.cli.main import main as tmain

REPO = Path(__file__).resolve().parents[1]
FGS_TOL = dict(rtol=1e-3, atol=2e-4)       # tests/test_refine.py:214
AGREE = 0.995


def _both(argv_of, capsys=None):
    """Run ``argv_of(tag)`` through JAX's main and the port's (on the CPU);
    returns (jax rc, port rc) and, with ``capsys``, their stdout."""
    jrc = jmain(argv_of("j"))
    jout = capsys.readouterr().out if capsys else None
    trc = tmain(argv_of("t") + ["--device", "cpu"])
    tout = capsys.readouterr().out if capsys else None
    return (jrc, trc), (jout, tout)


def _agreement(got, want):
    """Share of pixels with the same NaN state and |diff| <= 0.01."""
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    close = np.abs(np.nan_to_num(got) - np.nan_to_num(want)) <= 0.01
    return float(((nan_g == nan_w) & (close | nan_g | nan_w)).mean())


def _same_points(jpath, tpath, rtol=1e-6, atol=1e-4):
    (jp, jc), (tp, tc) = read_ply(jpath), read_ply(tpath)
    assert len(jp) == len(tp) > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tp, jp, rtol=rtol, atol=atol)


@pytest.fixture()
def pair_files(tmp_path):
    gt = box_scene(48, 64)
    left, right = random_dot_pair(48, 64, gt, blur=0.8)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    image_save(lp, left.astype(np.uint8))
    image_save(rp, right.astype(np.uint8))
    return lp, rp


@pytest.fixture()
def session_dir(tmp_path, rng):
    frames = []
    K = np.array([[300.0, 0, 32], [0, 300.0, 24], [0, 0, 1]])
    for i in range(2):
        ts = 100.0 + i
        T = np.eye(4)
        T[:3, 3] = [0, 0.1 * i, 0]   # ARKit-frame offset
        frames.append({"timestamp": ts, "camera": {
            "transform": T.T.flatten().tolist(),
            "intrinsics": K.T.flatten().tolist()}})
        img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        image_save(str(tmp_path / f"{ts}-1.000.jpeg"), img)
    (tmp_path / "session.json").write_text(json.dumps({"frames": frames}))
    return tmp_path


def test_build_dataset_rectify_and_match_npz(session_dir, tmp_path, capsys):
    rcs = [tmain(["build-dataset", str(session_dir / "session.json"),
                  "--output", str(tmp_path / "t.npz")]),
           jmain(["build-dataset", str(session_dir / "session.json"),
                  "--output", str(tmp_path / "j.npz")])]
    assert rcs == [0, 0]
    assert capsys.readouterr().out.count("wrote 2 frames") == 2
    with np.load(tmp_path / "t.npz", allow_pickle=True) as t, \
            np.load(tmp_path / "j.npz", allow_pickle=True) as j:
        for ft, fj in zip(t["image_data"], j["image_data"]):
            assert ft.keys() == fj.keys()
            for k in ft:
                np.testing.assert_array_equal(ft[k], fj[k])
    npz = str(tmp_path / "j.npz")

    rcs, _ = _both(lambda k: ["rectify", npz, "0", "1",
                              "--left_out", str(tmp_path / f"{k}l.png"),
                              "--right_out", str(tmp_path / f"{k}r.png")])
    assert rcs == (0, 0)
    for side in "lr":
        got = image_read(str(tmp_path / f"t{side}.png")).astype(int)
        want = image_read(str(tmp_path / f"j{side}.png")).astype(int)
        assert np.abs(got - want).max() <= 1     # float32 remap, rounded

    rcs, _ = _both(lambda k: ["match", "--npz_file", npz, "--id1", "0",
                              "--id2", "1", "--num_disparities", "16",
                              "--disp_out", str(tmp_path / f"{k}d.png"),
                              "--write_ply", "--ply_out",
                              str(tmp_path / f"{k}c.ply")])
    assert rcs == (0, 0)
    assert os.path.exists(tmp_path / "td.png")
    _same_points(tmp_path / "jc.ply", tmp_path / "tc.ply", rtol=1e-3)

    # id validation (reference parity: id2 > id1 >= 0)
    rcs, _ = _both(lambda k: ["match", "--npz_file", npz, "--id1", "1",
                              "--id2", "0", "--disp_out",
                              str(tmp_path / f"{k}d.png")])
    assert rcs == (2, 2)


def test_match_images_mode(pair_files, tmp_path, capsys):
    lp, rp = pair_files
    rcs, outs = _both(lambda k: [
        "match", "--left", lp, "--right", rp, "--num_disparities", "16",
        "--disp_out", str(tmp_path / f"{k}.png"), "--write_ply",
        "--ply_out", str(tmp_path / f"{k}.ply"), "--focal", "300",
        "--baseline", "0.1"], capsys)
    assert rcs == (0, 0)
    assert all("density" in o for o in outs)
    assert outs[0].split("(density")[1] == outs[1].split("(density")[1]
    got, want = (np.load(tmp_path / f"{k}.png.npy") for k in "tj")
    np.testing.assert_allclose(got, want, **FGS_TOL)
    _same_points(tmp_path / "j.ply", tmp_path / "t.ply", rtol=1e-3)


@pytest.mark.parametrize("method, flags", [
    ("bm", []), ("elas", []), ("mccnn", []),
    ("sgbm", ["--enhance", "--cost", "bt"]),
])
def test_match_method_variants(pair_files, tmp_path, method, flags):
    lp, rp = pair_files
    rcs, _ = _both(lambda k: ["match", "--left", lp, "--right", rp,
                              "--num_disparities", "16", "--method", method,
                              "--disp_out", str(tmp_path / f"{k}.png")]
                   + flags)
    assert rcs == (0, 0)
    got, want = (np.load(tmp_path / f"{k}.png.npy") for k in "tj")
    assert got.shape == (48, 64) and np.isfinite(got).mean() > 0.5
    if method in ("elas", "mccnn"):
        assert _agreement(got, want) >= AGREE, _agreement(got, want)
    else:
        np.testing.assert_allclose(got, want, **FGS_TOL)


def test_refused_checkpoints_exit_2(pair_files, tmp_path, capsys):
    lp, _ = pair_files
    ckpt = tmp_path / "orbax_ckpt"
    ckpt.mkdir()
    assert tmain(["mono", lp, "--checkpoint", str(ckpt), "--output",
                  str(tmp_path / "m.png"), "--device", "cpu"]) == 2
    assert tmain(["match", "--left", lp, "--right", lp, "--method", "mccnn",
                  "--mccnn_checkpoint", str(ckpt), "--device", "cpu"]) == 2
    assert capsys.readouterr().err.count("the JAX package's format") == 2


def test_reproject_cli(tmp_path):
    disp = np.full((32, 48), 60, np.uint8)
    disp[:4] = 0
    dp = str(tmp_path / "disp.png")
    image_save(dp, disp)
    for mode in ("disparity", "depth"):
        rcs, _ = _both(lambda k: ["reproject", dp, "--output",
                                  str(tmp_path / f"{k}.ply"), "--focal",
                                  "100", "--baseline", "0.5", "--min_value",
                                  "1", "--mode", mode, "--cx", "20"])
        assert rcs == (0, 0)
        _same_points(tmp_path / "j.ply", tmp_path / "t.ply")
        assert len(read_ply(str(tmp_path / "t.ply"))[0]) == 28 * 48


def test_eval_cli(tmp_path, capsys, rng):
    pred = rng.uniform(0, 20, (16, 16)).astype(np.float32)
    pred[0, :3] = np.nan
    gt = pred + rng.normal(0, 2, pred.shape).astype(np.float32)
    pp, gp = str(tmp_path / "p.npy"), str(tmp_path / "g.npy")
    np.save(pp, pred)
    np.save(gp, gt)
    rcs, outs = _both(lambda k: ["eval", pp, gp], capsys)
    assert rcs == (0, 0)
    want, got = (json.loads(o) for o in outs)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k


def test_costbin_cli_end_to_end(tmp_path):
    from stereo_match_tpu.data.costbin import write_cost_bin
    from stereo_match_tpu.ops.cost_volume import build_cost_volume
    H, W, D = 32, 64, 16
    gt = box_scene(H, W, 3.0, 9.0)
    left, right = random_dot_pair(H, W, gt, blur=0.8, seed=5)
    bin_path = tmp_path / "left.bin"
    write_cost_bin(str(bin_path), np.asarray(build_cost_volume(left, right,
                                                               D)))
    left_png = tmp_path / "left.png"
    image_save(str(left_png), left.astype(np.uint8))
    for wls in ([], ["--no-wls"]):
        rcs, _ = _both(lambda k: [
            "costbin", str(bin_path), "--disp-max", str(D), "--width",
            str(W), "--height", str(H), "--left", str(left_png), "--focal",
            "300", "--baseline", "0.5", "--disp-out",
            str(tmp_path / f"{k}.png"), "--ply-out",
            str(tmp_path / f"{k}.ply")] + wls)
        assert rcs == (0, 0)
        got, want = (np.load(tmp_path / f"{k}.png.npy") for k in "tj")
        np.testing.assert_allclose(got, want, **FGS_TOL)
        _same_points(tmp_path / "j.ply", tmp_path / "t.ply", rtol=1e-3)


def test_mono_cli(tmp_path):
    gt = box_scene(40, 64, 3.0, 9.0)
    left, _ = random_dot_pair(40, 64, gt, blur=1.0, seed=2, shading=0.6)
    ip = str(tmp_path / "img.png")
    image_save(ip, left)
    rcs, _ = _both(lambda k: ["mono", ip, "--output",
                              str(tmp_path / f"{k}.png")])
    assert rcs == (0, 0)
    got, want = (np.load(tmp_path / f"{k}.png.npy") for k in "tj")
    assert got.shape == (40, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 64)
    # an explicit .npz checkpoint, its arch inferred or named
    ckpt = str(REPO / "stereo_match_tpu/models/weights/monodepth_small.npz")
    for arch in ([], ["--mono-arch", "small"]):
        rcs, _ = _both(lambda k: ["mono", ip, "--checkpoint", ckpt,
                                  "--output", str(tmp_path / f"{k}c.png")]
                       + arch)
        assert rcs == (0, 0)
        np.testing.assert_array_equal(np.load(tmp_path / "tc.png.npy"), got)


def test_stream_cli(tmp_path):
    gt = box_scene(32, 64, 2.0, 8.0)
    for i in range(4):
        l, r = random_dot_pair(32, 64, gt, blur=0.8, seed=60 + i)
        image_save(str(tmp_path / f"l_{i}.png"), l)
        image_save(str(tmp_path / f"r_{i}.png"), r)
    globs = ["--left-glob", str(tmp_path / "l_*.png"),
             "--right-glob", str(tmp_path / "r_*.png"),
             "--num_disparities", "16"]
    for stages, mode in (("4", "census"), ("1", "census"), ("2", "volume")):
        rcs, _ = _both(lambda k: ["stream", "--out-dir",
                                  str(tmp_path / f"{k}{stages}"),
                                  "--stages", stages, "--payload-mode",
                                  mode] + globs)
        assert rcs == (0, 0)
        for i in range(4):
            got, want = (np.load(tmp_path / f"{k}{stages}" /
                                 f"disp_{i:04d}.npy") for k in "tj")
            assert got.shape == (32, 64)
            np.testing.assert_allclose(got, want, atol=5e-3)
    # the port's 4-stage and sequential outputs agree as JAX's do
    for i in range(4):
        np.testing.assert_allclose(np.load(tmp_path / "t4" /
                                           f"disp_{i:04d}.npy"),
                                   np.load(tmp_path / "t1" /
                                           f"disp_{i:04d}.npy"), atol=5e-3)
    rcs, _ = _both(lambda k: ["stream", "--left-glob",
                              str(tmp_path / "l_*.png"), "--right-glob",
                              str(tmp_path / "none_*.png")])
    assert rcs == (1, 1)


def test_train_and_benchmark_exit_2(tmp_path, capsys):
    assert tmain(["train-mccnn", "--left", "l.png", "--right", "r.png",
                  "--gt", "g.npy"]) == 2
    assert "queue 1 item 6" in capsys.readouterr().err
    assert tmain(["benchmark"]) == 2
    assert "benchmark" in capsys.readouterr().err


def test_cli_asks_for_the_card(tmp_path):
    """Without --device every computing subcommand asks for the card and,
    without one, raises instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    np.save(tmp_path / "p.npy", np.zeros((4, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["eval", str(tmp_path / "p.npy"), str(tmp_path / "p.npy")])


def test_cli_runs_without_jax(pair_files, tmp_path):
    """`smt-torch mono` and `match` in a process where importing jax or the
    JAX package fails."""
    lp, rp = pair_files
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'stereo_match_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from stereo_match_tpu_torch.cli.main import main\n"
        f"assert main(['mono', {lp!r}, '--output', "
        f"{str(tmp_path / 'm.png')!r}, '--device', 'cpu']) == 0\n"
        f"assert main(['match', '--left', {lp!r}, '--right', {rp!r}, "
        "'--num_disparities', '16', '--disp_out', "
        f"{str(tmp_path / 'd.png')!r}, '--device', 'cpu']) == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'stereo_match_tpu')]\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert np.load(tmp_path / "m.png.npy").shape == (48, 64)
