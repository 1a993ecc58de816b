"""Time whole frames, the main path's K2 and K4 and the speckle filter on
the card.

Frames, on the seed-1 KITTI scene (1242x375, D=128) and the seed-3 720p
one (1280x720): the headline (no post stack) in float32 and int16,
MC-CNN fast and accurate (the shipped checkpoints) at the headline's WTA
settings,
``DisparityConfig()`` at 720p (settings.ini: WLS), KITTI speckle 100 + WLS
with and without LR confidence, each through ``_match_core``, StereoBM
(block 21, disp12 -1: ``stereobm_true``) through ``block_match`` and with
speckle 100 through ``BlockMatcher``, and the 4-stage census-payload
``StreamingPipeline`` on one card. Each frame time is the mean of 10
frames (12 stream steps after the fill) by CUDA events after 2 warm-up
frames; MC-CNN fast and accurate also with the towers in bfloat16
(``compute_dtype``; a tree whose ``MCCNNFeatures`` has none reports
"not available"), each with the peak device memory of one frame above
what was allocated before it (``mccnn_frame_peak_bytes``). Kernels: K1
``census_words`` at KITTI (5x5 and 7x9) and 720p (5x5) on the scenes;
K8 ``mccnn_conv3x3`` a layer of each shipped tower (C_in = 1 and
C_in = F, float32 and bfloat16) on the KITTI scene's
activations, in bfloat16 in the storage the tree's module passes
(bfloat16 channels-last where its wrapper takes ``bf16_out``, float32
before), beside cuDNN on bfloat16 tensors (NCHW and channels-last) and
the layer's bound for that storage, and each whole tower; at KITTI on the
headline's volume and total: K2
``census_volume`` (float32, int16, transposed, 7x9, and one plane at D = 1
as ELAS launches it) and K4's ``wta_lr``, ``wta_stats`` and ``right_wta``
(float32 and int16), and K9 ``mccnn_volume`` on the shipped towers'
features of the scenes (KITTI D=128 at F=64 and F=112, 720p D=160 at
F=64), and, in a tree that has it, K11 ``mccnn_fused_volume`` on each
shipped tower's last-layer input at KITTI D=128 in float32 and
bfloat16 (as the tree's one-kernel path hands it), each the mean of 64
calls captured in one CUDA graph, so no host
time lies between the launches. The whole speckle
filter (T=100, range 2), the mean of 20 calls by CUDA events (the filter
of a tree that reads a flag on the host every sweep cannot be captured),
with the launches of one call: on the headline's KITTI and 720p maps with
``speckled``'s 600 blobs (max_iters 64, and at KITTI cut at 1 sweep), and
run to the fixpoint (max_iters 1000) on maps that need many sweeps, from
``data/speckle_maps.py``: the noisy ramps at KITTI and 720p, one of 3300
rows by 300 and the serpentine of 75 rows by 1242.

    python -m stereo_match_tpu_torch.tools.frame_probe [--tree DIR]...

With ``--tree`` the probe runs once per tree, in the order given, each in
a process that imports that checkout's package (and builds its kernels),
so two commits compare in one call: ``--tree OLD --tree . --tree .
--tree OLD``. Each run prints one JSON line. Needs one Hopper card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path


def _speckle_maps():
    """``data/speckle_maps.py`` of this checkout, loaded by path, so every
    tree under ``--tree`` times the same maps."""
    path = Path(__file__).resolve().parents[1] / "data" / "speckle_maps.py"
    spec = importlib.util.spec_from_file_location("_speckle_maps", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _probe() -> dict:
    import torch

    from stereo_match_tpu_torch.config import DisparityConfig
    from stereo_match_tpu_torch.costs import MCCNNCost
    from stereo_match_tpu_torch.data.synthetic import (random_dot_pair,
                                                       slanted_scene)
    from stereo_match_tpu_torch.models.mccnn import (from_flax_params,
                                                     load_default_params,
                                                     normalize_image)
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.ops.speckle import speckle_filter
    from stereo_match_tpu_torch.parallel import (StreamingPipeline,
                                                 make_stage_mesh)
    from stereo_match_tpu_torch.pipeline import block_matching
    from stereo_match_tpu_torch.pipeline.stereo import _match_core
    from stereo_match_tpu_torch.utils.backend import require_hopper

    dev = require_hopper(0)
    K.build()

    def scene(H, W, d_max, seed):
        gt = slanted_scene(H, W, 5.0, d_max)
        pair = random_dot_pair(H, W, gt, blur=1.0, seed=seed)
        return tuple(torch.from_numpy(im).to(dev, torch.float32)
                     for im in pair)

    def ms(fn, reps):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, n=64):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        return ms(graph.replay, 5) / n

    kitti, p720 = scene(375, 1242, 90.0, 1), scene(720, 1280, 110.0, 3)
    head = DisparityConfig(num_disparities=128, cost="census",
                           uniqueness_ratio=15, disp12_max_diff=1, wls=False,
                           speckle_window_size=0)
    spk = head.replace(wls=True, wls_iters=3, speckle_window_size=100,
                       speckle_range=2)
    mc_cfg = head.replace(cost="mccnn")
    towers = {arch: from_flax_params(load_default_params(arch), arch).to(dev)
              for arch in ("fast", "accurate")}
    try:
        towers16 = {arch: from_flax_params(load_default_params(arch), arch,
                                           torch.bfloat16).to(dev)
                    for arch in towers}
    except TypeError:                  # a tree without compute_dtype
        towers16 = {}
    out, peak = {}, {}
    for arch, model in towers.items():
        for kind, m in (("", model), (" bf16", towers16.get(arch))):
            if m is None:
                out[f"mccnn {arch}{kind}"] = "not available"
                continue
            provider = MCCNNCost(m, mc_cfg)
            out[f"mccnn {arch}{kind}"] = ms(lambda: _match_core(
                *kitti, mc_cfg, cost_fn=provider), 10)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            _match_core(*kitti, mc_cfg, cost_fn=provider)
            torch.cuda.synchronize()
            peak[f"mccnn {arch}{kind}"] = \
                torch.cuda.max_memory_allocated(dev) - before
    with torch.no_grad():
        feats = {(arch, where): towers[arch](torch.stack(
            [normalize_image(im) for im in pair]))
            for arch, where, pair in (("fast", "KITTI", kitti),
                                      ("accurate", "KITTI", kitti),
                                      ("fast", "720p", p720))}
    for name, pair, cfg in (
            ("headline", kitti, head),
            ("headline int16", kitti, head.replace(dtype="int16")),
            ("settings.ini 720p", p720, DisparityConfig()),
            ("speckle+wls", kitti, spk),
            ("speckle+wls+lr_confidence", kitti,
             spk.replace(wls_lr_confidence=True))):
        out[name] = ms(lambda: _match_core(*pair, cfg), 10)
    bm_kw = dict(num_disparities=128, block_size=21, disp12_max_diff=-1)
    out["stereobm_true"] = ms(lambda: block_matching.block_match(
        *kitti, device=dev, **bm_kw), 10)
    bm = block_matching.BlockMatcher(
        DisparityConfig(**bm_kw, speckle_window_size=100, speckle_range=2,
                        wls=False), device=dev)
    out["stereobm+speckle"] = ms(lambda: bm(*kitti), 10)
    maps = _speckle_maps()
    spk_maps = {name: (maps.speckled(_match_core(
        *pair, head.replace(num_disparities=D))[0]), 64)
        for name, pair, D in (("KITTI", kitti, 128), ("720p", p720, 160))}
    spk_maps["KITTI max_iters=1"] = (spk_maps["KITTI"][0], 1)
    for name, m in (("KITTI noisy ramp", maps.noisy_ramp(375, 1242)),
                    ("720p noisy ramp", maps.noisy_ramp(720, 1280)),
                    ("3-band noisy ramp", maps.noisy_ramp(
                        3300, 300, seed=3, holes=0.1, blobs=False)),
                    ("serpentine", maps.serpentine(75, 1242))):
        spk_maps[name] = (torch.from_numpy(m).to(dev), 1000)
    speckle = {}
    for name, (d, max_iters) in spk_maps.items():
        K.reset_launches()
        speckle_filter(d, 100, 2, max_iters)
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.launches.items() if v}
        speckle[name] = {"ms": ms(lambda: speckle_filter(d, 100, 2,
                                                         max_iters), 20),
                         "launches": launches}
    pipe = StreamingPipeline(head, make_stage_mesh(4, devices=[dev] * 4),
                             (375, 1242), payload_mode="census",
                             payload_dtype="float32")
    pipe.reset()
    for _ in range(3):
        pipe.step(*kitti)                      # fill
    out["census stream"] = ms(lambda: pipe.step(*kitti), 12)
    words = K.census_words(torch.stack(kitti).contiguous())
    wT = words.transpose(2, 3).contiguous()
    w79 = K.census_words(torch.stack(kitti).contiguous(), (7, 9))
    total = K.aggregate_paths(K.census_volume(words[0], words[1], 128),
                              head.P1, head.P2)
    total16 = K.aggregate_paths(K.census_volume(words[0], words[1], 128, 0,
                                                torch.int16), head.P1, head.P2)
    kernels = {
        "census_volume float32": lambda: K.census_volume(words[0], words[1],
                                                         128),
        "census_volume int16": lambda: K.census_volume(
            words[0], words[1], 128, 0, torch.int16),
        "census_volume transposed": lambda: K.census_volume(
            wT[0], wT[1], 128, transposed=True),
        "census_volume 7x9": lambda: K.census_volume(w79[0], w79[1], 128),
        "census_volume D=1 min_d=64": lambda: K.census_volume(
            words[0], words[1], 1, 64),
    }
    for name, t in (("float32", total), ("int16", total16)):
        kernels[f"wta_lr {name}"] = lambda t=t: K.wta_lr(t)
        kernels[f"wta_stats {name}"] = lambda t=t: K.wta_stats(t)
        kernels[f"right_wta {name}"] = lambda t=t: K.right_wta(t)
    for (arch, where), f in feats.items():
        D = 128 if where == "KITTI" else 160
        kernels[f"mccnn_volume {where} D={D} F={f.shape[1]}"] = \
            lambda f=f, D=D: K.mccnn_volume(f[0], f[1], D)
    if hasattr(K, "mccnn_fused_volume"):
        norm_k = torch.stack([normalize_image(im) for im in kitti])
        for arch in towers:
            for kind, m in (("", towers[arch]), (" bf16", towers16[arch])):
                i = m.num_layers - 1
                # K11's input and weights as the tree's one-kernel path
                # hands them (channels-last and K11's copy where it has
                # them)
                fused = getattr(m, "layout_fused", None)
                args = (m.hidden(norm_k, channels_last=True)
                        if fused is not None else m.hidden(norm_k),
                        m.weights[i], m.biases[i], 128, 24.0,
                        getattr(m, f"layout{i}") if fused is None else fused,
                        bool(kind))
                kernels[f"mccnn_fused_volume{kind} {arch} KITTI D=128"] = \
                    lambda a=args: K.mccnn_fused_volume(*a)
    pairs = {"KITTI": torch.stack(kitti).contiguous(),
             "720p": torch.stack(p720).contiguous()}
    for where, window in (("KITTI", (5, 5)), ("KITTI", (7, 9)),
                          ("720p", (5, 5))):
        kernels[f"census_words {where} {window[0]}x{window[1]}"] = \
            lambda im=pairs[where], w=window: K.census_words(im, w)
    norm = torch.stack([normalize_image(im) for im in kitti])[:, None]
    bf16_store = "bf16_out" in inspect.signature(K.mccnn_conv3x3).parameters
    bounds, towers_ms = {}, {}
    for arch, model in towers.items():
        for kind, m in (("", model), (" bf16", towers16.get(arch))):
            if m is None:
                continue
            bf16 = {"bf16": True} if kind else {}
            if kind and bf16_store:
                bf16["bf16_out"] = True
            h = norm
            for i in range(2):              # C_in = 1, then C_in = F
                args = (h, m.weights[i], m.biases[i], True, False)
                layout = getattr(m, f"layout{i}")
                name = (f"mccnn_conv3x3{kind} {arch} F={m.features} "
                        f"{'C_in=1' if i == 0 else 'C_in=F'}")
                kernels[name] = lambda a=args, lo=layout, kw=bf16: \
                    K.mccnn_conv3x3(*a, layout=lo, **kw)
                if kind:
                    _layer_bounds(bounds, name, h, m.weights[i], bf16_store)
                    x32, w, b = h.float(), m.weights[i], m.biases[i]
                    for fmt, fname in ((torch.contiguous_format, "NCHW"),
                                       (torch.channels_last,
                                        "channels-last")):
                        lib = tuple(t.to(torch.bfloat16, memory_format=fmt)
                                    for t in (x32, w))
                        kernels[f"cudnn bf16 {fname} {name[14:]}"] = \
                            lambda lib=lib, b=b.to(torch.bfloat16): \
                            torch.nn.functional.conv2d(*lib, b, padding=1)
                h = K.mccnn_conv3x3(*args, layout=layout, **bf16)
            towers_ms[f"mccnn tower {arch}{kind}"] = graph_ms(
                lambda m=m: m(norm[:, 0]), 16)
    kernel_ms = {name: graph_ms(fn) for name, fn in kernels.items()}
    kernel_ms.update(towers_ms)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    return {"ms_per_frame": out, "mccnn_frame_peak_bytes": peak,
            "kernel_ms": kernel_ms, "bound_ms": bounds,
            "speckle_filter": speckle, "card": card}


def _layer_bounds(bounds: dict, name: str, x, w, bf16_store: bool) -> None:
    """A bfloat16 K8 layer's bound (ms) on an H100 SXM: the larger of its
    bytes over 3.35 TB/s and its products over the 989 TFLOP/s of dense
    bfloat16; bytes for this tree's storage (``bf16_store``: 2 B a
    bfloat16 activation in and out, the float32 image; else 4 B each) and,
    for the C_in = F layer, for the last layer (float32 out)."""
    V, C, H, W = x.shape
    F = w.shape[0]
    px = V * H * W
    flop = 2 * 9 * F * C * px
    act = 2 if bf16_store else 4
    x_bytes = px * C * (4 if C == 1 else act)
    w_bytes = w.numel() * (2 if bf16_store and C > 1 else 4)

    def ms(out_bytes: int) -> float:
        return max((x_bytes + w_bytes + px * F * out_bytes) / 3.35e12,
                   flop / 989e12) * 1e3

    bounds[name] = ms(act)
    if C > 1:
        bounds[name + " last"] = ms(4)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="a checkout to time (repeatable, in order)")
    args = parser.parse_args()
    if not args.tree:
        print(json.dumps({"tree": os.getcwd(), **_probe()}))
        return
    for tree in args.tree:
        root = str(Path(tree).resolve())
        subprocess.run([sys.executable, str(Path(__file__).resolve())],
                       cwd=root, env={**os.environ, "PYTHONPATH": root},
                       check=True)


if __name__ == "__main__":
    main()
