"""Split the time of K11 (``mccnn_fused_volume``) on the card by ablation.

For each shipped MC-CNN tower (fast, F = 64; accurate, F = 112) in
bfloat16 and in float32, K11 runs on the last layer's input of the KITTI
scene (1242x375, both views, D = 128), as ``mccnn_cost_volume_fused``
hands it over (channels-last, K11's copy of the weights,
``layout_fused``), through the C entry ``smt_mccnn_fused_volume_probe``
(``csrc/mccnn.cu``): variant 0 is the launch the wrapper makes, also with
one part taken out at a time (the staging copies, i.e. the TMA boxes and
the weights' bulk copy; the layer's products; the band's products; the
volume's stores); what a part costs is the whole time less the time
without it (the parts overlap, so the differences need not add up to the
whole). The other variants (``VARIANTS``: the volume stored by every
warp's float4 stores, as the first form of K11 stored it, in place of
bulk stores; two staging buffers; the layer on mma.sync in place of
wgmma, in float32 with its weights in that body's copy,
``mma_weight_layout``; at F = 64 the features kept as they are and
split into TF32 hi and lo as the band reads them) are timed whole and
their volumes held to variant 0's (bit-equal share, largest
difference). Beside them: K8's
last launch then K9 (the two-kernel path K11 replaces; its input NCHW,
K8's copy of the weights) and K11 through its wrapper. Each time is the
mean of 32 launches captured in one CUDA graph, after a warm-up.

    python -m stereo_match_tpu_torch.tools.k11_probe

Prints one JSON line. Needs one Hopper card.
"""

from __future__ import annotations

import json
import subprocess

ABLATIONS = {"none": 0, "staging": 1, "layer products": 2,
             "band products": 4, "volume stores": 8}
# the probe entry's variants by (F, bf16): the launched one (16 warps a
# block, one block an SM, the layer on wgmma, ST staging buffers of one
# kernel row's taps, the volume by bulk stores; at F = 64 the features in
# TF32 hi and lo planes), then thread stores, two buffers, the layer on
# mma.sync and, at F = 64, the features split as the band reads them
_OTHER = ("thread stores", "two buffers", "layer on mma.sync")
_SPLIT = "band splits as it reads"
VARIANTS = {(64, True): ("launched (ST=6)", *_OTHER, _SPLIT),
            (112, True): ("launched (ST=4)", *_OTHER),
            (64, False): ("launched (ST=4)", *_OTHER, _SPLIT),
            (112, False): ("launched (ST=3)", *_OTHER)}


def mma_weight_layout(layout):
    """K8's float32 copy of a layer's weights, (2, 3, 3, C8, F8) TF32 hi
    and lo, -> the copy the mma.sync variant stages: (C8 / 8, 9, F8, 16),
    for (chunk, tap, output n) the words hi 2t, hi 2t + 1, lo 2t, lo 2t + 1
    of channels 8 chunk + 2t, + 1, t = 0 ... 3, so that a lane's B (k = t,
    t + 4 being channels 2t, 2t + 1) is one 16-B read."""
    C8, F8 = layout.shape[3:]
    return layout.view(2, 9, C8 // 8, 4, 2, F8).permute(
        2, 1, 5, 3, 0, 4).reshape(C8 // 8, 9, F8, 16).contiguous()


def _probe() -> dict:
    import torch

    from stereo_match_tpu_torch.data.synthetic import (random_dot_pair,
                                                       slanted_scene)
    from stereo_match_tpu_torch.models.mccnn import (from_flax_params,
                                                     load_default_params,
                                                     normalize_image)
    from stereo_match_tpu_torch.ops import cuda_kernels as K
    from stereo_match_tpu_torch.utils.backend import require_hopper

    dev = require_hopper(0)
    K.build()
    gt = slanted_scene(375, 1242, 5.0, 90.0)
    pair = random_dot_pair(375, 1242, gt, blur=1.0, seed=1)
    norm = torch.stack([normalize_image(torch.from_numpy(im).to(dev))
                        for im in pair])
    D = 128

    def graph_ms(fn, n=32):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (5 * n)

    out = {}
    for arch in ("fast", "accurate"):
        for bf16 in (True, False):
            m = from_flax_params(load_default_params(arch), arch,
                                 torch.bfloat16 if bf16 else
                                 torch.float32).to(dev)
            i = m.num_layers - 1
            x, w, b = m.hidden(norm), m.weights[i], m.biases[i]
            x_cl = m.hidden(norm, channels_last=True)
            layout = getattr(m, f"layout{i}")
            _, C, H, W = x.shape
            F = w.shape[0]
            vol = torch.empty((D, H, W), device=dev)
            probe = K._library().smt_mccnn_fused_volume_probe

            wl = {} if bf16 else {3: mma_weight_layout(layout)}

            def launch(variant, ablate=0):
                stream = torch.cuda.current_stream(dev).cuda_stream
                code = probe(K._ptr(x_cl),
                             K._ptr(wl.get(variant, m.layout_fused)),
                             K._ptr(b), K._ptr(vol), C, F, H, W, D, 24.0,
                             int(bf16), variant, ablate, stream)
                if code:
                    raise RuntimeError(f"probe launch failed: error {code}")

            def two_kernel():
                f = K.mccnn_conv3x3(x, w, b, False, True, layout=layout,
                                    bf16=bf16)
                return K.mccnn_volume(f[0], f[1], D)

            row = {}
            names = VARIANTS[F, bf16]
            t = {name: graph_ms(lambda a=a: launch(0, a))
                 for name, a in ABLATIONS.items()}
            t["cost"] = {name: t["none"] - t[name] for name in ABLATIONS
                         if name != "none"}
            row[names[0]] = t
            launch(0)
            ref = vol.clone()
            for variant, name in enumerate(names[1:], 1):
                launch(variant)
                row[name] = {"ms": graph_ms(lambda v=variant: launch(v)),
                             "equal": float((vol == ref).float().mean()),
                             "max_abs": float((vol - ref).abs().max())}
            row["wrapper"] = graph_ms(lambda: K.mccnn_fused_volume(
                x_cl, w, b, D, 24.0, m.layout_fused, bf16))
            row["K8 last + K9"] = graph_ms(two_kernel)
            out[f"{arch} F={F} {'bf16' if bf16 else 'float32'}"] = row
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    return {"k11_ms": out, "card": card}


def main() -> None:
    print(json.dumps(_probe()))


if __name__ == "__main__":
    main()
