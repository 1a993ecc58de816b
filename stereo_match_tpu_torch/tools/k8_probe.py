"""Split the time of K8's bfloat16 C_in > 1 body on the card by ablation.

For each shipped MC-CNN tower in bfloat16 (fast, F = 64; accurate,
F = 112), the second layer (C_in = F, ReLU, bfloat16 channels-last in and
out, as ``MCCNNFeatures`` runs it) on the KITTI scene's activations
(1242x375, both views) is timed whole and with one part of the kernel
taken out at a time, through the C entry ``smt_mccnn_conv3x3_bf16_probe``
(``csrc/mccnn.cu``): the staging copies (halo and weights), the products
(``ldmatrix`` and ``mma``), the epilogue's bias, rounding and ReLU, and the
stores to device memory. What a part costs is the whole time less the time
without it; the parts overlap, so the differences need not add up to the
whole. The entry's other variants (``VARIANTS``: the k16 steps chained
through the tensor-core accumulator, other warp shapes) are timed whole,
and so is the ``wgmma`` form (``WGMMA``), whose output is also held to
the launched body's (the share of equal outputs, the largest difference).
Each time is the mean of 64 launches captured in one CUDA graph,
after a warm-up. Beside them: the layer through its wrapper, cuDNN on
bfloat16 tensors (NCHW and channels-last) and the layer's bound (bytes of
its storage over 3.35 TB/s, products over 989 TFLOP/s).

    python -m stereo_match_tpu_torch.tools.k8_probe

Prints one JSON line. Needs one Hopper card.
"""

from __future__ import annotations

import json
import subprocess

ABLATIONS = {"none": 0, "staging": 1, "products": 2, "epilogue": 4,
             "stores": 8}
# the probe entry's variants by F: the body the layer launches (its
# ablations too; RW tile rows a warp, NS warps sharing them, ST staging
# buffers, a rounded add every k16 step), then the same with its k16
# steps chained through the tensor-core accumulator, with the three taps
# of a kernel row a partial sum, with one tile row a warp, and at F = 112
# with two staging buffers
WGMMA = 9   # the variant of the wgmma form, held to the launched one
VARIANTS = {64: ("launched (RW=2 NS=1 ST=2)", "chained", "a tap row a sum",
                 "RW=1"),
            112: ("launched (RW=2 NS=2 ST=3)", "chained", "a tap row a sum",
                  "RW=1", "ST=2")}


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
                        for im in pair])[:, None].contiguous()

    def graph_ms(fn, n=64):
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
        m = from_flax_params(load_default_params(arch), arch,
                             torch.bfloat16).to(dev)
        h = K.mccnn_conv3x3(norm, m.weights[0], m.biases[0], True, False,
                            m.layout0, bf16=True, bf16_out=True)
        w, b, layout = m.weights[1], m.biases[1], m.layout1
        V, C, H, W = h.shape
        F = w.shape[0]
        y = torch.empty_like(h)
        probe = K._library().smt_mccnn_conv3x3_bf16_probe

        def launch(ablate):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = probe(K._ptr(h), K._ptr(layout), K._ptr(b), K._ptr(y), V,
                         C, F, H, W, ablate, stream)
            if code:
                raise RuntimeError(f"probe launch failed: error {code}")

        row = {}
        for variant, shape in enumerate(VARIANTS[F]):
            if variant:
                row[shape] = graph_ms(lambda: launch(variant << 8))
                continue
            t = {name: graph_ms(lambda a=a: launch(a))
                 for name, a in ABLATIONS.items()}
            t["cost"] = {name: t["none"] - t[name] for name in ABLATIONS
                         if name != "none"}
            row[shape] = t
        launch(0)
        ref = y.clone()
        launch(WGMMA << 8)
        row["wgmma"] = {"ms": graph_ms(lambda: launch(WGMMA << 8)),
                        "equal": float((y == ref).float().mean()),
                        "max_abs_diff": float((y.float() - ref.float())
                                              .abs().max())}
        row["wrapper"] = graph_ms(lambda: K.mccnn_conv3x3(
            h, w, b, True, False, layout, bf16=True, bf16_out=True))
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        for fmt, name in ((torch.contiguous_format, "NCHW"),
                          (torch.channels_last, "channels-last")):
            xl, wl = (t.to(torch.bfloat16, memory_format=fmt)
                      for t in (h, wb))
            row[f"cudnn bf16 {name}"] = graph_ms(
                lambda xl=xl, wl=wl: torch.nn.functional.conv2d(
                    xl, wl, bb, padding=1))
        px = V * H * W
        nbytes = 2 * px * C + 2 * w.numel() + 2 * px * F
        flop = 2 * 9 * F * C * px
        row["bound"] = max(nbytes / 3.35e12, flop / 989e12) * 1e3
        out[f"{arch} F={F} C_in={C}"] = row
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    return {"k8_bf16_ms": out, "card": card}


def main() -> None:
    print(json.dumps(_probe()))


if __name__ == "__main__":
    main()
