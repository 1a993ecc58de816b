"""Where a monodepth frame's time goes on the card.

Runs ``predict_disparity`` on a 375x1242 ray-traced frame (seed 904) with
the shipped small checkpoint and a seeded full arch, through the 96x160
protocol and natively (padded to 384x1248), and times each part with CUDA
events (mean of 20 after 2 warm-up calls): the whole call, the input
resize (or edge pad), the network, and the output resize; prints the peak
device memory of each part and, from ``torch.profiler``, the device time
of a call by kernel name (top 8).

    python -m stereo_match_tpu_torch.tools.mono_probe

Needs one Hopper card.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from stereo_match_tpu_torch.data.raytrace import render_stereo
from stereo_match_tpu_torch.models import monodepth as md
from stereo_match_tpu_torch.utils.backend import require_hopper

H, W = 375, 1242


def _ms(fn, reps: int = 20) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _peak(fn, dev) -> int:
    """Bytes allocated at the peak of ``fn()`` above what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) - before


def _device_us(fn) -> list[tuple[str, float, int]]:
    """(kernel, device microseconds, calls) of one call of ``fn``, most
    time first."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def main() -> None:
    dev = require_hopper(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    left, _, _ = render_stereo(H, W, seed=904)
    img = torch.from_numpy(np.repeat(left[..., None], 3, -1)).to(dev)
    x = (img / 255.0).permute(2, 0, 1)[None]
    models = {"small (shipped)": md.load_default(device=dev),
              "full (seeded)": md.make_model("full", seed=7).to(dev)}
    for arch, model in models.items():
        for proto, internal in (("96x160", (96, 160)), ("native", None)):
            if internal is None:
                net_in = F.pad(x, (0, 1248 - W, 0, 384 - H),
                               mode="replicate")
                parts = {"edge pad": lambda: F.pad(
                    x, (0, 1248 - W, 0, 384 - H), mode="replicate")}
            else:
                net_in = md._resize(x, internal)
                frac = model(net_in)[0][:, :1]
                parts = {"input resize": lambda: md._resize(x, internal),
                         "output resize": lambda: md._resize(frac, (H, W))}
            parts = {"whole call": lambda: md.predict_disparity(
                model, img, internal),
                     "network": lambda: model(net_in), **parts}
            for name, fn in parts.items():
                print(f"[mono] {arch} {proto} {name}: {_ms(fn)} ms, peak "
                      f"{_peak(fn, dev)} B ({card})")
            rows = _device_us(lambda: md.predict_disparity(model, img,
                                                           internal))
            total = sum(us for _, us, _ in rows)
            print(f"[mono] {arch} {proto}: device time of one call "
                  f"{total} us over {sum(c for *_, c in rows)} kernels; "
                  f"top 8 by device time:")
            for key, us, count in rows[:8]:
                print(f"[mono]   {us} us x{count} {key[:110]}")


if __name__ == "__main__":
    main()
