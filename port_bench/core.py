"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` is what ``run.py`` drives on the card; the tests drive it on
the CPU at a small size (``size``), on the program's plain paths.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from port_bench import check, host, manifest, scenes
from port_bench.roofline import load_peaks
from port_bench.trace import WINDOW, reduce_trace


@dataclass
class Readings:
    """What the metric readers of ``metrics/`` read."""
    cell: str
    config: dict
    traffic: dict
    frames: int = 0
    window_s: float = 0.0
    entry_s: float = 0.0
    launches: int | None = None
    layer_s: dict = field(default_factory=dict)
    devices: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``size`` of the window's frames, drawn from the
    run's seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.items = size, 0, []
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed % 2 ** 64, 0x5EED]))

    def offer(self, pair: int, host_map: np.ndarray | None) -> None:
        """``host_map`` None: the frame's map never came. Only a map that
        is kept is copied, so the window pays for a few copies."""
        j = len(self.items) if len(self.items) < self.size \
            else int(self.rng.integers(0, self.seen + 1))
        if j < self.size:
            item = (pair, None if host_map is None else host_map.copy())
            if j == len(self.items):
                self.items.append(item)
            else:
                self.items[j] = item
        self.seen += 1


class Pool:
    """The cell's pairs, host arrays as a camera delivers them; call ``c``
    of ``B`` frames takes pairs ``(c + i) % P``, ``i < B``."""

    def __init__(self, lefts: np.ndarray, rights: np.ndarray):
        self.size = len(lefts)
        # a view of the doubled pool serves any B <= P without a copy
        self._l2 = np.concatenate([lefts] * 2)
        self._r2 = np.concatenate([rights] * 2)

    def call(self, c: int, B: int):
        if B > self.size:
            raise ValueError(f"{B} frames a call from a pool of {self.size}")
        s = c % self.size
        return (self._l2[s:s + B], self._r2[s:s + B],
                [(s + i) % self.size for i in range(B)])


class Window:
    """What a traffic kind records of the measured window: its span, each
    entry call's host time, each frame's latency, the sample."""

    def __init__(self, sample: Reservoir):
        self.sample, self.latencies, self.done_at = sample, [], []
        self.entry_s, self.frames, self.failed = 0.0, 0, 0
        self.t0 = self.t_end = None
        self._span = None

    def open(self) -> float:
        from torch.profiler import record_function
        self._span = record_function(WINDOW)
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self.t0

    def close(self, t_end: float) -> None:
        self.t_end = t_end
        self._span.__exit__(None, None, None)

    @contextmanager
    def entry(self):
        """Around each call into the program."""
        from torch.profiler import record_function
        t = time.perf_counter()
        with record_function("bench.entry"):
            yield
        self.entry_s += time.perf_counter() - t

    @contextmanager
    def download(self):
        """Around bringing the call's maps to the host."""
        from torch.profiler import record_function
        with record_function("bench.download"):
            yield

    def done(self, pairs: list, maps: np.ndarray, t_from: float,
             t_done: float) -> None:
        """The maps ``maps`` of frames ``pairs`` reached host memory at
        ``t_done``; each frame's latency runs from ``t_from``."""
        self.failed += max(0, len(pairs) - len(maps))
        for i, p in enumerate(pairs):
            self.sample.offer(p, maps[i] if i < len(maps) else None)
            self.latencies.append(t_done - t_from)
            self.done_at.append(t_done)
        self.frames += len(pairs)

    def by_second(self) -> str:
        """Frames and the p95 latency (ms) of each whole second of the
        window: whether a run's spread is in bursts or in the run."""
        at = np.asarray(self.done_at) - self.t0
        lat = np.asarray(self.latencies) * 1e3
        sec = np.floor(at).astype(int)
        n = [int(np.sum(sec == k)) for k in range(int(at.max()) + 1)] \
            if len(at) else []
        p95 = [round(float(np.percentile(lat[sec == k], 95)), 3)
               if c else None for k, c in enumerate(n)]
        return f"by second of the window: frames {n}; p95 ms {p95}"


def _launch_count() -> int:
    from stereo_match_tpu_torch.ops.cuda_kernels import launches
    return sum(launches.values())


def _synchronize(devices) -> None:
    import torch
    for d in {str(d) for d in devices}:
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, on_card: bool = True,
             size: tuple[int, int, int] | None = None,
             root: Path = manifest.ROOT, log=print) -> dict:
    """Run cell ``name`` once; return the result line's object.

    ``on_card`` False runs on the CPU (``["cpu"] * chips``), where the
    program takes its plain paths and no device metric is read; ``size``
    (H, W, D) replaces the configuration's frame and disparity range.
    The process keeps its defaults (torch's threads among them), as a
    user's does.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import system

    here = root / manifest.HERE.name
    cell = manifest.load_cell(name, root, here)
    cfg = dict(cell.config)
    if size is not None:
        cfg.update(height=size[0], width=size[1], num_disparities=size[2])
    tr = cell.traffic
    kind = manifest.traffic_kind(tr["kind"], here)
    devices = [f"cuda:{i}" for i in range(cell.chips)] if on_card \
        else ["cpu"] * cell.chips

    t_scenes = time.perf_counter()
    lefts, rights = scenes.make_pool(
        seed, tr["pool"], cfg["height"], cfg["width"],
        tr["max_disparity_share"] * cfg["num_disparities"], tr["noise"],
        tr["boxes"])
    pool = Pool(lefts, rights)
    t_system = time.perf_counter()
    fn = system.build(cfg, tr, devices, root)
    t_warm = time.perf_counter()
    kind.warm_up(fn, pool, tr)
    _synchronize(devices)
    for d in devices:
        if d.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s} s: to the scenes {t_scenes - t_start} s, scenes "
        f"{t_system - t_scenes} s, system {t_warm - t_system} s, warm-up "
        f"{t_start + setup_s - t_warm} s")

    window = Window(Reservoir(cell.checks["sample_frames"], seed))
    launches0 = _launch_count() if on_card else None
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   if on_card else [ProfilerActivity.CPU]) if trace else None
    if prof is not None:
        prof.start()
    h0 = host.snapshot()
    kind.run(fn, pool, tr, seconds, window)
    h1 = host.snapshot()
    if prof is not None:
        prof.stop()
    log(host.describe(h0, h1))
    log(window.by_second())
    window_s = window.t_end - window.t0
    frames, failed = window.frames, window.failed
    launches = _launch_count() - launches0 if on_card else None
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.startswith("cuda")), default=0)

    r = Readings(cell=name, config=cfg, traffic=tr, frames=frames,
                 window_s=window_s, entry_s=window.entry_s,
                 launches=launches,
                 work=manifest.layer_work(cfg, here), peaks=load_peaks())
    breakdown = None
    if prof is not None and on_card:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            red = reduce_trace(path, manifest.kernel_tables(here))
        finally:
            os.remove(path)
        r.layer_s, r.devices = red["layer_s"], red["devices"]
        seen = {d["device"] for d in r.devices}
        r.devices += [{"device": i, "busy_s": 0.0,
                       "window_s": red["window_s"]}
                      for i in range(cell.chips) if i not in seen]
        r.window_s = red["window_s"]
        breakdown = {"device_ops": [[n[:120], s] for n, s
                                    in red["device_ops"][:10]],
                     "idle_gaps": [[n[:120], s] for n, s
                                   in red["idle_gaps"][:10]]}
        for layer, s in sorted(red["layer_s"].items()):
            log(f"layer {layer}: {1e3 * s / frames} ms a frame")
        for d in red["devices"]:
            log(f"device {d['device']}: busy {d['busy_s']} s of "
                f"{d['window_s']} s")
    del prof, fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    frame_lat = np.asarray(window.latencies) * 1e3
    log(f"window: {frames} frames in {window_s} s; frame "
        f"latency median {np.median(frame_lat)} ms, p95 "
        f"{np.percentile(frame_lat, 95)} ms over {len(frame_lat)} frames; "
        f"set-up {setup_s} s; peak {peak} bytes")
    e2e = {"fps": frames / window_s,
           "frame_p95_ms": float(np.percentile(frame_lat, 95)),
           "peak_mem_mb": peak / 1e6, "setup_s": setup_s}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = manifest.reader(m["name"], here)(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}

    numbers = check.compare(window.sample.items, lefts, rights, cfg,
                            cell.checks, devices[0], root)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and on_card:
        device["busy_s"] = sum(d["busy_s"] for d in r.devices) / len(
            r.devices)
        device["window_s"] = r.window_s
    result = {"correct": check.passed(numbers), "attempted": frames,
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in numbers.items()}
    return result
