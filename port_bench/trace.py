"""Reduce a ``torch.profiler`` Chrome trace to the benchmark's readings.

The harness records its own spans with ``record_function``: ``bench.window``
around the measured loop, ``bench.entry`` around each call into the
program and ``bench.download`` around bringing its result to the host.
The device side is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
event of the trace, by card. Kernels are put into layers by the name
tables of ``layers/`` (a substring of the kernel's name); a kernel that no
table names is counted as "other".
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW, SPANS = "bench.window", ("bench.entry", "bench.download")


def _union(intervals: list[tuple[float, float]], lo: float,
           hi: float) -> tuple[float, list[tuple[float, float]]]:
    """Length of the union of ``intervals`` clipped to [lo, hi], and the
    idle gaps between them inside [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _top_level(events: list[dict]) -> tuple[list[float], list[dict]]:
    """The events of one thread not nested in an earlier one, by start."""
    starts, tops, end = [], [], float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ts"] >= end:
            starts.append(e["ts"])
            tops.append(e)
            end = e["ts"] + e.get("dur", 0.0)
    return starts, tops


def _covering(starts: list[float], tops: list[dict], t: float):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < tops[i]["ts"] + tops[i].get("dur", 0.0):
        return tops[i]["name"]
    return None


def layer_of(name: str, tables: dict[str, list[str]]) -> str:
    for layer, patterns in tables.items():
        if any(p in name for p in patterns):
            return layer
    return "other"


def reduce_trace(path: str, tables: dict[str, list[str]]) -> dict:
    """Readings of the traced window: window seconds; per layer its kernel
    seconds; per card its busy seconds; the device operations by total
    seconds; the idle seconds by what the host was doing."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    lo = window[0]["ts"]
    hi = lo + window[0]["dur"]
    by_device = defaultdict(list)
    layer_us = defaultdict(float)
    op_us = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        if e["ts"] < lo or e["ts"] > hi:
            continue
        dev = e.get("args", {}).get("device", e.get("pid"))
        by_device[dev].append((e["ts"], e["ts"] + e["dur"]))
        name = e.get("name", "?")
        op_us[name] += e["dur"]
        if e["cat"] == "kernel":
            layer_us[layer_of(name, tables)] += e["dur"]
        else:
            layer_us["copy"] += e["dur"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]
    cpu_ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and "dur" in e:
            cpu_ops[e.get("tid")].append(e)
    span_index = _top_level(spans)
    main_tid = spans[0].get("tid") if spans else None
    op_index = _top_level(cpu_ops.get(main_tid, []))
    devices, idle = [], defaultdict(float)
    for dev in sorted(by_device, key=str):
        busy, gaps = _union(by_device[dev], lo, hi)
        devices.append({"device": dev, "busy_s": busy * 1e-6,
                        "window_s": (hi - lo) * 1e-6})
        for a, b in gaps:
            span = _covering(*span_index, a) or "bench.loop"
            op = _covering(*op_index, a)
            idle[f"{span}/{op}" if op else span] += (b - a) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "layer_s": {k: v * 1e-6 for k, v in layer_us.items()},
        "devices": devices,
        "device_ops": sorted(((k, v * 1e-6) for k, v in op_us.items()),
                             key=lambda kv: -kv[1]),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
    }
