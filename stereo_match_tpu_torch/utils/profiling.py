"""Per-stage wall-clock timing and profiler annotations (PyTorch).

Counterpart of ``stereo_match_tpu/utils/profiling.py``. ``StageTimer``
collects wall-clock timings that wait for the device: where a stage names
tensors, it synchronises each CUDA device they live on before the clock is
read (CPU tensors need no wait). ``trace_stage`` wraps a stage in
``torch.profiler.record_function``, so stages show up in profiler traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _synchronize(value) -> None:
    """Wait for the CUDA devices holding the tensors in ``value`` (a
    tensor, or a list, tuple or dict of them, nested)."""
    devices, todo = set(), [value]
    while todo:
        v = todo.pop()
        if torch.is_tensor(v):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            todo.extend(v.values())
        elif isinstance(v, (list, tuple)):
            todo.extend(v)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall-clock per named stage; reports mean/total seconds."""

    def __init__(self) -> None:
        self.times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.times[name].append(time.perf_counter() - t0)

    def block(self, name: str, value):
        """Time the device completion of ``value`` under ``name``."""
        t0 = time.perf_counter()
        _synchronize(value)
        self.times[name].append(time.perf_counter() - t0)
        return value

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {"mean_s": sum(ts) / len(ts), "total_s": sum(ts),
                         "count": len(ts), "min_s": min(ts)}
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name:30s} mean {s['mean_s']*1e3:9.3f} ms  "
                         f"min {s['min_s']*1e3:9.3f} ms  x{s['count']}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_stage(name: str):
    """Annotate a stage for the torch profiler's timeline."""
    with torch.profiler.record_function(name):
        yield
