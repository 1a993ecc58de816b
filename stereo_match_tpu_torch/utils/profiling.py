"""Spans and counters of the port's matching path.

``span(name)`` marks a stage. While a torch profiler is recording it opens
``torch.profiler.record_function(name)``, so the stage lands in the
profiler's trace on the clock of the device's kernel, copy and runtime
events, and adds its host time (``time.perf_counter_ns``, inside the
annotation) and one call to ``spans[name]``. With no profiler recording it
costs one flag check: no annotation, no clock read. So ``spans`` holds the
stages of the traced windows alone.

``count(name, n)`` adds ``n`` to ``counters[name]`` whether or not a
profiler runs: the entry counts ``frames`` (one a ``_match_core`` call) and
``upload_bytes`` (the bytes it copies from host memory onto a card).
Kernel launches are counted apart, in ``ops/cuda_kernels.launches``.

An operator tracing their own process reads ``snapshot()`` and clears
both with ``reset()``. The registry is the process's: the port drives the
card from one thread.
"""

from __future__ import annotations

import contextlib
import time

import torch

# name -> {"calls": spans closed, "ns": host nanoseconds inside them}
spans: dict[str, dict[str, int]] = {}
counters: dict[str, int] = {}

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "annotation", "t0")

    def __init__(self, name: str):
        self.name = name
        self.annotation = torch.profiler.record_function(name)

    def __enter__(self):
        self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.annotation.__exit__(*exc)
        s = spans.get(self.name)
        if s is None:
            s = spans[self.name] = {"calls": 0, "ns": 0}
        s["calls"] += 1
        s["ns"] += ns


def span(name: str):
    """A context manager around a stage; see the module doc."""
    return _Span(name) if _recording() else _OFF


def count(name: str, n: int) -> None:
    counters[name] = counters.get(name, 0) + n


def snapshot() -> dict:
    """Copies of ``spans`` and ``counters``."""
    return {"spans": {k: dict(v) for k, v in spans.items()},
            "counters": dict(counters)}


def reset() -> None:
    spans.clear()
    counters.clear()
