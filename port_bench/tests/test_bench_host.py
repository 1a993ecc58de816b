"""The host's share of a run: the process's CPU time over the window, and
the window's frames and tail by second."""

import time

import numpy as np

from port_bench import host
from port_bench.core import Reservoir, Window


def test_describe_reports_the_process():
    a = host.snapshot()
    t = time.perf_counter()
    while time.perf_counter() - t < 0.05:
        pass
    line = host.describe(a, host.snapshot())
    assert line.startswith("host over the window: ")
    assert "this process's CPU" in line and "torch threads" in line


def test_window_by_second_and_sample():
    w = Window(Reservoir(2, 7))
    w.t0 = 100.0
    for k, t in enumerate((100.2, 100.5, 101.1, 102.9)):
        w.done([k % 3], np.full((1, 2, 2), k, np.float32), t - 0.01, t)
    w.done([1, 2], np.zeros((1, 2, 2), np.float32), 102.95, 103.0)
    assert w.by_second().startswith("by second of the window: frames "
                                    "[2, 1, 1, 2]; p95 ms ")
    assert w.frames == 6 and w.failed == 1
    assert len(w.sample.items) == 2 and w.sample.seen == 6
