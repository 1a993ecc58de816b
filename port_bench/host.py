"""What the run's own process did on the host over a window: its CPU
seconds against the wall's, its threads and the cores it may use. A
process that drives the card from one thread and reads several cores'
worth of CPU time is spinning or copying on the others, which is what a
host-clock metric's spread from run to run follows.
"""

from __future__ import annotations

import os
import resource
import time


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "user_s": ru.ru_utime,
            "sys_s": ru.ru_stime}


def describe(a: dict, b: dict) -> str:
    """One line on the process between snapshots ``a`` and ``b``."""
    import torch
    wall = b["t"] - a["t"]
    user, sys_ = b["user_s"] - a["user_s"], b["sys_s"] - a["sys_s"]
    return (f"host over the window: {wall} s; this process's CPU "
            f"{user + sys_} s (user {user}, sys {sys_}), "
            f"{(user + sys_) / max(wall, 1e-9)} cores busy on average; "
            f"torch threads {torch.get_num_threads()}; "
            f"{len(os.sched_getaffinity(0))} cores in the affinity mask")
