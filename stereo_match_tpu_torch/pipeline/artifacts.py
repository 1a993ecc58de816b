"""Stage artifacts and the batch session runner (numpy; the same code as
``stereo_match_tpu/pipeline/artifacts.py``, whose package imports JAX).

The reference's checkpoint/resume model is "the stage artifact on disk IS
the checkpoint" (SURVEY.md §5): ``tmp.npz`` after ingestion, rectified PNGs
after rectification, ``left.bin`` after external matching. This module
formalizes that: each pipeline stage writes an ``.npz`` artifact keyed by a
content stamp, and a rerun resumes from the newest valid artifact.

``run_session`` adds the failure-handling the reference lacked beyond
asserts: per-pair skip-and-continue with an error ledger (SURVEY.md §5
"failure detection").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np


def _stamp(**kw) -> str:
    blob = json.dumps({k: str(v) for k, v in sorted(kw.items())},
                      sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


class StageStore:
    """Content-addressed npz artifacts per pipeline stage."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, stage: str, **key) -> str:
        return os.path.join(self.root, f"{stage}-{_stamp(**key)}.npz")

    def has(self, stage: str, **key) -> bool:
        return os.path.isfile(self.path(stage, **key))

    def save(self, stage: str, arrays: dict[str, np.ndarray], **key) -> str:
        p = self.path(stage, **key)
        np.savez(p + ".tmp.npz", **arrays)
        os.replace(p + ".tmp.npz", p)   # atomic: a crash never half-writes
        return p

    def load(self, stage: str, **key) -> dict[str, np.ndarray] | None:
        p = self.path(stage, **key)
        if not os.path.isfile(p):
            return None
        with np.load(p, allow_pickle=False) as d:
            return {k: d[k] for k in d.files}

    def get_or_compute(self, stage: str, compute: Callable[[], dict],
                       **key) -> dict[str, np.ndarray]:
        cached = self.load(stage, **key)
        if cached is not None:
            return cached
        arrays = compute()
        self.save(stage, arrays, **key)
        return arrays


@dataclasses.dataclass
class PairResult:
    index: int
    ok: bool
    error: str = ""
    seconds: float = 0.0
    outputs: dict = dataclasses.field(default_factory=dict)


def run_session(pairs: Iterable[tuple], process: Callable[..., dict],
                store: StageStore | None = None,
                stage: str = "disparity",
                continue_on_error: bool = True) -> list[PairResult]:
    """Process (left, right, meta?) pairs with skip-and-continue.

    ``process(*pair) -> {name: array}``. Failures are recorded, not raised
    (unless ``continue_on_error=False``) — the batch analog of the
    reference's skipped-frame counter (``build_npz.py:205-209``).
    """
    results = []
    for i, pair in enumerate(pairs):
        t0 = time.perf_counter()
        try:
            if store is not None:
                outputs = store.get_or_compute(stage, lambda: process(*pair),
                                               pair_index=i)
            else:
                outputs = process(*pair)
            results.append(PairResult(i, True, "",
                                      time.perf_counter() - t0, outputs))
        except Exception as e:          # noqa: BLE001 - ledger, not mask
            if not continue_on_error:
                raise
            results.append(PairResult(i, False, f"{type(e).__name__}: {e}",
                                      time.perf_counter() - t0))
    return results
