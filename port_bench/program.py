"""What the program records of itself: the spans and counters of
``stereo_match_tpu_torch/utils/profiling.py``, read by the readers of
``metrics/`` that name ``program_span`` or ``program_counter`` as their
source. A program without that registry gives None."""

from __future__ import annotations


def span_ms(name: str, frames: int) -> float | None:
    """Host milliseconds a frame inside the program's span ``name``.

    Spans record only while a profiler runs, which is the traced window,
    so the window's ``frames`` divide them."""
    try:
        from stereo_match_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    s = spans.get(name)
    if not s or not frames:
        return None
    return 1e-6 * s["ns"] / frames


def per_frame(counter: str) -> float | None:
    """The program's counter ``counter`` over its own ``frames`` counter,
    both counted since the process began: warm-up calls have the cell's
    shapes, so the ratio is the window's."""
    try:
        from stereo_match_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    frames = counters.get("frames")
    if not frames or counter not in counters:
        return None
    return counters[counter] / frames
