"""The sgm layer's share of its roofline: its least time a frame (the work
of ``layers/sgm*.json`` at the peaks) over its kernel time a frame."""

from port_bench.roofline import least_seconds


def read(r):
    s, work = r.layer_s.get("sgm"), r.work.get("sgm")
    if not s or not work or not r.frames:
        return None
    return 100.0 * least_seconds(work, r.peaks) / (s / r.frames)
