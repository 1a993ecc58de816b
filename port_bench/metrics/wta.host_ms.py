"""Host time a frame spent issuing the wta layer (``wta_lr``: K4): the
program's ``smt.wta`` span over the traced window's frames."""

from port_bench.program import span_ms


def read(r):
    return span_ms("smt.wta", r.frames)
