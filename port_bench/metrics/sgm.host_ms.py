"""Host time a frame spent issuing the sgm layer (``aggregate_paths``: K3,
a launch a path): the program's ``smt.sgm`` span over the traced window's
frames."""

from port_bench.program import span_ms


def read(r):
    return span_ms("smt.sgm", r.frames)
