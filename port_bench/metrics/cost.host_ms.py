"""Host time a frame spent issuing the cost layer (census K1 and K2, or
the MC-CNN provider: the image normalisation, K8, K11): the program's
``smt.cost`` span over the traced window's frames."""

from port_bench.program import span_ms


def read(r):
    return span_ms("smt.cost", r.frames)
