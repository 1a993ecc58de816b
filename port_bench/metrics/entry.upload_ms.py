"""Host time a frame in the entry's upload, the host cast to float32 and
the copy onto the card: the program's ``smt.upload`` span over the traced
window's frames (a batched call's one span counts for its frames)."""

from port_bench.program import span_ms


def read(r):
    return span_ms("smt.upload", r.frames)
