"""Megabytes (10^6 B) a frame that the entry copies from host memory onto
the card: the program's ``upload_bytes`` counter over its ``frames``
counter."""

from port_bench.program import per_frame


def read(r):
    b = per_frame("upload_bytes")
    return None if b is None else b / 1e6
