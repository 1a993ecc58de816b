"""Mean host time a frame spends inside the entry call before it returns
(the synchronous upload included); host clock, harness side."""


def read(r):
    if not r.frames:
        return None
    return 1e3 * r.entry_s / r.frames
