"""The wta layer's kernel time a frame on the card (device trace; the
layer's kernels are named by ``layers/wta*.json``)."""


def read(r):
    s = r.layer_s.get("wta")
    if not s or not r.frames:
        return None
    return 1e3 * s / r.frames
