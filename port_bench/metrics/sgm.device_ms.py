"""The sgm layer's kernel time a frame on the card (device trace; the
layer's kernels are named by ``layers/sgm*.json``)."""


def read(r):
    s = r.layer_s.get("sgm")
    if not s or not r.frames:
        return None
    return 1e3 * s / r.frames
