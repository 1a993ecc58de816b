"""Kernel launches a frame: the program's own counter
(``stereo_match_tpu_torch.ops.cuda_kernels.launches``) summed over the
window, over the window's frames."""


def read(r):
    if r.launches is None or not r.frames:
        return None
    return r.launches / r.frames
