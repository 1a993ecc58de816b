"""Device checks for the CUDA kernels.

The kernels are compiled for ``sm_90a`` only (Hopper: H100, H200), so a
run that means to use them asks for the card explicitly and fails on
anything else; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def entry_device(device: torch.device | str | int = "cuda") -> torch.device:
    """The device of an entry point: the card unless the caller asks for
    the CPU.

    Entry points (``StereoMatcher``, ``compute_disparity``,
    ``run_pipeline``, ``rectify_pair``, ``rectification_maps``,
    ``external_volume_to_disparity``, ``BlockMatcher``, ``block_match``,
    ``elas_match``) default to ``"cuda"``; without a
    CUDA device that raises ``RuntimeError`` instead of running on the CPU.
    """
    dev = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def require_hopper(device: torch.device | str | int = 0) -> torch.device:
    """Return ``device`` as a CUDA device, raising unless it is a Hopper card.

    Raises ``RuntimeError`` when CUDA is unavailable, when ``device`` is not
    a CUDA device, or when its compute capability is not (9, 0).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an "
                           "NVIDIA Hopper card (sm_90)")
    dev = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"{dev} is not a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"{torch.cuda.get_device_name(dev)} has compute "
                           f"capability {cap}; the kernels are built for "
                           "sm_90a (Hopper)")
    return dev
