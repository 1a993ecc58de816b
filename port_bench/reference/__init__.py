"""The benchmark's plain reference: stereo matching in plain PyTorch.

It imports nothing of ``stereo_match_tpu_torch`` or ``stereo_match_tpu``
and takes nothing the program made: it reads the same host images (and,
for MC-CNN, the same weight file) and computes the raw disparity maps
again, by the published equations, in float32 with TF32 off
(``precision="float32"``). ``precision`` also selects the lower precision
that the check's control runs in: ``"bfloat16"`` (volume and SGM in
bfloat16) or ``"tf32"`` (the tower's and the band's products on operands
rounded to TF32, as TF32 tensor cores take them).

A configuration's check file (``checks/<config>.json``) names the module
of this package whose ``disparity_maps`` is its reference (``match``: the
census and MC-CNN costs, SGM, WTA); a stage that ``match`` lacks (WLS, a
speckle filter, another cost) comes as a new module and a check file that
names it.
"""

import importlib

from port_bench.reference.match import PRECISIONS, disparity_maps

__all__ = ["PRECISIONS", "disparity_maps", "maps_for"]


def maps_for(checks: dict):
    """The ``disparity_maps`` of the module ``checks["reference"]``."""
    return importlib.import_module(
        f"port_bench.reference.{checks['reference']}").disparity_maps
