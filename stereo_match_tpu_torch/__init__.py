"""stereo_match_tpu_torch — the PyTorch + CUDA port of ``stereo_match_tpu``.

The JAX package beside this one is the reference every function here is
held against. Public functions keep its ``(D, H, W)`` planes layout. Plain
tensor code is PyTorch; the kernels (census, cost volume, SGM scan, WTA,
speckle, WLS solve, MC-CNN tower layer and volume, census-fused scan) are
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/cuda_kernels.py``). ``parallel/`` runs the
row-tiled SGM, the batch matcher and the stage-pipelined stream over a
list of devices in one process.

Dispatch follows the device of the input tensor: a CPU tensor runs the
kernels' plain PyTorch versions, a CUDA tensor runs the kernels.
"""

__version__ = "0.1.0"
