"""fetalsyngen-torch: the PyTorch/CUDA port of the fetalsyngen-tpu generator.

Runs the artifact-free generator core batch-first on an NVIDIA Hopper GPU,
with the paired hat warp pass as a hand-written CUDA kernel. The JAX package
``fetalsyngen_tpu`` is the reference it is tested against.
"""

__version__ = "0.1.0"
