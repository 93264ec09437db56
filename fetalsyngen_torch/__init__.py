"""fetalsyngen-torch: the PyTorch/CUDA port of the fetalsyngen-tpu generator.

Runs the artifact-free generator core batch-first, and the public dataset
API (``FetalSynthGen``, ``FetalSynthDataset``, ``FetalTestDataset``, driven
by the repository's YAML configs), on an NVIDIA Hopper GPU, with the warp's
hat passes as hand-written CUDA kernels. The JAX package ``fetalsyngen_tpu``
is the reference it is tested against.
"""

__version__ = "0.1.0"
