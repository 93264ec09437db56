"""The four SR artifacts (port of ``fetalsyngen_tpu.generator.artifacts``).

``quality``: ``BlurCortex``, ``StructNoise``, ``SimulatedBoundaries``;
``scanner``: ``SimulateMotion`` (slice acquisition and PSF reconstruction),
with the host-only helpers copied from the JAX package (``transforms``,
``motion`` and its ``motion_traj.npz``, ``psf``); ``batched``: the input
stream's artifact chain and its motion engine.
"""
