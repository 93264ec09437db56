"""Offline preprocessing command lines (ports of ``fetalsyngen_tpu.scripts``):
``generate_seeds`` (with its Gaussian mixture, :mod:`.gmm`, on the device),
``resample`` and ``resize_seeds``."""
