"""The kernel probes' entry points: ports of ``scripts/microbench_warp.py``,
``scripts/probe_blocktp.py`` and ``scripts/profile_kernel_variants.py``.

Each runs on a CUDA device unless ``--device cpu`` is given (then it runs
its work once with the plain versions and prints no time)::

    python -m fetalsyngen_torch.probes.microbench_warp --variant probe2_taps8
    python -m fetalsyngen_torch.probes.probe_blocktp
    python -m fetalsyngen_torch.probes.profile_kernel_variants

and, on a CUDA device only, where K3's and K4's launches spend their time
(the ring blocks' timings and barrier waits; one call's time split into host
wait, the card's time around the kernels and the kernels themselves)::

    python -m fetalsyngen_torch.probes.ring_profile

and, where ``nvcc`` is (no card needed), each kernel's registers, spill
stores and SASS instructions, of this checkout's or other ``csrc`` dirs::

    python -m fetalsyngen_torch.probes.kernel_stats [CSRC_DIR ...]
"""
