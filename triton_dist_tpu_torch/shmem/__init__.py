"""Symmetric memory (≙ ``triton_dist_tpu/shmem``): the host side is
``host.py``; the device side is ``csrc/shmem.cuh``."""
