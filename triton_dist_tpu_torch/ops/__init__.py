"""Kernel wrappers and the plain PyTorch versions beside them.

Import the submodules directly (``from triton_dist_tpu_torch.ops import
flash_decode as fd``); this package re-exports nothing, so a submodule is
never shadowed by a function of the same name.
"""
