"""Kernel wrappers and the plain PyTorch versions beside them.

Import the submodules directly (``from triton_dist_tpu_torch.ops import
flash_decode as fd``). This package re-exports only names that no
submodule carries — the all-to-all's, as the JAX package's ``ops``
exports them — so a submodule is never shadowed by a function of the
same name.
"""

from triton_dist_tpu_torch.ops.all_to_all import (  # noqa: F401
    A2AConfig,
    all_to_all_post_process,
    fast_all_to_all,
    fast_all_to_all_op,
)
