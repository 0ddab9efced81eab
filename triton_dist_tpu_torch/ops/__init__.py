"""Kernel wrappers and the plain PyTorch versions beside them.

Import the submodules directly (``from triton_dist_tpu_torch.ops import
flash_decode as fd``). This package re-exports only names that no
submodule carries — the all-to-all's and the sequence-parallel
attention's, as the JAX package's ``ops`` exports them
(``triton_dist_tpu/ops/__init__.py:94-102``) — so a submodule is never
shadowed by a function of the same name. ``ring_attention`` is both a
submodule and its function: import the function from the submodule.
"""

from triton_dist_tpu_torch.ops.all_to_all import (  # noqa: F401
    A2AConfig,
    all_to_all_post_process,
    fast_all_to_all,
    fast_all_to_all_op,
)
from triton_dist_tpu_torch.ops.grads import ring_attention_grad  # noqa: F401
from triton_dist_tpu_torch.ops.ring_attention import (  # noqa: F401
    RingAttentionConfig,
    ring_attention_op,
    zigzag_permutation,
    zigzag_positions,
)
from triton_dist_tpu_torch.ops.ulysses import ulysses_attention, usp_attention  # noqa: F401
