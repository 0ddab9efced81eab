"""Kernel wrappers and the plain PyTorch versions beside them.

Import the submodules directly (``from triton_dist_tpu_torch.ops import
flash_decode as fd``). This package re-exports only names that no
submodule carries — the all-to-all's and the sequence-parallel
attention's and the KV stream's, as the JAX package's ``ops`` exports
them (``triton_dist_tpu/ops/__init__.py:83-102``) — so a submodule is
never shadowed by a function of the same name. ``ring_attention`` and
``kv_stream`` are both a submodule and its function: import the function
from the submodule.
"""

from triton_dist_tpu_torch.ops.all_to_all import (  # noqa: F401
    A2AConfig,
    all_to_all_post_process,
    fast_all_to_all,
    fast_all_to_all_op,
)
from triton_dist_tpu_torch.ops.grads import ring_attention_grad  # noqa: F401
# the in-rank `kv_stream` entry stays module-qualified (ops.kv_stream.kv_stream):
# re-exporting it here would shadow the submodule attribute on the package
from triton_dist_tpu_torch.ops.kv_stream import (  # noqa: F401
    KV_STREAM_TUNE_SPACE,
    KVStreamConfig,
    dequantize_kv_wire,
    kv_stream_op,
    quantize_kv_wire,
    quantize_kv_wire_fp8,
)
from triton_dist_tpu_torch.ops.ring_attention import (  # noqa: F401
    RingAttentionConfig,
    ring_attention_op,
    zigzag_permutation,
    zigzag_positions,
)
from triton_dist_tpu_torch.ops.ulysses import ulysses_attention, usp_attention  # noqa: F401
