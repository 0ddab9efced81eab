"""The layer tier (≙ ``triton_dist_tpu/layers``): ``nn.Module`` wrappers
over the ops, with no parameters of their own: each takes its weights per
call, as the JAX layers do. They pin the choices a user makes per layer —
the allgather's method (:class:`AllGatherLayer`), the SP decode combine's
method (:class:`SpGQAFlashDecodeAttention`), the ring configs of the dense
MLP (:class:`TPMLP`) and the overlapped or sequential MoE MLP
(:class:`TPMoEMLP`). Call them inside ``ctx.run`` at world > 1.

Still to port from the JAX tier: the EP layers (``EPAll2AllLayer``,
``HierEPAll2AllLayer``, ``EPMoEMLP``; ROADMAP A12) and ``ElasticStep``
(A9).
"""

from triton_dist_tpu_torch.layers.allgather_layer import AllGatherLayer  # noqa: F401
from triton_dist_tpu_torch.layers.sp_flash_decode_layer import (  # noqa: F401
    SpGQAFlashDecodeAttention,
)
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP, TPMoEMLP  # noqa: F401
