"""The layer tier (≙ ``triton_dist_tpu/layers``): ``nn.Module`` wrappers
over the ops, with no parameters of their own: each takes its weights per
call, as the JAX layers do. They pin the choices a user makes per layer —
the allgather's method (:class:`AllGatherLayer`), the SP decode combine's
method (:class:`SpGQAFlashDecodeAttention`), the ring configs of the dense
MLP (:class:`TPMLP`) and the overlapped or sequential MoE MLP
(:class:`TPMoEMLP`) — and the expert-parallel dispatch and combine
(:class:`EPAll2AllLayer`, and over a pair of axes the two-phase
:class:`HierEPAll2AllLayer`) with the MoE MLP over it (:class:`EPMoEMLP`).
Call them inside ``ctx.run`` at world > 1; ``axis=`` (a name or a pair of
a 2-D runtime) picks the ranks a layer runs over.

Still to port from the JAX tier: ``ElasticStep`` (A9).
"""

from triton_dist_tpu_torch.layers.allgather_layer import AllGatherLayer  # noqa: F401
from triton_dist_tpu_torch.layers.ep_a2a_layer import (  # noqa: F401
    EPAll2AllLayer,
    HierEPAll2AllLayer,
)
from triton_dist_tpu_torch.layers.ep_moe_mlp import EPMoEMLP  # noqa: F401
from triton_dist_tpu_torch.layers.sp_flash_decode_layer import (  # noqa: F401
    SpGQAFlashDecodeAttention,
)
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP, TPMoEMLP  # noqa: F401
