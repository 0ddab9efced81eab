"""The allgather layer (≙ ``triton_dist_tpu/layers/allgather_layer.py``,
``AllGatherLayer`` at ``:16``)."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.utils import group_of


class AllGatherLayer(torch.nn.Module):
    """A method-pinned allgather over the context's ranks: ``forward`` uses
    `method` (``auto``: the full-mesh push K5 on a full mesh, the rings
    K19/K21 off one), and one entry a method mirrors the JAX layer's
    ``forward_*`` set. x ``[m, ...]`` → ``[world * m, ...]``. ``axis`` (a
    name or a tuple) gathers over ``ctx``'s group over it; over several
    axes only ``auto`` (the 2-D ring K36, then staged gathers) is valid,
    and the pinned entries raise the reference's ``ValueError``."""

    def __init__(self, ctx=None, method: str = "auto", axis=None):
        super().__init__()
        self.ctx, self.method = group_of(ctx, axis), method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, ctx=self.ctx, method=self.method)

    def forward_ring(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, ctx=self.ctx, method="ring_1d")

    def forward_ring_bidir(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, ctx=self.ctx, method="ring_bidir")

    def forward_push(self, x: torch.Tensor) -> torch.Tensor:
        """Direct stores to every peer (≙ ``forward_push_2d_ll``)."""
        return all_gather(x, ctx=self.ctx, method="full_mesh_push")
