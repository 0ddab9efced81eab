"""The allgather layer (≙ ``triton_dist_tpu/layers/allgather_layer.py``,
``AllGatherLayer`` at ``:16``)."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.allgather import all_gather


class AllGatherLayer(torch.nn.Module):
    """A method-pinned allgather over the context's ranks: ``forward`` uses
    `method` (``auto``: the full-mesh push K5 on a full mesh, the rings
    K19/K21 off one), and one entry a method mirrors the JAX layer's
    ``forward_*`` set. x ``[m, ...]`` → ``[world * m, ...]``."""

    def __init__(self, ctx=None, method: str = "auto"):
        super().__init__()
        self.ctx, self.method = ctx, method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, ctx=self.ctx, method=self.method)

    def forward_ring(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, ctx=self.ctx, method="ring_1d")

    def forward_ring_bidir(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, ctx=self.ctx, method="ring_bidir")

    def forward_push(self, x: torch.Tensor) -> torch.Tensor:
        """Direct stores to every peer (≙ ``forward_push_2d_ll``)."""
        return all_gather(x, ctx=self.ctx, method="full_mesh_push")
