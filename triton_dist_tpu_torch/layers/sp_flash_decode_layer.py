"""The SP GQA flash-decode layer (≙
``triton_dist_tpu/layers/sp_flash_decode_layer.py``,
``SpGQAFlashDecodeAttention`` at ``:22``): split-KV attention over this
rank's sequence shard of the cache, an allgather of the per-rank (out,
lse) partials, and their online-softmax combine."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.flash_decode import (
    FlashDecodeConfig,
    flash_decode_distributed,
    paged_flash_decode_distributed,
)
from triton_dist_tpu_torch.utils import axis_index


class SpGQAFlashDecodeAttention(torch.nn.Module):
    """Decode attention over a KV cache sharded on the sequence across the
    context's ranks, contiguous (K2) or paged (K3). ``ag_method`` picks the
    combine's allgather: ``full_mesh_push`` (K5), ``ring_1d`` (K19) or
    ``ring_bidir`` (K21), or ``auto`` by topology."""

    def __init__(self, ctx=None, config: FlashDecodeConfig | None = None,
                 ag_method: str = "full_mesh_push"):
        super().__init__()
        self.ctx, self.config, self.ag_method = ctx, config, ag_method

    def forward(self, q, k_shard, v_shard, kv_lens_shard):
        """q ``[b, hq, d]``, k/v ``[b, h_kv, s_loc, d]`` this rank's shard,
        kv_lens_shard ``[b]`` valid positions in the LOCAL shard →
        ``[b, hq, d]``."""
        return flash_decode_distributed(q, k_shard, v_shard, kv_lens_shard, config=self.config,
                                        ctx=self.ctx, ag_method=self.ag_method)

    def forward_paged(self, q, k_pages, v_pages, kv_lens_shard, block_table):
        """The paged cache: each rank's page pool ``[n_pages, h_kv, page,
        d]`` and block table ``[b, max_pages]`` cover its sequence shard."""
        return paged_flash_decode_distributed(q, k_pages, v_pages, kv_lens_shard, block_table,
                                              ctx=self.ctx, ag_method=self.ag_method)

    def local_lens_from_global(self, global_kv_lens: torch.Tensor, s_shard: int) -> torch.Tensor:
        """This rank's valid lengths from the global ones (rank r holds
        positions ``[r * s_shard, (r + 1) * s_shard)``)."""
        me = axis_index(self.ctx)
        return torch.clamp(global_kv_lens - me * s_shard, 0, s_shard)
