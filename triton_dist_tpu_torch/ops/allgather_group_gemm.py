"""The MoE up-projection, allgather + grouped GEMM (≙
``triton_dist_tpu/ops/allgather_group_gemm.py``) → K9 at world > 1 (the
overlapped entry, whose Pallas site is ``_ag_overlap_fused`` at ``:235``
with the body ``ops/gg_pipeline.py:288 make_ag_overlap_kernel``), K8 at
world 1.

Two entries, as in the JAX package:

- :func:`ag_group_gemm`, the sequential composition: gather the tokens
  (``all_gather`` with ``ag_method``: K5 on a full mesh, the ring
  allgathers K19-K22 off one) and their routing, align them globally,
  gather the aligned rows, one grouped GEMM (K8). The tensor-parallel MoE
  forward takes it at world 1 and, with ``overlap=False``, at any world.
- :func:`ag_group_gemm_overlap`, sort-before-gather: each rank pre-sorts
  its own tokens into expert-aligned order (:func:`presort_local_rows`,
  over the per-rank alignment of ``moe_utils.moe_align_ranked``), the
  ranks exchange the sorted slabs, and the grouped GEMM runs over each
  source's slab as it lands. The TPU kernel rides a ring (its torus); on
  the H100 every rank is one store away, so the slabs move as K6's shards
  do: after the entry barrier, one copy-engine put of the slab into every
  peer's workspace and a flag per source, then (after the host
  rendezvous) a persistent consumer (``csrc/dist.cu``, at most
  floor(SMs / ranks) - 2 blocks) that walks the sources in arrival order
  ``me, me-1, ...``, waits (bounded) for a source's flag before its first
  tile, and multiplies each 128-row tile by the expert bank its block
  names in that source's expert ids.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch import _build
from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.ops.allgather_gemm import push_shards
from triton_dist_tpu_torch.ops.common import max_consumer_blocks, stream_ptr
from triton_dist_tpu_torch.ops.gemm import DTYPE_CODE
from triton_dist_tpu_torch.ops.group_gemm import (
    _group_gemm_plain,
    check_config,
    check_group_operands,
    group_gemm,
)
from triton_dist_tpu_torch.ops.moe_utils import (
    RankedAlignment,
    gather_sorted_rows,
    moe_align_block_size,
)
from triton_dist_tpu_torch.utils import axis_index, axis_size, count_call, count_launch


def ag_group_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    topk_ids: torch.Tensor,
    *,
    ctx=None,
    config=None,
    ag_method: str = "auto",
    gather_output: bool = False,
):
    """Sequential MoE up-projection (≙ ``ag_group_gemm``, ``:73``; call
    inside ``ctx.run``). a ``[m_loc, K]`` token shard, b ``[E, K, n_loc]``
    expert bank sharded on its columns, topk_ids ``[m_loc, topk]`` →
    ``(h_sorted [t_pad, n_loc], alignment)`` over the gathered tokens, and
    with `gather_output` also the block-aligned rows ``a_sorted [t_pad,
    K]`` the GEMM read (the backward's residual). The tokens are gathered
    with ``all_gather(method=ag_method)`` (``:101``)."""
    cfg = check_config(config)
    topk = topk_ids.shape[1]
    a_full = all_gather(a, ctx=ctx, method=ag_method)
    ids_full = topk_ids if axis_size(ctx) == 1 else ctx.all_gather(topk_ids, 0)
    alignment = moe_align_block_size(ids_full.reshape(-1), b.shape[0], cfg.block_m)
    a_sorted = gather_sorted_rows(a_full, alignment, topk)
    h_sorted = group_gemm(a_sorted, b, alignment.expert_ids, config=cfg)
    return (h_sorted, alignment, a_sorted) if gather_output else (h_sorted, alignment)


def presort_local_rows(a: torch.Tensor, ral: RankedAlignment, ctx=None) -> torch.Tensor:
    """This rank's block-aligned slab ``[t_pad_loc, K]`` (≙
    ``presort_local_rows``, ``:142``): one gather; sentinel rows repeat row
    0 of the rank's own chunk."""
    me = axis_index(ctx)
    return a[(ral.src_rows[me] - me * a.shape[0]).long()]


def _ag_overlap_xla(a_srt, b, ral, ctx, gather_output, out_dtype):
    """Plain version (≙ ``_ag_overlap_xla``, ``:140``): gather the sorted
    slabs on the host rendezvous, then the plain grouped GEMM over the
    rank-major layout."""
    count_call(_ag_overlap_xla)
    ag = ctx.all_gather(a_srt, 0)
    out = _group_gemm_plain(ag, b, ral.expert_ids.reshape(-1), ral.block_m, out_dtype, None)
    return (out, ag) if gather_output else out


_ag_overlap_xla.calls = 0


def ag_group_gemm_overlap(
    a: torch.Tensor,
    b: torch.Tensor,
    ral: RankedAlignment,
    *,
    ctx=None,
    config=None,
    gather_output: bool = False,
    out_dtype: torch.dtype | None = None,
):
    """Overlapped MoE up-projection (≙ ``ag_group_gemm_overlap``, ``:270``;
    call inside ``ctx.run``). a ``[m_loc, K]``, b ``[E, K, n_loc]``, `ral`
    from ``moe_align_ranked`` over the gathered routing ids → ``[n *
    t_pad_loc, n_loc]`` in rank-major aligned order (plus the gathered
    sorted slabs ``[n * t_pad_loc, K]`` with `gather_output`). World 1 is
    the grouped GEMM (K8) over the pre-sorted slab."""
    cfg = check_config(config)
    out_dtype = out_dtype or a.dtype
    if ral.block_m != cfg.block_m:
        raise ValueError(f"alignment block {ral.block_m} != config.block_m {cfg.block_m}")
    a_srt = presort_local_rows(a, ral, ctx)
    if axis_size(ctx) == 1:
        h = group_gemm(a_srt, b, ral.expert_ids[0], config=cfg, out_dtype=out_dtype)
        return (h, a_srt) if gather_output else h
    if a.device.type == "cpu":
        return _ag_overlap_xla(a_srt, b, ral, ctx, gather_output, out_dtype)
    return _ag_overlap_fused(a_srt, b, ral, ctx, gather_output, out_dtype)


ag_group_gemm_overlap.launches = 0


def _ag_overlap_fused(a_srt, b, ral, ctx, gather_output, out_dtype):
    n, me = ctx.world, ctx.rank
    ids = ral.expert_ids
    bm = check_group_operands(a_srt, b, ids[me], out_dtype, None, "ag_group_gemm_overlap")
    t_pad_loc, k = a_srt.shape
    n_exp, _, n_loc = b.shape
    out = torch.empty((n * t_pad_loc, n_loc), dtype=out_dtype, device=a_srt.device)
    launch, gathered, flags = push_shards(ctx, a_srt, "ag_group_gemm")
    rc = launch.lib.tdt_ag_group_gemm_consumer(
        gathered.data_ptr(), b.data_ptr(), ids.data_ptr(), out.data_ptr(), t_pad_loc, n_loc,
        k, n_exp, bm, DTYPE_CODE[a_srt.dtype], DTYPE_CODE[out_dtype], n, me, flags,
        launch.epoch, max_consumer_blocks(ctx), *launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(launch.lib, rc, "ag_group_gemm_overlap")
    count_launch(ag_group_gemm_overlap)
    if gather_output:
        # the workspace is reused by the next call
        return out, gathered.clone()
    return out
