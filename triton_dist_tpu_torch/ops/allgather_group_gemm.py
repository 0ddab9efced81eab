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

Both take ``scale=`` (``[E, 1, n_loc]`` f32), which marks `b` as an int8 or
fp8 e4m3 pool, or ``config.w8``/``.fp8``, which quantizes a float bank at
the op boundary (``group_gemm.resolve_w8``): the grouped GEMM is then K24
and the overlapped consumer K25, K9 over one-byte weight slabs with the
scale row folded per tile.

Both take ``config.ragged`` (the ragged-row policy): the sequential entry
aligns with the ``valid_rows`` map and runs K29; the overlapped one reads
``ral.valid_rows`` (``moe_align_ranked(..., ragged=True)``) and runs K30,
K9 whose tiles at or past their block's live count store zeros and skip
the mainloop (each after its slab's wait, so every slab still lands).
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
    check_scale,
    group_gemm,
    launch_key,
    resolve_w8,
    weight_code,
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
    scale: torch.Tensor | None = None,
):
    """Sequential MoE up-projection (≙ ``ag_group_gemm``, ``:73``; call
    inside ``ctx.run``). a ``[m_loc, K]`` token shard, b ``[E, K, n_loc]``
    expert bank sharded on its columns, topk_ids ``[m_loc, topk]`` →
    ``(h_sorted [t_pad, n_loc], alignment)`` over the gathered tokens, and
    with `gather_output` also the block-aligned rows ``a_sorted [t_pad,
    K]`` the GEMM read (the backward's residual). The tokens are gathered
    with ``all_gather(method=ag_method)`` (``:101``). ``scale`` marks `b`
    as an int8/fp8 pool (``:107-111``); ``config.ragged`` builds the
    alignment's ``valid_rows`` map and hands it to the grouped GEMM (K29,
    ``:104-110``)."""
    cfg = check_config(config)
    topk = topk_ids.shape[1]
    a_full = all_gather(a, ctx=ctx, method=ag_method)
    ids_full = topk_ids if axis_size(ctx) == 1 else ctx.all_gather(topk_ids, 0)
    alignment = moe_align_block_size(ids_full.reshape(-1), b.shape[0], cfg.block_m,
                                     ragged=cfg.ragged)
    a_sorted = gather_sorted_rows(a_full, alignment, topk)
    h_sorted = group_gemm(a_sorted, b, alignment.expert_ids, valid_rows=alignment.valid_rows,
                          scale=scale, config=cfg)
    return (h_sorted, alignment, a_sorted) if gather_output else (h_sorted, alignment)


def presort_local_rows(a: torch.Tensor, ral: RankedAlignment, ctx=None) -> torch.Tensor:
    """This rank's block-aligned slab ``[t_pad_loc, K]`` (≙
    ``presort_local_rows``, ``:142``): one gather; sentinel rows repeat row
    0 of the rank's own chunk."""
    me = axis_index(ctx)
    return a[(ral.src_rows[me] - me * a.shape[0]).long()]


def _ag_overlap_xla(a_srt, b, ral, ctx, gather_output, out_dtype, scale=None,
                    ragged=False):
    """Plain version (≙ ``_ag_overlap_xla``, ``:140``): gather the sorted
    slabs on the host rendezvous, then the plain grouped GEMM over the
    rank-major layout; with `ragged`, its dead rows zero
    (``ral.valid_rows``)."""
    count_call(_ag_overlap_xla)
    ag = ctx.all_gather(a_srt, 0)
    valid = ral.valid_rows.reshape(-1) if ragged else None
    out = _group_gemm_plain(ag, b, ral.expert_ids.reshape(-1), ral.block_m, out_dtype, None,
                            scale, valid)
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
    scale: torch.Tensor | None = None,
):
    """Overlapped MoE up-projection (≙ ``ag_group_gemm_overlap``, ``:270``;
    call inside ``ctx.run``). a ``[m_loc, K]``, b ``[E, K, n_loc]``, `ral`
    from ``moe_align_ranked`` over the gathered routing ids → ``[n *
    t_pad_loc, n_loc]`` in rank-major aligned order (plus the gathered
    sorted slabs ``[n * t_pad_loc, K]`` with `gather_output`). World 1 is
    the grouped GEMM (K8) over the pre-sorted slab. ``scale`` (``[E, 1,
    n_loc]``) marks `b` as an int8/fp8 pool (K25; K24 at world 1), as does
    ``config.w8``/``.fp8`` over this rank's float shard (``:295-351``).
    ``config.ragged`` needs ``ral.valid_rows`` and takes K30 (K29 at world
    1)."""
    cfg = check_config(config)
    out_dtype = out_dtype or a.dtype
    if ral.block_m != cfg.block_m:
        raise ValueError(f"alignment block {ral.block_m} != config.block_m {cfg.block_m}")
    if cfg.ragged and ral.valid_rows is None:
        raise ValueError("GroupGemmConfig.ragged needs a ragged RankedAlignment — build it "
                         "with moe_align_ranked(..., ragged=True)")
    valid = ral.valid_rows if cfg.ragged else None
    b, scale = resolve_w8(b, scale, cfg)
    check_scale(b, scale, "ag_group_gemm_overlap")
    a_srt = presort_local_rows(a, ral, ctx)
    if axis_size(ctx) == 1:
        h = group_gemm(a_srt, b, ral.expert_ids[0], valid_rows=None if valid is None else
                       valid[0], scale=scale, config=cfg, out_dtype=out_dtype)
        return (h, a_srt) if gather_output else h
    if a.device.type == "cpu":
        return _ag_overlap_xla(a_srt, b, ral, ctx, gather_output, out_dtype, scale,
                               cfg.ragged)
    return _ag_overlap_fused(a_srt, b, ral, ctx, gather_output, out_dtype, scale, valid)


ag_group_gemm_overlap.launches = 0         # K9
ag_group_gemm_overlap.scaled_launches = 0  # K25
ag_group_gemm_overlap.ragged_launches = 0  # K30, all three formats


def _ag_overlap_fused(a_srt, b, ral, ctx, gather_output, out_dtype, scale, valid):
    n, me = ctx.world, ctx.rank
    ids = ral.expert_ids
    bm = check_group_operands(a_srt, b, ids[me], out_dtype, None, "ag_group_gemm_overlap",
                              scale, None if valid is None else valid[me])
    if valid is not None and not valid.is_contiguous():
        raise ValueError("ag_group_gemm_overlap: ral.valid_rows must be contiguous")
    t_pad_loc, k = a_srt.shape
    n_exp, _, n_loc = b.shape
    out = torch.empty((n * t_pad_loc, n_loc), dtype=out_dtype, device=a_srt.device)
    launch, gathered, flags = push_shards(ctx, a_srt, "ag_group_gemm")
    rc = launch.lib.tdt_ag_group_gemm_consumer(
        gathered.data_ptr(), b.data_ptr(), None if scale is None else scale.data_ptr(),
        ids.data_ptr(), None if valid is None else valid.data_ptr(), out.data_ptr(),
        t_pad_loc, n_loc, k, n_exp, bm,
        DTYPE_CODE[a_srt.dtype], weight_code(a_srt, b), DTYPE_CODE[out_dtype], n, me, flags,
        launch.epoch, max_consumer_blocks(ctx), *launch.wait,
        stream_ptr(torch.cuda.current_stream()),
    )
    _build.check(launch.lib, rc, "ag_group_gemm_overlap")
    count_launch(ag_group_gemm_overlap, launch_key(scale, valid))
    if gather_output:
        # the workspace is reused by the next call
        return out, gathered.clone()
    return out
