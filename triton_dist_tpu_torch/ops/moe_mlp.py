"""The tensor-parallel MoE MLP forward (≙
``triton_dist_tpu/ops/grads.py::_tp_moe_forward_impl``, ``:238-342``, for
bf16 and f32 expert banks).

World > 1 takes the overlapped pair by default (``overlap=True``): the
routing is gathered (host collectives, ≙ XLA's ``all_gather``), aligned
per rank (``moe_align_ranked``), the up-projection runs as K9, the GELU as
a plain elementwise pass, the down-projection + combine + reduce-scatter
as K10. ``overlap=False`` takes the sequential composition at any world
(``:320-333``): ``ag_group_gemm`` (the token gather K5, or K19/K21 on a
ring, then K8) over the global alignment, then ``moe_reduce_rs`` with the
GELU fused into the down-projection's A tiles (K8) and its
reduce-scatter (K12, or K18 on a ring). World 1 has nothing to overlap
and always takes the sequential composition, as ``:288-294`` routes it.

Asked for them, both also return the residuals the backward needs
(``ops/grads.py``'s ``tp_moe_mlp_grad``); serving does not ask, and pays
for none. Pre-quantized banks come with B16's w8/fp8 formats.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.allgather_group_gemm import ag_group_gemm, ag_group_gemm_overlap
from triton_dist_tpu_torch.ops.group_gemm import check_config, gelu
from triton_dist_tpu_torch.ops.moe_reduce_rs import moe_reduce_rs, moe_reduce_rs_overlap
from triton_dist_tpu_torch.ops.moe_utils import (
    MoEAlignment,
    RankedAlignment,
    moe_align_ranked,
    ranked_combine_rows,
    ranked_scatter_meta,
)
from triton_dist_tpu_torch.utils import axis_size


@dataclasses.dataclass(frozen=True)
class MoEResiduals:
    """What the forward keeps for the backward (≙ the ``res`` tuple of
    ``_tp_moe_forward_impl``, ``:340``): the block-aligned gathered rows
    ``a_sorted [t_pad, H]`` (sentinel rows hold clamped junk), the
    pre-activation up-projection ``h_sorted [t_pad, F / world]``, the
    gathered routing weights ``tw_full [m_tot, topk]`` and the alignment
    the rows follow: the global one of the sequential composition, the
    rank-major one of the overlapped pair (the backward takes its global
    view)."""

    a_sorted: torch.Tensor
    h_sorted: torch.Tensor
    tw_full: torch.Tensor
    alignment: MoEAlignment | RankedAlignment


def _tp_moe_forward_impl(x, w_up, w_down, topk_ids, topk_weights, ctx, cfg, residuals=False,
                         overlap=True):
    """One rank's MoE MLP: ``(out [m_loc, H], res)``, `res` the
    :class:`MoEResiduals` with `residuals`, else None."""
    n = axis_size(ctx)
    m_loc = x.shape[0]
    topk = topk_ids.shape[1]
    tw_full = topk_weights if n == 1 else ctx.all_gather(topk_weights, 0)
    if n > 1 and overlap:
        ids_full = ctx.all_gather(topk_ids, 0)
        ral = moe_align_ranked(ids_full.reshape(n, m_loc * topk), w_up.shape[0], cfg.block_m,
                               m_loc)
        # the gathered slab is a copy of the workspace: made only when kept
        up = ag_group_gemm_overlap(x, w_up, ral, ctx=ctx, config=cfg, gather_output=residuals)
        h_sorted, a_sorted = up if residuals else (up, None)
        act = gelu(h_sorted.float()).to(x.dtype)
        dst_ids, w_rows = ranked_scatter_meta(ral, tw_full)
        out = moe_reduce_rs_overlap(
            act, w_down, ral.expert_ids, dst_ids, w_rows, ctx=ctx, m_out=m_loc,
            combine_rows=ranked_combine_rows(ral, m_loc, topk), config=cfg,
            out_dtype=x.dtype,
        )
        alignment = ral
    else:
        # the activation rides the down-projection's A tiles; h_sorted
        # stays pre-activation, which is what the backward wants
        h_sorted, alignment, a_sorted = ag_group_gemm(x, w_up, topk_ids, ctx=ctx, config=cfg,
                                                      gather_output=True)
        out = moe_reduce_rs(h_sorted, w_down, alignment, tw_full, ctx=ctx, n_tokens=n * m_loc,
                            config=cfg, out_dtype=x.dtype, act_fn=gelu)
    res = MoEResiduals(a_sorted, h_sorted, tw_full, alignment) if residuals else None
    return out.to(x.dtype), res


def tp_moe_mlp(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    topk_ids: torch.Tensor,
    topk_weights: torch.Tensor,
    *,
    ctx=None,
    gg_config=None,
    overlap: bool = True,
) -> torch.Tensor:
    """One rank's MoE MLP (call inside ``ctx.run``): x ``[m_loc, H]`` token
    shard, w_up ``[E, H, F / world]``, w_down ``[E, F / world, H]``, the
    local tokens' routing ``topk_ids [m_loc, topk]`` and f32
    ``topk_weights`` → ``[m_loc, H]`` in x's dtype. The activation is the
    tanh GELU, the one the kernels fuse. ``overlap`` picks the overlapped
    pair (True) or the sequential composition at world > 1."""
    return _tp_moe_forward_impl(x, w_up, w_down, topk_ids, topk_weights, ctx,
                                check_config(gg_config), overlap=overlap)[0]
