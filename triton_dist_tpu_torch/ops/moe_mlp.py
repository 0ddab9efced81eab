"""The tensor-parallel MoE MLP forward (≙ the forward of
``triton_dist_tpu/ops/grads.py::_tp_moe_forward_impl``, ``:238-342``, for
bf16 and f32 expert banks).

World > 1 takes the overlapped pair: the routing is gathered (host
collectives, ≙ XLA's ``all_gather``), aligned per rank
(``moe_align_ranked``), the up-projection runs as K9, the GELU as a plain
elementwise pass, the down-projection + combine + reduce-scatter as K10.
World 1 has nothing to overlap and takes the sequential composition, as
``:288-294`` routes it: ``ag_group_gemm`` then ``moe_reduce_rs`` with the
GELU fused into the down-projection's A tiles (two K8 launches).

The differentiable wrapper (``tp_moe_mlp_grad``, a
``torch.autograd.Function`` in the port) and its backward, the
transpose grouped GEMM ``gg_pipeline.py:159``, come with training (ROADMAP
A11, training); pre-quantized banks come with B16's w8/fp8 formats.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.allgather_group_gemm import ag_group_gemm, ag_group_gemm_overlap
from triton_dist_tpu_torch.ops.group_gemm import check_config, gelu
from triton_dist_tpu_torch.ops.moe_reduce_rs import moe_reduce_rs, moe_reduce_rs_overlap
from triton_dist_tpu_torch.ops.moe_utils import (
    moe_align_ranked,
    ranked_combine_rows,
    ranked_scatter_meta,
)
from triton_dist_tpu_torch.utils import axis_size


def tp_moe_mlp(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    topk_ids: torch.Tensor,
    topk_weights: torch.Tensor,
    *,
    ctx=None,
    gg_config=None,
) -> torch.Tensor:
    """One rank's MoE MLP (call inside ``ctx.run``): x ``[m_loc, H]`` token
    shard, w_up ``[E, H, F / world]``, w_down ``[E, F / world, H]``, the
    local tokens' routing ``topk_ids [m_loc, topk]`` and f32
    ``topk_weights`` → ``[m_loc, H]`` in x's dtype. The activation is the
    tanh GELU, the one the kernels fuse."""
    cfg = check_config(gg_config)
    n = axis_size(ctx)
    m_loc = x.shape[0]
    topk = topk_ids.shape[1]
    tw_full = topk_weights if n == 1 else ctx.all_gather(topk_weights, 0)
    if n > 1:
        ids_full = ctx.all_gather(topk_ids, 0)
        ral = moe_align_ranked(ids_full.reshape(n, m_loc * topk), w_up.shape[0], cfg.block_m,
                               m_loc)
        h_sorted = ag_group_gemm_overlap(x, w_up, ral, ctx=ctx, config=cfg)
        act = gelu(h_sorted.float()).to(x.dtype)
        dst_ids, w_rows = ranked_scatter_meta(ral, tw_full)
        out = moe_reduce_rs_overlap(
            act, w_down, ral.expert_ids, dst_ids, w_rows, ctx=ctx, m_out=m_loc,
            combine_rows=ranked_combine_rows(ral, m_loc, topk), config=cfg,
            out_dtype=x.dtype,
        )
    else:
        # the activation rides the down-projection's A tiles; h_sorted
        # stays pre-activation
        h_sorted, alignment = ag_group_gemm(x, w_up, topk_ids, ctx=ctx, config=cfg)
        out = moe_reduce_rs(h_sorted, w_down, alignment, tw_full, ctx=ctx, n_tokens=n * m_loc,
                            config=cfg, out_dtype=x.dtype, act_fn=gelu)
    return out.to(x.dtype)
