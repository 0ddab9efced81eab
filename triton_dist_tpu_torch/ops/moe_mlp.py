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
and always takes the sequential composition, as ``:288-294`` routes it;
so does ``gg_config.backend="ragged_dot"`` (``:295-302``: the sentinel
needs globally expert-sorted blocks). ``gg_config.chunks_per_shard`` and
``span_policy`` reach the overlapped pair, which takes K32/K33 wherever a
slab or a partial holds more than one span.

Asked for them, both also return the residuals the backward needs
(``ops/grads.py``'s ``tp_moe_mlp_grad``); serving does not ask, and pays
for none.

``w_up_scale``/``w_down_scale`` (``[E, 1, F / world]`` and ``[E, 1, H]``
f32) mark the banks as pre-quantized int8 or fp8 e4m3 pools: every grouped
GEMM takes them as its ``scale`` (K24 at world 1, K25 and K26 at world >
1). ``gg_config.w8``/``.fp8`` with float banks quantizes each rank's own
shard at every op boundary instead, as the JAX package does inside
``shard_map`` (``w_down`` is split on its contracted dim, so those per-shard
scales differ from the whole bank's).

``gg_config.ragged`` (the ragged-row policy, ≙ ``:303-320``): the
alignments carry their ``valid_rows`` maps and every grouped GEMM skips
the dead tiles: K30 and K31 in the overlapped pair, K29 in the
sequential composition; the backward (``ops/grads.py``) takes the same
maps (K29, and K34 for the weight gradients).

The counters on :func:`tp_moe_mlp` measure the padding of every forward
(both entries): ``rows`` (the aligned rows a rank's grouped GEMMs run
over, summed over the ranks), ``live_rows`` (per rank: the rows of the
128-row tiles they compute, ``rows`` when padded; a device scalar under
the ragged map, read after the work) and ``assignments`` (the gathered
(token, k) pairs each rank's GEMMs serve, summed over the ranks).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.allgather_group_gemm import ag_group_gemm, ag_group_gemm_overlap
from triton_dist_tpu_torch.ops.group_gemm import TILE_M, check_config, gelu, is_quantized
from triton_dist_tpu_torch.ops.moe_reduce_rs import moe_reduce_rs, moe_reduce_rs_overlap
from triton_dist_tpu_torch.ops.moe_utils import (
    MoEAlignment,
    RankedAlignment,
    live_tile_rows,
    moe_align_ranked,
    ranked_combine_rows,
    ranked_scatter_meta,
)
from triton_dist_tpu_torch.utils import axis_index, axis_size, count_launch, count_rows


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


def check_scales(w_up, w_down, w_up_scale, w_down_scale) -> None:
    """The scale contracts of ``_tp_moe_forward_impl`` (``ops/grads.py:
    253-266``): both scales or neither, and explicit scales need int8 or
    fp8 pools."""
    if (w_up_scale is None) != (w_down_scale is None):
        raise ValueError("pass both w_up_scale and w_down_scale (pre-quantized serving "
                         "banks), or neither")
    if w_up_scale is not None and not (is_quantized(w_up) and is_quantized(w_down)):
        raise ValueError(f"explicit scales mark the banks as int8/fp8 pools; got w_up "
                         f"{w_up.dtype}, w_down {w_down.dtype} (quantize with "
                         f"quantize_expert_weights(_fp8) first)")


def _tp_moe_forward_impl(x, w_up, w_down, topk_ids, topk_weights, ctx, cfg, residuals=False,
                         overlap=True, w_up_scale=None, w_down_scale=None):
    """One rank's MoE MLP: ``(out [m_loc, H], res)``, `res` the
    :class:`MoEResiduals` with `residuals`, else None."""
    check_scales(w_up, w_down, w_up_scale, w_down_scale)
    n = axis_size(ctx)
    m_loc = x.shape[0]
    topk = topk_ids.shape[1]
    tw_full = topk_weights if n == 1 else ctx.all_gather(topk_weights, 0)
    if n > 1 and overlap and cfg.backend == "pallas":
        ids_full = ctx.all_gather(topk_ids, 0)
        ral = moe_align_ranked(ids_full.reshape(n, m_loc * topk), w_up.shape[0], cfg.block_m,
                               m_loc, ragged=cfg.ragged)
        # the gathered slab is a copy of the workspace: made only when kept
        up = ag_group_gemm_overlap(x, w_up, ral, ctx=ctx, config=cfg, gather_output=residuals,
                                   scale=w_up_scale)
        h_sorted, a_sorted = up if residuals else (up, None)
        act = gelu(h_sorted.float()).to(x.dtype)
        dst_ids, w_rows = ranked_scatter_meta(ral, tw_full)
        out = moe_reduce_rs_overlap(
            act, w_down, ral.expert_ids, dst_ids, w_rows, ctx=ctx, m_out=m_loc,
            combine_rows=ranked_combine_rows(ral, m_loc, topk), valid_rows=ral.valid_rows,
            config=cfg, out_dtype=x.dtype, scale=w_down_scale,
        )
        alignment = ral
    else:
        # the activation rides the down-projection's A tiles; h_sorted
        # stays pre-activation, which is what the backward wants
        h_sorted, alignment, a_sorted = ag_group_gemm(x, w_up, topk_ids, ctx=ctx, config=cfg,
                                                      gather_output=True, scale=w_up_scale)
        out = moe_reduce_rs(h_sorted, w_down, alignment, tw_full, ctx=ctx, n_tokens=n * m_loc,
                            config=cfg, out_dtype=x.dtype, act_fn=gelu, scale=w_down_scale)
    rows = alignment.local_ids.numel() if isinstance(alignment, RankedAlignment) else (
        h_sorted.shape[0])
    count_launch(tp_moe_mlp, "rows", rows)
    count_launch(tp_moe_mlp, "assignments", n * m_loc * topk)
    count_rows(tp_moe_mlp, "live_rows", axis_index(ctx), rows if alignment.valid_rows is None
               else live_tile_rows(alignment.valid_rows, cfg.block_m, TILE_M))
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
    w_up_scale: torch.Tensor | None = None,
    w_down_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One rank's MoE MLP (call inside ``ctx.run``): x ``[m_loc, H]`` token
    shard, w_up ``[E, H, F / world]``, w_down ``[E, F / world, H]``, the
    local tokens' routing ``topk_ids [m_loc, topk]`` and f32
    ``topk_weights`` → ``[m_loc, H]`` in x's dtype. The activation is the
    tanh GELU, the one the kernels fuse. ``overlap`` picks the overlapped
    pair (True) or the sequential composition at world > 1. The scales
    mark pre-quantized int8/fp8 banks (module docstring)."""
    return _tp_moe_forward_impl(x, w_up, w_down, topk_ids, topk_weights, ctx,
                                check_config(gg_config), overlap=overlap,
                                w_up_scale=w_up_scale, w_down_scale=w_down_scale)[0]


tp_moe_mlp.rows = 0
tp_moe_mlp.live_rows = {}
tp_moe_mlp.assignments = 0
