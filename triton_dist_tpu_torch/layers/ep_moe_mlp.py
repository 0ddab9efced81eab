"""The expert-parallel MoE MLP (≙ ``triton_dist_tpu/layers/ep_moe_mlp.py``:
``EPMoEMLP`` at ``:71``, ``assert_no_overflow``, ``_overflow_message``).

Each rank holds ``n_experts / world`` whole experts; the tokens travel to
them: dispatch over the all-to-all (``EPAll2AllLayer``, K27/K28), the
local grouped GEMMs on the block-aligned received rows (K8, or K24 over
int8 / fp8 banks, with the GELU fused into the down-projection's A), the
rows back into the slab layout, and the combine (the all-to-all in
reverse and the top-k weighted sum). Under the padded contract of the JAX
package every slab row runs through the GEMMs, the padding rows on the
clamped last expert, and the combine drops them. ``gg_config.ragged``
(≙ ``:174-185``) gives the alignment its ``valid_rows`` map, in which the
virtual padding expert's blocks are dead, and both grouped GEMMs (K29)
skip every dead 128-row tile. The class counters ``rows`` (grouped-GEMM
rows of the layout, the padded ``t_pad`` a call), ``live_rows`` (the rows
of the 128-row tiles the GEMMs compute: ``rows`` when padded, the live
tiles' rows when ragged; a block below 128 rows is its own tile) and
``assignments`` (the (token, k) pairs a call dispatches) measure how much
of that work is padding.

``outer``/``inner`` (≙ ``:98-116``) take the hierarchical two-phase
dispatch over that pair of a 2-D rank runtime (``HierEPAll2AllLayer``):
each rank holds ``n_experts / (n_o * n_i)`` whole experts, ``max_m`` is
the phase-1 slab and ``max_m2`` the phase-2 one (default ``n_o * max_m *
topk``, which never drops). Under grad mode over float banks the expert
GEMMs are ``group_gemm_grad`` (≙ ``:184-193``: K8/K11, or K29/K34 under a
ragged config) with the GELU between them, so the layer trains; the
dispatch and combine are differentiable already.
"""

from __future__ import annotations

import sys

import torch

from triton_dist_tpu_torch import config
from triton_dist_tpu_torch.layers.ep_a2a_layer import EPAll2AllLayer, HierEPAll2AllLayer
from triton_dist_tpu_torch.ops.all_to_all import A2AConfig
from triton_dist_tpu_torch.ops.grads import group_gemm_grad
from triton_dist_tpu_torch.ops.group_gemm import (
    TILE_M,
    GroupGemmConfig,
    check_config,
    gelu,
    group_gemm,
    quantize_expert_weights,
)
from triton_dist_tpu_torch.ops.moe_utils import live_tile_rows
from triton_dist_tpu_torch.utils import axis_index, axis_size, count_launch, count_rows, tally


def _overflow_message(ov: int) -> str:
    return (f"EP dispatch dropped {ov} assignments to slab overflow — max_m too small "
            f"(≙ the reference's assert, low_latency_all_to_all.py:212). Raise the capacity "
            f"or route fewer tokens per rank.")


def assert_no_overflow(overflow) -> None:
    """Host-side hard stop on an overflow count (the second output of
    ``EPMoEMLP(..., with_overflow=True)``)."""
    ov = int(overflow)
    if ov > 0:
        raise RuntimeError(_overflow_message(ov))


class EPMoEMLP(torch.nn.Module):
    """x ``[m_loc, H]`` (this rank's token shard), w_up ``[E / world, H,
    F]``, w_down ``[E / world, F, H]`` (this rank's whole experts), the
    routing ``topk_ids``/``topk_weights [m_loc, topk]`` → ``[m_loc, H]``
    (call inside ``ctx.run``). ``max_m`` is the per-(source, destination)
    slab capacity; ``quant`` the one-byte dispatch wire; ``gg_config`` the
    grouped GEMMs' (``w8`` quantizes float banks here, once a call)."""

    rows = 0         # grouped-GEMM rows of the layout (both GEMMs run the same rows)
    assignments = 0  # (token, k) assignments dispatched
    # rank -> rows of the 128-row tiles computed: a device scalar under the
    # ragged map, read once after a serve (live_row_count): no host sync
    live_rows: dict = {}

    @classmethod
    def live_row_count(cls) -> int:
        """Every rank's ``live_rows``, summed (a sync: read it after the
        work it counts)."""
        return tally(cls.live_rows)

    def __init__(self, n_experts: int, topk: int, max_m: int, ctx=None, *,
                 outer: str | None = None, inner: str | None = None,
                 max_m2: int | None = None,
                 gg_config: GroupGemmConfig | None = None, quant: str | None = None,
                 a2a_config: A2AConfig | None = None):
        super().__init__()
        if (outer is None) != (inner is None):
            raise ValueError("set both outer= and inner=, or neither")
        self.ctx, self.gg_config = ctx, gg_config
        self.hier = outer is not None
        if self.hier:
            n_o = axis_size(ctx, outer)
            self.pair = (outer, inner)
            self.layer = HierEPAll2AllLayer(n_experts, topk, max_m,
                                            max_m2 or n_o * max_m * topk, ctx, outer, inner,
                                            quant, a2a_config)
        else:
            self.pair = None
            self.layer = EPAll2AllLayer(n_experts, topk, max_m, ctx, quant, a2a_config)

    def forward(self, x, w_up, w_down, topk_ids, topk_weights, *, with_overflow: bool = False,
                w_up_scale=None, w_down_scale=None):
        """``w_up_scale``/``w_down_scale`` (``[E / world, 1, N]``) mark the
        banks as int8 / fp8 pools (K24). ``with_overflow`` also returns the
        count of assignments dropped to slab overflow."""
        cfg = check_config(self.gg_config)
        layer = self.layer
        epr = layer.n_experts // axis_size(self.ctx, self.pair)
        if w_up.shape[0] != epr or w_down.shape[0] != epr:
            raise ValueError(
                f"EPMoEMLP: a rank holds {epr} whole experts of {layer.n_experts}, got banks "
                f"{tuple(w_up.shape)} / {tuple(w_down.shape)} (shard an EP model's parameters "
                f"on the expert dim: shard_params(params, world, cfg=cfg))")
        if (w_up_scale is None) != (w_down_scale is None):
            raise ValueError("pass both expert-weight scales, or neither")
        if cfg.w8 and w_up_scale is None:
            if not (w_up.is_floating_point() and w_down.is_floating_point()):
                raise ValueError("GroupGemmConfig.w8 with one-byte expert banks needs their "
                                 "scales (w_up_scale / w_down_scale)")
            w_up, w_up_scale = quantize_expert_weights(w_up)
            w_down, w_down_scale = quantize_expert_weights(w_down)
        m_loc, hidden = x.shape
        if self.hier:
            recv, info = layer.dispatch(x, topk_ids, topk_weights)
        else:
            recv, info = layer.dispatch(x, topk_ids)
        al = layer.receiver_alignment(info, cfg.block_m, ragged=cfg.ragged)
        rows = recv.reshape(-1, hidden)
        r_cap = rows.shape[0]
        ids = al.sorted_token_ids.long()
        a_sorted = rows[torch.clamp(ids, max=r_cap - 1)]
        if torch.is_grad_enabled() and w_up_scale is None:
            # training (``:184-193``): the differentiable grouped GEMMs on
            # the block-aligned rows, the activation between them
            h1 = group_gemm_grad(a_sorted, w_up, al.expert_ids, valid_rows=al.valid_rows,
                                 config=cfg, assume_sorted=True)
            h1 = gelu(h1.float()).to(x.dtype)
            y_sorted = group_gemm_grad(h1, w_down, al.expert_ids, valid_rows=al.valid_rows,
                                       config=cfg, assume_sorted=True)
        else:
            h1 = group_gemm(a_sorted, w_up, al.expert_ids, valid_rows=al.valid_rows,
                            scale=w_up_scale, config=cfg)
            y_sorted = group_gemm(h1, w_down, al.expert_ids, valid_rows=al.valid_rows,
                                  scale=w_down_scale, config=cfg, act_fn=gelu)
        # back to the received slab layout; the sentinel rows land in a scratch row
        y = torch.zeros((r_cap + 1, y_sorted.shape[1]), dtype=x.dtype, device=x.device)
        y[ids] = y_sorted.to(x.dtype)
        y = y[:r_cap].view(recv.shape[0], recv.shape[1], -1)
        if self.hier:
            out = layer.combine(y, info, m_loc).to(x.dtype)
        else:
            out = layer.combine(y, info, topk_weights, m_loc).to(x.dtype)
        count_launch(EPMoEMLP, "rows", ids.shape[0])
        count_launch(EPMoEMLP, "assignments", topk_ids.numel())
        live = ids.shape[0] if al.valid_rows is None else live_tile_rows(
            al.valid_rows, cfg.block_m, TILE_M)
        count_rows(EPMoEMLP, "live_rows", axis_index(self.ctx, self.pair), live)
        if config.debug_ep_overflow:
            ov = int(info.overflow)  # a host sync: debug runs only
            if ov > 0:
                print(f"ERROR: {_overflow_message(ov)}", file=sys.stderr, flush=True)
                out = torch.full_like(out, float("nan"))
        return (out, info.overflow) if with_overflow else out
