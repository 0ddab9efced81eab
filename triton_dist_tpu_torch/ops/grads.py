"""The differentiable fused ops (≙ ``triton_dist_tpu/ops/grads.py``): each
``jax.custom_vjp`` there is a ``torch.autograd.Function`` here whose
backward runs the same kernels as the JAX backward.

  C = AG(A) @ B            (column-parallel, ``ag_gemm_grad``)
    dA = gemm_rs(dC, Bᵀ)   dB = AG(A)ᵀ @ dC
  C = psum_scatter(A @ B)  (row-parallel, ``gemm_rs_grad``)
    dA = ag_gemm(dC, Bᵀ)   dB = Aᵀ @ AG(dC)

Gradient accounting is the JAX package's under ``shard_map`` with
``check_vma=False``: every rank differentiates its own copy of the
(replicated) loss, so what comes back is the gradient of the sum of the
ranks' losses. The transpose of ``psum`` is a ``psum``, of ``all_gather``
a ``psum_scatter``; ``train_step`` then psums the replicated parameters'
gradients over the ranks and divides every gradient by the world.

Call these inside ``ctx.run(..., grad=True)`` at world > 1: each rank's
backward must run on the rank's own thread, since the backward kernels
meet the other ranks on the host. The dense products of the weight
gradients (``AG(A)ᵀ @ dC``, ``Aᵀ @ AG(dC)``) are ``jnp.dot``s outside any
Pallas kernel in the JAX package and ``torch.matmul`` here; the operands
the kernels take transposed (``Bᵀ``, the expert banks' ``W.transpose(1,
2)``) are contiguous copies made in the backward.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.all_to_all import fast_all_to_all
from triton_dist_tpu_torch.ops.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import gemm_rs
from triton_dist_tpu_torch.ops.group_gemm import (
    check_config,
    gelu,
    group_gemm,
    group_gemm_dw,
    refuse_ragged_backward,
)
from triton_dist_tpu_torch.ops.moe_mlp import _tp_moe_forward_impl
from triton_dist_tpu_torch.ops.moe_utils import RankedAlignment, ranked_global_view
from triton_dist_tpu_torch.ops.reduce_scatter import reduce_scatter
from triton_dist_tpu_torch.utils import axis_size


def _t(w: torch.Tensor) -> torch.Tensor:
    """The transpose of the last two dims, contiguous (the kernels take
    row-major operands)."""
    return w.transpose(-1, -2).contiguous()


class _AGGemm(torch.autograd.Function):
    @staticmethod
    def forward(fc, a, b, ctx, ag_config, rs_config):
        out, a_full = ag_gemm(a, b, ctx=ctx, config=ag_config, gather_output=True)
        fc.save_for_backward(a_full, b)
        fc.dist, fc.rs_config = ctx, rs_config
        return out

    @staticmethod
    def backward(fc, dc):
        a_full, b = fc.saved_tensors
        dc = dc.contiguous()
        da = gemm_rs(dc, _t(b), ctx=fc.dist, config=fc.rs_config, out_dtype=dc.dtype)
        db = torch.matmul(a_full.t(), dc).to(b.dtype)
        return da, db, None, None, None


def ag_gemm_grad(a: torch.Tensor, b: torch.Tensor, *, ctx=None, ag_config=None,
                 rs_config=None) -> torch.Tensor:
    """Differentiable ``all_gather(a) @ b`` (≙ ``ag_gemm_grad``, ``:38``):
    forward ``ag_gemm`` with `ag_config` (K6 on a full mesh, K15 on a ring
    or with spans; K1 at world 1), backward ``gemm_rs`` with `rs_config`
    (K7, or K16/K17 on a ring; K1 at world 1)."""
    return _AGGemm.apply(a, b, ctx, ag_config, rs_config)


class _GemmRS(torch.autograd.Function):
    @staticmethod
    def forward(fc, a, b, ctx, rs_config, ag_config):
        fc.save_for_backward(a, b)
        fc.dist, fc.ag_config = ctx, ag_config
        return gemm_rs(a, b, ctx=ctx, config=rs_config)

    @staticmethod
    def backward(fc, dc):
        a, b = fc.saved_tensors
        # world 1: dc_full is dc and the product is K1's
        da, dc_full = ag_gemm(dc.contiguous(), _t(b), ctx=fc.dist, config=fc.ag_config,
                              gather_output=True, out_dtype=a.dtype)
        db = torch.matmul(a.t(), dc_full).to(b.dtype)
        return da, db, None, None, None


def gemm_rs_grad(a: torch.Tensor, b: torch.Tensor, *, ctx=None, rs_config=None,
                 ag_config=None) -> torch.Tensor:
    """Differentiable ``psum_scatter(a @ b)`` (≙ ``gemm_rs_grad``, ``:73``):
    forward ``gemm_rs`` with `rs_config` (K7, or K16/K17 on a ring; K1 at
    world 1), backward ``ag_gemm`` with `ag_config` (K6, or K15; K1 at
    world 1)."""
    return _GemmRS.apply(a, b, ctx, rs_config, ag_config)


def _group_gemm_bwd(a_sorted, b, expert_ids, g, cfg, need_db=True):
    """Both gradients of ``group_gemm(a_sorted, b)`` for the cotangent `g`
    (≙ ``_gg_bwd``): dA ``[t_pad, K]`` f32 from K8 over the transposed bank
    (g in a_sorted's dtype), dB ``[E, K, N]`` in b's dtype from K11 (both
    operands in f32 where their dtypes differ, as the JAX kernel takes
    them); dB None without `need_db`."""
    da = group_gemm(g.to(a_sorted.dtype), _t(b), expert_ids, config=cfg,
                    out_dtype=torch.float32)
    if not need_db:
        return da, None
    a = a_sorted
    if g.dtype != a.dtype:
        a, g = a.float(), g.float()
    db = group_gemm_dw(a, g, expert_ids, b.shape[0], config=cfg).to(b.dtype)
    return da, db


class _GroupGemm(torch.autograd.Function):
    @staticmethod
    def forward(fc, a_sorted, b, expert_ids, cfg, out_dtype):
        fc.save_for_backward(a_sorted, b, expert_ids)
        fc.cfg = cfg
        return group_gemm(a_sorted, b, expert_ids, config=cfg, out_dtype=out_dtype)

    @staticmethod
    def backward(fc, dout):
        a_sorted, b, expert_ids = fc.saved_tensors
        da, db = _group_gemm_bwd(a_sorted, b, expert_ids, dout.contiguous(), fc.cfg)
        return da.to(a_sorted.dtype), db, None, None, None


def group_gemm_grad(a_sorted, b, expert_ids, *, config=None, out_dtype=None):
    """Differentiable block-aligned grouped GEMM (≙ ``group_gemm_grad``,
    ``:595``): forward K8; backward K8 with the transposed bank for dA and
    K11 for dB. ``expert_ids`` gets no gradient. A ragged config refuses:
    its dW kernel is not ported (ROADMAP B16, ragged dW)."""
    cfg = check_config(config)
    refuse_ragged_backward(cfg)
    return _GroupGemm.apply(a_sorted, b, expert_ids, cfg, out_dtype or a_sorted.dtype)


class _TPMoE(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, w_up, w_down, topk_ids, topk_weights, ctx, cfg, overlap, w_up_scale,
                w_down_scale):
        out, res = _tp_moe_forward_impl(x, w_up, w_down, topk_ids, topk_weights, ctx, cfg,
                                        residuals=True, overlap=overlap,
                                        w_up_scale=w_up_scale, w_down_scale=w_down_scale)
        fc.save_for_backward(w_up, w_down)
        fc.res, fc.dist, fc.cfg = res, ctx, cfg
        fc.scales = (w_up_scale, w_down_scale)
        return out

    @staticmethod
    def backward(fc, dout):
        """``_tp_moe_bwd`` (``:414-534``) step for step, over the global
        alignment: the sequential composition's own, or the global view of
        the overlapped pair's rank-major one. Straight-through for the
        scaled formats (``:414-430``): ``w8``/``fp8`` are stripped from the
        config, pre-quantized banks are dequantized once and differentiated
        against, and the banks and their scales get zero cotangents (the
        int8 banks none: they take no gradient in PyTorch)."""
        w_up, w_down = fc.saved_tensors
        res, ctx, cfg = fc.res, fc.dist, fc.cfg
        w_up_scale, w_down_scale = fc.scales
        fc.res = fc.scales = None
        cfg = dataclasses.replace(cfg, w8=False, fp8=False)
        al, tw_full, h_sorted = res.alignment, res.tw_full, res.h_sorted
        f32 = torch.float32
        m_tot, topk = tw_full.shape
        if isinstance(al, RankedAlignment):
            al = ranked_global_view(al, m_tot // al.n_ranks, topk)
        t = m_tot * topk
        dtype = res.a_sorted.dtype
        quantized = w_up_scale is not None
        if quantized:
            w_up = (w_up.float() * w_up_scale).to(dtype)
            w_down = (w_down.float() * w_down_scale).to(dtype)

        # the reduce-scatter's transpose: every rank sees the whole dout
        dpartial = (dout if axis_size(ctx) == 1 else ctx.all_gather(dout.contiguous(), 0)).float()
        ids = al.sorted_token_ids.long()                  # [t_pad], sentinel t
        valid = ids < t
        slot = ids.clamp(0, t - 1)
        token_of_row = (ids // topk).clamp(0, m_tot - 1)
        w_row = torch.where(valid, tw_full.reshape(-1)[slot].float(), 0.0)

        # remat the activation and y_sorted
        act = gelu(h_sorted.float()).to(dtype)
        y_sorted = group_gemm(act, w_down, al.expert_ids, config=cfg, out_dtype=f32)
        dpart_rows = dpartial[token_of_row]               # [t_pad, H]
        # d topk_weights: <dout row, y row> per live assignment, summed over
        # the ranks (each holds its F shard's part)
        dtw_rows = torch.where(valid, (dpart_rows * y_sorted).sum(-1), 0.0)
        dtw_full = torch.zeros(t, dtype=f32, device=dout.device).index_add_(0, slot, dtw_rows)
        dtw_full = dtw_full.reshape(m_tot, topk)
        dtw = (dtw_full if axis_size(ctx) == 1 else ctx.psum_scatter(dtw_full, 0)).to(
            tw_full.dtype)
        del y_sorted, dtw_rows

        # back through the weighted combine and the down grouped GEMM
        dy_sorted = (dpart_rows * w_row[:, None]).to(dtype)
        del dpart_rows
        # pre-quantized banks take no gradient: no K11 pass for them (``:490``)
        dact, dw_down = _group_gemm_bwd(act, w_down, al.expert_ids, dy_sorted, cfg,
                                        need_db=not quantized)
        del act, dy_sorted
        # through the activation, then the up grouped GEMM; sentinel rows of
        # the residual hold clamped junk: zero them
        dh_sorted = torch.ops.aten.gelu_backward(dact, h_sorted.float(),
                                                 approximate="tanh").to(dtype)
        del dact
        a_sorted = torch.where(valid[:, None], res.a_sorted, 0)
        da_sorted, dw_up = _group_gemm_bwd(a_sorted, w_up, al.expert_ids, dh_sorted, cfg,
                                           need_db=not quantized)
        del a_sorted, dh_sorted
        # the unsorted scatter-add back to the tokens, then the all-gather's
        # transpose
        da_full = torch.zeros((m_tot, da_sorted.shape[1]), dtype=f32, device=dout.device)
        da_full.index_add_(0, token_of_row, torch.where(valid[:, None], da_sorted, 0.0))
        dx = reduce_scatter(da_full, ctx=ctx).to(dtype)
        if quantized:
            return (dx, None, None, None, dtw, None, None, None,
                    torch.zeros_like(w_up_scale), torch.zeros_like(w_down_scale))
        return dx, dw_up, dw_down, None, dtw, None, None, None, None, None


def tp_moe_mlp_grad(x, w_up, w_down, topk_ids, topk_weights, *, ctx=None, gg_config=None,
                    overlap: bool = True, w_up_scale=None, w_down_scale=None):
    """Differentiable tensor-parallel MoE MLP (≙ ``tp_moe_mlp_grad``,
    ``:345``; call inside ``ctx.run(..., grad=True)``). Forward
    ``ops/moe_mlp.py`` (K8 at world 1; K9, K10 at world > 1, or with
    ``overlap=False`` the sequential composition: the token gather, K8,
    K8 and the reduce-scatter). Backward:
    the all-gather of ``dout`` (host collective), the remat of ``y_sorted``
    and the two transposed grouped GEMMs on K8 (f32 out), ``dw_up`` and
    ``dw_down`` on K11, the GELU's VJP and the token scatter-add plain,
    ``d topk_weights`` through ``psum_scatter`` and ``dx`` through
    ``reduce_scatter`` (K12; K18 off a full mesh). ``topk_ids`` gets no
    gradient. ``w_up_scale``/``w_down_scale`` mark pre-quantized int8/fp8
    banks (K24, K25, K26 in the forward; ``:346-395``); the backward is
    straight-through (``_TPMoE.backward``). A ragged ``gg_config`` refuses
    before the forward runs (ROADMAP B16, ragged dW)."""
    cfg = check_config(gg_config)
    refuse_ragged_backward(cfg)
    return _TPMoE.apply(x, w_up, w_down, topk_ids, topk_weights, ctx, cfg, overlap,
                        w_up_scale, w_down_scale)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fc, tokens, splits, meta, ctx, config):
        out = fast_all_to_all(tokens, splits, meta=meta, ctx=ctx, config=config)
        fc.dist, fc.config = ctx, config
        fc.save_for_backward(out[1])
        fc.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(fc, d_recv, *_):
        (recv_splits,) = fc.saved_tensors
        dx, _ = fast_all_to_all(d_recv.contiguous(), recv_splits, ctx=fc.dist, config=fc.config)
        return dx, None, None, None, None


def fast_all_to_all_grad(tokens: torch.Tensor, splits: torch.Tensor,
                         meta: torch.Tensor | None = None, *, ctx=None, config=None):
    """Differentiable padded-slab all-to-all (≙ ``fast_all_to_all_grad``,
    ``:541``): the exchange is its own inverse (slab j of rank i ↔ slab i
    of rank j; full slabs always move), so the backward is the same
    exchange of the cotangent with the received splits, through the same
    kernel (`config` applies both ways); splits and meta take no gradient.
    Always returns ``(recv, recv_splits, recv_meta or None)``."""
    out = _AllToAll.apply(tokens, splits, meta, ctx, config)
    return out if meta is not None else (*out, None)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx):
        fc.dist = ctx
        return ctx.psum(x)

    @staticmethod
    def backward(fc, g):
        return fc.dist.psum(g.contiguous()), None


def psum(x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Differentiable ``ctx.psum`` (≙ ``jax.lax.psum``; its transpose is a
    psum of the cotangents)."""
    return x if axis_size(ctx) == 1 else _PSum.apply(x, ctx)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx, dim):
        fc.dist, fc.dim = ctx, dim
        return ctx.all_gather(x, dim)

    @staticmethod
    def backward(fc, g):
        return fc.dist.psum_scatter(g.contiguous(), fc.dim), None, None


def all_gather(x: torch.Tensor, ctx=None, dim: int = 0) -> torch.Tensor:
    """Differentiable ``ctx.all_gather`` (≙ ``jax.lax.all_gather(...,
    tiled=True)``; its transpose is a psum_scatter of the cotangent)."""
    return x if axis_size(ctx) == 1 else _AllGather.apply(x, ctx, dim)


def grads_all_finite(grads, ctx=None) -> torch.Tensor:
    """The skip-step gate of ``train_step`` (≙ ``grads_all_finite``,
    ``:718``): a 0-dim bool tensor, true when every floating leaf of
    `grads` (nested lists, tuples and dicts of tensors) is finite on every
    rank. No host sync."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            leaves.append(node)

    walk(grads)
    if not leaves:
        return torch.tensor(True)
    bad = torch.stack([~torch.isfinite(g).all() for g in leaves]).sum(dtype=torch.int32)
    if axis_size(ctx) > 1:
        bad = ctx.psum(bad)
    return bad == 0
