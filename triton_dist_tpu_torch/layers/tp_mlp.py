"""Tensor-parallel MLP blocks over the fused ops (≙
``triton_dist_tpu/layers/tp_mlp.py``: ``TPMLP`` at ``:20``, ``TPMoEMLP``
at ``:45``)."""

from __future__ import annotations

from typing import Callable

import torch

from triton_dist_tpu_torch.ops import grads
from triton_dist_tpu_torch.ops.allgather_gemm import AGGemmConfig, ag_gemm
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import GemmRSConfig, gemm_rs
from triton_dist_tpu_torch.ops.group_gemm import GroupGemmConfig, gelu
from triton_dist_tpu_torch.ops.moe_mlp import tp_moe_mlp
from triton_dist_tpu_torch.utils import group_of


class TPMLP(torch.nn.Module):
    """Column → row parallel MLP forward: ``gemm_rs(act(ag_gemm(x, w_up)),
    w_down)``. x ``[m_loc, H]``, w_up ``[H, F / world]``, w_down ``[F /
    world, H]`` → ``[m_loc, H]``. The configs pick the projections' kernels
    as in the model: on a full mesh K6/K7, on a ring (or with spans) K15
    and K16/K17; K1 at world 1. ``axis`` (≙ the JAX layer's ``axis``: a
    name, or a pair such as ``("dp", "tp")``) runs it over ``ctx``'s group
    over those axes; over a pair the up-projection is K37 and the
    down-projection the 2-D GEMM-RS (weights split over the flattened
    pair); None is the whole of ``ctx``."""

    def __init__(self, ctx=None, activation: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 ag_config: AGGemmConfig | None = None, rs_config: GemmRSConfig | None = None,
                 axis=None):
        super().__init__()
        self.ctx, self.activation = group_of(ctx, axis), activation
        self.ag_config, self.rs_config = ag_config, rs_config

    def forward(self, x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
        h = self.activation(ag_gemm(x, w_up, ctx=self.ctx, config=self.ag_config))
        return gemm_rs(h, w_down, ctx=self.ctx, config=self.rs_config, out_dtype=x.dtype)


class TPMoEMLP(torch.nn.Module):
    """MoE MLP with tensor-parallel experts (``ops/moe_mlp.py``):
    ``overlap=True`` the overlapped pair (K9, K10), ``overlap=False`` the
    sequential composition (the token allgather — K19/K21 on a ring — K8,
    K8 and the reduce-scatter — K18 on a ring). Differentiable when grad
    mode is on (``ops/grads.py::tp_moe_mlp_grad``). x ``[m_loc, H]``, w_up
    ``[E, H, F / world]``, w_down ``[E, F / world, H]``, the local tokens'
    ``topk_ids`` and ``topk_weights`` ``[m_loc, topk]`` → ``[m_loc, H]``.
    The activation is the tanh GELU, the one the kernels fuse. ``axis`` as
    :class:`TPMLP`'s: over a pair ``overlap=True`` runs K9/K10 over the
    flattened pair, as the JAX package's overlap kernels do, and
    ``overlap=False`` K36, K8, K8 and the 2-D reduce-scatter."""

    def __init__(self, ctx=None, gg_config: GroupGemmConfig | None = None, overlap: bool = True,
                 axis=None):
        super().__init__()
        self.ctx, self.gg_config, self.overlap = group_of(ctx, axis), gg_config, overlap

    def forward(self, x, w_up, w_down, topk_ids, topk_weights) -> torch.Tensor:
        mlp = grads.tp_moe_mlp_grad if torch.is_grad_enabled() else tp_moe_mlp
        return mlp(x, w_up, w_down, topk_ids, topk_weights.float(), ctx=self.ctx,
                   gg_config=self.gg_config, overlap=self.overlap).to(x.dtype)
