"""Ulysses-style sequence parallelism (≙ ``triton_dist_tpu/ops/ulysses.py``):
one all-to-all re-shards ``[seq → heads]``, each rank runs dense local
attention on its head slice over the whole sequence, and one all-to-all
re-shards back. The exchange is the port's padded-slab all-to-all through
``fast_all_to_all_grad`` (K27 on the card): head-group slabs are equal,
so the slab contract is exact, and q, k and v ride one exchange (their rows
back to back a slab). The local attention is plain PyTorch, as the JAX
package leaves it to XLA.

:func:`usp_attention` composes the head exchange over an inner group
with ring attention (K35) over an outer one, the two axes of a 2-D rank
runtime; with an inner axis of one rank it is ``ring_attention_grad``.
"""

from __future__ import annotations

import math

import torch

from triton_dist_tpu_torch.ops.grads import fast_all_to_all_grad, ring_attention_grad
from triton_dist_tpu_torch.utils import axis_size, group_of


def _exchange(x: torch.Tensor, ctx) -> torch.Tensor:
    """``[n, rows, d]`` slab exchange (slab j → rank j); returns the same
    shape with slab i what rank i sent here (≙ ``_exchange``, ``:28``)."""
    n, rows = x.shape[0], x.shape[1]
    splits = torch.full((n,), rows, dtype=torch.int32, device=x.device)
    return fast_all_to_all_grad(x.contiguous(), splits, ctx=ctx)[0]


def _seq_to_heads(arrs, ctx):
    """``[b, h, s_loc, d]`` sequence shards → ``[b, h/n, S, d]`` head shards
    for same-shape arrays in one exchange (≙ ``_seq_to_heads``, ``:41``)."""
    n = ctx.world
    b, h, s_loc, d = arrs[0].shape
    h_loc = h // n
    rows = b * h_loc * s_loc
    slabs = torch.cat([a.reshape(b, n, h_loc, s_loc, d).permute(1, 0, 2, 3, 4)
                       .reshape(n, rows, d) for a in arrs], 1)
    recv = _exchange(slabs, ctx)
    return tuple(recv[:, i * rows:(i + 1) * rows].reshape(n, b, h_loc, s_loc, d)
                 .permute(1, 2, 0, 3, 4).reshape(b, h_loc, n * s_loc, d)
                 for i in range(len(arrs)))


def _heads_to_seq(arrs, ctx):
    """``[b, h/n, S, d]`` head shards → ``[b, h, s_loc, d]`` sequence shards
    in one exchange, the exact transpose of :func:`_seq_to_heads` (≙
    ``_heads_to_seq``, ``:71``)."""
    n = ctx.world
    b, h_loc, s_tot, d = arrs[0].shape
    s_loc = s_tot // n
    rows = b * h_loc * s_loc
    slabs = torch.cat([a.reshape(b, h_loc, n, s_loc, d).permute(2, 0, 1, 3, 4)
                       .reshape(n, rows, d) for a in arrs], 1)
    recv = _exchange(slabs, ctx)
    return tuple(recv[:, i * rows:(i + 1) * rows].reshape(n, b, h_loc, s_loc, d)
                 .permute(1, 0, 2, 3, 4).reshape(b, n * h_loc, s_loc, d)
                 for i in range(len(arrs)))


def _local_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Dense attention on the local heads over the whole sequence, f32
    scores and softmax (≙ ``_local_attention``, ``:99``)."""
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if causal:
        s_tot = q.shape[2]
        mask = torch.ones((s_tot, s_tot), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, -1)
    return torch.einsum("bhqs,bhsd->bhqd", p, v.float()).to(q.dtype)


class _Ulysses(torch.autograd.Function):
    """The custom VJP (``:124-157``): the residuals are the head-sharded
    inputs, the local attention is recomputed in the backward, and the
    cotangent takes the reverse exchanges."""

    @staticmethod
    def forward(fc, q, k, v, ctx, causal):
        fc.dist, fc.causal = ctx, causal
        if axis_size(ctx) == 1:
            fc.save_for_backward(q, k, v)
            return _local_attention(q, k, v, causal)
        qh, kh, vh = _seq_to_heads((q, k, v), ctx)
        fc.save_for_backward(qh, kh, vh)
        return _heads_to_seq((_local_attention(qh, kh, vh, causal),), ctx)[0]

    @staticmethod
    def backward(fc, dout):
        qh, kh, vh = (x.detach().requires_grad_() for x in fc.saved_tensors)
        ctx = fc.dist
        if axis_size(ctx) > 1:
            (dout,) = _seq_to_heads((dout.contiguous(),), ctx)
        with torch.enable_grad():
            out = _local_attention(qh, kh, vh, fc.causal)
            grads = torch.autograd.grad(out, (qh, kh, vh), dout)
        if axis_size(ctx) > 1:
            grads = _heads_to_seq(grads, ctx)
        return (*grads, None, None)


def ulysses_attention(q, k, v, *, ctx=None, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention by head exchange (≙
    ``ulysses_attention``, ``:113``; call inside ``ctx.run``, with
    ``grad=True`` to differentiate at world > 1). q, k, v ``[b, h, s_loc,
    d]`` sequence shards with ``h % world == 0``; returns the same layout.
    The golden is full (causal) attention over the gathered sequence."""
    if q.shape[1] % axis_size(ctx):
        raise ValueError(f"ulysses_attention: {q.shape[1]} heads over {axis_size(ctx)} ranks")
    return _Ulysses.apply(q, k, v, ctx, causal)


def usp_attention(q, k, v, *, ctx=None, outer=None, inner=None, causal: bool = True,
                  ring_config=None, layout: str = "contig") -> torch.Tensor:
    """Unified sequence parallelism (≙ ``usp_attention``, ``:160``; call
    inside ``ctx.run``, with ``grad=True`` to differentiate): the Ulysses
    head exchange over the `inner` group composed with ring attention over
    the `outer` one. `outer` and `inner` are axis names of the runtime
    `ctx` (``outer="sp", inner="tp"`` on ``mesh_shape={"sp": 2, "tp":
    2}``) or groups; `outer` None is `ctx` itself, `inner` None an inner
    axis of one rank (ring attention over `outer` alone). q, k, v ``[b, h,
    s_loc, d]`` with the sequence sharded over both axes outer-major and
    ``h % n_inner == 0``. After the inner exchange each rank holds ``h /
    n_inner`` heads of its outer group's contiguous sequence block, the
    ring's contiguous layout over `outer` (``layout="zigzag"`` composes as
    in the reference: permute the global sequence with
    ``zigzag_permutation(n_outer, S)``). Differentiable end to end."""
    outer = group_of(ctx, outer) if isinstance(outer, str) or outer is None else outer
    inner = group_of(ctx, inner) if isinstance(inner, str) else inner
    n_i = axis_size(inner)
    if n_i == 1:
        return ring_attention_grad(q, k, v, ctx=outer, causal=causal, config=ring_config,
                                   layout=layout)
    if q.shape[1] % n_i:
        raise ValueError(f"usp_attention: {q.shape[1]} heads over an inner axis of {n_i} ranks")
    qh, kh, vh = _seq_to_heads((q, k, v), inner)
    oh = ring_attention_grad(qh, kh, vh, ctx=outer, causal=causal, config=ring_config,
                             layout=layout)
    return _heads_to_seq((oh,), inner)[0]
