"""The context-parallel (sequence-parallel) decoder, long-context training
on ring attention (≙ ``triton_dist_tpu/models/sp_transformer.py``).

The residual stream stays sequence-sharded end to end: rank r holds
``[b, s_loc]`` tokens of every sequence (rows ``[r s_loc, (r+1) s_loc)``,
or under ``zigzag`` the stripes r and 2n-1-r, tokens pre-permuted with
``ops.ring_attention.zigzag_permutation``), every weight is replicated,
and attention is ring attention with its backward
(``ops/grads.py::ring_attention_grad``: K35 forward on the card). The
projections, norms, RoPE and the SwiGLU are plain PyTorch, as the JAX
model leaves them to XLA. The parameter tree is the dense model's
(``tp_transformer.init_params`` / ``params_from_numpy``), unsharded.

Call :meth:`SPTransformer.loss` and :func:`sp_train_step` per rank inside
``ctx.run(..., grad=True)`` (world 1: directly, ``ctx`` None).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.models.tp_transformer import (
    TransformerConfig,
    _tree_leaves,
    _tree_map,
    rmsnorm,
    rope,
)
from triton_dist_tpu_torch.ops.grads import ring_attention_grad
from triton_dist_tpu_torch.ops.ring_attention import RingAttentionConfig, positions
from triton_dist_tpu_torch.utils import axis_index, axis_size


@dataclasses.dataclass(frozen=True)
class SPTransformerConfig(TransformerConfig):
    """``TransformerConfig`` over a sequence-sharded stream (≙
    ``SPTransformerConfig``, ``:33``): ``ring_config`` reaches ring
    attention, ``zigzag`` takes the causal-load-balanced layout (feed tokens
    and targets pre-permuted; logits come back in the same order)."""

    ring_config: RingAttentionConfig | None = None
    zigzag: bool = False

    @property
    def layout(self) -> str:
        return "zigzag" if self.zigzag else "contig"


@dataclasses.dataclass
class SPTransformer:
    """Decoder forward on one rank's sequence shard (≙ ``SPTransformer``,
    ``:49``); ``ctx`` None is world 1."""

    cfg: SPTransformerConfig
    ctx: object = None

    def block(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        c, ctx = self.cfg, self.ctx
        b, s_loc, _ = x.shape
        g = c.n_q_heads // c.n_kv_heads
        d = c.head_dim
        h = rmsnorm(x, p["attn_norm"], c.norm_eps)
        qkv = (h @ p["wqkv"].reshape(c.hidden, -1)).reshape(b, s_loc, c.n_kv_heads, g + 2, d)
        # the global positions of this shard's rows
        pos = positions(axis_index(ctx), axis_size(ctx), s_loc, c.layout, x.device)
        q = rope(qkv[..., :g, :].reshape(b, s_loc, c.n_q_heads, d), pos, c.rope_theta)
        k = rope(qkv[..., g, :], pos, c.rope_theta)
        v = qkv[..., g + 1, :]
        # ring attention takes [b, h, s_loc, d], the kv heads repeated for GQA
        q_t = q.transpose(1, 2)
        k_t = k.transpose(1, 2).repeat_interleave(g, dim=1)
        v_t = v.transpose(1, 2).repeat_interleave(g, dim=1)
        attn = ring_attention_grad(q_t, k_t, v_t, ctx=ctx, causal=True, config=c.ring_config,
                                   layout=c.layout).transpose(1, 2)
        x = x + attn.reshape(b, s_loc, c.q_dim) @ p["wo"]
        h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
        gu = (h @ p["w_gate_up"].reshape(c.hidden, -1)).reshape(b, s_loc, -1, 2)
        act = torch.nn.functional.silu(gu[..., 0].float()).to(x.dtype) * gu[..., 1]
        return x + act @ p["w_down"]

    def __call__(self, tokens_loc: torch.Tensor, params: dict) -> torch.Tensor:
        """tokens_loc ``[b, s_loc]`` → logits ``[b, s_loc, vocab]`` of the
        local rows."""
        c = self.cfg
        x = params["embed"][tokens_loc]
        for p in params["layers"]:
            x = self.block(x, p)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        return x @ params["lm_head"]

    def loss(self, tokens_loc, targets_loc, params) -> torch.Tensor:
        """Mean cross-entropy over the local rows (≙ ``loss``, ``:104``):
        the shards partition the tokens, so the global objective is the
        ranks' mean of these."""
        logits = self(tokens_loc, params).float()
        lse = torch.logsumexp(logits, -1)
        tl = logits.gather(-1, targets_loc.long()[..., None])[..., 0]
        return (lse - tl).mean()


def _rank_mean(ctx, g: torch.Tensor) -> torch.Tensor:
    """``psum(g) / n`` over the ranks (≙ ``:119-120``) as a reduce-scatter of
    the flat gradient and a gather: the same f32 sums in rank order, cast
    once, but each rank's f32 transient is 1/n of the leaf rather than all
    of it (the replicated embedding and LM head are the large ones)."""
    n = ctx.world
    flat = g.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return ctx.all_gather(ctx.psum_scatter(flat, 0), 0)[:g.numel()].reshape(g.shape) / n


def _sp_loss_and_grads(model: SPTransformer, params: dict, tokens_loc, targets_loc):
    """The ranks' mean loss and the gradients ``sp_train_step`` applies, a
    list in the order of ``_tree_leaves(params)`` (None for a leaf that is
    not floating): each rank's local-loss gradient, ``psum(g) / n``
    (:func:`_rank_mean`)."""
    if not torch.is_grad_enabled() or torch.is_inference_mode_enabled():
        raise RuntimeError("sp_train_step takes gradients: at world > 1 call it inside "
                           "ctx.run(..., grad=True), not in an inference-mode run")
    ctx = model.ctx
    n = axis_size(ctx)
    work = _tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    leaves = _tree_leaves(work)
    live = [p for p in leaves if p.requires_grad]
    loss = model.loss(tokens_loc, targets_loc, work)
    found = dict(zip(map(id, live), torch.autograd.grad(loss, live, allow_unused=True)))
    grads = []
    for p in leaves:
        g = found.pop(id(p), None)  # each local gradient is freed once assembled
        if p.is_floating_point():
            g = torch.zeros_like(p) if g is None else g
            g = _rank_mean(ctx, g) if n > 1 else g
        grads.append(g)
    loss = loss.detach()
    return (ctx.psum(loss) / n if n > 1 else loss), grads


def sp_train_step(model: SPTransformer, params: dict, tokens_loc: torch.Tensor,
                  targets_loc: torch.Tensor, lr: float = 1e-2):
    """One SGD step of one rank (≙ ``sp_train_step``, ``:112``): the local
    loss's gradients, assembled for the replicated parameters as ``psum(g)
    / n`` over the ranks, the loss averaged over them. Returns ``(params,
    loss)``, new tensors."""
    loss, grads = _sp_loss_and_grads(model, params, tokens_loc, targets_loc)
    order = iter(range(len(grads)))

    def update(p):
        i = next(order)
        g, grads[i] = grads[i], None  # each gradient is freed once applied
        return p - lr * g.to(p.dtype) if p.is_floating_point() else p

    with torch.no_grad():
        return _tree_map(update, params), loss
