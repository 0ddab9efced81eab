"""Serving-side decode for the dense transformer (≙ ``triton_dist_tpu/
models/decode.py``): the KV cache strategies, one decode step, the bulk
prefill, greedy ``generate`` and the ``ContinuousBatcher``, at any world.

Layout at world n (the JAX package's): activations at decode are ``[b,
H]`` and replicated on every rank; decode projections are plain ``h @ W``
on the rank's weight shard (the JAX package leaves them to XLA), with the
host collectives of the runtime where the JAX body has XLA's (a head
all-gather of qkv, ``psum`` after ``wo`` and ``w_down``, a vocab
all-gather of the logits). The KV cache is SEQUENCE-sharded: rank ``r``
owns positions ``[r * s_shard, (r+1) * s_shard)``, and each step the
owning rank appends a sequence's k/v; attention goes through the K2
(contiguous cache) or K3 (paged cache) flash-decode kernels on the rank's
shard, merged over the ranks by the SP combine (K5 allgather). Prefill
runs the per-rank forward (K6/K7 at world > 1, K1 at world 1) and writes
every prompt position's K/V into its owner's shard in one pass. The cache
is updated IN PLACE (the JAX package donates the old cache buffer instead;
in place saves the same copy), and each function still returns it so call
sites read like the reference.

A position at or past ``s_max`` is owned by no rank, so its write is
dropped — the JAX package's ownership rule, kept so parked rows behave
alike. At world > 1 the step functions run once per rank inside
``ctx.run`` (``parallel/mesh.py``); the batcher drives them.

A :class:`~triton_dist_tpu_torch.models.tp_transformer.MoETransformerConfig`
serves the MoE decoder: prefill runs ``TPMoETransformer`` (K8 at world 1,
K9/K10 at world > 1; over int8 or fp8 banks K24, and K25/K26), and a decode
step's MLP computes every expert on its few rows with dense einsums, a
one-hot top-k combine and the ``psum``, in plain PyTorch as the JAX package
leaves it to XLA (``:446-481``).

The suffix-only ranged prefill (:func:`prefill_cache_ranged`) runs the
decode-shaped forward over a prompt range ``[pos0, pos0 + S)`` of every
sequence, attending already-landed KV through the multi-position verify
kernels (K13 contiguous, K14 paged). The batcher admits through it in two
serving modes: chunked prefill (``prefill_chunk_tokens``: a long prompt
lands in bounded chunks between decode steps) and the radix prefix cache
(``prefix_cache``, ``models/prefix_cache.py``: a trie hit's pages are the
range's prior, only the divergent suffix runs).

An :class:`~triton_dist_tpu_torch.models.tp_transformer.EPMoETransformerConfig`
serves the expert-parallel decoder (flat EP): prefill runs
``EPMoETransformer`` on the token shards, and a decode step or a ranged
pass dispatches each rank's slice of the rows to the experts' owners over
the all-to-all (K27/K28) and gathers the combined slices (``:414-444``);
the ranks hold whole experts (``shard_params`` with the config).

The hierarchical deployment (``cfg.ep_outer`` set; ≙ ``:58-85``,
``:407-445``, ``:487-571``): on a 2-D rank runtime with axes ``(ep_outer,
axis)`` each outer group serves its own batch slice (``batch / n_o``
sequences, DP attention over its cache shards: the caches hold the
group's slice), the tensor and sequence parallelism run over the group of
``axis``, the MoE layer's two-phase dispatch spans every rank, and the
logits gather back over the outer axis to the replicated ``[b, vocab]``
the host loop schedules against. The prompt shard of the bulk prefill is
outer-major over both axes (``_prompt_shard``, ``:1503``). The prefix
cache stays flat-only there, as in the JAX package.

Not ported yet: the prefix cache's poisoned-page strike (the integrity
tier's eviction of every reader of a poisoned shared page).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from triton_dist_tpu_torch.config import resolve_device
from triton_dist_tpu_torch.models.tp_transformer import (
    EPMoETransformer,
    EPMoETransformerConfig,
    MoETransformerConfig,
    TPMoETransformer,
    TPTransformer,
    TransformerConfig,
    apply_rope,
    ep_moe_apply,
    rmsnorm,
    rope_tables,
    shard_params,
)
from triton_dist_tpu_torch.ops.group_gemm import gelu
from triton_dist_tpu_torch.ops.flash_decode import (
    FlashDecodeConfig,
    flash_decode_distributed,
    flash_ranged_prefill_distributed,
    paged_flash_decode_distributed,
    paged_flash_ranged_prefill_distributed,
)
from triton_dist_tpu_torch.ops.moe_utils import select_experts
from triton_dist_tpu_torch.utils import axis_index, axis_size


def _outer_of(cfg) -> str | None:
    """The serving runtime's outer axis (≙ ``_outer_of``, ``:58``), or
    None on the flat deployment."""
    return getattr(cfg, "ep_outer", None)


def _tp_of(ctx, cfg):
    """The group a decode step's tensor and sequence parallelism run over:
    the ``cfg.axis`` group of the runtime (the runtime itself when 1-D)."""
    if ctx is None or not hasattr(ctx, "group"):
        return ctx
    return ctx.group(cfg.axis)


def _outer_dims(cfg, ctx) -> tuple[int, int]:
    """``(n_o, my_o)`` of the hierarchical deployment, ``(1, 0)`` when flat
    (≙ ``_outer_dims``, ``:64``); inside ``ctx.run``."""
    o = _outer_of(cfg)
    if o is None:
        return 1, 0
    return axis_size(ctx, o), axis_index(ctx, o)


def _mesh_outer(cfg, ctx) -> int:
    """The outer axis' size of the serving runtime, host side (≙
    ``_mesh_outer``, ``:73``): a hierarchical config needs a runtime with
    that axis, and raises the reference's message without one."""
    o = _outer_of(cfg)
    if o is None:
        return 1
    shape = {"tp": 1} if ctx is None else dict(ctx.runtime.mesh_shape)
    if o not in shape:
        raise ValueError(
            f"hierarchical EP serving (ep_outer={o!r}) needs a mesh with "
            f"axes ({o!r}, {cfg.axis!r}); got {shape}"
        )
    return shape[o]


def _group_cfg(cfg, n_o: int):
    """The per-outer-group config: ``batch`` is the group's slice (≙
    ``:523-530``); the flat config itself when ``n_o`` is 1."""
    if cfg.batch % n_o:
        raise ValueError(f"batch={cfg.batch} must divide over the {n_o} outer groups")
    return dataclasses.replace(cfg, batch=cfg.batch // n_o) if n_o > 1 else cfg


def _shard_of(s_max: int, n: int) -> int:
    """Per-rank sequence shard; positions past ``(s_max // n) * n`` would
    be owned by no rank, so require even division."""
    if s_max % n != 0:
        raise ValueError(f"s_max={s_max} must divide evenly over {n} PEs")
    return s_max // n


def _local_lens(pos_h: np.ndarray, me: int, s_shard: int) -> np.ndarray:
    """Per-rank valid prefix per sequence: positions are global; rank
    `me`'s shard covers ``[me * s_shard, (me+1) * s_shard)``."""
    return np.clip(pos_h + 1 - me * s_shard, 0, s_shard).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class _StepPlan:
    """What one decode step's cache writes and attention need, computed once
    for all layers from the step's positions: the owned rows (positions
    below ``s_max``; a slice when every row owns its position), where each
    owned row's new k/v lands in one layer's cache, and the valid lengths
    after the write."""

    rows: Any
    at: tuple
    lens: torch.Tensor


def _rows_and_lens(pos_h: np.ndarray, s_shard: int, me: int, device):
    """The rows whose position this rank owns (a slice when all do) and
    the rank's valid lengths (≙ ``_mask_store_and_lens``, ``:101``)."""
    own = pos_h // s_shard == me
    rows = slice(None) if own.all() else torch.as_tensor(np.flatnonzero(own), device=device)
    lens = torch.as_tensor(_local_lens(pos_h, me, s_shard), device=device)
    return rows, lens


@dataclasses.dataclass(frozen=True)
class _RangePlan:
    """What one ranged pass's cache writes and attention need, computed once
    for all layers from the range's first positions: the (sequence, range
    row) pairs whose position this rank owns (indices into the ``b * S``
    flattened rows), where each lands in one layer's cache, and the first
    positions on the device, from which the ranged attention entries derive
    each row's prefix."""

    src: torch.Tensor
    at: tuple
    pos0: torch.Tensor


def _owned_range(pos0_h: np.ndarray, S: int, s_shard: int, me: int):
    """Flat ``[b * S]`` indices of the range rows whose position rank `me`
    owns (ownership-gated appends: a position no rank owns, as every row
    of a slot parked at ``s_max``, is dropped), and those positions."""
    pos = pos0_h[:, None].astype(np.int64) + np.arange(S)[None, :]
    flat = np.flatnonzero(pos // s_shard == me)
    return flat, pos.reshape(-1)[flat]


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Contiguous cache: per layer ``[b, h_kv, s_max / world, d]`` on each
    rank (its sequence shard). The spec is also the cache STRATEGY:
    ``pre_step``, ``step_plan`` and ``update_and_attend`` are the only
    places decode touches the cache."""

    s_max: int

    def init(self, cfg: TransformerConfig, device, n: int = 1, n_o: int = 1) -> dict:
        """One rank's cache at world `n` (the sequence-parallel group); with
        `n_o` outer groups it holds its group's ``batch / n_o`` slots
        (≙ ``:123-136``)."""
        s_shard = _shard_of(self.s_max, n)
        if cfg.batch % n_o:
            raise ValueError(
                f"batch={cfg.batch} must divide over the {n_o} outer "
                f"(node) groups — each group owns a batch slice"
            )
        shape = (cfg.n_layers, cfg.batch // n_o, cfg.n_kv_heads, s_shard, cfg.head_dim)
        return dict(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        )

    def pre_step(self, cfg, cache: dict, pos_b, me: int = 0, n: int = 1) -> dict:
        return cache

    def step_plan(self, cfg, cache, pos_h: np.ndarray, pos_b, me: int = 0,
                  n: int = 1) -> _StepPlan:
        s_shard = _shard_of(self.s_max, n)
        rows, lens = _rows_and_lens(pos_h, s_shard, me, pos_b.device)
        bidx = torch.arange(cfg.batch, device=pos_b.device)
        return _StepPlan(rows, (bidx[rows], slice(None), pos_b[rows] % s_shard), lens)

    def update_and_attend(self, cfg, cache, li, k_new, v_new, q, plan, fd_config,
                          ctx=None):
        """The owning rank appends each sequence's k/v at ITS position
        (ragged); then SP flash decode over the valid prefixes. Returns
        ``(attn [b, hq, d] f32, cache)``."""
        kc, vc = cache["k"][li], cache["v"][li]
        kc[plan.at] = k_new[plan.rows].to(kc.dtype)
        vc[plan.at] = v_new[plan.rows].to(vc.dtype)
        attn = flash_decode_distributed(q.to(kc.dtype), kc, vc, plan.lens,
                                        config=fd_config, ctx=ctx)
        return attn, cache

    def range_plan(self, cfg, cache, pos0_h: np.ndarray, S: int, me: int, n: int,
                   device) -> _RangePlan:
        s_shard = _shard_of(self.s_max, n)
        flat, pos = _owned_range(pos0_h, S, s_shard, me)
        at = (torch.as_tensor(flat // S, device=device), slice(None),
              torch.as_tensor(pos % s_shard, device=device))
        return _RangePlan(torch.as_tensor(flat, device=device), at,
                          torch.as_tensor(pos0_h, device=device))

    def update_multi_and_attend(self, cfg, cache, li, k_new, v_new, q, plan, fd_config,
                                ctx=None):
        """Append S consecutive positions per sequence (owner-gated per
        position: a range may straddle shard boundaries), then the SP
        ranged attention (K13). k_new, v_new ``[b, S, h_kv, d]``; q ``[b,
        S, hq, d]``. Returns ``(attn [b, S, hq, d] f32, cache)``
        (≙ ``:178``)."""
        kc, vc = cache["k"][li], cache["v"][li]
        _append_range(kc, vc, k_new, v_new, plan)
        attn = flash_ranged_prefill_distributed(q.to(kc.dtype), kc, vc, plan.pos0,
                                                config=fd_config, ctx=ctx)
        return attn, cache


@dataclasses.dataclass(frozen=True)
class PagedKVCacheSpec:
    """Paged cache: on each rank a page POOL ``[L, n_pages, h_kv, page, d]``
    covering its sequence shard, plus a per-sequence block table ``[1, b,
    pages_per_seq]``. ``static_table``
    pre-assigns each slot its own page range (what continuous batching and
    the bulk prefill need); otherwise a bump allocator hands out a page the
    first time a position opens one."""

    s_max: int
    page_size: int
    static_table: bool = False
    # physical pages past the table-assigned ranges; the prefix cache
    # reserves one as the scratch page that released slots' rows park on,
    # so an idle slot's dummy decode write never lands on a reissued page
    extra_pages: int = 0

    def _geometry(self, cfg, n: int = 1, n_o: int = 1) -> tuple[int, int]:
        s_shard = _shard_of(self.s_max, n)
        if s_shard % self.page_size:
            raise ValueError(
                f"page_size={self.page_size} must divide the per-PE "
                f"sequence shard {s_shard}"
            )
        if cfg.batch % n_o:
            raise ValueError(
                f"batch={cfg.batch} must divide over the {n_o} outer "
                f"(node) groups — each group owns a batch slice"
            )
        pages_per_seq = s_shard // self.page_size
        return pages_per_seq, (cfg.batch // n_o) * pages_per_seq

    def init(self, cfg: TransformerConfig, device, n: int = 1, n_o: int = 1) -> dict:
        """One rank's pool, table and allocator at world `n` (the
        sequence-parallel group); with `n_o` outer groups the pool covers
        its group's ``batch / n_o`` slots (≙ ``:246-280``)."""
        pps, n_pages = self._geometry(cfg, n, n_o)
        b_att = cfg.batch // n_o
        shape = (cfg.n_layers, n_pages + self.extra_pages, cfg.n_kv_heads, self.page_size,
                 cfg.head_dim)
        if self.static_table:
            bt = (
                torch.arange(b_att, dtype=torch.int32, device=device)[:, None] * pps
                + torch.arange(pps, dtype=torch.int32, device=device)[None, :]
            )[None]
        else:
            bt = torch.zeros((1, b_att, pps), dtype=torch.int32, device=device)
        return dict(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            block_table=bt.contiguous(),
            n_alloc=torch.zeros((1,), dtype=torch.int32, device=device),
        )

    def pre_step(self, cfg, cache: dict, pos_b, me: int = 0, n: int = 1) -> dict:
        """Bump-allocate a physical page for each sequence whose position
        opens a new logical page on the owning rank (ragged: the needing
        sequences claim consecutive ids, in slot order)."""
        if self.static_table:
            return cache
        s_shard = _shard_of(self.s_max, n)
        off = pos_b % s_shard
        need = (pos_b // s_shard == me) & (off % self.page_size == 0)
        need_i = need.to(torch.int32)
        order = torch.cumsum(need_i, 0, dtype=torch.int32) - need_i
        bidx = torch.arange(cfg.batch, device=pos_b.device)
        page_idx = off // self.page_size
        bt = cache["block_table"]
        cur = bt[0, bidx, page_idx]
        bt[0, bidx, page_idx] = torch.where(need, cache["n_alloc"][0] + order, cur)
        cache["n_alloc"] += need.sum().to(torch.int32)
        return cache

    def step_plan(self, cfg, cache, pos_h: np.ndarray, pos_b, me: int = 0,
                  n: int = 1) -> _StepPlan:
        """Reads the block table after ``pre_step`` allocated this step's
        pages."""
        s_shard = _shard_of(self.s_max, n)
        rows, lens = _rows_and_lens(pos_h, s_shard, me, pos_b.device)
        off = pos_b[rows] % s_shard
        bidx = torch.arange(cfg.batch, device=pos_b.device)[rows]
        pages = cache["block_table"][0][bidx, off // self.page_size].long()
        return _StepPlan(rows, (pages, slice(None), off % self.page_size), lens)

    def update_and_attend(self, cfg, cache, li, k_new, v_new, q, plan, fd_config,
                          ctx=None):
        kc, vc = cache["k"][li], cache["v"][li]
        kc[plan.at] = k_new[plan.rows].to(kc.dtype)
        vc[plan.at] = v_new[plan.rows].to(vc.dtype)
        attn = paged_flash_decode_distributed(
            q.to(kc.dtype), kc, vc, plan.lens, cache["block_table"][0], ctx=ctx,
        )
        return attn, cache

    def range_plan(self, cfg, cache, pos0_h: np.ndarray, S: int, me: int, n: int,
                   device) -> _RangePlan:
        """Reads the block table: push the table before the plan."""
        if not self.static_table:
            raise NotImplementedError(
                "ranged prefill on the paged cache needs static_table=True "
                "(pre-assigned page ranges)"
            )
        s_shard = _shard_of(self.s_max, n)
        flat, pos = _owned_range(pos0_h, S, s_shard, me)
        off = pos % s_shard
        bidx = torch.as_tensor(flat // S, device=device)
        pages = cache["block_table"][0][
            bidx, torch.as_tensor(off // self.page_size, device=device)].long()
        at = (pages, slice(None), torch.as_tensor(off % self.page_size, device=device))
        return _RangePlan(torch.as_tensor(flat, device=device), at,
                          torch.as_tensor(pos0_h, device=device))

    def update_multi_and_attend(self, cfg, cache, li, k_new, v_new, q, plan, fd_config,
                                ctx=None):
        """The ranged append on the page pool, onto the slot's own pages
        only (the plan's pairs are owned positions; shared prefix pages lie
        below every range), then the paged ranged attention (K14) through
        the same table (≙ ``:359``)."""
        kc, vc = cache["k"][li], cache["v"][li]
        _append_range(kc, vc, k_new, v_new, plan)
        attn = paged_flash_ranged_prefill_distributed(
            q.to(kc.dtype), kc, vc, plan.pos0, cache["block_table"][0], ctx=ctx,
        )
        return attn, cache


def _append_range(kc, vc, k_new, v_new, plan: _RangePlan) -> None:
    b, S = k_new.shape[:2]
    kc[plan.at] = k_new.reshape(b * S, *k_new.shape[2:])[plan.src].to(kc.dtype)
    vc[plan.at] = v_new.reshape(b * S, *v_new.shape[2:])[plan.src].to(vc.dtype)


def decode_step(
    cfg: TransformerConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,   # [b] int — this step's input token per sequence
    pos,                    # int or [b] int on the host — position per sequence
    *,
    spec: KVCacheSpec | PagedKVCacheSpec,
    fd_config: FlashDecodeConfig | None = None,
    ctx=None,
) -> tuple[torch.Tensor, dict]:
    """One decode step of one rank (inside ``ctx.run``; ``ctx`` None is
    world 1): returns ``(logits [b, vocab], cache)``, the logits
    replicated. Positions are host data, so which rows this rank owns is
    decided on the host and the step never waits on the card; what depends
    only on the positions (RoPE tables, cache-write indices, valid lengths)
    is computed once for all layers.

    Hierarchical (``cfg.ep_outer`` on a 2-D runtime; ≙ ``:503-571``): the
    rank's outer group serves its batch slice (``tokens``, ``pos`` and the
    logits stay global), its cache holds that slice."""
    n_o, my_o = _outer_dims(cfg, ctx)
    c = _group_cfg(cfg, n_o)
    tp = _tp_of(ctx, cfg)
    n, me = axis_size(tp), axis_index(tp)
    if c.n_kv_heads % n:
        raise ValueError(f"n_kv_heads={c.n_kv_heads} must split over {n} ranks")
    g = c.n_q_heads // c.n_kv_heads
    d = c.head_dim
    hq_loc = c.n_q_heads // n
    dev = tokens.device
    pos_h = np.array(np.broadcast_to(np.asarray(pos, dtype=np.int64), (cfg.batch,)))
    rows_o = slice(my_o * c.batch, (my_o + 1) * c.batch)
    pos_h = pos_h[rows_o]
    pos_b = torch.as_tensor(pos_h, device=dev)
    tokens = tokens[rows_o].long()
    x = params["embed"][tokens]                          # [b, H] replicated
    cache = spec.pre_step(c, cache, pos_b, me, n)
    plan = spec.step_plan(c, cache, pos_h, pos_b, me, n)
    cos, sin = rope_tables(pos_b[:, None], d, c.rope_theta)
    for li, p in enumerate(params["layers"]):
        h = rmsnorm(x, p["attn_norm"], c.norm_eps)
        # head-complete qkv: rank-major concat == kv-group-major (the groups
        # are sharded contiguously)
        qkv = _all_gather(tp, h @ p["wqkv"].reshape(c.hidden, -1), dim=1)
        qkv = qkv.reshape(c.batch, c.n_kv_heads, g + 2, d)
        q = qkv[:, :, :g, :].reshape(c.batch, 1, c.n_q_heads, d)
        k_new = qkv[:, :, g, :].reshape(c.batch, 1, c.n_kv_heads, d)
        v_new = qkv[:, :, g + 1, :]                      # [b, h_kv, d]
        q = apply_rope(q, cos, sin)[:, 0]                # [b, hq, d]
        k_new = apply_rope(k_new, cos, sin)[:, 0]        # [b, h_kv, d]
        attn, cache = spec.update_and_attend(
            c, cache, li, k_new, v_new, q, plan, fd_config, tp
        )
        # row-parallel out-projection on the rank's head slice, then psum
        attn = attn[:, me * hq_loc:(me + 1) * hq_loc].reshape(c.batch, -1).to(x.dtype)
        x = x + _psum(tp, attn @ p["wo"])
        x = _decode_mlp(c, x, p, tp)
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    logits = _all_gather(tp, x @ params["lm_head"], dim=1)
    if n_o > 1:
        # back to the replicated [b, vocab]: the outer groups are batch-major
        logits = ctx.group(_outer_of(cfg)).all_gather(logits, 0)
    return logits, cache


def _decode_mlp(c, x: torch.Tensor, p: dict, ctx) -> torch.Tensor:
    """The MLP residual of a decode step on the ``[m, H]`` replicated rows
    (≙ ``_decode_mlp``, ``:407``): dense SwiGLU, or for the MoE decoder
    every expert's F shard on every row (dense einsums: at decode row counts
    every expert's weights stream anyway) and a one-hot top-k combine; then
    the ``psum`` of the rank's partial. The expert-parallel decoder
    dispatches each rank's ``m / world`` rows over the all-to-all instead
    (K27, the grouped GEMMs K8 or K24) and gathers the results.

    Quantized banks (``:456-478``): each pool is upcast to the activation
    dtype for its einsum and its scale multiplies the f32 result after the
    contraction (exact: the scale is constant over the contracted dim),
    before the GELU and before the combine. Eager PyTorch materialises each
    upcast bank every step where XLA fuses the convert into the dot."""
    m = x.shape[0]
    h = rmsnorm(x, p["mlp_norm"], c.norm_eps)
    if isinstance(c, EPMoETransformerConfig):  # before its base class, MoE
        # expert-parallel (``:414-444``): each rank dispatches its row slice
        # to the expert owners, and the combined slices are gathered back;
        # hierarchical, every rank of both axes is a source and a phase-1
        # slab holds at most one copy of a row
        n, me = axis_size(ctx), axis_index(ctx)
        if m % n:
            raise ValueError(f"EP serving decode shards its rows over the ranks: rows={m} "
                             f"must divide evenly over {n} ranks")
        m_loc = m // n
        hier = _outer_of(c) is not None
        y = ep_moe_apply(c, h[me * m_loc:(me + 1) * m_loc], p,
                         c.ep_max_m or (m_loc if hier else m_loc * c.topk), ctx=ctx)
        return x + _all_gather(ctx, y, dim=0).to(x.dtype)
    if not isinstance(c, MoETransformerConfig):
        gu = (h @ p["w_gate_up"].reshape(c.hidden, -1)).reshape(m, -1, 2)
        act = torch.nn.functional.silu(gu[..., 0].float()).to(x.dtype) * gu[..., 1]
        return x + _psum(ctx, act @ p["w_down"])
    tw, ids = select_experts(h.float() @ p["router"].float(), c.topk)    # [m, topk]
    quant = "w_up_scale" in p
    w_up = p["w_up"].to(h.dtype) if quant else p["w_up"]
    w_down = p["w_down"].to(x.dtype) if quant else p["w_down"]
    # matmul broadcasts h over the experts; einsum would copy the bank
    h_e = torch.matmul(h, w_up).float()                                  # [E, m, F/n]
    if quant:
        h_e = h_e * p["w_up_scale"]                                      # [E, 1, F/n]
    act = gelu(h_e).to(x.dtype)
    y_e = torch.einsum("ebf,efh->ebh", act, w_down).float()
    if quant:
        y_e = y_e * p["w_down_scale"]
    w_e = torch.zeros((m, c.n_experts), dtype=torch.float32, device=x.device)
    w_e.scatter_add_(1, ids.long(), tw)
    y = torch.einsum("be,ebh->bh", w_e, y_e)
    return x + _psum(ctx, y.to(x.dtype))


def _all_gather(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
    return x if ctx is None else ctx.all_gather(x, dim)


def _psum(ctx, x: torch.Tensor) -> torch.Tensor:
    return x if ctx is None else ctx.psum(x)


def prefill_cache(
    cfg, params, cache, prompt_flat, spec, s_max, slot_mask=None, pick=None, ctx=None
):
    """Bulk prefill of one rank (inside ``ctx.run``; ``ctx`` None is world
    1): the per-rank forward over this rank's token shard of the flattened
    prompt (``cfg.batch * cfg.seq`` tokens, batch-major, replicated in
    `prompt_flat`) writes every position's post-RoPE k/v into its owner's
    cache shard in one pass: the rank's heads are gathered to all heads
    (``:1584-1635``), and each rank keeps its sequence window ``[me *
    s_shard, (me+1) * s_shard)``, zero past the prompt. A paged cache needs
    the static table: each slot's page range is written whole. ``slot_mask
    [b] bool`` (host) restricts the write to chosen sequences; ``pick
    [b]`` chooses each sequence's logit row (default ``L-1``). Returns
    ``(cache, last_logits [b, vocab])``, the logits replicated.

    Hierarchical (``cfg.ep_outer``; ≙ ``:1503-1540``, ``:1566-1572``): the
    prompt shard is outer-major over both axes (``_prompt_shard``), so outer
    group ``o`` runs its sequences ``[o * b / n_o, (o+1) * b / n_o)`` and
    writes them to its caches; `slot_mask` and `pick` stay global, and so
    do the logits."""
    paged = isinstance(spec, PagedKVCacheSpec)
    if paged and not spec.static_table:
        raise ValueError(
            "paged prefill needs static_table=True (pre-assigned page "
            "ranges): the bump allocator cannot batch-claim a prompt"
        )
    n_o, my_o = _outer_dims(cfg, ctx)
    c = _group_cfg(cfg, n_o)
    rows_o = slice(my_o * c.batch, (my_o + 1) * c.batch)
    if slot_mask is not None:
        slot_mask = np.asarray(slot_mask)[rows_o]
    if pick is not None:
        pick = pick[rows_o]
    outer_ctx = ctx
    ctx = _tp_of(ctx, cfg)
    n, me = axis_size(ctx), axis_index(ctx)
    b, L = c.batch, c.seq
    if (b * L) % n:
        raise ValueError(f"prefill needs b*L={b * L} divisible over {n} PEs")
    s_shard = _shard_of(s_max, n)
    dev = prompt_flat.device
    m_loc = b * L // n
    # this rank's slice of the b-major prompt, outer-major over both axes
    r = my_o * n + me
    if isinstance(c, EPMoETransformerConfig):
        model_cls = EPMoETransformer
    elif isinstance(c, MoETransformerConfig):
        model_cls = TPMoETransformer
    else:
        model_cls = TPTransformer
    model = model_cls(c, kv_sink=[], ctx=ctx)
    logits = model(prompt_flat[r * m_loc:(r + 1) * m_loc].long(), params)  # [b*L, V/n]
    sel = torch.as_tensor(
        np.arange(b) if slot_mask is None else np.flatnonzero(np.asarray(slot_mask)),
        device=dev,
    )
    lo, hi = me * s_shard, min(L, (me + 1) * s_shard)
    for li, (k_l, v_l) in enumerate(model.kv_sink):
        kd = cache["k"].dtype
        k_l = _all_gather(ctx, k_l, dim=2)                 # [b, L, h_kv, d]
        v_l = _all_gather(ctx, v_l, dim=2)
        # [b, L, h_kv, d] → this rank's window, zero past L
        k_new = torch.zeros((b, c.n_kv_heads, s_shard, c.head_dim), dtype=kd, device=dev)
        v_new = torch.zeros_like(k_new)
        if hi > lo:
            k_new[:, :, :hi - lo] = k_l[:, lo:hi].transpose(1, 2)
            v_new[:, :, :hi - lo] = v_l[:, lo:hi].transpose(1, 2)
        if paged:
            ps = spec.page_size
            pps = s_shard // ps
            kp = k_new.reshape(b, c.n_kv_heads, pps, ps, c.head_dim).transpose(1, 2)
            vp = v_new.reshape(b, c.n_kv_heads, pps, ps, c.head_dim).transpose(1, 2)
            ids = cache["block_table"][0][sel].long().reshape(-1)
            cache["k"][li, ids] = kp[sel].reshape(-1, *kp.shape[2:])
            cache["v"][li, ids] = vp[sel].reshape(-1, *vp.shape[2:])
        else:
            cache["k"][li, sel] = k_new[sel]
            cache["v"][li, sel] = v_new[sel]
    if pick is None:
        pick = torch.full((b,), L - 1, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev) * L + torch.clamp(pick.to(dev).long(), 0, L - 1)
    # the row is picked BEFORE the vocab gather: only [b, V] materializes
    last = _all_gather(ctx, logits[rows], dim=1)
    if n_o > 1:
        last = outer_ctx.group(_outer_of(cfg)).all_gather(last, 0)
    return cache, last


def prefill_cache_ranged(
    cfg: TransformerConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,   # [b, S] int — range inputs per sequence
    pos0,                   # int or [b] int on the host — first range position
    *,
    spec: KVCacheSpec | PagedKVCacheSpec,
    fd_config: FlashDecodeConfig | None = None,
    ctx=None,
) -> tuple[torch.Tensor, dict]:
    """Suffix-only ranged prefill of one rank (inside ``ctx.run``; ``ctx``
    None is world 1; ≙ ``prefill_cache_ranged``, ``:1647``): the forward
    over a prompt range ``[pos0, pos0 + S)`` of every sequence, attending
    the KV already landed below it — each row's causal prefix comes from
    the ranged attention entries (K13/K14, via the spec's
    ``update_multi_and_attend``). Returns ``(logits [b, S, vocab], cache)``,
    the logits replicated: row i is the next-token distribution after
    ``..., tokens[:, i]``, what S successive :func:`decode_step` calls
    would give. Composing consecutive ranges gives every row the same mask
    as one whole-range pass.

    It is the decode step's forward on ``m = b * S`` replicated rows: the
    projections are ``h @ W`` on the rank's weight shard (the JAX package
    leaves them to XLA), with the qkv head all-gather, the ``wo`` and MLP
    ``psum`` and the vocab all-gather of the logits; the MLP is
    :func:`_decode_mlp`, so the MoE decoder rides the same path. The
    positions are host data: which rows this rank owns, where they land
    and the RoPE tables are computed once for all layers. A paged cache
    needs the static table. Hierarchical configs run per outer group as in
    :func:`decode_step` (≙ ``:1682-1700``); the logits stay global."""
    n_o, my_o = _outer_dims(cfg, ctx)
    c = _group_cfg(cfg, n_o)
    outer_ctx = ctx
    ctx = _tp_of(ctx, cfg)
    n, me = axis_size(ctx), axis_index(ctx)
    if c.n_kv_heads % n:
        raise ValueError(f"n_kv_heads={c.n_kv_heads} must split over {n} ranks")
    if tokens.shape[0] != cfg.batch:
        raise ValueError(f"tokens batch {tokens.shape[0]} != cfg.batch {cfg.batch}")
    rows_o = slice(my_o * c.batch, (my_o + 1) * c.batch)
    tokens = tokens[rows_o]
    b, S = tokens.shape
    g, d = c.n_q_heads // c.n_kv_heads, c.head_dim
    hq_loc = c.n_q_heads // n
    m = b * S
    dev = tokens.device
    pos0_h = np.array(np.broadcast_to(np.asarray(pos0, dtype=np.int64), (cfg.batch,)))[rows_o]
    pos_flat = torch.as_tensor((pos0_h[:, None] + np.arange(S)[None, :]).reshape(-1),
                               device=dev)
    plan = spec.range_plan(c, cache, pos0_h, S, me, n, dev)
    cos, sin = rope_tables(pos_flat[:, None], d, c.rope_theta)
    x = params["embed"][tokens.reshape(-1).long()]          # [m, H] b-major
    for li, p in enumerate(params["layers"]):
        h = rmsnorm(x, p["attn_norm"], c.norm_eps)
        qkv = _all_gather(ctx, h @ p["wqkv"].reshape(c.hidden, -1), dim=1)
        qkv = qkv.reshape(m, c.n_kv_heads, g + 2, d)
        q = qkv[:, :, :g, :].reshape(m, 1, c.n_q_heads, d)
        k_new = qkv[:, :, g, :].reshape(m, 1, c.n_kv_heads, d)
        v_new = qkv[:, :, g + 1, :]                          # [m, h_kv, d]
        q = apply_rope(q, cos, sin)[:, 0]                    # [m, hq, d]
        k_new = apply_rope(k_new, cos, sin)[:, 0]            # [m, h_kv, d]
        attn, cache = spec.update_multi_and_attend(
            c, cache, li, k_new.reshape(b, S, c.n_kv_heads, d),
            v_new.reshape(b, S, c.n_kv_heads, d), q.reshape(b, S, c.n_q_heads, d),
            plan, fd_config, ctx,
        )                                                    # [b, S, hq, d] f32
        attn = attn.reshape(m, c.n_q_heads, d)[:, me * hq_loc:(me + 1) * hq_loc]
        x = x + _psum(ctx, attn.reshape(m, -1).to(x.dtype) @ p["wo"])
        x = _decode_mlp(c, x, p, ctx)
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    logits = _all_gather(ctx, x @ params["lm_head"], dim=1).reshape(b, S, -1)
    if n_o > 1:
        logits = outer_ctx.group(_outer_of(cfg)).all_gather(logits, 0)
    return logits, cache


def _make_spec(s_max, page_size, fd_config, static_table, extra_pages=0):
    if page_size and fd_config is not None:
        raise ValueError(
            "fd_config tiles the contiguous kernel; with page_size the page "
            "is the block — pass one or the other"
        )
    if page_size:
        return PagedKVCacheSpec(s_max, page_size, static_table=static_table,
                                extra_pages=extra_pages)
    return KVCacheSpec(s_max)


class _Ranks:
    """The per-rank parameters and caches of a serving loop, and how one
    step runs on every rank: directly at world 1 (``ctx`` None), through
    ``ctx.run`` otherwise, where each rank's step builds its inputs on its
    own device and the replicated output of rank 0 is returned."""

    def __init__(self, cfg, params: dict, spec, device: torch.device, ctx=None):
        self.ctx = ctx
        n_o = _mesh_outer(cfg, ctx)
        if ctx is None:
            self.devices = [device]
            self.params = [_to_device(params, device)]
        else:
            if ctx.device.type != device.type:
                raise ValueError(
                    f"the rank runtime runs on {ctx.device.type}, the batcher "
                    f"was asked for {device}"
                )
            self.devices = ctx.devices
            self.params = shard_params(params, cfg=cfg, ctx=ctx)
        n = axis_size(ctx, None if ctx is None else cfg.axis)
        self.caches = [spec.init(cfg, d, n, n_o) for d in self.devices]

    def run(self, step):
        """``step(params, cache, device) -> (cache, out)`` on every rank;
        returns rank 0's ``out``."""
        if self.ctx is None:
            with torch.inference_mode():
                self.caches[0], out = step(self.params[0], self.caches[0], self.devices[0])
            return out

        def body():
            r = self.ctx.rank
            return step(self.params[r], self.caches[r], self.devices[r])

        results = self.ctx.run(body)
        self.caches = [cache for cache, _ in results]
        return results[0][1]


def generate(
    cfg: TransformerConfig,
    params: dict,
    prompt,              # [b, prompt_len] int
    n_steps: int,
    *,
    s_max: int,
    page_size: int | None = None,
    fd_config: FlashDecodeConfig | None = None,
    prefill: bool = False,
    device=None,
    ctx=None,
) -> torch.Tensor:
    """Greedy generation: process the prompt (token by token, or in one
    bulk forward with ``prefill=True``), then decode ``n_steps`` new
    tokens. Returns ``[b, n_steps]`` int32 on `device`. ``ctx`` (a rank
    runtime) serves at its world; ``None`` is world 1. A hierarchical
    config (``cfg.ep_outer``) needs a runtime with both axes (≙
    ``:635-650``)."""
    dev = resolve_device(device)
    prompt_h = np.asarray(prompt).astype(np.int64)
    b, prompt_len = prompt_h.shape
    if b != cfg.batch:
        raise ValueError(f"prompt batch {b} != cfg.batch {cfg.batch}")
    if prompt_len + n_steps > s_max:
        raise ValueError(
            f"prompt_len={prompt_len} + n_steps={n_steps} exceeds the KV "
            f"cache capacity s_max={s_max}"
        )
    spec = _make_spec(s_max, page_size, fd_config, static_table=prefill)
    _mesh_outer(cfg, ctx)
    n_all = axis_size(ctx)
    if prefill and (b * prompt_len) % n_all:
        raise ValueError(
            f"prefill needs b*prompt_len={b * prompt_len} divisible "
            f"over {n_all} PEs (the prompt shard is the model's "
            f"token shard)"
        )
    ranks = _Ranks(cfg, params, spec, dev, ctx)

    def step_fn(tok, i):
        def step(p, cache, d):
            logits, cache = decode_step(
                cfg, p, cache, torch.as_tensor(tok, device=d), i, spec=spec,
                fd_config=fd_config, ctx=ctx,
            )
            return cache, logits.argmax(dim=-1).cpu().numpy()
        return step

    outs = []
    if prefill:
        pcfg = dataclasses.replace(cfg, seq=prompt_len)

        def first(p, cache, d):
            cache, last = prefill_cache(
                pcfg, p, cache, torch.as_tensor(prompt_h.reshape(-1), device=d), spec,
                s_max, ctx=ctx,
            )
            return cache, last.argmax(dim=-1).cpu().numpy()

        tok = ranks.run(first)
        outs.append(tok)
        for i in range(n_steps - 1):
            tok = ranks.run(step_fn(tok, prompt_len + i))
            outs.append(tok)
        out = np.stack(outs, axis=1)[:, :n_steps]
    else:
        tok = prompt_h[:, 0]
        for i in range(prompt_len + n_steps - 1):
            nxt = ranks.run(step_fn(tok, i))
            outs.append(nxt)
            tok = prompt_h[:, i + 1] if i + 1 < prompt_len else nxt
        out = np.stack(outs[prompt_len - 1:], axis=1)
    return torch.as_tensor(out.astype(np.int32), device=dev)


def _to_device(params: dict, dev: torch.device) -> dict:
    return dict(
        embed=params["embed"].to(dev),
        layers=[{k: v.to(dev) for k, v in p.items()} for p in params["layers"]],
        final_norm=params["final_norm"].to(dev),
        lm_head=params["lm_head"].to(dev),
    )


@dataclasses.dataclass
class Request:
    """One generation request for :class:`ContinuousBatcher`.

    Sampling: greedy by default; ``temperature > 0`` samples from the
    softmax (optionally truncated to the ``top_k`` most likely tokens),
    reproducibly per request via ``seed`` — each slot owns an independent
    numpy RNG, so a request's tokens do not depend on what shares the batch
    with it. ``rng`` overrides the seed-derived RNG with a live
    ``np.random.Generator``."""

    prompt: list            # token ids, len >= 1
    max_new_tokens: int
    eos_id: int | None = None
    temperature: float = 0.0
    top_k: int | None = None
    seed: int | None = None
    uid: Any = None
    rng: Any = None

    def dist(self, logits) -> np.ndarray:
        """The sampling distribution (float64 probs) for a [vocab] f32 logit
        row. Requires ``temperature > 0``."""
        z = logits.astype(np.float64) / self.temperature
        if self.top_k is not None:
            k = min(self.top_k, len(z))
            keep = np.argpartition(z, -k)[-k:]   # exactly k indices: ties
            mask = np.full_like(z, -np.inf)      # beyond k drop, so top_k=1
            mask[keep] = z[keep]                 # stays greedy
            z = mask
        z -= z.max()
        probs = np.exp(z)
        probs /= probs.sum()
        return probs

    def sample(self, logits, rng) -> int:
        """Pick the next token from a [vocab] f32 logit row."""
        if self.temperature <= 0.0:
            return int(logits.argmax())
        probs = self.dist(logits)
        return int(rng.choice(len(probs), p=probs))


class StepsExhaustedError(RuntimeError):
    """``ContinuousBatcher.run`` spent its step budget with work still in
    flight. Finished generations stay drainable via
    :meth:`ContinuousBatcher.drain_finished`."""

    def __init__(self, max_steps: int, pending_uids, finished_uids):
        self.max_steps = int(max_steps)
        self.pending_uids = tuple(pending_uids)
        self.finished_uids = tuple(finished_uids)
        super().__init__(
            f"run(max_steps={max_steps}) exhausted with requests still "
            f"in flight: {list(self.pending_uids)}; "
            f"{len(self.finished_uids)} finished generation(s) "
            f"{list(self.finished_uids)} are retained — collect them with "
            f"drain_finished()"
        )


class ContinuousBatcher:
    """Continuous batching over the ragged decode step: the device runs one
    decode step for every slot (static shapes, per-slot positions); the host
    picks each slot's next token (prompt feed, argmax or sample), admits
    queued requests into free slots, and collects finished sequences.
    ``prefill=True`` admits a prompt in one bulk forward (K1 GEMMs at world
    1, K6/K7 at world > 1) instead of token by token; ``page_size`` selects
    the paged cache (K3 decode), otherwise the contiguous one (K2). With
    ``ctx`` (a rank runtime, ``parallel/mesh.py``) every device step runs
    on all its ranks over sharded weights and a sequence-sharded cache;
    ``None`` is world 1. A hierarchical config (``cfg.ep_outer``) serves
    on a 2-D runtime with axes ``(ep_outer, cfg.axis)``: each outer group
    its batch slice (≙ ``:823-851``).

    ``prefill_chunk_tokens`` (with ``prefill=True``): a prompt longer than
    this is admitted in bounded ranged chunks (:func:`prefill_cache_ranged`,
    K13/K14), one per step between decode steps, while its slot is parked at
    ``pos = s_max`` (owned by no rank: its dummy decode writes drop).
    ``prefix_cache`` (a :class:`~triton_dist_tpu_torch.models.prefix_cache.
    PrefixCacheConfig`, paged cache only): admission takes the longest
    prefix of whole pages the trie already holds and feeds only the rest —
    token by token, or with ``prefill=True`` through one ranged pass (or
    chunks) from the first unshared position; a miss rides the same ranged
    pass from 0, so a hit gives the tokens of its miss.

        batcher = ContinuousBatcher(cfg, params, s_max=256)
        batcher.submit(Request([1, 2, 3], max_new_tokens=8))
        done = batcher.run()
    """

    def __init__(
        self,
        cfg: TransformerConfig,
        params: dict,
        *,
        s_max: int,
        page_size: int | None = None,
        fd_config: FlashDecodeConfig | None = None,
        prefill: bool = False,
        prefill_chunk_tokens: int | None = None,
        prefix_cache: Any = None,
        device=None,
        ctx=None,
    ):
        if prefix_cache is not None:
            prefix_cache.validate()
            if not page_size:
                raise ValueError(
                    "prefix_cache shares refcounted chains of PHYSICAL "
                    "pages — it needs the paged cache (pass page_size)"
                )
        if prefill_chunk_tokens is not None:
            if not prefill:
                raise ValueError(
                    "prefill_chunk_tokens bounds the ranged chunks of bulk "
                    "admission — it needs prefill=True (token-fed admission "
                    "already interleaves one token per step)"
                )
            if prefill_chunk_tokens < 1:
                raise ValueError("prefill_chunk_tokens must be >= 1")
        self.device = resolve_device(device)
        self.cfg, self.s_max = cfg, s_max
        self.ctx = ctx
        self.world = axis_size(ctx)
        if prefix_cache is not None and _mesh_outer(cfg, ctx) > 1:
            raise ValueError(
                "prefix_cache supports flat (1-axis) serving meshes: "
                "a hierarchical deployment shards the page pool per "
                "outer batch group, so one trie cannot name pages "
                "across groups"
            )
        self.prefill = prefill
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self._fd_config = fd_config
        # static tables: slots reset mid-run, which the bump allocator
        # cannot reclaim
        self.spec = _make_spec(s_max, page_size, fd_config, static_table=True,
                               extra_pages=1 if prefix_cache is not None else 0)
        self._ranks = _Ranks(cfg, params, self.spec, self.device, ctx)
        self._buckets: set[int] = set()
        # chunked prefill: slot -> next unfed prompt position
        self._chunk: dict[int, int] = {}
        # cumulative real prompt tokens through the bulk and ranged prefill,
        # and the prefill WORK in swept query x key token pairs that the
        # serving engine's prefill charge bills: bucket x bucket per bulk
        # admission, chunk bucket x hi per ranged pass
        self.prefill_tokens_total = 0
        self.prefill_work_total = 0
        b = cfg.batch
        self.pos = np.zeros(b, np.int32)        # next write position per slot
        self.tok = np.zeros(b, np.int32)        # next input token per slot
        self.slot_req: list[Request | None] = [None] * b
        self.slot_rng: list[Any] = [None] * b
        self.slot_fed: list[int] = [0] * b      # prompt tokens already fed
        self.slot_out: list[list] = [[] for _ in range(b)]
        self.queue: list[Request] = []
        self.finished: list[tuple[Any, list]] = []
        # the radix prefix cache: a host-managed block table over the pool
        self._px = None
        self._px_dirty = False
        if prefix_cache is not None:
            from triton_dist_tpu_torch.models.prefix_cache import PagePrefixCache

            self._px = PagePrefixCache(
                prefix_cache, n_slots=b, page=page_size,
                pps_local=(s_max // self.world) // page_size, n_pes=self.world,
            )
            self._px_dirty = True   # park every row on scratch before step 1

    def validate_request(self, req: Request) -> None:
        """Admissibility checks (the serving engine runs them at enqueue)."""
        if not req.prompt:
            raise ValueError("empty prompt (need at least one token)")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.top_k is not None and req.top_k < 1:
            raise ValueError("top_k must be >= 1 (or None)")
        if len(req.prompt) + req.max_new_tokens > self.s_max:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new {req.max_new_tokens} "
                f"exceeds s_max={self.s_max}"
            )

    def submit(self, req: Request) -> None:
        self.validate_request(req)
        self.queue.append(req)

    @property
    def cache(self) -> dict:
        """Rank 0's cache (at world 1, the cache)."""
        return self._ranks.caches[0]

    def _bucket(self, length: int) -> int:
        """Padded prompt length: the next power of two, capped at s_max,
        with ``batch * bucket`` divisible over the ranks (the prompt's
        token shard)."""
        n, b = self.world, self.cfg.batch
        bucket = 1
        while bucket < self.s_max and (bucket < length or (b * bucket) % n):
            bucket *= 2
        bucket = min(bucket, self.s_max)
        if bucket < length or (b * bucket) % n:
            raise ValueError(
                f"no prefill bucket <= s_max={self.s_max} fits prompt "
                f"length {length} with b*bucket divisible over {n} PEs"
            )
        return bucket

    def _push_px_table(self) -> None:
        """Copy the prefix cache's block table (admissions repointed rows at
        shared chains and fresh private pages, releases parked rows on
        scratch) into each rank's cache, on the rank's own stream. It must
        land before any pass whose cache writes or attention read it."""
        table = self._px.table

        def push(params, cache, dev):
            cache["block_table"] = torch.tensor(table[axis_index(self.ctx)][None], device=dev)
            return cache, None

        self._ranks.run(push)
        self._px_dirty = False

    def _ranged_pass(self, i: int, req: Request, lo: int, hi: int) -> None:
        """One suffix-only ranged pass for slot ``i`` over prompt positions
        ``[lo, hi)``, padded to a power-of-two chunk bucket (the pad rows of
        the target slot write junk KV at positions ``>= hi``, which the next
        chunk or decode step overwrites before any length exposes it); every
        other slot is parked at ``pos0 = s_max``. When ``hi`` reaches the
        prompt's end, the first token samples from position ``L - 1``'s
        row, as in :meth:`_admit_prefill`."""
        L, S = len(req.prompt), hi - lo
        bucket = 1
        while bucket < S:
            bucket *= 2
        tokens = np.zeros((self.cfg.batch, bucket), np.int64)
        tokens[i, :S] = req.prompt[lo:hi]
        pos0 = np.full(self.cfg.batch, self.s_max, np.int64)  # parked rows
        pos0[i] = lo
        if self._px is not None and self._px_dirty:
            self._push_px_table()

        def ranged(params, cache, dev):
            logits, cache = prefill_cache_ranged(
                self.cfg, params, cache, torch.as_tensor(tokens, device=dev), pos0,
                spec=self.spec, fd_config=self._fd_config, ctx=self.ctx,
            )
            return cache, logits[i, S - 1].float().cpu().numpy() if hi == L else None

        last_i = self._ranks.run(ranged)
        self.prefill_tokens_total += S
        self.prefill_work_total += bucket * hi
        if self._px is not None:
            # publish-on-completion, batch form: every prompt page fully
            # covered by [0, hi) enters the trie now
            pg = self._px.page
            while True:
                g = self._px.next_publish(i)
                if (g + 1) * pg > hi or (g + 1) * pg > L:
                    break
                if self._px.publish(i, g, req.prompt[g * pg:(g + 1) * pg]):
                    self._px_dirty = True
        if hi == L:
            self._first_token(i, req, last_i)

    def _admit_ranged(self, i: int, req: Request, lo: int) -> None:
        """Feed prompt positions ``[lo, L)`` (the suffix past a trie hit, or
        the whole prompt) through one ranged pass, or park the slot for
        bounded chunks when ``prefill_chunk_tokens`` is set and shorter."""
        ct = self.prefill_chunk_tokens
        if ct is not None and len(req.prompt) - lo > ct:
            self._chunk[i] = lo
            self.pos[i] = self.s_max      # parked: owned by no rank
            self.tok[i] = 0
            self.slot_fed[i] = 0
            return
        self._ranged_pass(i, req, lo, len(req.prompt))

    def _admit_prefill(self, i: int, req: Request) -> None:
        """One masked full-forward pass writes slot ``i``'s whole prompt KV
        and yields its first generated token."""
        L = len(req.prompt)
        bucket = self._bucket(L)
        prompt = np.zeros((self.cfg.batch, bucket), np.int64)
        prompt[i, :L] = req.prompt
        pick = np.zeros(self.cfg.batch, np.int64)
        pick[i] = L - 1
        pcfg = dataclasses.replace(self.cfg, seq=bucket)

        def admit(params, cache, dev):
            cache, last = prefill_cache(
                pcfg, params, cache, torch.as_tensor(prompt.reshape(-1), device=dev),
                self.spec, self.s_max, slot_mask=np.arange(self.cfg.batch) == i,
                pick=torch.as_tensor(pick, device=dev), ctx=self.ctx,
            )
            return cache, last[i].float().cpu().numpy()

        last_i = self._ranks.run(admit)
        self._buckets.add(bucket)
        self.prefill_tokens_total += L
        self.prefill_work_total += bucket * bucket
        self._first_token(i, req, last_i)

    def _first_token(self, i: int, req: Request, last_i: np.ndarray) -> None:
        """Complete a bulk or ranged admission: sample the first token from
        the prompt's last logit row."""
        L = len(req.prompt)
        t0 = req.sample(last_i, self.slot_rng[i])
        self.slot_fed[i] = L
        self.slot_out[i] = [t0]
        self.tok[i] = t0
        self.pos[i] = L
        if len(self.slot_out[i]) >= req.max_new_tokens or (
            req.eos_id is not None and t0 == req.eos_id
        ):
            self._finish(i, req)

    def _finish(self, i: int, req: Request) -> None:
        self.finished.append((req.uid, self.slot_out[i]))
        self.slot_req[i] = None
        if self._px is not None:
            self._px.release(i)
            self._px_dirty = True

    def _admit(self) -> None:
        # an admission can free the slot it just filled (max_new_tokens=1 or
        # instant EOS): re-pass until a full sweep admits nothing
        admitted = True
        while admitted and self.queue:
            admitted = False
            for i, r in enumerate(self.slot_req):
                if r is None and self.queue:
                    req = self.queue.pop(0)
                    admitted = True
                    self.slot_req[i] = req
                    self.slot_out[i] = []
                    self.slot_rng[i] = (
                        req.rng if req.rng is not None
                        else np.random.default_rng(req.seed)
                    )
                    if self.prefill and len(req.prompt) > 1:
                        if self._px is not None:
                            # the trie hit's pages are the ranged pass's
                            # prior; a miss runs the same pass from 0
                            n_hit = self._px.acquire(i, req.prompt, req.max_new_tokens)
                            self._px_dirty = True
                            self._admit_ranged(i, req, n_hit)
                        elif (self.prefill_chunk_tokens is not None
                              and len(req.prompt) > self.prefill_chunk_tokens):
                            self._admit_ranged(i, req, 0)
                        else:
                            self._admit_prefill(i, req)
                    elif self._px is not None:
                        # token-fed: the feed starts at the first token whose
                        # KV the trie does not hold; the divergent page
                        # onward is private (copy-on-write)
                        n_hit = self._px.acquire(i, req.prompt, req.max_new_tokens)
                        self._px_dirty = True
                        self.pos[i] = n_hit
                        self.tok[i] = req.prompt[n_hit]
                        self.slot_fed[i] = n_hit + 1
                    else:
                        self.pos[i] = 0
                        self.tok[i] = req.prompt[0]
                        self.slot_fed[i] = 1

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    @property
    def n_free_slots(self) -> int:
        """Slots a new submission could claim: idle slots minus what the
        admission queue will absorb first."""
        free = sum(r is None for r in self.slot_req)
        return max(0, free - len(self.queue))

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def prefill_bucket_count(self) -> int:
        """Distinct padded prefill lengths run so far (the JAX package
        compiles one program per bucket; the gauge keeps its meaning)."""
        return len(self._buckets)

    def drain_finished(self) -> list[tuple[Any, list]]:
        """Hand over (and clear) every finished ``(uid, tokens)``."""
        out, self.finished = self.finished, []
        return out

    def prefix_cache_stats(self) -> dict | None:
        """The prefix cache's counters and gauges, or None when disarmed."""
        return None if self._px is None else self._px.stats()

    @property
    def prefix_cache(self):
        """The live :class:`~triton_dist_tpu_torch.models.prefix_cache.
        PagePrefixCache`, or None."""
        return self._px

    def step(self) -> None:
        """One ragged decode step for every slot + host scheduling: first
        one bounded ranged chunk for each slot admitted in chunks."""
        self._admit()
        if self.idle:
            return
        self._chunk_pass()
        self._decode_round()

    def _chunk_pass(self) -> None:
        # decode rows never mix across the batch, so a chunk pass leaves
        # every neighbour's stream as it was
        for i in sorted(self._chunk):
            req = self.slot_req[i]
            lo = self._chunk[i]
            hi = min(lo + self.prefill_chunk_tokens, len(req.prompt))
            if hi < len(req.prompt):
                self._chunk[i] = hi
            else:
                del self._chunk[i]    # final chunk: _ranged_pass admits
            self._ranged_pass(i, req, lo, hi)

    def _publish_step(self, i: int, req: Request) -> None:
        # publish-on-completion: a prompt page enters the trie once its last
        # position's KV is written; pages touching generated positions stay
        # private
        p, pg = int(self.pos[i]), self._px.page
        if p % pg == 0:
            g = p // pg - 1
            if g == self._px.next_publish(i) and (g + 1) * pg <= len(req.prompt):
                if self._px.publish(i, g, req.prompt[g * pg:(g + 1) * pg]):
                    self._px_dirty = True

    def _decode_round(self) -> None:
        if self._px is not None and self._px_dirty:
            self._push_px_table()
        tok, pos = self.tok.copy(), self.pos.copy()
        # greedy slots need only the argmax; the full logit rows cross to
        # the host only when an active request samples
        sampling = any(
            r is not None and r.temperature > 0.0
            and self.slot_fed[i] >= len(r.prompt)
            for i, r in enumerate(self.slot_req)
        )

        def step(params, cache, dev):
            logits, cache = decode_step(
                self.cfg, params, cache, torch.as_tensor(tok, device=dev), pos,
                spec=self.spec, fd_config=self._fd_config, ctx=self.ctx,
            )
            nxt = logits.argmax(dim=-1).cpu().numpy()
            return cache, (nxt, logits.float().cpu().numpy() if sampling else None)

        nxt, logits_h = self._ranks.run(step)
        for i, req in enumerate(self.slot_req):
            if req is None or i in self._chunk:
                # an idle slot decoded a dummy token; a slot parked between
                # chunks decoded at s_max (nothing written): ignore both
                continue
            if self.slot_fed[i] < len(req.prompt):
                self.tok[i] = req.prompt[self.slot_fed[i]]
                self.slot_fed[i] += 1
            else:
                t = (
                    int(nxt[i]) if req.temperature <= 0.0
                    else req.sample(logits_h[i], self.slot_rng[i])
                )
                self.slot_out[i].append(t)
                self.tok[i] = t
                if len(self.slot_out[i]) >= req.max_new_tokens or (
                    req.eos_id is not None and t == req.eos_id
                ):
                    self._finish(i, req)
                    continue
            self.pos[i] += 1
            if self._px is not None:
                self._publish_step(i, req)

    def run(self, max_steps: int = 100000) -> list[tuple[Any, list]]:
        """Drive until every queued request finishes; returns ``[(uid,
        tokens), ...]`` in completion order, or raises
        :class:`StepsExhaustedError`."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        if not self.idle:
            pending = [r.uid for r in self.slot_req if r is not None] + [
                r.uid for r in self.queue
            ]
            raise StepsExhaustedError(
                max_steps, pending, [uid for uid, _ in self.finished]
            )
        return self.drain_finished()
