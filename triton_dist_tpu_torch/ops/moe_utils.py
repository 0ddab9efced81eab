"""MoE routing and token alignment (≙ ``triton_dist_tpu/ops/moe_utils.py``):
top-k routing, the block-aligned token order the grouped GEMMs consume,
its per-rank form for the overlapped kernels, and the gathers that move
rows into and out of that order.

The JAX package does all of this in XLA (sorts, scans, gathers); here it
is plain PyTorch, with no host synchronisation on the card: counts come
from ``scatter_add_``, block owners from ``searchsorted``, and every
shape is static. The padded row count is the worst case
``round_up(T + E * (block_m - 1), block_m)``; padding rows carry the
sentinel assignment id ``T``, gathers clamp them to a real row so every
padded row holds finite values, and the combines give them zero weight.
"""

from __future__ import annotations

import dataclasses

import torch


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def select_experts(logits: torch.Tensor, topk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax + top-k routing (≙ ``select_experts``, ``:29``). logits
    ``[tokens, E]`` → ``(weights [tokens, topk] f32, renormalised over the
    chosen experts; ids [tokens, topk] int32)``. Ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, not ``torch.topk``, whose order among equal values is
    unspecified."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :topk], ids[:, :topk]
    return weights / weights.sum(dim=-1, keepdim=True), ids.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class MoEAlignment:
    """Block-aligned token order for the grouped GEMM (≙ ``MoEAlignment``).

    sorted_token_ids: ``[t_pad]`` int32 — the flat assignment index
      (``token * topk + k``) of each padded row; sentinel ``T`` for padding.
    expert_ids: ``[t_pad // block_m]`` int32 — the owning expert of each
      row block (every block holds one expert's rows).
    num_tokens_post_pad: scalar int32 — rows inside the experts' padded
      segments.
    valid_rows: ``[t_pad // block_m]`` int32 or None — the ragged map: the
      live rows of each block (a prefix of it; 0 for the trailing blocks
      past every segment), None under the padded contract. The ragged
      grouped GEMMs skip what lies past it and write it as zeros.
    """

    sorted_token_ids: torch.Tensor
    expert_ids: torch.Tensor
    num_tokens_post_pad: torch.Tensor
    valid_rows: torch.Tensor | None = None

    @property
    def block_m(self) -> int:
        return self.sorted_token_ids.shape[0] // self.expert_ids.shape[0]


def moe_align_block_size(
    topk_ids: torch.Tensor, n_experts: int, block_m: int, *, ragged: bool = False
) -> MoEAlignment:
    """Sort assignments by expert, each expert's segment padded to a
    multiple of `block_m` (≙ ``moe_align_block_size``, ``:73``). topk_ids
    ``[T]`` flat assignments; a stable sort keeps token order within an
    expert; blocks past every segment keep a clamped (valid) expert id.
    ``ragged`` also builds the ``valid_rows`` map (``:116-126``): how far
    each block's expert's real rows reach into it, on the device."""
    dev = topk_ids.device
    t = topk_ids.shape[0]
    t_pad = round_up(t + n_experts * (block_m - 1), block_m)
    ids = topk_ids.long()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev).scatter_add_(
        0, ids, torch.ones_like(ids))
    padded = (counts + block_m - 1) // block_m * block_m
    ends = torch.cumsum(padded, 0)
    seg_starts = ends - padded
    order = torch.argsort(ids, stable=True)
    expert_sorted = ids[order]
    cum_counts = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(t, device=dev) - cum_counts[expert_sorted]
    target = seg_starts[expert_sorted] + pos_in_expert
    sorted_token_ids = torch.full((t_pad,), t, dtype=torch.int32, device=dev).scatter_(
        0, target, order.to(torch.int32))
    block_starts = torch.arange(t_pad // block_m, device=dev) * block_m
    expert_ids = torch.searchsorted(ends, block_starts, right=True).clamp_max(n_experts - 1)
    valid_rows = None
    if ragged:
        # the trailing blocks' clamped expert never owns them: 0 live rows
        offs = block_starts - seg_starts[expert_ids]
        valid_rows = torch.clamp(counts[expert_ids] - offs, 0, block_m).to(torch.int32)
    return MoEAlignment(
        sorted_token_ids=sorted_token_ids,
        expert_ids=expert_ids.to(torch.int32),
        num_tokens_post_pad=padded.sum().to(torch.int32),
        valid_rows=valid_rows,
    )


def live_tile_rows(valid_rows: torch.Tensor, block_m: int, tile: int = 128) -> torch.Tensor:
    """The rows of the `tile`-row M tiles a ragged grouped GEMM computes
    under the map `valid_rows` (a block below `tile` rows is its own tile):
    a device scalar, no host sync."""
    tile = min(tile, block_m)
    return ((valid_rows.long() + tile - 1) // tile).sum() * tile


def valid_rows_from_sorted(sorted_token_ids: torch.Tensor, block_m: int,
                           sentinel: int) -> torch.Tensor:
    """The ragged map of an alignment whose padding rows carry `sentinel`
    (≙ ``valid_rows_from_sorted``, ``:133``): real rows pack from each
    block's start, so the count of non-sentinel rows a block is the map."""
    return (sorted_token_ids.reshape(-1, block_m) < sentinel).sum(1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class RankedAlignment:
    """Per-source-rank alignment, rank-major and expert-minor (≙
    ``RankedAlignment``): each rank's ``m_loc * topk`` assignments aligned on
    their own, so every row block draws its tokens from one rank's chunk.

    local_ids: ``[n, t_pad_loc]`` int32 — rank-local flat assignment index,
      sentinel ``t_loc`` for padding.
    src_rows: ``[n, t_pad_loc]`` int32 — the gathered-token row feeding each
      aligned row (``c * m_loc + token``); sentinels clamp to row 0 of their
      own chunk.
    expert_ids: ``[n, nb]`` int32 — the owning expert of each row block.
    valid_rows: ``[n, nb]`` int32 or None — the ragged map of each rank's
      blocks (:attr:`MoEAlignment.valid_rows`).
    """

    local_ids: torch.Tensor
    src_rows: torch.Tensor
    expert_ids: torch.Tensor
    valid_rows: torch.Tensor | None = None

    @property
    def n_ranks(self) -> int:
        return self.local_ids.shape[0]

    @property
    def t_pad_loc(self) -> int:
        return self.local_ids.shape[1]

    @property
    def blocks_per_rank(self) -> int:
        return self.expert_ids.shape[1]

    @property
    def block_m(self) -> int:
        return self.t_pad_loc // self.blocks_per_rank


def moe_align_ranked(
    ids_full: torch.Tensor, n_experts: int, block_m: int, m_loc: int, *, ragged: bool = False
) -> RankedAlignment:
    """Align each rank's routing independently (≙ ``moe_align_ranked``,
    ``:228``). ids_full ``[n, m_loc * topk]``: the gathered flat top-k ids;
    ``ragged`` carries each rank's ``valid_rows`` map through."""
    n, t_loc = ids_full.shape
    topk = t_loc // m_loc
    als = [moe_align_block_size(ids_full[c], n_experts, block_m, ragged=ragged)
           for c in range(n)]
    local_ids = torch.stack([al.sorted_token_ids for al in als])
    token_of = torch.clamp(local_ids // topk, 0, m_loc - 1)
    c = torch.arange(n, dtype=torch.int32, device=ids_full.device)[:, None]
    src_rows = c * m_loc + torch.where(local_ids < t_loc, token_of, 0)
    return RankedAlignment(
        local_ids=local_ids,
        src_rows=src_rows.to(torch.int32),
        expert_ids=torch.stack([al.expert_ids for al in als]),
        valid_rows=torch.stack([al.valid_rows for al in als]) if ragged else None,
    )


def ranked_global_view(al: RankedAlignment, m_loc: int, topk: int) -> MoEAlignment:
    """The rank-major alignment as an ordinary global one over the gathered
    tokens (≙ ``ranked_global_view``): row ``(c, r)`` is global assignment
    ``c * m_loc * topk + local_ids[c, r]``, sentinel ``n * m_loc * topk``;
    ``num_tokens_post_pad`` is the full padded length."""
    n, t_pad_loc = al.local_ids.shape
    t_loc = m_loc * topk
    c = torch.arange(n, dtype=torch.int32, device=al.local_ids.device)[:, None]
    sorted_token_ids = torch.where(al.local_ids < t_loc, c * t_loc + al.local_ids, n * t_loc)
    return MoEAlignment(
        sorted_token_ids=sorted_token_ids.reshape(-1).to(torch.int32),
        expert_ids=al.expert_ids.reshape(-1),
        num_tokens_post_pad=torch.full((), n * t_pad_loc, dtype=torch.int32,
                                       device=al.local_ids.device),
        valid_rows=None if al.valid_rows is None else al.valid_rows.reshape(-1),
    )


def ranked_scatter_meta(
    al: RankedAlignment, topk_weights_full: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row combine metadata of the fused MoE-Reduce-RS (≙
    ``ranked_scatter_meta``): the destination token of each row within its
    own chunk, and its routing weight (0 for sentinel rows).
    topk_weights_full ``[n * m_loc, topk]`` → ``(dst_ids [n, nb, bm] int32,
    w_rows [n, nb, bm] f32)``."""
    n, _ = al.local_ids.shape
    topk = topk_weights_full.shape[1]
    m_loc = topk_weights_full.shape[0] // n
    t_loc = m_loc * topk
    valid = al.local_ids < t_loc
    local_tok = torch.clamp(al.local_ids // topk, 0, m_loc - 1)
    c = torch.arange(n, dtype=torch.int32, device=al.local_ids.device)[:, None]
    glob = torch.clamp(c * t_loc + al.local_ids, 0, n * t_loc - 1).long()
    w = torch.where(valid, topk_weights_full.reshape(-1)[glob].float(), 0.0)
    bm = al.block_m
    return local_tok.to(torch.int32).reshape(n, -1, bm), w.reshape(n, -1, bm)


def ranked_combine_rows(al: RankedAlignment, m_loc: int, topk: int) -> torch.Tensor:
    """The gather form's inverse map, per chunk: ``[n, m_loc, topk]`` int32,
    the aligned row (within its chunk) that holds each token's k-th
    assignment. A stable argsort of the chunk's slot ids is that inverse,
    since every slot sits on exactly one row and sentinels sort last (≙
    what ``scatter_add_unsorted`` builds). The fused down-projection (K10)
    combines with it, each token summing its rows in k order."""
    n, _ = al.local_ids.shape
    inv = torch.argsort(al.local_ids, dim=1, stable=True)[:, :m_loc * topk]
    return inv.reshape(n, m_loc, topk).to(torch.int32)


def gather_sorted_rows(x: torch.Tensor, alignment: MoEAlignment, topk: int) -> torch.Tensor:
    """Tokens to block-aligned rows: row ``r`` is token ``sorted_token_ids[r]
    // topk``; sentinels clamp to the last token."""
    rows = torch.clamp(alignment.sorted_token_ids.long() // topk, max=x.shape[0] - 1)
    return x[rows]


def scatter_add_unsorted(
    y_sorted: torch.Tensor, alignment: MoEAlignment, weights: torch.Tensor, n_tokens: int
) -> torch.Tensor:
    """The inverse of :func:`gather_sorted_rows` with the top-k weighted sum
    fused in (≙ ``scatter_add_unsorted``, its gather form): ``out[token] =
    Σ_k w[token, k] * y_sorted[row(token, k)]`` in f32, a gather per k in k
    order. Every slot sits on exactly one row (what the builders here
    guarantee), so a stable argsort of the slot ids is the inverse map."""
    topk = weights.shape[1]
    t = n_tokens * topk
    inv = torch.argsort(alignment.sorted_token_ids.long(), stable=True)[:t]
    inv = inv.reshape(n_tokens, topk)
    w = weights.float()
    out = y_sorted[inv[:, 0]].float() * w[:, 0, None]
    for k in range(1, topk):
        out = out + y_sorted[inv[:, k]].float() * w[:, k, None]
    return out
