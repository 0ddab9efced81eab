"""The expert-parallel dispatch and combine (≙ ``triton_dist_tpu/layers/
ep_a2a_layer.py``: ``EPAll2AllLayer`` at ``:116``, ``DispatchInfo`` at
``:104``, the wire quantizer ``:41-100`` and ``_align_received`` at
``:580``).

Expert placement: each rank holds ``n_experts / world`` whole experts;
expert ``e`` lives on rank ``e // epr`` as local expert ``e % epr``. Every
(token, k) assignment travels to its expert's rank over the padded-slab
all-to-all (``ops/all_to_all.py``, K27/K28 on the card) with its local
expert id on the payload; the combine is the same exchange in reverse,
then the top-k weighted sum back into token order. The routing bookkeeping
(sort by destination, slab slots, the un-permutation) is plain PyTorch, as
the JAX package leaves it to XLA, with no host sync: a dropped assignment
(slab overflow) lands in a scratch row instead of being masked out.

``quant="int8"`` / ``"fp8"`` sends the dispatch slab in one byte a value
with per-row absmax scales bitcast onto the payload: serving only, since
the rounding has no gradient; the combine stays in the token dtype.

``HierEPAll2AllLayer`` (``:306``, with ``HierDispatchInfo`` at ``:285``)
is the two-phase dispatch over an (outer, inner) pair of a 2-D rank
runtime: phase 1 sends each token over the outer axis once per
destination outer group (the assignments to one group deduplicated), with
its top-k ids and f32 weights (bitcast) on the payload; phase 2 at the
relay scatters each row over the inner axis to the ranks that own its
experts. The combine is the inner reverse, the relay's weighted sum of its
group's expert outputs a row, then the outer reverse and the sum a token.
Both phases ride the padded-slab all-to-all over their group (K27/K28 on
the card). ``quant`` quantizes the phase-1 wire only.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.all_to_all import A2AConfig, fast_all_to_all
from triton_dist_tpu_torch.ops.grads import fast_all_to_all_grad
from triton_dist_tpu_torch.ops.group_gemm import FP8_DTYPE
from triton_dist_tpu_torch.ops.moe_utils import MoEAlignment, moe_align_block_size
from triton_dist_tpu_torch.utils import axis_index, axis_size

# the one-byte dispatch wire formats: (dtype, the absmax's image)
_QUANT_FORMATS = {"int8": (torch.int8, 127.0), "fp8": (FP8_DTYPE, 448.0)}


def _check_quant(quant) -> None:
    if quant is not None and quant not in _QUANT_FORMATS:
        raise ValueError(f"quant must be one of {sorted(_QUANT_FORMATS)} or None, got {quant!r}")


def _quantize_rows(send: torch.Tensor, quant: str):
    """Per-row absmax quantization of a send slab ``[n, max_m, h]`` →
    ``(slab_q, scale [n, max_m] f32)`` (≙ ``_quantize_rows``, bit for bit
    as the JAX dispatch computes it under ``jit``, where XLA turns the
    division by the constant ``qmax`` into a product with its f32
    reciprocal; the row-scale division stays a true division). Both
    operands are tensors, so the card rounds as the CPU does (PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal).
    All-zero (padding) rows get the scale 1e-8 and quantize to exact
    zeros."""
    qdt, qmax = _QUANT_FORMATS[quant]
    xf = send.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax * amax.new_full((), 1.0 / qmax), min=1e-8)
    q = xf / scale[..., None]
    if quant == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(qdt), scale


def _dequantize_rows(recv_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of :func:`_quantize_rows`."""
    return (recv_q.float() * scale[..., None]).to(dtype)


def _pack_slabs(dest: torch.Tensor, n_dest: int, max_m: int):
    """Sort-and-slot slab packing (≙ ``_pack_slabs``): stable-sort the
    assignments by destination, each one's position in its destination's
    slab, the counts clamped to the slab. Returns ``(order, slot, offsets,
    clamped, overflow)``: ``slot`` the flat slab row of each sorted
    assignment (``n_dest * max_m`` for one that does not fit), ``offsets``
    the unclamped group starts in the sorted order (what the combine
    indexes), ``clamped`` what ships."""
    t = dest.shape[0]
    dev = dest.device
    order = torch.argsort(dest, stable=True)
    dest_sorted = dest[order]
    counts = torch.zeros(n_dest + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, dest, torch.ones_like(dest))[:n_dest]
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t, device=dev) - offsets[dest_sorted.clamp(0, n_dest - 1)]
    fits = (pos < max_m) & (dest_sorted < n_dest)
    slot = torch.where(fits, dest_sorted * max_m + pos, n_dest * max_m)
    clamped = torch.clamp(counts, max=max_m)
    return order, slot, offsets, clamped.to(torch.int32), (counts - clamped).sum()


def _scatter_slots(values: torch.Tensor, slot: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``values`` at their slab rows of a ``[rows, ...]`` buffer filled with
    `fill`; values whose slot is `rows` (dropped) land in a scratch row."""
    out = torch.full((rows + 1, *values.shape[1:]), fill, dtype=values.dtype,
                     device=values.device)
    out[slot] = values
    return out[:rows]


@dataclasses.dataclass(frozen=True)
class DispatchInfo:
    """What the combine needs to route results back (≙ ``DispatchInfo``)."""

    order: torch.Tensor         # [m_loc * topk] assignment ids sorted by destination
    send_splits: torch.Tensor   # [n] rows sent to each rank
    send_offsets: torch.Tensor  # [n] each destination's start in `order`
    recv_splits: torch.Tensor   # [n] rows received from each rank
    recv_expert: torch.Tensor   # [n, max_m] local expert of each received row
    overflow: torch.Tensor      # [] assignments dropped to slab overflow


@dataclasses.dataclass
class EPAll2AllLayer:
    """Dispatch tokens to their experts' ranks and combine the results back
    (≙ ``EPAll2AllLayer``; call inside ``ctx.run``). ``max_m`` is the
    per-(source, destination) slab capacity: assignments past it are
    dropped and counted in ``DispatchInfo.overflow``. ``quant`` the
    one-byte wire (serving only); ``a2a_config`` the transport schedule
    (``chunks_per_shard > 1``: K28)."""

    n_experts: int
    topk: int
    max_m: int
    ctx: object = None
    quant: str | None = None
    a2a_config: A2AConfig | None = None

    def _epr(self) -> int:
        n = axis_size(self.ctx)
        if self.n_experts % n != 0 or self.n_experts < n:
            raise ValueError(f"n_experts={self.n_experts} must be a positive multiple of the "
                             f"world {n}")
        return self.n_experts // n

    def dispatch(self, tokens: torch.Tensor, topk_ids: torch.Tensor):
        """Send each (token, k) assignment to the rank owning its expert.
        tokens ``[m_loc, hidden]``, topk_ids ``[m_loc, topk]`` global expert
        ids → ``(recv [n, max_m, hidden], info)``: slab ``j`` holds rank
        ``j``'s assignments for this rank (``info.recv_splits[j]`` valid),
        the local expert of each row in ``info.recv_expert``."""
        epr = self._epr()
        _check_quant(self.quant)
        n = axis_size(self.ctx)
        hidden = tokens.shape[1]
        flat_ids = topk_ids.reshape(-1).long()
        order, slot, offsets, clamped, overflow = _pack_slabs(flat_ids // epr, n, self.max_m)
        rows = n * self.max_m
        send = _scatter_slots(tokens[order // self.topk], slot, rows, 0).view(
            n, self.max_m, hidden)
        send_exp = _scatter_slots((flat_ids[order] % epr).to(torch.int32), slot, rows, -1).view(
            n, self.max_m)
        if self.quant is not None:
            # the one-byte slab; its f32 row scales ride the payload as bits
            send_q, scale = _quantize_rows(send, self.quant)
            meta = torch.cat([send_exp, scale.view(torch.int32)], dim=1)
            recv_q, recv_splits, meta_r = fast_all_to_all(
                send_q, clamped, meta=meta, ctx=self.ctx, config=self.a2a_config)
            recv_exp = meta_r[:, :self.max_m]
            r_scale = meta_r[:, self.max_m:].contiguous().view(torch.float32)
            recv = _dequantize_rows(recv_q, r_scale, tokens.dtype)
        else:
            recv, recv_splits, recv_exp = fast_all_to_all_grad(
                send, clamped, send_exp, ctx=self.ctx, config=self.a2a_config)
        info = DispatchInfo(order=order, send_splits=clamped, send_offsets=offsets,
                            recv_splits=recv_splits, recv_expert=recv_exp, overflow=overflow)
        return recv, info

    def receiver_alignment(self, info: DispatchInfo, block_m: int, *,
                           ragged: bool = False) -> MoEAlignment:
        """Block-align the received rows by local expert for the grouped
        GEMMs; padding rows go to a virtual trailing expert whose blocks
        compute on the clamped last expert, and the combine drops them.
        ``ragged`` adds the ``valid_rows`` map, with the virtual expert's
        blocks dead (0 live rows), so the ragged GEMMs skip them."""
        return _align_received(info.recv_expert, info.recv_splits, self.max_m, self._epr(),
                               block_m, ragged=ragged)

    def combine(self, y: torch.Tensor, info: DispatchInfo, topk_weights: torch.Tensor,
                m_loc: int) -> torch.Tensor:
        """Return the expert outputs ``y [n, max_m, h]`` (the received slab
        layout) to their source ranks and sum each token's top-k in f32:
        → ``[m_loc, h]`` f32."""
        n = axis_size(self.ctx)
        back, _, _ = fast_all_to_all_grad(y, info.recv_splits, ctx=self.ctx,
                                          config=self.a2a_config)
        h = y.shape[-1]
        idx = torch.arange(n * self.max_m, device=y.device)
        slab, pos = idx // self.max_m, idx % self.max_m
        valid = pos < info.send_splits[slab]
        # slab p row i is sorted assignment offsets[p] + i
        sorted_pos = torch.clamp(info.send_offsets[slab] + pos, 0, info.order.shape[0] - 1)
        assignment = info.order[sorted_pos]
        w = torch.where(valid, topk_weights.reshape(-1)[assignment].float(), 0.0)
        contrib = torch.where(valid[:, None], back.reshape(-1, h).float() * w[:, None], 0.0)
        out = torch.zeros((m_loc, h), dtype=torch.float32, device=y.device)
        return out.index_add_(0, assignment // self.topk, contrib)


@dataclasses.dataclass(frozen=True)
class HierDispatchInfo:
    """The two-phase dispatch's bookkeeping (≙ ``HierDispatchInfo``):
    phase 1 at the source over the outer axis, phase 2 at the relay over
    the inner axis."""

    order1: torch.Tensor         # [m_loc * topk] assignment ids sorted by destination group
    send_splits1: torch.Tensor   # [n_o] rows sent to each outer group
    send_offsets1: torch.Tensor  # [n_o] each destination's start in `order1`
    recv_splits1: torch.Tensor   # [n_o] rows received from each source group
    order2: torch.Tensor         # [R * topk] relay assignment ids sorted by destination
    send_splits2: torch.Tensor   # [n_i]
    send_offsets2: torch.Tensor  # [n_i]
    recv_splits2: torch.Tensor   # [n_i]
    recv_expert: torch.Tensor    # [n_i, max_m2] local expert of each received row
    rel_weights: torch.Tensor    # [R, topk] f32 routing weights at the relay
    overflow: torch.Tensor       # [] assignments dropped to slab overflow (either phase)


@dataclasses.dataclass
class HierEPAll2AllLayer:
    """Dispatch and combine over a pair of axes ``(outer, inner)`` of a rank
    runtime (≙ ``HierEPAll2AllLayer``; call inside ``ctx.run``, `ctx` the
    runtime or any group of it). Expert ``e`` lives on the rank whose
    flattened (outer-major) pair index is ``e // epr``, as in the flat
    layer over the flattened pair. ``max_m1`` is the per-(source,
    destination group) slab of phase 1, ``max_m2`` the per-(relay,
    destination) slab of phase 2. The routing weights ride phase 1 twice:
    bitcast f32 on the payload (the value the combine uses) and as top-k
    slab columns (the differentiable channel, straight through); with
    ``quant`` (serving only) the slab is one byte a value with per-row
    scales on the payload, and no weight columns."""

    n_experts: int
    topk: int
    max_m1: int
    max_m2: int
    ctx: object = None
    outer: str = "dp"
    inner: str = "tp"
    quant: str | None = None
    a2a_config: A2AConfig | None = None

    def _groups(self):
        return self.ctx.group(self.outer), self.ctx.group(self.inner)

    def _dims(self) -> tuple[int, int]:
        return axis_size(self.ctx, self.outer), axis_size(self.ctx, self.inner)

    def _epr(self) -> int:
        n_o, n_i = self._dims()
        if self.n_experts % (n_o * n_i) != 0:
            raise ValueError(f"n_experts={self.n_experts} must divide over the {n_o}x{n_i} mesh")
        return self.n_experts // (n_o * n_i)

    def dispatch(self, tokens: torch.Tensor, topk_ids: torch.Tensor,
                 topk_weights: torch.Tensor):
        """tokens ``[m_loc, hidden]``, topk_ids/weights ``[m_loc, topk]`` →
        ``(recv [n_i, max_m2, hidden], info)`` in phase 2's slab layout
        (the local expert of each row in ``info.recv_expert``). The
        weights travel along, so :meth:`combine` takes none."""
        n_o, n_i = self._dims()
        epr = self._epr()
        _check_quant(self.quant)
        outer, inner = self._groups()
        m_loc, hidden = tokens.shape
        topk, max_m1, max_m2 = self.topk, self.max_m1, self.max_m2
        my_o = axis_index(self.ctx, self.outer)

        # phase 1: one copy per (token, destination group); an assignment
        # is a duplicate when an earlier k of its token goes to that group
        flat_ids = topk_ids.reshape(-1).long()
        dest_o = (flat_ids // epr) // n_i
        ids2d = dest_o.reshape(m_loc, topk)
        dup = torch.zeros((m_loc, topk), dtype=torch.bool, device=tokens.device)
        for k in range(1, topk):
            dup[:, k] = (ids2d[:, :k] == ids2d[:, k:k + 1]).any(dim=1)
        dest1 = torch.where(dup.reshape(-1), n_o, dest_o)
        order1, slot1, offsets1, clamped1, overflow1 = _pack_slabs(dest1, n_o, max_m1)
        rows1 = n_o * max_m1
        src_tok = order1 // topk
        meta_ids = _scatter_slots(topk_ids.to(torch.int32)[src_tok], slot1, rows1, -1)
        meta_w = _scatter_slots(topk_weights.float().contiguous().view(torch.int32)[src_tok],
                                slot1, rows1, 0)
        meta_ids, meta_w = meta_ids.view(n_o, -1), meta_w.view(n_o, -1)
        if self.quant is not None:
            send1 = _scatter_slots(tokens[src_tok], slot1, rows1, 0).view(n_o, max_m1, hidden)
            send1_q, scale1 = _quantize_rows(send1, self.quant)
            meta1 = torch.cat([meta_ids, meta_w, scale1.view(torch.int32)], dim=1)
            recv1_q, recv_splits1, rmeta1 = fast_all_to_all(
                send1_q, clamped1, meta=meta1, ctx=outer, config=self.a2a_config)
            k_w = max_m1 * topk
            rel_ids = rmeta1[:, :k_w].reshape(-1, topk)
            rel_w = rmeta1[:, k_w:2 * k_w].contiguous().view(torch.float32).reshape(-1, topk)
            r_scale1 = rmeta1[:, 2 * k_w:].contiguous().view(torch.float32)
            rows = _dequantize_rows(recv1_q, r_scale1, tokens.dtype).reshape(-1, hidden)
        else:
            # the weights ride twice: exact f32 bits on the payload (the
            # value) and as slab columns (the gradient), straight through
            payload = torch.cat([tokens, topk_weights.to(tokens.dtype)], dim=1)
            send1 = _scatter_slots(payload[src_tok], slot1, rows1, 0).view(
                n_o, max_m1, hidden + topk)
            recv1, recv_splits1, rmeta1 = fast_all_to_all_grad(
                send1, clamped1, torch.cat([meta_ids, meta_w], dim=1), ctx=outer,
                config=self.a2a_config)
            rmeta1 = rmeta1.reshape(n_o, 2, max_m1, topk)
            rel_ids = rmeta1[:, 0].reshape(-1, topk)
            exact_w = rmeta1[:, 1].contiguous().view(torch.float32).reshape(-1, topk)
            rows_full = recv1.reshape(-1, hidden + topk)
            rows = rows_full[:, :hidden]
            slab_w = rows_full[:, hidden:].float()
            rel_w = exact_w + (slab_w - slab_w.detach())

        # phase 2: the relay scatters each row to the inner ranks that own
        # its experts of this outer group
        r_cap = n_o * max_m1
        idx = torch.arange(r_cap, device=tokens.device)
        row_valid = idx % max_m1 < recv_splits1.long()[idx // max_m1]
        g = rel_ids.reshape(-1).long()
        g_owner = torch.where(g >= 0, g // epr, 0)
        amask = row_valid.repeat_interleave(topk) & (g >= 0) & (g_owner // n_i == my_o)
        dest2 = torch.where(amask, g_owner % n_i, n_i)
        order2, slot2, offsets2, clamped2, overflow2 = _pack_slabs(dest2, n_i, max_m2)
        rows2 = n_i * max_m2
        send2 = _scatter_slots(rows[order2 // topk], slot2, rows2, 0).view(n_i, max_m2, hidden)
        send_exp2 = _scatter_slots(torch.where(g >= 0, g % epr, -1)[order2].to(torch.int32),
                                   slot2, rows2, -1).view(n_i, max_m2)
        recv2, recv_splits2, recv_exp2 = fast_all_to_all_grad(
            send2, clamped2, send_exp2, ctx=inner, config=self.a2a_config)
        info = HierDispatchInfo(
            order1=order1, send_splits1=clamped1, send_offsets1=offsets1,
            recv_splits1=recv_splits1, order2=order2, send_splits2=clamped2,
            send_offsets2=offsets2, recv_splits2=recv_splits2, recv_expert=recv_exp2,
            rel_weights=rel_w, overflow=overflow1 + overflow2)
        return recv2, info

    def receiver_alignment(self, info: HierDispatchInfo, block_m: int, *,
                           ragged: bool = False) -> MoEAlignment:
        """Block-align the received rows by local expert, as the flat
        layer does."""
        return _align_received(info.recv_expert, info.recv_splits2, self.max_m2, self._epr(),
                               block_m, ragged=ragged)

    def combine(self, y: torch.Tensor, info: HierDispatchInfo, m_loc: int) -> torch.Tensor:
        """Return ``y [n_i, max_m2, h]`` (phase 2's slab layout): the inner
        reverse, the relay's weighted sum per phase-1 row (one partial a
        (token, outer group) crosses the outer axis back), the outer
        reverse and the sum per token → ``[m_loc, h]`` f32."""
        outer, inner = self._groups()
        n_o, n_i = self._dims()
        topk, max_m1, max_m2 = self.topk, self.max_m1, self.max_m2
        h = y.shape[-1]
        dev = y.device
        r_cap = n_o * max_m1
        back2, _, _ = fast_all_to_all_grad(y, info.recv_splits2, ctx=inner,
                                           config=self.a2a_config)
        idx2 = torch.arange(n_i * max_m2, device=dev)
        slab2, pos2 = idx2 // max_m2, idx2 % max_m2
        valid2 = pos2 < info.send_splits2.long()[slab2]
        a2 = info.order2[torch.clamp(info.send_offsets2[slab2] + pos2, 0,
                                     info.order2.shape[0] - 1)]
        r_row, k_slot = a2 // topk, a2 % topk
        w = torch.where(valid2, info.rel_weights[r_row, k_slot], 0.0)
        contrib = torch.where(valid2[:, None], back2.reshape(-1, h).float() * w[:, None], 0.0)
        partial = torch.zeros((r_cap, h), dtype=torch.float32, device=dev).index_add(
            0, r_row, contrib)
        back1, _, _ = fast_all_to_all_grad(partial.view(n_o, max_m1, h).to(y.dtype),
                                           info.recv_splits1, ctx=outer,
                                           config=self.a2a_config)
        idx1 = torch.arange(r_cap, device=dev)
        slab1, pos1 = idx1 // max_m1, idx1 % max_m1
        valid1 = pos1 < info.send_splits1.long()[slab1]
        a1 = info.order1[torch.clamp(info.send_offsets1[slab1] + pos1, 0,
                                     info.order1.shape[0] - 1)]
        contrib1 = torch.where(valid1[:, None], back1.reshape(-1, h).float(), 0.0)
        out = torch.zeros((m_loc, h), dtype=torch.float32, device=dev)
        return out.index_add(0, a1 // topk, contrib1)


def _align_received(recv_expert, recv_splits, max_m: int, epr: int, block_m: int,
                    ragged: bool = False) -> MoEAlignment:
    """Receiver-side block alignment (≙ ``_align_received``): the rows past
    a slab's count go to the virtual expert ``epr``, whose blocks keep the
    clamped id ``epr - 1``; with `ragged` their live rows are 0
    (``:597-600``)."""
    flat = recv_expert.reshape(-1)
    idx = torch.arange(flat.shape[0], device=flat.device)
    valid = idx % max_m < recv_splits.long()[idx // max_m]
    al = moe_align_block_size(torch.where(valid, flat, epr), epr + 1, block_m, ragged=ragged)
    valid_rows = None
    if ragged:
        valid_rows = torch.where(al.expert_ids >= epr, 0, al.valid_rows).to(torch.int32)
    return MoEAlignment(sorted_token_ids=al.sorted_token_ids,
                        expert_ids=torch.clamp(al.expert_ids, max=epr - 1),
                        num_tokens_post_pad=al.num_tokens_post_pad, valid_rows=valid_rows)
